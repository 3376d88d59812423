"""CycleGAN losses: sigmoid focal cross-entropy and the reference's recipe.

Counterpart of ``transfer_em_tpu/ops/losses.py:29-105`` (which replaces
``tfa.losses.SigmoidFocalCrossEntropy``, reference cgan.py:78-81):

* per-element loss alpha_t * (1 - p_t)**gamma * ce, summed over the channel
  axis, then the mean over everything else (SUM_OVER_BATCH_SIZE);
* the composite losses with the reference's x2, LAMBDA (= 2) and 0.5
  factors and the ``tconf = 1 - |a - b| / 2`` trick (cgan.py:110-142);
* ``rmse`` and ``psnr`` (losses.py:108-118), the debug tools' scores.

Plain torch, differentiable by autograd.  Where the JAX functions have a
kink (``maximum``, ``clip``) the port uses ``torch.maximum`` /
``torch.minimum``, which split the gradient at a tie as ``lax.max`` does
(``torch.clamp`` would give it all to one side), and |x| has JAX's gradient
of 1 at x = 0 (``torch.abs`` gives 0 there).
"""

from __future__ import annotations

import torch

# Keras backend epsilon used by binary_crossentropy's probability clipping.
K_EPSILON = 1e-7


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient: sign(x), and 1 at x = 0."""
    return torch.where(x >= 0, x, -x)


def sigmoid_focal_ce(labels: torch.Tensor, preds: torch.Tensor, *,
                     alpha: float = 0.5, gamma: float = 2.0,
                     from_logits: bool = True) -> torch.Tensor:
    """tfa sigmoid_focal_crossentropy with SUM_OVER_BATCH_SIZE reduction;
    ``preds`` are logits (``from_logits``) or probabilities.  Returns the
    scalar mean over all non-channel elements of the channel-summed loss."""
    labels = labels.to(torch.float32)
    preds = preds.to(torch.float32)
    zero = preds.new_zeros(())
    if from_logits:
        # numerically stable sigmoid CE: max(x, 0) - x*z + log1p(exp(-|x|))
        ce = (torch.maximum(preds, zero) - preds * labels
              + torch.log1p(torch.exp(-_abs(preds))))
        p = torch.sigmoid(preds)
    else:
        # Keras-3 binary_crossentropy: clip to [eps, 1 - eps], then another
        # +eps inside each log.  p_t takes the UNCLIPPED probabilities, so
        # out-of-range preds keep a gradient through the modulating factor.
        p_clip = torch.minimum(torch.maximum(preds, zero + K_EPSILON),
                               zero + (1.0 - K_EPSILON))
        ce = -(labels * torch.log(p_clip + K_EPSILON)
               + (1.0 - labels) * torch.log(1.0 - p_clip + K_EPSILON))
        p = preds
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_t = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    focal = alpha_t * torch.pow(1.0 - p_t, gamma) * ce
    return torch.mean(torch.sum(focal, dim=-1))


def generator_adv_loss(disc_fake: torch.Tensor, *,
                       gamma: float = 2.0) -> torch.Tensor:
    """Focal CE of the fakes' logits against ones, x2 (cgan.py:119-120)."""
    return sigmoid_focal_ce(torch.ones_like(disc_fake), disc_fake,
                            gamma=gamma, from_logits=True) * 2.0


def discriminator_loss(disc_real: torch.Tensor, disc_fake: torch.Tensor, *,
                       gamma: float = 2.0) -> torch.Tensor:
    """(real vs ones x2 + fake vs zeros x2) * 0.5 (cgan.py:110-117)."""
    real_loss = sigmoid_focal_ce(torch.ones_like(disc_real), disc_real,
                                 gamma=gamma, from_logits=True) * 2.0
    fake_loss = sigmoid_focal_ce(torch.zeros_like(disc_fake), disc_fake,
                                 gamma=gamma, from_logits=True) * 2.0
    return (real_loss + fake_loss) * 0.5


def _tconf_focal(real: torch.Tensor, other: torch.Tensor, *,
                 gamma: float) -> torch.Tensor:
    """Agreement in [-1, 1] space as a pseudo-probability, tconf = 1 -
    |real - other| / 2, against ones, x2 (cgan.py:122-142)."""
    tconf = 1.0 - _abs(real - other) / 2.0
    return sigmoid_focal_ce(torch.ones_like(tconf), tconf, gamma=gamma,
                            from_logits=False) * 2.0


def cycle_loss(real: torch.Tensor, cycled: torch.Tensor, *,
               gamma: float = 2.0) -> torch.Tensor:
    """LAMBDA (= 2) * tconf focal (cgan.py:133-142)."""
    return 2.0 * _tconf_focal(real, cycled, gamma=gamma)


def identity_loss(real: torch.Tensor, same: torch.Tensor, *,
                  gamma: float = 2.0) -> torch.Tensor:
    """LAMBDA (= 2) * 0.5 * tconf focal (cgan.py:122-131)."""
    return 2.0 * 0.5 * _tconf_focal(real, same, gamma=gamma)


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Root mean squared error in float32 (reference debug.py:65-71
    ``accuracy``)."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.sqrt(torch.mean(d * d))


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 2.0) -> torch.Tensor:
    """PSNR in dB; the default peak 2.0 is the range of data scaled to
    [-1, 1]."""
    d = a.to(torch.float32) - b.to(torch.float32)
    mse = torch.clamp_min(torch.mean(d * d), 1e-20)
    return 10.0 * torch.log10(peak * peak / mse)
