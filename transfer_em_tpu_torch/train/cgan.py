"""The 3D CycleGAN train step (counterpart of transfer_em_tpu/train/cgan.py:
79-403, reference transfer_em/cgan.py:144-228).

One step runs the two generators four times (``batched_apps``: round 1 runs
each generator once on 2B tiles, round 2 the two cycles) and the two
discriminators four times, sums the four losses into ONE scalar with the
reference's gradient routing, takes ONE ``backward()`` and applies four
Keras-exact Adam updates in place:

* fakes enter the discriminator losses detached (the discriminators learn,
  the generators do not through that term);
* the generators' adversarial terms see the discriminators FROZEN: their
  parameters go in detached through ``torch.func.functional_call``, so the
  gradient reaches the fakes and not the discriminators;
* the cycle loss appears once and reaches both generators.

Every k3 conv runs on the conv3 kernels and every standalone LeakyReLU on
the leaky_relu kernel, through their autograd Functions (backward in plain
torch: cuDNN's f32 conv gradients, as ``lax.conv``'s VJP in the JAX
package).  Dropout draws from a torch.Generator on the batch's device,
seeded from (seed, step): the same seed and step give the same masks, but
not the JAX package's bits.

Waiting for later slices (each raises NotImplementedError where a caller
reaches it): 2D, bf16 training, ``ensemble_apps``, ``remat``,
``make_scan_train_step``, the EM2EM orchestrator with its checkpoints and
metrics, and the data pipelines.  A prior is built from a loaded generator
with ``_tap_prior``; ``create_prior_helper`` (a prior from an export path)
comes with the orchestrator.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..config import CycleGANConfig
from ..device import resolve_device
from ..models.discriminator import Discriminator
from ..models.generator import UNetGenerator
from ..ops import losses as L
from ..ops.convs import center_crop, zero_pad
from ..shapes import generator_shapes, is_valid_dimsize
from .state import CycleGANState, make_optimizer

# (7,) [g_gen_total, f_gen_total, disc_y, disc_x, g_gen_only, f_gen_only,
# cycle], as the JAX package orders it
LossVector = torch.Tensor


class _Tapped(Exception):
    """Ends a prior's forward at its tapped layer."""


def _tap_prior(gen: UNetGenerator, last_layer: str) -> Callable:
    """Weight-frozen intermediate tap of a generator, to pass as a
    discriminator's ``disc_prior`` (transfer_em_tpu/train/cgan.py:79-108).

    The prior's WEIGHTS never update: they go in detached, and they are not
    parameters of any network in the train state.  Its INPUT gradient flows,
    as TF's ``trainable = False`` lets it (reference cgan.py:29): the
    generator's adversarial loss through disc_y includes the path through
    the prior.  The returned callable runs ``gen`` up to the submodule
    ``last_layer`` (a DownBlock gives its downsampled output) and carries
    ``channels``, the tap's width."""
    sub = gen.get_submodule(last_layer)
    kernels = [p for n, p in sub.named_parameters() if n.endswith("kernel")]

    def prior(x: torch.Tensor) -> torch.Tensor:
        out = []

        def hook(_mod, _inp, o):
            out.append(o[0] if isinstance(o, tuple) else o)
            raise _Tapped

        handle = sub.register_forward_hook(hook)
        try:
            functional_call(gen, {k: v.detach()
                                  for k, v in gen.named_parameters()}, (x,))
        except _Tapped:
            pass
        finally:
            handle.remove()
        return out[0]

    prior.channels = int(kernels[-1].shape[-1])
    return prior


def _check_config(config: CycleGANConfig) -> None:
    if not config.is3d:
        raise NotImplementedError("2D CycleGAN training comes with a later "
                                  "slice of the port; this slice is 3D")
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {config.compute_dtype!r}: bf16 training comes "
            "with a later slice of the port; this slice trains in float32")


def build_models(config: CycleGANConfig, disc_prior: Optional[Callable] = None,
                 *, generator: Optional[torch.Generator] = None
                 ) -> Tuple[UNetGenerator, UNetGenerator, Discriminator,
                            Discriminator]:
    """G, F and the two discriminators (disc_y optionally with a prior,
    reference cgan.py:58-62), initialised on the CPU from ``generator``."""
    _check_config(config)
    g, wf, n = generator, config.wf, config.use_norm
    gg = UNetGenerator(wf=wf, use_norm=n, generator=g)
    gf = UNetGenerator(wf=wf, use_norm=n, generator=g)
    dx = Discriminator(wf=wf, use_norm=n, generator=g)
    dy = Discriminator(wf=wf, use_norm=n, disc_prior=disc_prior,
                       prior_channels=(disc_prior.channels if disc_prior
                                       else 0), generator=g)
    return gg, gf, dx, dy


def create_state(config: CycleGANConfig, seed: int = 0, device="cuda",
                 disc_prior: Optional[Callable] = None) -> CycleGANState:
    """All four networks, initialised from ``seed`` (N(0, 0.02) weights drawn
    on the CPU in the order G, F, Dx, Dy, then moved to ``device``), and
    four fresh Adam states."""
    dev = resolve_device(device)
    if config.dimsize < 74:
        raise ValueError("minimum dimension allowed is 74")  # cgan.py:52
    if not is_valid_dimsize(config.dimsize):
        raise ValueError(f"{config.dimsize} does not allow valid convolutions")
    nets = [n.to(dev) for n in build_models(
        config, disc_prior, generator=torch.Generator().manual_seed(seed))]
    opt = make_optimizer(config.learning_rate, config.adam_beta1)
    opts = [opt.init(dict(n.named_parameters())) for n in nets]
    return CycleGANState(0, *nets, *opts)


def _frozen(net: torch.nn.Module) -> Callable:
    """net with its parameters detached: gradients reach the input only."""
    params = {k: v.detach() for k, v in net.named_parameters()}
    return lambda x: functional_call(net, params, (x,))


def cyclegan_losses(gg: UNetGenerator, gf: UNetGenerator, dx: Discriminator,
                    dy: Discriminator, buffer: int, gamma: float,
                    real_x: torch.Tensor, real_y: torch.Tensor,
                    dropout_generator: Optional[torch.Generator] = None, *,
                    batched_apps: bool = True, deterministic: bool = False
                    ) -> Tuple[torch.Tensor, LossVector]:
    """One combined scalar whose gradient w.r.t. each network equals the
    reference's four ``tape.gradient`` calls (cgan.py:144-215), and the
    7-loss vector.  ``batched_apps=False`` runs the reference's six separate
    generator applications (same math).  ``deterministic`` turns dropout off
    (tests); otherwise masks come from ``dropout_generator``."""
    B = real_x.shape[0]

    def g(net, x):
        return net(x, deterministic=deterministic,
                   dropout_generator=dropout_generator)

    # the crops feed the conv3 kernels, which read contiguous tensors
    real_x_c = center_crop(real_x, buffer).contiguous()
    real_y_c = center_crop(real_y, buffer).contiguous()
    real_x_c2 = center_crop(real_x, buffer * 2)
    real_y_c2 = center_crop(real_y, buffer * 2)

    if batched_apps:
        # round 1: everything from the real images, one apply a network
        out_g1 = g(gg, torch.cat([real_x, real_y], 0))
        fake_y, same_y = out_g1[:B], out_g1[B:]
        out_f1 = g(gf, torch.cat([real_y, real_x], 0))
        fake_x, same_x = out_f1[:B], out_f1[B:]
        # round 2: the cycles
        cycled_y = g(gg, zero_pad(fake_x, buffer))
        cycled_x = g(gf, zero_pad(fake_y, buffer))
        out_dx = dx(torch.cat([real_x_c, fake_x.detach()], 0))
        disc_real_x, disc_fake_x_d = out_dx[:B], out_dx[B:]
        out_dy = dy(torch.cat([real_y_c, fake_y.detach()], 0))
        disc_real_y, disc_fake_y_d = out_dy[:B], out_dy[B:]
    else:
        # the reference's structure (cgan.py:152-183)
        fake_y = g(gg, real_x)
        cycled_x = g(gf, zero_pad(fake_y, buffer))
        fake_x = g(gf, real_y)
        cycled_y = g(gg, zero_pad(fake_x, buffer))
        same_x = g(gf, real_x)
        same_y = g(gg, real_y)
        disc_real_x = dx(real_x_c)
        disc_real_y = dy(real_y_c)
        disc_fake_x_d = dx(fake_x.detach())
        disc_fake_y_d = dy(fake_y.detach())
    disc_fake_x_gen = _frozen(dx)(fake_x)
    disc_fake_y_gen = _frozen(dy)(fake_y)
    cycled_x_c = center_crop(cycled_x, buffer)
    cycled_y_c = center_crop(cycled_y, buffer)

    # losses (reference cgan.py:192-203)
    gen_g_loss = L.generator_adv_loss(disc_fake_y_gen, gamma=gamma)
    gen_f_loss = L.generator_adv_loss(disc_fake_x_gen, gamma=gamma)
    total_cycle = (L.cycle_loss(real_x_c2, cycled_x_c, gamma=gamma)
                   + L.cycle_loss(real_y_c2, cycled_y_c, gamma=gamma))
    id_y = L.identity_loss(real_y_c, same_y, gamma=gamma)
    id_x = L.identity_loss(real_x_c, same_x, gamma=gamma)
    total_gen_g = gen_g_loss + total_cycle + id_y
    total_gen_f = gen_f_loss + total_cycle + id_x
    disc_x_loss = L.discriminator_loss(disc_real_x, disc_fake_x_d, gamma=gamma)
    disc_y_loss = L.discriminator_loss(disc_real_y, disc_fake_y_d, gamma=gamma)

    # the cycle term appears ONCE: its gradient reaches both generators, as
    # it does through both total_gen losses upstream
    combined = (gen_g_loss + gen_f_loss + total_cycle + id_y + id_x
                + disc_x_loss + disc_y_loss)
    loss_vec = torch.stack([total_gen_g, total_gen_f, disc_y_loss,
                            disc_x_loss, gen_g_loss, gen_f_loss,
                            total_cycle]).detach()
    return combined, loss_vec


def _dropout_generator(device: torch.device, seed: int, step: int,
                       micro: Optional[int] = None) -> torch.Generator:
    """The dropout masks' generator for one step (and microbatch): seeded
    from (seed, step[, micro]), as the JAX step folds the step (and the
    microbatch index) into its key."""
    words = [seed, step] if micro is None else [seed, step, micro]
    s = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & (2 ** 63 - 1))


def build_step_fn(config: CycleGANConfig, batched_apps: bool = True,
                  deterministic: bool = False) -> Callable:
    """The train step: ``step(state, real_x, real_y, seed) -> loss7``,
    updating ``state`` in place (parameters, Adam states, ``step``).

    real_x / real_y: standardized float32 batches (B, D, H, W, 1) of
    ``config.dimsize``, on the state's device.  ``config.accum_steps > 1``
    splits the batch into that many microbatches, runs one backward each
    (the gradients add up in ``p.grad``), averages, and applies ONE update:
    full-batch math, since every loss is a per-sample mean.  ``seed`` with
    the state's step count seeds the dropout masks; ``deterministic`` turns
    dropout off (tests)."""
    if config.ensemble_apps or config.remat:
        raise NotImplementedError(
            "ensemble_apps and remat are opt-ins of the JAX package that "
            "come with a later slice of the port")
    accum = int(config.accum_steps)
    if accum < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum}")
    buffer = generator_shapes(config.dimsize).buffer
    gamma = config.focal_gamma
    opt = make_optimizer(config.learning_rate, config.adam_beta1)

    def step(state: CycleGANState, real_x: torch.Tensor,
             real_y: torch.Tensor, seed: int) -> LossVector:
        B = real_x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by accum_steps {accum}")
        nets = (state.gg, state.gf, state.dx, state.dy)
        for net in nets:
            net.zero_grad(set_to_none=True)
        micro = B // accum
        loss_sum = None
        for i in range(accum):
            gen = None if deterministic else _dropout_generator(
                real_x.device, seed, state.step, i if accum > 1 else None)
            part = slice(i * micro, (i + 1) * micro)
            combined, lv = cyclegan_losses(
                *nets, buffer, gamma, real_x[part], real_y[part], gen,
                batched_apps=batched_apps, deterministic=deterministic)
            combined.backward()
            loss_sum = lv if loss_sum is None else loss_sum + lv
        if accum > 1:
            for net in nets:
                for p in net.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum)
            loss_sum = loss_sum / accum
        for net, o in zip(nets, (state.opt_gg, state.opt_gf, state.opt_dx,
                                 state.opt_dy)):
            opt.update_module(net, o)
        state.step += 1
        return loss_sum

    return step


def make_train_step(config: CycleGANConfig, device="cuda") -> Callable:
    """The train step on ``device`` (default ``cuda``; raises where it is
    absent): ``step(state, real_x, real_y, seed) -> loss7``, with the
    batches moved to the device and the state checked to be there."""
    dev = resolve_device(device)
    step = build_step_fn(config)

    def run(state: CycleGANState, real_x, real_y, seed: int) -> LossVector:
        where = next(state.gg.parameters()).device
        if where != dev:
            raise ValueError(f"state is on {where}, the step on {dev}")
        return step(state, torch.as_tensor(real_x).to(dev),
                    torch.as_tensor(real_y).to(dev), seed)

    return run


def make_scan_train_step(*_args, **_kwargs):
    """Several steps per dispatch (JAX ``lax.scan``): not in this slice."""
    raise NotImplementedError(
        "make_scan_train_step (the scan window) is an opt-in of the JAX "
        "package that comes with a later slice of the port")


class EM2EM:
    """The training orchestrator (checkpoints, metrics, data pipelines)."""

    def __init__(self, *_args, **_kwargs):
        raise NotImplementedError(
            "EM2EM, its checkpoints and metrics and the data pipelines come "
            "with a later slice of the port; drive create_state and "
            "make_train_step directly")
