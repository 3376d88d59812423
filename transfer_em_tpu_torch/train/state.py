"""Training state and the Keras-exact Adam.

Counterpart of ``transfer_em_tpu/train/state.py``: the four networks (two
generators, two discriminators) and their four Adam states, as the
reference checkpoints them together (cgan.py:58-95).  The networks are
``nn.Module``s holding their parameters; the optimizer updates them in
place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class AdamState:
    """One network's Adam state: the update count and the first and second
    moments by parameter name (optax ``ScaleByAdamState``)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class KerasAdam:
    """Adam(lr, beta1) with tf.keras Adam's EXACT update (reference
    cgan.py:69-73; transfer_em_tpu/train/state.py:18-57):

        m <- b1*m + (1-b1)*g;  v <- b2*v + (1-b2)*g*g
        p <- p - lr*sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)

    eps goes on the UNCORRECTED sqrt(v) and the bias correction is folded
    into the step size; ``torch.optim.Adam`` adds eps to the corrected
    sqrt(v_hat), which differs where sqrt(v) ~ eps.  The step size is
    computed in float32, as the JAX package computes it.

    The update runs under ``torch.no_grad()`` with in-place ops on the
    parameters themselves (never through ``.data``), so each parameter's
    version counter moves and conv3's packed-weight cache repacks it."""

    def __init__(self, lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
                 eps: float = 1e-7):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for k, p in params.items()})

    def step_size(self, count: int) -> float:
        """lr * sqrt(1 - b2^t) / (1 - b1^t) in float32."""
        f = np.float32
        c = f(count)
        one = f(1.0)
        return float(f(self.lr) * np.sqrt(one - f(self.b2) ** c)
                     / (one - f(self.b1) ** c))

    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]],
               state: AdamState) -> None:
        """One update of ``params`` in place from ``grads`` (a missing or
        None gradient counts as zeros, as ``jax.grad`` gives them)."""
        b1, b2 = self.b1, self.b2
        state.count += 1
        lr_t = self.step_size(state.count)
        with torch.no_grad():
            for name, p in params.items():
                g = grads.get(name)
                if g is None:
                    g = torch.zeros_like(p)
                m, v = state.mu[name], state.nu[name]
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * (1 - b2) * g)
                p.add_(m * -lr_t / (v.sqrt() + self.eps))

    def update_module(self, module: nn.Module, state: AdamState) -> None:
        """:meth:`update` from the gradients autograd left in ``p.grad``."""
        params = dict(module.named_parameters())
        self.update(params, {k: p.grad for k, p in params.items()}, state)


def make_optimizer(lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
                   eps: float = 1e-7) -> KerasAdam:
    """Adam(2e-4, beta1=0.5) with Keras's update (eps=1e-7, Keras's
    default), like the JAX package's ``make_optimizer``."""
    return KerasAdam(lr, b1, b2, eps)


@dataclasses.dataclass
class CycleGANState:
    """All trainable state of the CycleGAN (reference ``tf.train.Checkpoint``
    contents, cgan.py:86-93): ``gg`` G (X -> Y), ``gf`` F (Y -> X), the
    discriminators ``dx`` and ``dy``, one Adam state each, and the step
    count.  The train step updates it in place."""

    step: int
    gg: nn.Module
    gf: nn.Module
    dx: nn.Module
    dy: nn.Module
    opt_gg: AdamState
    opt_gf: AdamState
    opt_dx: AdamState
    opt_dy: AdamState
