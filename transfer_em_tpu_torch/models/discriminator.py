"""PatchGAN discriminator, 3D or 2D (counterpart of
transfer_em_tpu/models/discriminator.py:35-77, reference
transfer_em/models/discriminator.py:14-106), with its quirks.  3D:

    down1: DownBlock(64/wf), k3 1 -> 64/wf (direct conv3)   40 -> 38 -> 18
    hack:  3x3 conv 16 -> LeakyReLU (on down1's output)      18 -> 16
    down2: DownBlock(256/wf)                                 16 -> 14 -> 6
    [concat disc_prior(input): 6^3 features]
    down3: DownBlock(32)                                     6 -> 4 -> 1
    LeakyReLU again (negatives get slope 0.3**2, discriminator.py:73)
    head:  1x1 conv (256/wf) -> LeakyReLU
    out:   1x1 conv (1) with the net's ONLY bias

2D, the reference's "HACK" path (discriminator.py:44-55): ``hack`` takes
the RAW input and there is no ``down1`` (the reference computes it and
discards it; the JAX package's 2D tree has none, and neither has this
state_dict): 40^2 -> hack 38 -> down2 17 -> down3 6 -> 6^2 logits.

Input (B, 40, 40, 40, 1) -> float32 patch logits (B, 1, 1, 1, 1).  With
``compute_dtype`` bfloat16 the input is cast at entry and every conv runs
in bf16, as in the JAX module (discriminator.py:47-49, :77).  Which
kernel runs each conv is ``ops/convs.py``'s choice (its module docstring).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .blocks import (ConvActND, ConvND, DownBlock, DTypeLike, compute_dtype_of,
                     leaky)

Prior = Callable[[torch.Tensor], torch.Tensor]


class Discriminator(nn.Module):
    """Patch discriminator; (B, *S, 1) -> (B, *s, 1) logits.

    Args:
      wf: width factor (reference ``wf``).
      is3d: three spatial axes, or two (the HACK path, no ``down1``).
      use_norm: InstanceNorm in down2 (off by default, as upstream).
      compute_dtype: None/float32, or bfloat16 (blocks.py); the output is
        float32 either way.
      disc_prior: optional frozen feature extractor (train/cgan.py
        ``_tap_prior``) whose output on the input, on down2's grid, is
        concatenated before down3 (discriminator.py:67-69).  It is a plain
        callable, not a submodule: its weights are not this module's
        parameters and get no update.
      prior_channels: the prior's output channels (widens down3.conv).
      generator: torch.Generator for the N(0, 0.02) weight init.
    """

    def __init__(self, wf: int = 8, *, is3d: bool = True,
                 use_norm: bool = False, compute_dtype: DTypeLike = None,
                 disc_prior: Optional[Prior] = None, prior_channels: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (disc_prior is None) != (prior_channels == 0):
            raise ValueError("disc_prior and prior_channels > 0 go together")
        c1, c4 = 64 // wf, 256 // wf
        self.compute_dtype = compute_dtype_of(compute_dtype)
        k = {"ndim": 3 if is3d else 2, "compute_dtype": self.compute_dtype,
             "generator": generator}
        self.is3d = is3d
        self.disc_prior = disc_prior
        if is3d:
            self.down1 = DownBlock(1, c1, **k)
        self.hack = ConvActND(c1 if is3d else 1, 16, 3, **k)
        self.down2 = DownBlock(16, c4, use_norm=use_norm, **k)
        self.down3 = DownBlock(c4 + prior_channels, 32, **k)
        self.head = ConvActND(32, c4, 1, **k)
        self.out = ConvND(c4, 1, 1, use_bias=True, **k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype or torch.float32)
        h = self.hack(self.down1(x)[0] if self.is3d else x)
        down2, _ = self.down2(h)
        if self.disc_prior is not None:
            down2 = torch.cat([down2, self.disc_prior(x)], dim=-1)
        down3, _ = self.down3(down2)
        h = leaky(down3)  # the reference applies LeakyReLU twice here
        return self.out(self.head(h)).to(torch.float32)


def build_discriminator(is3d: bool = True, wf: int = 8,
                        use_norm: bool = False,
                        compute_dtype: DTypeLike = None,
                        disc_prior: Optional[Prior] = None,
                        prior_channels: int = 0,
                        generator: Optional[torch.Generator] = None
                        ) -> Discriminator:
    """Constructor with the JAX package's argument order
    (transfer_em_tpu/models/discriminator.py:80-84); ``prior_channels`` is
    the port's (its kernels are built before any input is seen)."""
    return Discriminator(wf=wf, is3d=is3d, use_norm=use_norm,
                         compute_dtype=compute_dtype, disc_prior=disc_prior,
                         prior_channels=prior_channels, generator=generator)


def discriminator(is3d=True, norm_type="instancenorm", wf=8, disc_prior=None,
                  prior_channels=0, compute_dtype=None):
    """Reference-named constructor (models/discriminator.py:14), at the
    reference's import path.  ``norm_type`` is inert, as in the reference
    (its norm calls are commented out, models/utils.py:75-82)."""
    del norm_type
    return build_discriminator(is3d=is3d, wf=wf, compute_dtype=compute_dtype,
                               disc_prior=disc_prior,
                               prior_channels=prior_channels)
