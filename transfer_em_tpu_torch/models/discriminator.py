"""3D PatchGAN discriminator (counterpart of
transfer_em_tpu/models/discriminator.py:35-77, reference
transfer_em/models/discriminator.py:14-106), 3D path, with its quirks:

    down1: DownBlock(64/wf), k3 1 -> 64/wf (direct conv3)   40 -> 38 -> 18
    hack:  3x3 conv 16 -> LeakyReLU (on down1's output)      18 -> 16
    down2: DownBlock(256/wf)                                 16 -> 14 -> 6
    [concat disc_prior(input): 6^3 features]
    down3: DownBlock(32)                                     6 -> 4 -> 1
    LeakyReLU again (negatives get slope 0.3**2, discriminator.py:73)
    head:  1x1 conv (256/wf) -> LeakyReLU
    out:   1x1 conv (1) with the net's ONLY bias

Input (B, 40, 40, 40, 1) float32 -> patch logits (B, 1, 1, 1, 1).  The k3
convs run on the conv3 kernels (hack, down2.conv and down3.conv on the
tensor cores at wf=8), the LeakyReLUs after the k4 convs, the double one and
the head's on the leaky_relu kernel; the k4 and 1x1 convs on cuDNN.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.cuda_kernels import leaky_relu
from .blocks import ConvActND, ConvND, DownBlock

Prior = Callable[[torch.Tensor], torch.Tensor]


class Discriminator(nn.Module):
    """Patch discriminator; (B, D, H, W, 1) -> (B, d, h, w, 1) logits.

    Args:
      wf: width factor (reference ``wf``).
      use_norm: InstanceNorm in down2 (off by default, as upstream).
      disc_prior: optional frozen feature extractor (train/cgan.py
        ``_tap_prior``) whose output on the input, on down2's grid, is
        concatenated before down3 (discriminator.py:67-69).  It is a plain
        callable, not a submodule: its weights are not this module's
        parameters and get no update.
      prior_channels: the prior's output channels (widens down3.conv).
      generator: torch.Generator for the N(0, 0.02) weight init.
    """

    def __init__(self, wf: int = 8, *, use_norm: bool = False,
                 disc_prior: Optional[Prior] = None, prior_channels: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (disc_prior is None) != (prior_channels == 0):
            raise ValueError("disc_prior and prior_channels > 0 go together")
        g = generator
        c1, c4 = 64 // wf, 256 // wf
        self.disc_prior = disc_prior
        self.down1 = DownBlock(1, c1, generator=g)
        self.hack = ConvActND(c1, 16, 3, generator=g)
        self.down2 = DownBlock(16, c4, use_norm=use_norm, generator=g)
        self.down3 = DownBlock(c4 + prior_channels, 32, generator=g)
        self.head = ConvActND(32, c4, 1, generator=g)
        self.out = ConvND(c4, 1, 1, use_bias=True, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        down1, _ = self.down1(x)
        h = self.hack(down1)
        down2, _ = self.down2(h)
        if self.disc_prior is not None:
            down2 = torch.cat([down2, self.disc_prior(x)], dim=-1)
        down3, _ = self.down3(down2)
        h = leaky_relu(down3)  # the reference applies LeakyReLU twice here
        return self.out(self.head(h))
