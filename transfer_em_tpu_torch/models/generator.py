"""Fully-VALID-conv U-Net generator, 3D or 2D (counterpart of
transfer_em_tpu/models/generator.py, reference transfer_em/models/
generator.py:22-119), layer for layer:

    stem 3x3 conv (64/wf) -> LeakyReLU                       74 -> 72
    down1 (64/wf), skip tap at 70                            72 -> 34
    down2 (128/wf), skip tap at 32                           34 -> 15
    up1: UpBlock(128/wf)                                     15 -> 26
    concat center-cropped skip1
    mid 3x3 conv (256/wf) -> LeakyReLU                       26 -> 24
    up0: UpBlock(64/wf)                                      24 -> 44
    concat center-cropped skip0
    head 3x3 conv (128/wf) -> LeakyReLU                      44 -> 42
    out  3x3 conv (1, no bias)                               42 -> 40

No bias, no output nonlinearity; norm layers only with ``use_norm`` (off
by default, as in the reference).  Inputs and outputs are channels-last,
(B, D, H, W, 1) in 3D and (B, H, W, 1) in 2D, like the JAX module; the
sizes above hold per spatial axis in both.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.convs import crop_to_match
from ..shapes import generator_shapes, is_valid_dimsize
from .blocks import (ConvActND, ConvND, DownBlock, DTypeLike, UpBlock,
                     compute_dtype_of)

__all__ = ["UNetGenerator", "build_generator", "unet_generator",
           "compute_dtype_of", "DTypeLike"]


class UNetGenerator(nn.Module):
    """U-Net generator; (B, *S, 1) -> (B, *(S - 2*buffer), 1) float32.

    Args:
      wf: width factor dividing the base widths (reference ``wf``; 1..32).
      is3d: three spatial axes (kernels k^3), or two (k^2) for 2D images.
      compute_dtype: None/float32, or bfloat16: the input is cast at entry,
        every conv casts its input to it and keeps its output in it (convs
        sum in f32), like generator.py:54-56 and the JAX ``conv_nd``; the
        output is cast back to float32.  Parameters stay float32.
      use_norm: the reference's (disabled) InstanceNorm call sites in down2,
        up1 and up0, as in the JAX module.
      int8_conv: serve every conv in int8 (ops/quant.py; the hand-written
        int8 conv kernel), dequantized into ``compute_dtype``; forward only,
        as the JAX module's ``int8_conv``.
      generator: torch.Generator for the N(0, 0.02) weight init.

    ``forward(x, deterministic=True, dropout_generator=None)``: with
    ``deterministic=False`` the two UpBlocks apply Dropout(0.5), drawing from
    ``dropout_generator`` (a torch.Generator on x's device).
    """

    def __init__(self, wf: int = 8, compute_dtype: DTypeLike = None, *,
                 is3d: bool = True, use_norm: bool = False,
                 int8_conv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.wf = wf
        self.is3d = is3d
        self.int8_conv = int8_conv
        self.compute_dtype = compute_dtype_of(compute_dtype)
        c1, c2, c4 = 64 // wf, 128 // wf, 256 // wf
        g, n = generator, use_norm
        k = {"ndim": 3 if is3d else 2, "compute_dtype": self.compute_dtype,
             "int8_conv": int8_conv, "generator": g}
        self.stem = ConvActND(1, c1, 3, **k)
        self.down1 = DownBlock(c1, c1, **k)
        self.down2 = DownBlock(c1, c2, use_norm=n, **k)
        self.up1 = UpBlock(c2, c2, use_norm=n, **k)
        self.mid = ConvActND(c2 + c2, c4, 3, **k)
        self.up0 = UpBlock(c4, c1, use_norm=n, **k)
        self.head = ConvActND(c1 + c1, c2, 3, **k)
        self.out = ConvND(c2, 1, 3, **k)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = {"deterministic": deterministic,
                "dropout_generator": dropout_generator}
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.stem(x)
        down1, skip0 = self.down1(x)
        down2, skip1 = self.down2(down1)
        up1 = self.up1(down2, **drop)
        x = torch.cat([up1, crop_to_match(skip1, up1)], dim=-1)
        x = self.mid(x)
        up0 = self.up0(x, **drop)
        x = torch.cat([up0, crop_to_match(skip0, up0)], dim=-1)
        x = self.head(x)
        return self.out(x).to(torch.float32)


def build_generator(dimsize: int, is3d: bool = True, wf: int = 8,
                    use_norm: bool = False, compute_dtype: DTypeLike = None,
                    strict: bool = True,
                    generator: Optional[torch.Generator] = None):
    """``(UNetGenerator, output size)`` for ``dimsize``, like the
    reference's ``unet_generator`` (transfer_em_tpu/models/generator.py:
    92-109).  ``strict`` raises ValueError unless ``dimsize`` passes
    ``shapes.is_valid_dimsize``; ``is3d`` chooses the module's rank."""
    if strict and not is_valid_dimsize(dimsize):
        raise ValueError(
            f"{dimsize} does not allow for valid convolutions "
            f"(see transfer_em_tpu_torch.shapes.valid_dimsizes())")
    model = UNetGenerator(wf=wf, compute_dtype=compute_dtype, is3d=is3d,
                          use_norm=use_norm, generator=generator)
    return model, generator_shapes(dimsize).out


def unet_generator(dimsize, is3d=True, norm_type="instancenorm", wf=8):
    """Reference-named constructor (models/generator.py:22) -> ``(module,
    out_dimsize)``.  ``norm_type`` is inert, as in the reference; an invalid
    ``dimsize`` raises ``RuntimeError``, the reference's type (the native
    ``build_generator`` raises ValueError)."""
    del norm_type
    try:
        return build_generator(dimsize, is3d=is3d, wf=wf)
    except ValueError as e:
        raise RuntimeError(str(e)) from e
