"""VALID-convolution shape calculus for the transfer_em U-Net family.

Own copy of ``transfer_em_tpu/shapes.py`` (the defaults, kernel sizes,
generator_shapes, is_valid_dimsize, valid_dimsizes, discriminator_shapes,
tile_plan_outdimsize): the port imports nothing of the JAX package.  The reference hardcodes
``VALID_DIMS=[74]`` / ``VALID_OUT=[40]`` (transfer_em/models/generator.py:
18-20); 74 -> 40 (buffer 17) remains the verified default.
"""

from __future__ import annotations

import dataclasses
from typing import List

# The verified default, matching the reference exactly.
DEFAULT_DIMSIZE = 74
DEFAULT_OUT = 40
DEFAULT_BUFFER = 17

# Kernel sizes used throughout the model family (reference models/utils.py:61,66).
CONV_K = 3
DOWN_K = 4
DOWN_STRIDE = 2
UP_K = 4
UP_STRIDE = 2


def conv_out(n: int, k: int = CONV_K, s: int = 1) -> int:
    """Output length of a VALID convolution: floor((n - k) / s) + 1."""
    return (n - k) // s + 1


def conv_transpose_same_out(n: int, s: int = UP_STRIDE) -> int:
    """Output length of a stride-s SAME transposed convolution (TF)."""
    return n * s


@dataclasses.dataclass(frozen=True)
class GeneratorShapes:
    """Every spatial size in the U-Net generator, for one input size."""

    dimsize: int          # input size (74)
    stem: int             # after stem 3x3 conv (72)
    skip0: int            # skip tap of downsample 1 (70)
    down1: int            # after strided downsample 1 (34)
    skip1: int            # skip tap of downsample 2 (32)
    down2: int            # bottleneck (15)
    up1: int              # after upsample 2 (26)
    crop1: int            # total size cut cropping skip1 to up1 (6)
    mid: int              # after middle 3x3 conv (24)
    up0: int              # after upsample 1 (44)
    crop0: int            # total size cut cropping skip0 to up0 (26)
    head: int             # after head 3x3 conv (42)
    out: int              # final output size (40)

    @property
    def buffer(self) -> int:
        """Halo consumed per face: (in - out) // 2."""
        return (self.dimsize - self.out) // 2


def generator_shapes(dimsize: int) -> GeneratorShapes:
    """Trace the U-Net VALID-conv arithmetic for ``dimsize``.

    Raises ValueError when an intermediate size collapses below a kernel.
    """
    stem = conv_out(dimsize)
    skip0 = conv_out(stem)
    down1 = conv_out(skip0, DOWN_K, DOWN_STRIDE)
    skip1 = conv_out(down1)
    down2 = conv_out(skip1, DOWN_K, DOWN_STRIDE)
    up1 = conv_transpose_same_out(conv_out(down2))
    crop1 = skip1 - up1
    mid = conv_out(up1)
    up0 = conv_transpose_same_out(conv_out(mid))
    crop0 = skip0 - up0
    head = conv_out(up0)
    out = conv_out(head)
    shapes = GeneratorShapes(
        dimsize=dimsize, stem=stem, skip0=skip0, down1=down1, skip1=skip1,
        down2=down2, up1=up1, crop1=crop1, mid=mid, up0=up0, crop0=crop0,
        head=head, out=out,
    )
    smallest = min(down2 - CONV_K + 1, crop0, crop1)
    if smallest < 0 or out <= 0:
        raise ValueError(f"dimsize {dimsize} collapses inside the U-Net: {shapes}")
    return shapes


def is_valid_dimsize(dimsize: int) -> bool:
    """True when ``dimsize`` runs through the U-Net with symmetric crops,
    an even output and an even total halo."""
    try:
        s = generator_shapes(dimsize)
    except ValueError:
        return False
    return (
        s.crop0 >= 0 and s.crop1 >= 0
        and s.crop0 % 2 == 0 and s.crop1 % 2 == 0
        and s.out % 2 == 0
        and (s.dimsize - s.out) % 2 == 0
        and s.out > 0
    )


def valid_dimsizes(lo: int = 20, hi: int = 512) -> List[int]:
    """Enumerate valid input sizes in [lo, hi]."""
    return [d for d in range(lo, hi + 1) if is_valid_dimsize(d)]


@dataclasses.dataclass(frozen=True)
class DiscriminatorShapes:
    """Spatial sizes in the PatchGAN discriminator (reference
    discriminator.py)."""

    dimsize: int
    down1: int     # after downsample 1 (no module of the 2D net uses it)
    hack: int      # after the "HACK" 3x3 conv (3D: on down1; 2D: on the input)
    down2: int
    down3: int
    out: int       # patch-logit grid size

    @property
    def patches(self) -> int:
        return self.out


def discriminator_shapes(dimsize: int,
                         is3d: bool = True) -> DiscriminatorShapes:
    """Trace the discriminator, with the reference's "HACK" asymmetry
    (discriminator.py:44-55): in 3D the extra 3x3 conv takes the first
    downsample's output, in 2D the raw input (40 -> 3D 1, 2D 6)."""
    down1 = conv_out(conv_out(dimsize), DOWN_K, DOWN_STRIDE)
    hack = conv_out(down1 if is3d else dimsize)
    down2 = conv_out(conv_out(hack), DOWN_K, DOWN_STRIDE)
    down3 = conv_out(conv_out(down2), DOWN_K, DOWN_STRIDE)
    if down3 <= 0:  # the two 1x1 convs keep the size
        raise ValueError(f"dimsize {dimsize} collapses in discriminator")
    return DiscriminatorShapes(dimsize=dimsize, down1=down1, hack=hack,
                               down2=down2, down3=down3, out=down3)


def tile_plan_outdimsize(outdimsize: int, buffer: int) -> tuple:
    """Shrink the tile output size to a multiple of 6 and fold the trim into
    the buffer, like reference utils.py:68-75 (its comment says "multiple of
    8" but the code uses 6; code behaviour wins).

    Returns (outdimsize, buffer, tpad).
    """
    tpad = 0
    if (outdimsize // 6) != 0:
        diff = outdimsize % 6
        outdimsize -= diff
        tpad = diff // 2
        buffer += tpad
    return outdimsize, buffer, tpad
