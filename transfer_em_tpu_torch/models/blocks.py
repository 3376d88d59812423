"""Building blocks: VALID conv stacks and the TF-exact transposed conv.

Counterpart of ``transfer_em_tpu/models/blocks.py`` (reference
transfer_em/models/utils.py), as ``nn.Module``s.  Kernels are stored in the
JAX layout, (k, k, k, Cin, Cout) under the name ``kernel``, so the state_dict
maps one to one onto the flax param tree (models/convert.py).

* 3x3x3 stride-1 convs run on the hand-written conv3 kernel
  (ops/cuda_conv.py), with LeakyReLU fused into its epilogue where the
  block has one.
* k4 stride-2 down convs and the TF-SAME transposed convs run on
  ``torch.nn.functional`` (ops/convs.py); the LeakyReLU after each runs on
  the hand-written leaky_relu kernel (ops/cuda_kernels.py).

LeakyReLU slope 0.3 (Keras default; torch's default is 0.01).  Weight init
N(0, 0.02) (tf.random_normal_initializer(0, .02)), from an explicit
``torch.Generator``.  InstanceNorm waits for the training slice: the
serving path runs ``use_norm=False`` like the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.convs import conv_nd, conv_transpose_nd
from ..ops.cuda_conv import conv3, conv3_act
from ..ops.cuda_kernels import LEAKY_SLOPE, leaky_relu

WEIGHT_STD = 0.02

__all__ = ["LEAKY_SLOPE", "ConvND", "ConvActND", "ConvTransposeND",
           "DownBlock", "UpBlock"]


def _init_kernel(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    w = torch.empty(shape, dtype=torch.float32)
    w.normal_(0.0, WEIGHT_STD, generator=generator)
    return nn.Parameter(w)


class ConvND(nn.Module):
    """VALID conv, channels last; kernel (k, k, k, Cin, Cout), no bias."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.kernel = _init_kernel((kernel_size,) * 3
                                   + (in_features, features), generator)

    def _is_conv3(self) -> bool:
        return self.kernel.shape[0] == 3 and self.stride == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        if self._is_conv3():
            return conv3(x, w)
        return conv_nd(x, w, stride=self.stride)


class ConvActND(ConvND):
    """Conv + LeakyReLU(0.3); same param tree as ConvND (one ``kernel``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        if self._is_conv3():
            return conv3_act(x, w)
        return leaky_relu(conv_nd(x, w, stride=self.stride))


class ConvTransposeND(nn.Module):
    """TF-exact stride-2 SAME transposed conv; kernel (4, 4, 4, Cin, Cout)
    in the transpose direction (TF stores (.., Cout, Cin): swap the last two
    axes to import it)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _init_kernel((4, 4, 4, in_features, features),
                                   generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose_nd(x, self.kernel.to(x.dtype), stride=2)


class DownBlock(nn.Module):
    """3x3 VALID conv -> LeakyReLU (skip tap) -> 4x4 s2 VALID conv ->
    LeakyReLU; returns (downsampled, skip) like reference ``downsample``
    (utils.py:41-85)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = ConvActND(in_features, features, 3, generator=generator)
        self.down = ConvND(features, features, 4, stride=2,
                           generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        skip = self.conv(x)
        return leaky_relu(self.down(skip)), skip


class UpBlock(nn.Module):
    """3x3 VALID conv (2x filters) -> LeakyReLU -> 4x4 s2 SAME convT ->
    Dropout(0.5) -> LeakyReLU (reference utils.py:89-137).  Inference only
    in this slice: Dropout is deterministic, i.e. the identity."""

    def __init__(self, in_features: int, features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = ConvActND(in_features, features * 2, 3,
                              generator=generator)
        self.up = ConvTransposeND(features * 2, features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.up(self.conv(x)))
