"""Hand-written CUDA kernels for the tile step's elementwise edges.

Counterpart of ``transfer_em_tpu/ops/pallas_kernels.py``; the kernels are in
``csrc/elementwise.cu``, whose header notes what bounds each on the H100.

=========================  ==============================================
wrapper                    replaces (Pallas, transfer_em_tpu/ops/)
=========================  ==============================================
``preprocess_u8``          pallas_kernels.py:60-85 ``preprocess_u8``
``postprocess_u8``         pallas_kernels.py:97-124 ``postprocess_u8``
``leaky_relu``             pallas_kernels.py:127-151 ``leaky_relu_kernel_call``
=========================  ==============================================

Each wrapper runs its ``*_plain`` PyTorch version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel (and counts the launch under
its name, ``ops/counts.py``) or raises.  Outputs are allocated with
``torch.empty`` and the kernels run on the current stream without
synchronising.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import kernels, telemetry

LEAKY_SLOPE = 0.3  # Keras LeakyReLU default, as in models/blocks.py


@functools.lru_cache(maxsize=None)
def slope_in(dtype: torch.dtype, negative_slope: float = LEAKY_SLOPE) -> float:
    """The slope rounded to ``dtype``, as the JAX modules' weak-typed Python
    scalar meets an array of that dtype in ``nn.leaky_relu``: bf16(0.3) =
    0.30078125, while float32 keeps 0.3.  The kernels compute in f32 with
    the slope they are given; with this one, a bf16 product is exact in f32
    and rounds once, as JAX's bf16 multiply does."""
    return float(torch.tensor(negative_slope, dtype=dtype))


MeanStd = Optional[Tuple[float, float]]


def preprocess_affine(meanstd: MeanStd) -> Tuple[float, float]:
    """uint8 -> standardized float as one affine map a*x + b
    (transfer_em_tpu/ops/normalize.py:78-91)."""
    if meanstd is None:
        return 1.0 / 127.5, -1.0
    mean, std = meanstd
    return 1.0 / (127.5 * std), (-1.0 - mean) / std


# -- kernel 2: preprocess ----------------------------------------------------

def preprocess_u8_plain(x_u8: torch.Tensor, meanstd: MeanStd) -> torch.Tensor:
    """(...) uint8 -> (..., 1) float32 ``x * a + b``."""
    a, b = preprocess_affine(meanstd)
    return (x_u8.to(torch.float32) * a + b).unsqueeze(-1)


def preprocess_u8(x_u8: torch.Tensor, meanstd: MeanStd) -> torch.Tensor:
    """uint8 tiles -> standardized float32 with a trailing channel axis.
    A strided input is read through a contiguous copy."""
    if x_u8.device.type == "cpu":
        return preprocess_u8_plain(x_u8, meanstd)
    x_u8 = x_u8.contiguous()
    kernels.check_cuda_tensor(x_u8, "preprocess_u8", (torch.uint8,))
    a, b = preprocess_affine(meanstd)
    y = torch.empty(x_u8.shape + (1,), dtype=torch.float32,
                    device=x_u8.device)
    kernels.launch("tem_preprocess_u8", x_u8.data_ptr(), y.data_ptr(),
                   x_u8.numel(), a, b, device=x_u8.device)
    telemetry.count("preprocess_u8")
    return y


# -- kernel 3: postprocess ---------------------------------------------------

def _trim(y: torch.Tensor, tpad: int) -> torch.Tensor:
    """``tpad`` off both faces of every spatial axis of (B, *S, C)."""
    if tpad == 0:
        return y
    t = slice(tpad, -tpad)
    return y[(slice(None),) + (t,) * (y.dim() - 2)]


def postprocess_u8_plain(y: torch.Tensor, meanstd: MeanStd,
                         tpad: int = 0) -> torch.Tensor:
    """(B, *S, 1) float32, 2D or 3D -> (B, *(S - 2t)) uint8, in the order
    of transfer_em_tpu/ops/normalize.py:94-102: y*std + mean, + 1, * 127.5,
    round half to even, clip to [0, 255]."""
    y = _trim(y, tpad)[..., 0].to(torch.float32)
    if meanstd is not None:
        mean, std = meanstd
        y = y * std + mean
    return torch.clamp(torch.round((y + 1.0) * 127.5), 0, 255).to(torch.uint8)


def postprocess_u8(y: torch.Tensor, meanstd: MeanStd,
                   tpad: int = 0) -> torch.Tensor:
    """Model output, (B, D, H, W, 1) or (B, H, W, 1) -> uint8 tiles,
    trimming ``tpad`` voxels per face of every spatial axis.  The kernel
    reads the trimmed window in place (strided; no copy); a 2D batch runs
    as D = 1 with no trim on that axis.  A strided ``y`` is read through a
    contiguous copy."""
    if y.device.type == "cpu":
        return postprocess_u8_plain(y, meanstd, tpad)
    y = y.contiguous()
    kernels.check_cuda_tensor(y, "postprocess_u8", (torch.float32,))
    spatial = tuple(y.shape[1:-1])
    if (y.dim() not in (4, 5) or y.shape[-1] != 1 or tpad < 0
            or min(spatial) <= 2 * tpad):
        raise ValueError(f"postprocess_u8: bad shape {tuple(y.shape)} for "
                         f"tpad={tpad}")
    d, h, w = spatial if len(spatial) == 3 else (1,) + spatial
    dtpad = tpad if len(spatial) == 3 else 0
    out = torch.empty((y.shape[0],) + tuple(n - 2 * tpad for n in spatial),
                      dtype=torch.uint8, device=y.device)
    mean, std = meanstd if meanstd is not None else (0.0, 1.0)
    kernels.launch("tem_postprocess_u8", y.data_ptr(), out.data_ptr(),
                   y.shape[0], d, h, w, dtpad, tpad,
                   int(meanstd is not None), mean, std, device=y.device)
    telemetry.count("postprocess_u8")
    return out


# -- kernel 4: LeakyReLU -----------------------------------------------------

def leaky_relu_plain(x: torch.Tensor,
                     negative_slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """where(x >= 0, x, x * slope), computed in float32 and rounded once to
    x's dtype."""
    v = x.to(torch.float32)
    return torch.where(v >= 0, v, v * negative_slope).to(x.dtype)


class _LeakyReLU(torch.autograd.Function):
    """leaky_relu with a gradient: the kernel forward, and the backward
    where(x >= 0, g, slope * g) in plain torch, in g's dtype (the VJP of
    the JAX package's where(x >= 0, x, slope * x); it has no backward
    kernel).  Under ``torch.func.vmap`` one launch covers every stacked
    network."""

    @staticmethod
    def forward(x, negative_slope):
        return _leaky_relu(x, negative_slope)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, negative_slope = inputs
        ctx.slope = negative_slope
        ctx.save_for_backward(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None

    @staticmethod
    def vmap(info, in_dims, x, negative_slope):
        x = x.movedim(in_dims[0], 0).contiguous()
        return _LeakyReLU.apply(x, negative_slope), 0


def leaky_relu(x: torch.Tensor,
               negative_slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """Elementwise LeakyReLU, float32 or bfloat16, through
    :class:`_LeakyReLU` (the gradient where autograd needs one, and the
    rule for ``torch.func.vmap``)."""
    return _LeakyReLU.apply(x, negative_slope)


def _leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return leaky_relu_plain(x, negative_slope)
    x = x.contiguous()  # a strided view is read through a copy
    kernels.check_cuda_tensor(x, "leaky_relu", tuple(kernels.DTYPE_CODES))
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    kernels.launch("tem_leaky_relu", x.data_ptr(), y.data_ptr(),
                   kernels.DTYPE_CODES[x.dtype], x.numel(), negative_slope,
                   device=x.device)
    telemetry.count("leaky_relu")
    if x.dtype == torch.bfloat16:
        telemetry.count("leaky_relu_bf16")
    return y
