"""Int8 quantized convolutions: the serving opt-in of the int8 generator.

Counterpart of ``transfer_em_tpu/ops/quant.py`` (the same scheme, the same
call shapes, 2D and 3D): activations quantized per tensor over the whole
batch, weights per output channel, both symmetric (no zero points), an
int8 x int8 -> int32 conv, dequantized straight into the requested dtype.
``UNetGenerator(int8_conv=True)`` routes every conv through here.

Quantization and the dequant scale stay PyTorch ops (in JAX they are XLA
ops, not Pallas).  The integer conv is the hand-written kernel of
``ops/cuda_int8.py``, a stride-1 VALID conv with kernel extents <= 3; the
JAX package's convs reduce to it exactly, since integer sums do not depend
on their order:

* a stride-s VALID conv (the k4 stride-2 down convs): the kernel padded to
  a multiple of s per axis, input and kernel space-to-depth by s, then a
  stride-1 conv with ceil(k/s) taps per axis and s^n * C channels;
* SAME at stride 1: the input zero-padded as ``lax`` pads it;
* the TF-SAME stride-2 k4 transposed conv: its phase decomposition
  (``ops/convs.py`` :func:`phase_kernel`), one k3 conv over the codes
  padded by 1 with 2^n * Cout outputs, each dequantized by its Cout's scale,
  then interleaved.  Each phase tap is one weight code, so the codes are
  those JAX quantizes from its flipped kernel (a flip moves no channel).

Since the activation scale spans the whole batch (padded tiles included),
an int8 tile's output depends on its batch-mates: the tile-grid modes'
bit-equality across batch shapes does not carry over to int8.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .convs import interleave_phases, phase_kernel
from .cuda_int8 import conv_int8

__all__ = ["quantize_sym", "conv_nd_int8", "conv_transpose_nd_int8",
           "space_to_depth", "kernel_to_depth"]


def quantize_sym(a: torch.Tensor, axes: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over ``axes`` (keepdims scales):
    ``scale = max(amax, 1e-12) / 127``, ``q = clip(round(a / scale), -127,
    127)``, rounding half to even and dividing truly, as ``jnp.round`` and
    ``a / scale`` do.  Returns (q int8, scale float32)."""
    a = a.to(torch.float32)
    amax = a.abs().amax(dim=tuple(axes), keepdim=True)
    # a divisor on the device: CUDA turns a division by a Python scalar into
    # a multiplication by its reciprocal, which is not amax / 127 for every
    # amax (the CPU divides)
    scale = torch.clamp(amax, min=1e-12) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, *S, C) with every S divisible by s -> (B, *(S/s), s^n * C), the
    channel index (p_1, .., p_n, c) with p_i the offset along axis i."""
    n = x.dim() - 2
    bsz, sp, c = x.shape[0], tuple(x.shape[1:-1]), x.shape[-1]
    shape = [bsz]
    for d in sp:
        shape += [d // s, s]
    x = x.reshape(shape + [c])
    perm = [0] + [1 + 2 * i for i in range(n)] + [2 + 2 * i
                                                  for i in range(n)]
    return x.permute(perm + [1 + 2 * n]).reshape(
        (bsz,) + tuple(d // s for d in sp) + (s ** n * c,))


def kernel_to_depth(k: torch.Tensor, s: int) -> torch.Tensor:
    """(k,)*n + (C, O), k divisible by s -> (k/s,)*n + (s^n * C, O), the
    input channels ordered as :func:`space_to_depth` orders them."""
    n = k.dim() - 2
    kk, c, o = k.shape[0], k.shape[-2], k.shape[-1]
    shape = []
    for _ in range(n):
        shape += [kk // s, s]
    k = k.reshape(shape + [c, o])
    perm = [2 * i for i in range(n)] + [1 + 2 * i for i in range(n)]
    return k.permute(perm + [2 * n, 2 * n + 1]).reshape(
        (kk // s,) * n + (s ** n * c, o))


def _same_pads(k: int) -> Tuple[int, int]:
    """``lax``'s SAME padding at stride 1: (k-1)//2 low, the rest high."""
    return (k - 1) // 2, k - 1 - (k - 1) // 2


def _strided_to_unit(qx: torch.Tensor, qk: torch.Tensor, s: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stride-s VALID conv of codes as a stride-1 one (module docstring):
    the kernel zero-padded to k' = s * ceil(k/s), the input cut (or
    zero-padded) to s * (out - 1) + k' per axis, both space-to-depth."""
    n = qx.dim() - 2
    k = qk.shape[0]
    kp = -(-k // s) * s
    if kp != k:
        qk = F.pad(qk, (0, 0, 0, 0) + (0, kp - k) * n)
    outs = [(d - k) // s + 1 for d in qx.shape[1:-1]]
    if min(outs) < 1:
        raise ValueError(f"input {tuple(qx.shape)} smaller than the kernel")
    need = [s * (o - 1) + kp for o in outs]
    qx = qx[(slice(None),) + tuple(slice(0, min(m, d)) for m, d in
                                   zip(need, qx.shape[1:-1]))]
    grow = [m - d for m, d in zip(need, qx.shape[1:-1])]
    if any(grow):
        qx = F.pad(qx, (0, 0) + sum(((0, g) for g in reversed(grow)), ()))
    return space_to_depth(qx, s), kernel_to_depth(qk, s)


def conv_nd_int8(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
                 padding: str = "VALID",
                 out_dtype: Optional[torch.dtype] = None,
                 leaky: Optional[float] = None) -> torch.Tensor:
    """VALID/SAME N-D conv in int8: quantize both operands, integer conv,
    dequantize to ``out_dtype`` (default float32).  Same call shape as
    :func:`..convs.conv_nd` and as the JAX package's ``conv_nd_int8``;
    ``leaky`` fuses a LeakyReLU on the dequantized value (rounded to
    ``out_dtype`` first) into the kernel's epilogue."""
    n = x.dim() - 2
    if n not in (2, 3) or kernel.dim() != x.dim():
        raise ValueError(f"expected NHWC x HWIO or NDHWC x DHWIO; got x "
                         f"{tuple(x.shape)}, kernel {tuple(kernel.shape)}")
    qx, sx = quantize_sym(x, tuple(range(x.dim())))
    qk, sk = quantize_sym(kernel.to(x.device), tuple(range(n + 1)))
    if padding == "SAME":
        if stride != 1:
            raise ValueError("SAME padding is supported at stride 1 only")
        qx = F.pad(qx, (0, 0) + sum((_same_pads(k) for k in
                                     reversed(kernel.shape[:n])), ()))
    elif padding != "VALID":
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
    if stride != 1:
        qx, qk = _strided_to_unit(qx, qk, stride)
    return conv_int8(qx, qk, sx, sk, out_dtype or torch.float32, leaky)


def conv_transpose_nd_int8(x: torch.Tensor, kernel: torch.Tensor, *,
                           stride: int = 2,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """TF-exact stride-2 SAME transposed conv (k4) in int8: (B, *S, Cin) *
    (4.., Cin, Cout) -> (B, *2S, Cout) in ``out_dtype`` (default float32).
    The JAX package writes it as an input-dilated conv on its flipped
    kernel's codes; here it is the phase decomposition of the same codes
    (module docstring)."""
    n = x.dim() - 2
    if n not in (2, 3) or kernel.dim() != x.dim():
        raise ValueError(f"expected NHWC x HWIO or NDHWC x DHWIO; got x "
                         f"{tuple(x.shape)}, kernel {tuple(kernel.shape)}")
    if stride != 2 or kernel.shape[0] != 4:
        raise ValueError("conv_transpose_nd_int8 supports k=4, stride=2 "
                         "(the generator's up convs)")
    qx, sx = quantize_sym(x, tuple(range(x.dim())))
    qk, sk = quantize_sym(kernel.to(x.device), tuple(range(n + 1)))
    qxp = F.pad(qx, (0, 0) + (1, 1) * n)
    y = conv_int8(qxp, phase_kernel(qk), sx, sk.reshape(-1).repeat(2 ** n),
                  out_dtype or torch.float32)
    return interleave_phases(y).contiguous()
