"""The int8 conv on a hand-written CUDA kernel (``csrc/conv_int8.cu``).

Not a port of a Pallas kernel: the JAX package's int8 serving path
(``transfer_em_tpu/ops/quant.py:56-95``) leaves the integer conv to XLA,
``lax.conv_general_dilated(..., preferred_element_type=int32)``, and
PyTorch has no int8 conv on CUDA (``F.conv3d`` refuses int8).

:func:`conv_int8` is one stride-1 VALID conv of int8 codes, channels last,
with per-axis kernel extents of 1 to 3, rank 5 (3D) or rank 4 (2D, run as
D = 1), summed exactly in int32 and then, by ``out_dtype``:

* ``torch.int32``: the accumulators themselves (the kernel's check);
* ``torch.float32`` / ``torch.bfloat16``: dequantized as the JAX package
  does, ``float(acc) * (sx * sk[c])`` with the scale product taken first
  in f32, rounded to ``out_dtype``, then the optional fused
  LeakyReLU(``leaky``) on that rounded value.

``ops/quant.py`` reduces every conv of the int8 generator to it (k4
stride-2 VALID by space-to-depth, the SAME transposed conv by its phase
decomposition).

:func:`conv_int8_plain` is the same function in plain PyTorch: the integer
conv in float64, which is exact here (the widest reduction of the
generator, 27 * 256 taps at wf=1, sums at most 6,912 * 127^2 ~ 1.1e8 in
magnitude: above float32's 2^24, far below float64's 2^53).  The wrapper
takes it for tensors on the CPU only; a CUDA tensor launches the kernel
(``conv_int8.launches`` counts the launches) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels

OUT_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_MMA_K = 32  # mma.sync m16n8k32: int8 K per step


def _as_3d(qx: torch.Tensor, qk: torch.Tensor):
    """Rank-4 (2D) operands as rank 5 with D = 1 and kd = 1."""
    if qx.dim() == 4 and qk.dim() == 4:
        return qx.unsqueeze(1), qk.unsqueeze(0)
    if qx.dim() == 5 and qk.dim() == 5:
        return qx, qk
    raise ValueError(f"conv_int8: expected NDHWC x DHWIO or NHWC x HWIO, got "
                     f"x {tuple(qx.shape)}, kernel {tuple(qk.shape)}")


def _check(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
           sk: torch.Tensor, out_dtype: torch.dtype) -> None:
    if qx.dtype != torch.int8 or qk.dtype != torch.int8:
        raise TypeError(f"conv_int8: int8 codes expected, got {qx.dtype} x "
                        f"{qk.dtype}")
    if out_dtype not in OUT_MODES:
        raise TypeError(f"conv_int8: out_dtype {out_dtype} not in "
                        f"{list(OUT_MODES)}")
    if qk.shape[-2] != qx.shape[-1]:
        raise ValueError(f"conv_int8: kernel {tuple(qk.shape)} does not "
                         f"match input channels {qx.shape[-1]}")
    if any(not 1 <= k <= 3 for k in qk.shape[:-2]):
        raise ValueError(f"conv_int8: kernel extents {tuple(qk.shape[:-2])} "
                         f"outside 1..3")
    if any(k > s for k, s in zip(qk.shape[:-2], qx.shape[1:-1])):
        raise ValueError(f"conv_int8: input {tuple(qx.shape)} smaller than "
                         f"the kernel {tuple(qk.shape)}")
    if sx.numel() != 1 or sk.numel() != qk.shape[-1]:
        raise ValueError(f"conv_int8: scales of {sx.numel()} and "
                         f"{sk.numel()} values for {qk.shape[-1]} outputs")


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sk: torch.Tensor,
               out_dtype: torch.dtype,
               leaky: Optional[float] = None) -> torch.Tensor:
    """The kernel's epilogue in plain PyTorch: float(acc) * (sx * sk[c]),
    rounded to ``out_dtype``, then LeakyReLU(``leaky``) on that value."""
    scale = sx.reshape(()).to(torch.float32) * sk.reshape(-1).to(
        torch.float32)
    y = (acc.to(torch.float32) * scale).to(out_dtype)
    if leaky is not None:
        y = torch.where(y >= 0, y, y * leaky)
    return y


def conv_int8_plain(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
                    sk: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                    leaky: Optional[float] = None) -> torch.Tensor:
    """The kernel's function: the exact integer conv (in float64), then
    :func:`dequantize` (or the int32 accumulators)."""
    _check(qx, qk, sx, sk, out_dtype)
    x5, k5 = _as_3d(qx, qk)
    acc = F.conv3d(x5.to(torch.float64).permute(0, 4, 1, 2, 3),
                   k5.to(torch.float64).permute(4, 3, 0, 1, 2))
    acc = acc.permute(0, 2, 3, 4, 1).to(torch.int32)
    if qx.dim() == 4:
        acc = acc.squeeze(1)
    if out_dtype == torch.int32:
        return acc.contiguous()
    return dequantize(acc, sx, sk, out_dtype, leaky).contiguous()


def pack_int8_weights(qk: torch.Tensor) -> torch.Tensor:
    """(kd, kh, kw, C, O) int8, C % 4 == 0 -> the kernel's B operand
    wt[n][k] (Opad, Kpad), k = tap * C + c, zero-padded: K to a multiple of
    32, O to 8, 16, 32 or a multiple of 64."""
    o = qk.shape[-1]
    k = qk[..., 0].numel()
    opad = next((p for p in (8, 16, 32) if o <= p), -(-o // 64) * 64)
    kpad = -(-k // _MMA_K) * _MMA_K
    wt = torch.zeros((opad, kpad), dtype=torch.int8, device=qk.device)
    wt[:o, :k] = qk.reshape(k, o).t()
    return wt


def conv_int8(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
              sk: torch.Tensor, out_dtype: torch.dtype = torch.float32,
              leaky: Optional[float] = None) -> torch.Tensor:
    """(B, [D,] H, W, C) int8 * ([kd,] kh, kw, C, O) int8 -> (B, [D',] H',
    W', O) in ``out_dtype`` (module docstring).  ``sx``: the activations'
    scale (one float32 value), ``sk``: the weights' per-output scales (O
    float32 values), both on the codes' device; read there by the kernel,
    so nothing waits for the host."""
    if qx.device.type == "cpu":
        return conv_int8_plain(qx, qk, sx, sk, out_dtype, leaky)
    _check(qx, qk, sx, sk, out_dtype)
    kernels.check_cuda_tensor(qx, "conv_int8 x", (torch.int8,))
    x5, k5 = _as_3d(qx, qk.to(qx.device))
    c = x5.shape[-1]
    if c % 4:  # whole 4-byte words of channels; zero codes add nothing
        x5 = F.pad(x5, (0, 4 - c % 4))
        k5 = F.pad(k5, (0, 0, 0, 4 - c % 4))
    x5 = x5.contiguous()
    wt = pack_int8_weights(k5)
    sx = sx.reshape(1).to(device=qx.device, dtype=torch.float32).contiguous()
    sk = sk.reshape(-1).to(device=qx.device, dtype=torch.float32).contiguous()
    bsz, d, h, w, cp = x5.shape
    kd, kh, kw, _, o = k5.shape
    y = torch.empty((bsz, d - kd + 1, h - kh + 1, w - kw + 1, o),
                    dtype=out_dtype, device=qx.device)
    act = int(leaky is not None and out_dtype != torch.int32)
    kernels.launch("tem_conv_int8", x5.data_ptr(), wt.data_ptr(),
                   y.data_ptr(), sx.data_ptr(), sk.data_ptr(),
                   OUT_MODES[out_dtype], bsz, d, h, w, cp, kd, kh, kw, o,
                   wt.shape[0], wt.shape[1], act,
                   float(leaky) if act else 0.0, device=qx.device)
    conv_int8.launches += 1
    return y.squeeze(1) if qx.dim() == 4 else y


conv_int8.launches = 0
