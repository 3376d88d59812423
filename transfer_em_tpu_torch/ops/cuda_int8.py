"""The int8 conv on a hand-written CUDA kernel (``csrc/conv_int8.cu``).

Not a port of a Pallas kernel: the JAX package's int8 serving path
(``transfer_em_tpu/ops/quant.py:56-95``) leaves the integer conv to XLA,
``lax.conv_general_dilated(..., preferred_element_type=int32)``, and
PyTorch has no int8 conv on CUDA (``F.conv3d`` refuses int8).

:func:`conv_int8` is one stride-1 VALID conv of int8 codes, channels last
(C a multiple of 4, as ``ops/quant.quantize_int8`` writes them), with
per-axis kernel extents of 1 to 3, rank 5 (3D) or rank 4 (2D, run as
D = 1), summed exactly in int32 and then, by ``out_dtype``:

* ``torch.int32``: the accumulators themselves (the kernel's check);
* ``torch.float32`` / ``torch.bfloat16``: dequantized as the JAX package
  does, ``float(acc) * (sx * sk[c])`` with the scale product taken first
  in f32, rounded to ``out_dtype``, then the optional fused
  LeakyReLU(``leaky``) on that rounded value.

With ``phases`` the 2^n * Cout outputs of a phase conv (the transposed
conv's decomposition, ``ops/convs.py`` :func:`phase_kernel`) are stored
interleaved, (B, *2S, Cout), as :func:`interleave_phases` orders them.

:func:`conv_int8_plain` is the same function in plain PyTorch: the integer
conv in float64, which is exact here (the widest reduction of the
generator, 27 * 256 taps at wf=1, sums at most 6,912 * 127^2 ~ 1.1e8 in
magnitude: above float32's 2^24, far below float64's 2^53).  The wrapper
takes it for tensors on the CPU only; a CUDA tensor launches the kernel
(counted as ``conv_int8``, ``ops/counts.py``) or raises.

The kernel's B operand is packed by :func:`pack_int8_weights`, once per
parameter (``ops/quant.int8_weights``), for the block shape the kernel
makes from the weights' shape alone (:func:`int8_plan` asks it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import kernels, telemetry
from .convs import interleave_phases

OUT_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _as_3d(qx: torch.Tensor, qk: torch.Tensor):
    """Rank-4 (2D) operands as rank 5 with D = 1 and kd = 1."""
    if qx.dim() == 4 and qk.dim() == 4:
        return qx.unsqueeze(1), qk.unsqueeze(0)
    if qx.dim() == 5 and qk.dim() == 5:
        return qx, qk
    raise ValueError(f"conv_int8: expected NDHWC x DHWIO or NHWC x HWIO, got "
                     f"x {tuple(qx.shape)}, kernel {tuple(qk.shape)}")


def _check(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
           sk: torch.Tensor, out_dtype: torch.dtype, phases: bool) -> None:
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
    if phases and qk.shape[-1] % 2 ** (qx.dim() - 2):
        raise ValueError(f"conv_int8: {qk.shape[-1]} outputs are not "
                         f"{2 ** (qx.dim() - 2)} phases")


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
                    leaky: Optional[float] = None, *, packed=None,
                    phases: bool = False) -> torch.Tensor:
    """The kernel's function: the exact integer conv (in float64), then
    :func:`dequantize` (or the int32 accumulators), interleaved with
    ``phases``.  ``packed`` (the kernel's operand) is not read."""
    del packed
    _check(qx, qk, sx, sk, out_dtype, phases)
    x5, k5 = _as_3d(qx, qk)
    acc = F.conv3d(x5.to(torch.float64).permute(0, 4, 1, 2, 3),
                   k5.to(torch.float64).permute(4, 3, 0, 1, 2))
    acc = acc.permute(0, 2, 3, 4, 1).to(torch.int32)
    if qx.dim() == 4:
        acc = acc.squeeze(1)
    y = (acc if out_dtype == torch.int32
         else dequantize(acc, sx, sk, out_dtype, leaky))
    return (interleave_phases(y) if phases else y).contiguous()


# -- the kernel's block shape and packed weights -------------------------------

class Int8Plan(NamedTuple):
    """A block's shape for one conv, as ``csrc/conv_int8.cu`` make_plan
    makes it: ``nc`` output channels (the wgmma N: 8, 16, 32 or 64) of
    ``p`` consecutive 8x8 output planes, the input channels ``cb`` bytes at
    a time (the voxel's pitch in shared memory ``vs``, copies of ``unit``
    bytes), ``ksteps`` k-steps of 32 bytes a channel block, ``smem`` bytes
    of shared memory.  The packing reads ``nc``, ``cb`` and ``ksteps``."""
    nc: int
    p: int
    cb: int
    vs: int
    unit: int
    ksteps: int
    smem: int


@functools.lru_cache(maxsize=None)
def int8_plan(kd: int, kh: int, kw: int, c: int, o: int,
              is3d: bool) -> Int8Plan:
    """The plan the kernel makes for a (kd, kh, kw, c, o) kernel (c % 4 ==
    0), asked of the kernel library (``tem_conv_int8_plan``), which the
    conv's launch makes again from the same shapes."""
    out = (ctypes.c_int * 7)()
    code = kernels.library().tem_conv_int8_plan(kd, kh, kw, c, o,
                                                3 if is3d else 2, out)
    if code != 0:
        raise ValueError(f"int8_plan: no plan for a ({kd}, {kh}, {kw}, {c}, "
                         f"{o}) kernel (channels whole words, extents 1-3)")
    return Int8Plan(*out)


class Int8Pack(NamedTuple):
    """:func:`pack_int8_weights`' result: the operand and its plan."""
    wp: torch.Tensor
    plan: Int8Plan


def _pack_index(kd: int, kh: int, kw: int, c: int, o: int, plan: Int8Plan,
               device=None):
    """For each byte of the packed operand, laid out (O chunk, channel
    block, k-step, 8-channel group, K half, row, byte) =
    (ceil(o/nc), ceil(c/cb), ksteps, nc/8, 2, 8, 16): the (tap, channel,
    output) it holds and whether it lies inside the kernel (else zero).
    K word j = k-step * 8 + half * 4 + byte / 4 of a channel block holds
    tap j / (cb/4), channels block * cb + (j % (cb/4)) * 4 + byte % 4."""
    taps, cwn = kd * kh * kw, plan.cb // 4
    n_cb, n_ch = -(-c // plan.cb), -(-o // plan.nc)
    shape = (n_ch, n_cb, plan.ksteps, plan.nc // 8, 2, 8, 16)

    def ax(i):
        v = torch.arange(shape[i], device=device)
        return v.reshape([-1 if j == i else 1 for j in range(len(shape))])

    chunk, cbi, ks, grp, half, row, byte = (ax(i) for i in range(7))
    j = ks * 8 + half * 4 + byte // 4
    tap = j // cwn
    ch = cbi * plan.cb + (j % cwn) * 4 + byte % 4
    out = chunk * plan.nc + grp * 8 + row
    inside = (tap < taps) & (ch < c) & (out < o)
    return (torch.broadcast_to(tap, shape), torch.broadcast_to(ch, shape),
            torch.broadcast_to(out, shape), torch.broadcast_to(inside, shape))


def pack_int8_weights(qk: torch.Tensor,
                      plan: Optional[Int8Plan] = None) -> Int8Pack:
    """([kd,] kh, kw, C, O) int8 codes, C % 4 == 0 -> the kernel's B
    operand for :func:`int8_plan`'s block shape (or ``plan``, which the CPU
    tests walk without the kernel library): per O chunk and channel
    block, the k-steps in wgmma's K-major, unswizzled layout (core matrices
    of 8 outputs x 16 bytes of K; 128 B between the two K halves, 256 B
    between groups of 8 outputs), zero past the kernel's taps, C and O."""
    is3d = qk.dim() == 5
    k5 = qk if is3d else qk.unsqueeze(0)
    kd, kh, kw, c, o = k5.shape
    if plan is None:
        plan = int8_plan(kd, kh, kw, c, o, is3d)
    tap, ch, out, inside = _pack_index(kd, kh, kw, c, o, plan, qk.device)
    flat = k5.reshape(-1)
    src = ((tap * c + ch) * o + out).clamp(max=flat.numel() - 1)
    wp = torch.where(inside, flat[src],
                     torch.zeros((), dtype=torch.int8, device=qk.device))
    return Int8Pack(wp.contiguous(), plan)


def conv_int8(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
              sk: torch.Tensor, out_dtype: torch.dtype = torch.float32,
              leaky: Optional[float] = None, *,
              packed: Optional[Int8Pack] = None,
              phases: bool = False) -> torch.Tensor:
    """(B, [D,] H, W, C) int8 * ([kd,] kh, kw, C, O) int8 -> (B, [D',] H',
    W', O) in ``out_dtype`` (module docstring).  ``sx``: the activations'
    scale (one float32 value), ``sk``: the weights' per-output scales (O
    float32 values), both on the codes' device; read there by the kernel,
    so nothing waits for the host.  ``packed``: ``qk``'s operand from
    :func:`pack_int8_weights` (packed here when None)."""
    if qx.device.type == "cpu":
        return conv_int8_plain(qx, qk, sx, sk, out_dtype, leaky,
                               phases=phases)
    y = conv_int8_cuda(qx, qk, sx, sk, out_dtype, leaky, packed=packed,
                       phases=phases)
    telemetry.count("conv_int8")
    return y


def conv_int8_cuda(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
                   sk: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                   leaky: Optional[float] = None, *,
                   packed: Optional[Int8Pack] = None,
                   phases: bool = False) -> torch.Tensor:
    """The launch of :func:`conv_int8` on CUDA tensors, uncounted."""
    _check(qx, qk, sx, sk, out_dtype, phases)
    kernels.check_cuda_tensor(qx, "conv_int8 x", (torch.int8,))
    if qx.shape[-1] % 4:
        raise ValueError(f"conv_int8: {qx.shape[-1]} channels are not whole "
                         "4-byte words (quantize_int8 pads them)")
    x5, k5 = _as_3d(qx, qk)
    if packed is None:
        packed = pack_int8_weights(qk.to(qx.device))
    wp, plan = packed
    kernels.check_cuda_tensor(wp, "conv_int8 packed", (torch.int8,))
    if plan != int8_plan(*k5.shape, qx.dim() == 5):
        raise ValueError(f"conv_int8: weights packed for {plan}, not the "
                         "kernel's plan")
    sx = sx.reshape(1).to(device=qx.device, dtype=torch.float32)
    sk = sk.reshape(-1).to(device=qx.device, dtype=torch.float32)
    bsz, d, h, w, c = x5.shape
    kd, kh, kw, _, o = k5.shape
    sp = (d - kd + 1, h - kh + 1, w - kw + 1)
    n = qx.dim() - 2
    nph = 2 ** n if phases else 0
    if phases:
        cout = o // nph
        out_shape = ((bsz,) + tuple(2 * s for s in sp[3 - n:]) + (cout,))
    else:
        out_shape = (bsz,) + sp[3 - n:] + (o,)
    y = torch.empty(out_shape, dtype=out_dtype, device=qx.device)
    act = int(leaky is not None and out_dtype != torch.int32)
    kernels.launch("tem_conv_int8", x5.data_ptr(), wp.data_ptr(),
                   y.data_ptr(), sx.data_ptr(), sk.data_ptr(),
                   OUT_MODES[out_dtype], n, bsz, d, h, w, c, kd, kh, kw, o,
                   nph, act, float(leaky) if act else 0.0, device=qx.device)
    return y
