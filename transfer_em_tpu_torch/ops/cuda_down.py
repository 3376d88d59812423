"""4x4x4 stride-2 VALID conv on a hand-written CUDA kernel.

No Pallas kernel of the JAX package computes this conv: it leaves its k4
stride-2 down convs to XLA (``transfer_em_tpu/ops/convs.py`` ``conv_nd``).
The port runs them on ``csrc/down4_tc.cu`` where ``ops/convs.py`` picks
it (its module docstring): an implicit GEMM on the tensor cores, float32 as
3xTF32 (conv3's split and sums), that reads x in place at stride 2 and
multiplies only the 64 real taps.  Its weights are packed once per
parameter (:func:`packed_down4_weights`); its source's header says what
bounds it on the H100 and what its design does about it.

The plain version (:func:`down4_plain`) is the same function written as a
stride-1 conv with 2 taps an axis: per axis o[m] = sum_{j, r in {0, 1}}
x[2(m + j) + r] w[2j + r], so the k4 stride-2 VALID conv is the 2x2x2-tap
conv over x's space-to-depth by 2 (:func:`space_to_depth`) by
:func:`kernel_to_depth` of its kernel.  The wrapper :func:`down4` takes it
for a CPU tensor; a CUDA tensor reaches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels, telemetry
from .cuda_conv import split_tf32, storage_cached

TILE = 4            # an m64 tile is TILE^3 outputs (csrc/down4_tc.cu kT)
CHANNEL_BLOCK = 8   # input channels a k-step (one TF32 k-step a tap)
_OUT_CHUNKS = (8, 16, 32, 64)  # output channels per block (the MMA's N)


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


def down4_plain(x: torch.Tensor, w: torch.Tensor,
                leaky: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (B, D, H, W, C) * (4, 4, 4,
    C, O) -> (B, D//2 - 1, H//2 - 1, W//2 - 1, O) in x's dtype, the
    2x2x2-tap conv over :func:`space_to_depth` of x (an odd extent's last
    voxel, which the conv never reads, dropped) by :func:`kernel_to_depth`
    of w, then the optional LeakyReLU."""
    even = x[(slice(None),) + tuple(slice(0, 2 * (d // 2))
                                    for d in x.shape[1:4])]
    k2 = kernel_to_depth(w.to(x.dtype), 2)
    y = F.conv3d(space_to_depth(even, 2).permute(0, 4, 1, 2, 3),
                 k2.permute(4, 3, 0, 1, 2))
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    if leaky is not None:
        y = torch.where(y >= 0, y, y * leaky)
    return y


@dataclass(frozen=True)
class Down4Plan:
    """How the weights of one (C, O) are laid out for the kernel: C in
    ``n_cb`` blocks of :data:`CHANNEL_BLOCK` channels, O in ``n_chunks``
    chunks of ``nc`` (the MMA's N, which picks the kernel's instantiation
    in csrc/down4_tc.cu; both zero-padded)."""
    c: int
    o: int
    n_cb: int
    nc: int
    n_chunks: int


def down4_plan(c: int, o: int) -> Down4Plan:
    nc = next((n for n in _OUT_CHUNKS if n >= o), _OUT_CHUNKS[-1])
    return Down4Plan(c, o, -(-c // CHANNEL_BLOCK), nc, -(-o // nc))


def pack_down4_weights(w: torch.Tensor) -> torch.Tensor:
    """(4, 4, 4, C, O) -> the kernel's B operand, float32, of shape
    (n_chunks, n_cb, 4, 4, 4, 2, nc/8, 2, 8, 4): for each output-channel
    chunk and block of 8 input channels, one stage per (kd, kh) and in it
    one k-step per kw, each as TF32 hi and lo parts of wgmma core matrices
    (8 output channels x 16 bytes of K, the two K halves 128 B apart,
    groups of 8 channels 256 B apart), the layout of conv3's pack.  K index
    h*4 + a holds channel 2a + h of the block, so that the kernel's A words
    k t and k t+4 are the neighbouring channels 2t and 2t+1.  C and O are
    zero-padded."""
    c, o = w.shape[3], w.shape[4]
    p = down4_plan(c, o)
    wp = torch.zeros((4, 4, 4, p.n_cb * CHANNEL_BLOCK, p.n_chunks * p.nc),
                     dtype=torch.float32, device=w.device)
    wp[:, :, :, :c, :o] = w
    wp = wp.reshape(4, 4, 4, p.n_cb, 4, 2, p.n_chunks, p.nc // 8, 8)
    # -> (chunk, channel block, kd, kh, kw, 8-channel group, K half, row, a)
    wp = wp.permute(6, 3, 0, 1, 2, 7, 5, 8, 4).contiguous()
    return torch.stack(split_tf32(wp), dim=5).contiguous()


def packed_down4_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_down4_weights` (w), cached on w's storage and stamped
    with its version counter (``cuda_conv.storage_cached``): built once per
    parameter, again after an in-place update.  Each pack counts as
    ``down4_weight_packs`` (``ops/counts.py``)."""
    def pack():
        telemetry.count("down4_weight_packs")
        return pack_down4_weights(w.detach())

    return storage_cached(w, "_down4_packs", (), pack)


def down4(x: torch.Tensor, w: torch.Tensor,
          leaky: Optional[float] = None) -> torch.Tensor:
    """(B, D, H, W, C) * (4, 4, 4, C, O) -> (B, D//2 - 1, H//2 - 1,
    W//2 - 1, O), the k4 stride-2 VALID conv, float32, ``leaky`` fused
    into the epilogue as LeakyReLU(negative_slope=leaky): on the CPU
    :func:`down4_plain`, on the card ``csrc/down4_tc.cu`` with w packed
    once per parameter.  A strided x is read through a contiguous copy.
    No gradient: ``ops/convs.py`` routes only calls that record none."""
    if x.device.type == "cpu":
        return down4_plain(x, w, leaky)
    x = x.contiguous()
    kernels.check_cuda_tensor(x, "down4 x", (torch.float32,), 5)
    if w.device != x.device or w.dtype != torch.float32:
        raise TypeError(f"down4 w: expected float32 on {x.device}, got "
                        f"{w.dtype} on {w.device}")
    bsz, d, h, wd, c = x.shape
    if tuple(w.shape[:4]) != (4, 4, 4, c) or w.dim() != 5:
        raise ValueError(f"down4: kernel {tuple(w.shape)} does not match "
                         f"input channels {c}")
    if min(d, h, wd) < 4:
        raise ValueError(f"down4: input {tuple(x.shape)} smaller than 4^3")
    y = torch.empty((bsz, d // 2 - 1, h // 2 - 1, wd // 2 - 1, w.shape[-1]),
                    dtype=x.dtype, device=x.device)
    wp = packed_down4_weights(w)
    kernels.launch("tem_down4_tc", x.data_ptr(), wp.data_ptr(), y.data_ptr(),
                   bsz, d, h, wd, c, y.shape[-1],
                   down4_plan(c, y.shape[-1]).nc, int(leaky is not None),
                   0.0 if leaky is None else float(leaky), device=x.device)
    telemetry.count("down4")
    return y
