"""3x3x3 stride-1 VALID conv on two hand-written CUDA kernels.

Counterpart of ``transfer_em_tpu/ops/pallas_conv.py``: the kernels replace
the Pallas Toeplitz-GEMM ``_tconv3_kernel`` (pallas_conv.py:69-114,
``pallas_call`` at :174) reached through ``tconv3`` (138-159), ``tconv3_op``
(196-219) and ``tconv3_act_op`` (224-246).  Unlike the TPU kernel, whose
``supported()`` (42-53) needs W >= 128/C and so leaves the C=1 stem to XLA
at 74^3, they serve every k3 conv of the generator, the stem included.
Which convs reach them is ``ops/convs.py``'s choice (its module
docstring).

The wrapper picks one of two kernels by shape (:func:`conv3_path`):

* ``"tc"`` (``csrc/conv3_tc.cu``), C >= 4 and O >= 8: an implicit GEMM on
  the tensor cores (wgmma), float32 as 3xTF32 and bfloat16 as one bf16
  product, both summed in f32.  Its weights are packed once per parameter
  by :func:`pack_conv3_weights` into the MMA's B layout (cached).  Float32
  at O <= 32 takes the kernel's kw form (:func:`conv3_plan`): the three kw
  taps' weights side by side in the MMA's N, each output the sum of three
  rows shifted along w, which runs the narrow layers at wgmma's rate for
  N = 3 * O rather than N = O.
* ``"direct"`` (``csrc/conv3_direct.cu``), C < 4 or O < 8: a direct
  convolution on the CUDA cores from shared-memory tiles; these shapes are
  bound by bytes.

Each source's header says what bounds it on the H100 and what its design
does about it.

Gradients: :func:`conv3` runs through a ``torch.autograd.Function`` whose
forward is the kernel and whose backward is ``F.conv3d``'s gradients
(:func:`conv3_backward`): the ``custom_vjp`` split of pallas_conv.py:
196-246 (``_bwd`` 206-216, ``_act_bwd`` 234-243), whose backward is
``lax.conv``'s VJP, not a Pallas kernel.  float32 operands take cuDNN's
float32 engines.  bfloat16 operands take them too, on the bf16 values
with the TF32 tensor cores allowed (a bf16 value is a TF32 value, so
every product is exact and summed in f32), dx and dw rounded to bf16: the
function of JAX's default bf16 step, whose VJP is XLA's bf16 conv, and of
its fast_conv path, which rounds f32-math gradients to bf16.  cuDNN's
bf16 engines are not used: at the train step's largest reductions their
dw is up to 2.8 bf16 steps off the exact value and misses its rounding at
93% of the elements.  At the train step's 12 k3 shapes (B=128) the TF32
engines take about 200 ms, within 0.6 bf16 steps of the exact gradients,
against 442 ms for the bf16 engines and 2,140 ms for FP32, on an H100
80GB HBM3 at 700 W (chip_smoke.py ``bwd_engine``; PERF.md).  With
the LeakyReLU epilogue the backward takes the mask from the SAVED OUTPUT
(``y >= 0``); it differs from JAX's mask on the recomputed pre-activation
only where ``pre * 0.3`` underflows to -0, and it costs no recomputed
forward.  Under
``torch.func.vmap`` over stacked networks (``ensemble_apps``) the Function
launches the kernel once per network: conv3 has no grouped form.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels, telemetry
from .cuda_kernels import LEAKY_SLOPE

# The tensor-core path needs C >= TC_MIN_IN and O >= TC_MIN_OUT.
TC_MIN_IN, TC_MIN_OUT = 4, 8
# Float32 convs with at most KW_MAX_OUT outputs take the kw form.
KW_MAX_OUT = 32
_MMA_DEPTH = {torch.float32: 8, torch.bfloat16: 16}  # wgmma k, elements
_BLOCK_BYTES = 64            # most bytes of one voxel's channels in smem
_OUT_CHUNKS = (8, 16, 32, 64)  # output channels per block (wgmma N)
SMEM_LIMIT = 227 * 1024      # H100 dynamic shared memory per block
# The weight stages are loaded at once (the tap form: a channel block's 9;
# the kw form: all, once a block, its input planes then in a ring where one
# channel block) where the block then needs at most this much shared
# memory: three blocks still fit on an SM.  (Above it, fewer resident blocks
# cost more than the streamed stages' waits on the H100: head and up0.conv
# at wf=8 ran faster streamed, in both forms.)
RESIDENT_SMEM = 75 * 1024


def conv3_path(c: int, o: int) -> str:
    """Which kernel serves a (C -> O) conv3: ``"tc"`` or ``"direct"``."""
    return "tc" if c >= TC_MIN_IN and o >= TC_MIN_OUT else "direct"


@dataclass(frozen=True)
class TCPlan:
    """How the tensor-core kernel tiles one (C, O, dtype).

    ``cb`` input channels per block (C zero-padded to ``n_cb * cb``), ``nc``
    output channels per block (O padded to ``n_chunks * nc``); ``kw``: the
    kw form (the kw taps side by side in N = 3 * nc, a tile 4 output rows by
    16 input columns, a block walking chunks of ``planes`` output planes
    along d) or the tap form (N = nc, a tile 8 x 8 outputs, a block one
    chunk of ``planes``); ``resident``: the weight stages are loaded at once
    (the tap form: a channel block's 9; the kw form: all 9 * n_cb, once a
    block), else they stream through 2 stage buffers (tap) or two kh
    rows of 3 stages (kw); ``ring``: the kw form keeps two chunks' input
    planes in a ring, so each plane is copied once (one channel block,
    resident weights); ``smem_bytes`` is what one block asks for.  Must
    match ``Cfg`` and ``CfgKw`` in csrc/conv3_tc.cu."""
    c: int
    o: int
    dtype: torch.dtype
    kk: int
    cb: int
    n_cb: int
    nc: int
    n_chunks: int
    kw: bool
    planes: int
    resident: bool
    ring: bool
    smem_bytes: int

    @property
    def parts(self) -> int:
        return 2 if self.dtype == torch.float32 else 1


def conv3_plan(c: int, o: int, dtype: torch.dtype) -> TCPlan:
    """The plan the kernel runs a (C -> O) conv3 in ``dtype`` with: the kw
    form where the dtype is float32 and O <= KW_MAX_OUT (the narrow layers,
    where wgmma at N = O runs far under its rate), else the tap form."""
    return tc_plan(c, o, dtype, dtype == torch.float32 and o <= KW_MAX_OUT)


def tc_plan(c: int, o: int, dtype: torch.dtype, kw: bool) -> TCPlan:
    """The tensor-core kernel's plan for (C -> O) in ``dtype`` in the form
    ``kw`` names (the kw form is float32 only, O <= 32)."""
    kk = _MMA_DEPTH[dtype]
    es = torch.empty((), dtype=dtype).element_size()
    cb = min(-(-c // kk) * kk, _BLOCK_BYTES // es)
    nc = next((n for n in _OUT_CHUNKS if n >= o), _OUT_CHUNKS[-1])
    parts = 2 if dtype == torch.float32 else 1
    steps = cb // kk  # k-steps of one tap
    n_cb = math.ceil(c / cb)
    if kw:
        if dtype != torch.float32 or o > KW_MAX_OUT:
            raise ValueError(f"conv3: no kw form for {o} outputs in {dtype}")
        planes = 4 if nc <= 16 else 2
        stage = steps * parts * 3 * nc * 32
        plane = 96 * cb * es  # 6 x 16 voxels
        resident = (planes + 2) * plane + 9 * n_cb * stage <= RESIDENT_SMEM
        ring = resident and n_cb == 1 and (
            (2 * planes + 2) * plane + 9 * stage <= RESIDENT_SMEM)
        smem = ((2 * planes + 2 if ring else planes + 2) * plane
                + (9 * n_cb if resident else 6) * stage)
    else:
        planes = 4 if nc <= 32 else 2
        stage = 3 * steps * parts * nc * 32
        inp = (planes + 2) * 100 * (32 if cb == kk else 96)  # bytes a voxel
        resident = inp + 9 * stage <= RESIDENT_SMEM
        ring = False
        smem = inp + (9 if resident else 2) * stage
    return TCPlan(c, o, dtype, kk, cb, n_cb, nc, math.ceil(o / nc), kw,
                  planes, resident, ring, smem)


# -- weight packing (plain torch; reachable on the CPU) ---------------------

def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 w -> (hi, lo): hi is w rounded to TF32 (10-bit mantissa,
    round to nearest even, by integer operations on the bits) and
    lo = w - hi, exact in float32, so hi + lo == w."""
    if w.dtype != torch.float32:
        raise TypeError(f"split_tf32: expected float32, got {w.dtype}")
    bits = w.contiguous().view(torch.int32)
    hi = ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return hi, w - hi


def pack_conv3_weights(w: torch.Tensor, dtype: torch.dtype,
                       plan: Optional[TCPlan] = None) -> torch.Tensor:
    """(3, 3, 3, C, O) -> the tensor-core kernel's B operand in ``dtype``
    for ``plan`` (default :func:`conv3_plan`'s).

    Tap form: shape (n_chunks, n_cb, 3, 3, 3, cb/kk, parts, nc/8, 2, 8,
    kk/2): for each output-channel chunk and input-channel block, one stage
    per (kd, kh) and, inside it, one k-step per (kw, kk channels),
    tap-major and channel-minor.  kw form: shape (1, n_cb, 3, 3, cb/kk,
    parts, 3 nc/8, 2, 8, kk/2): one stage per (kh, kd), kh-major so that a
    kh row's three stages lie together, one k-step per kk channels, and in
    it the three kw taps side by side in N (n = kw * nc + o), so that one
    wgmma of N = 3 nc takes a voxel's products with all three taps.  A
    k-step holds ``parts`` (f32: TF32 hi and lo; bf16: 1) K-major wgmma
    core matrices: 8 output channels x 16 bytes of K, the two K halves
    128 B apart, groups of 8 channels 256 B apart.  Inside a k-step, K is
    permuted so that the kernel's A words k t and k t+4 (in 32-bit words)
    are neighbouring words of the input: K index h*kk/2 + e, e = a*kk/8 + r,
    holds channel a*kk/4 + h*kk/8 + r.  C and O are zero-padded."""
    c, o = w.shape[3], w.shape[4]
    p = conv3_plan(c, o, dtype) if plan is None else plan
    wp = torch.zeros((3, 3, 3, p.n_cb * p.cb, p.n_chunks * p.nc),
                     dtype=dtype, device=w.device)
    wp[:, :, :, :c, :o] = w.to(dtype)
    wp = wp.reshape(3, 3, 3, p.n_cb, p.cb // p.kk, 4, 2, p.kk // 8,
                    p.n_chunks, p.nc // 8, 8)
    if p.kw:
        # -> (chunk, cb, kh, kd, k-step, kw, 8-channel group, K half h, row,
        # a, r): the kw taps and the groups make N
        wp = wp.permute(8, 3, 1, 0, 4, 2, 9, 6, 10, 5, 7).reshape(
            p.n_chunks, p.n_cb, 3, 3, p.cb // p.kk, 3 * p.nc // 8, 2, 8,
            p.kk // 2)
        part_dim = 5
    else:
        # -> (chunk, cb, kd, kh, kw, k-step, 8-channel group, K half h,
        # row, a, r)
        wp = wp.permute(8, 3, 0, 1, 2, 4, 9, 6, 10, 5, 7).reshape(
            p.n_chunks, p.n_cb, 3, 3, 3, p.cb // p.kk, p.nc // 8, 2, 8,
            p.kk // 2)
        part_dim = 6
    if dtype == torch.float32:
        parts = torch.stack(split_tf32(wp.contiguous()), dim=part_dim)
    else:
        parts = wp.unsqueeze(part_dim)
    return parts.contiguous()


def packed_weights(w: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """pack_conv3_weights(w, dtype or w.dtype), cached on w's STORAGE,
    keyed by the view (offset, shape, strides, dtype) and the target dtype,
    and stamped with w's version counter: it lives as long as the weight's
    memory.

    * A ``.detach()`` alias of a parameter (the frozen discriminators'
      ``functional_call``) shares the parameter's storage and version
      counter, so it hits the parameter's pack.
    * An in-place update of the parameter (``Adam``'s ``p.add_`` under
      ``no_grad``) bumps the version, so the next call repacks.  A write
      through ``p.data`` does NOT bump it and is not seen: the port's
      optimizer never writes through ``.data``.
    * A bfloat16 forward packs straight from the float32 parameter
      (``dtype=torch.bfloat16``), so it packs once per parameter too; a
      cast made per call would be a fresh tensor each forward (and, under
      ``inference_mode``, an inference tensor, which has no version
      counter and always repacks).

    Each pack counts as ``conv3_weight_packs`` (``ops/counts.py``)."""
    dtype = w.dtype if dtype is None else dtype

    def pack():
        telemetry.count("conv3_weight_packs")
        return pack_conv3_weights(w.detach(), dtype)

    return storage_cached(w, "_conv3_packs", (dtype,), pack)


def storage_cached(w: torch.Tensor, name: str, key: tuple, make):
    """make(), cached on w's STORAGE (in a dict at its attribute ``name``),
    keyed by w's view (offset, shape, strides, dtype) and ``key``, and
    stamped with w's version counter: an in-place update of w remakes it,
    and it lives as long as w's memory.  A tensor made in inference mode
    keeps no version counter, so make() runs on every call.  The one cache
    of what is derived from a parameter."""
    if w.is_inference():
        return make()
    storage = w.untyped_storage()
    key = (w.storage_offset(), tuple(w.shape), w.stride(), w.dtype) + key
    cache = getattr(storage, name, None)
    if cache is None:
        cache = {}
        setattr(storage, name, cache)
    hit = cache.get(key)
    if hit is not None and hit[0] == w._version:
        return hit[1]
    made = make()
    cache[key] = (w._version, made)
    return made


# -- the conv ----------------------------------------------------------------

def conv3_plain(x: torch.Tensor, w: torch.Tensor,
                leaky: Optional[float] = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch: w rounded to x's dtype,
    float32 products and sums rounded to x's dtype, then the optional
    LeakyReLU on that value, rounded again (bf16: a bf16 conv followed by a
    bf16 activation, as the JAX package's default path computes them)."""
    y = F.conv3d(x.to(torch.float32).permute(0, 4, 1, 2, 3),
                 w.to(x.dtype).to(torch.float32).permute(4, 3, 0, 1, 2))
    y = y.permute(0, 2, 3, 4, 1).to(x.dtype)
    if leaky is not None:
        y = torch.where(y >= 0, y, y * leaky)
    return y.contiguous()


def conv3_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                   need_x: bool = True, need_w: bool = True
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Gradients of the VALID conv (no epilogue) w.r.t. x and w for the
    output cotangent g, all three of one dtype; None where not needed.
    float32 (or float64): ``F.conv3d``'s backward in that dtype (cuDNN on
    the card).  bfloat16: the same in float32 on the bf16 values, cuDNN's
    TF32 tensor cores allowed (exact products, f32 sums), dx and dw rounded
    to bf16."""
    if x.dtype != torch.bfloat16:
        return conv_backward_in_dtype(x, w, g, need_x, need_w)
    f = torch.float32
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        dx, dw = conv_backward_in_dtype(x.to(f), w.to(f), g.to(f), need_x,
                                        need_w)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return tuple(None if t is None else t.to(x.dtype) for t in (dx, dw))


def conv_backward_in_dtype(x: torch.Tensor, w: torch.Tensor,
                           g: torch.Tensor, need_x: bool = True,
                           need_w: bool = True
                           ) -> Tuple[Optional[torch.Tensor],
                                      Optional[torch.Tensor]]:
    """``F.conv3d``'s backward in the operands' own dtype under the current
    cuDNN flags (on bf16 operands, cuDNN's bf16 engines)."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
        w.permute(4, 3, 0, 1, 2), None, [1, 1, 1], [0, 0, 0], [1, 1, 1],
        False, [0, 0, 0], 1, [need_x, need_w, False])
    if dx is not None:
        dx = dx.permute(0, 2, 3, 4, 1)
    if dw is not None:
        dw = dw.permute(2, 3, 4, 1, 0)
    return dx, dw


class _Conv3(torch.autograd.Function):
    """conv3 with gradients: the kernel forward, conv3_backward behind it.
    The gradients are those of the conv on w cast to x's dtype, then of
    the cast (dw rounded to x's dtype, returned in w's)."""

    @staticmethod
    def forward(x, w, leaky):
        return _conv3(x, w, leaky)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, leaky = inputs
        ctx.leaky = leaky
        ctx.save_for_backward(x, w, output if leaky is not None else None)

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        if ctx.leaky is not None:  # the mask from the saved output
            g = torch.where(y >= 0, g, g * ctx.leaky)
        dx, dw = conv3_backward(x, w.to(x.dtype), g,
                                *ctx.needs_input_grad[:2])
        return dx, None if dw is None else dw.to(w.dtype), None

    @staticmethod
    def vmap(info, in_dims, x, w, leaky):
        xd, wd = in_dims[:2]
        ys = [_Conv3.apply(x if xd is None else x.select(xd, i).contiguous(),
                           w if wd is None else w.select(wd, i), leaky)
              for i in range(info.batch_size)]
        return torch.stack(ys), 0


def conv3(x: torch.Tensor, w: torch.Tensor,
          leaky: Optional[float] = None) -> torch.Tensor:
    """(B, D, H, W, C) * (3, 3, 3, C, O) -> (B, D-2, H-2, W-2, O) in x's
    dtype (float32 or bfloat16).  w is x's dtype, or a float32 parameter
    under a bfloat16 x: the conv then runs on w rounded to bfloat16, packed
    once per parameter (:func:`packed_weights`).  ``leaky`` fuses
    LeakyReLU(negative_slope=leaky) into the epilogue.  A strided x (a
    cropped view) is read through a contiguous copy.  Every call goes
    through :class:`_Conv3`, which records the gradient where autograd
    needs one and carries the rule for ``torch.func.vmap``."""
    return _Conv3.apply(x, w, leaky)


def _conv3(x: torch.Tensor, w: torch.Tensor,
           leaky: Optional[float]) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3_plain(x, w, leaky)
    x = x.contiguous()
    kernels.check_cuda_tensor(x, "conv3 x", tuple(kernels.DTYPE_CODES), 5)
    kernels.check_cuda_tensor(w, "conv3 w", (x.dtype, torch.float32), 5)
    bsz, d, h, wd, c = x.shape
    o = w.shape[-1]
    if tuple(w.shape[:4]) != (3, 3, 3, c):
        raise ValueError(f"conv3: kernel {tuple(w.shape)} does not match "
                         f"input channels {c}")
    if min(d, h, wd) < 3:
        raise ValueError(f"conv3: input {tuple(x.shape)} smaller than 3^3")
    y = torch.empty((bsz, d - 2, h - 2, wd - 2, o), dtype=x.dtype,
                    device=x.device)
    if conv3_path(c, o) == "tc":
        conv3_tc(x, packed_weights(w, x.dtype), y, conv3_plan(c, o, x.dtype),
                 leaky)
    else:
        w = w.to(x.dtype)  # C < 4 or O < 8: a few hundred weights
        kernels.launch("tem_conv3_direct", x.data_ptr(), w.data_ptr(),
                       y.data_ptr(), kernels.DTYPE_CODES[x.dtype], bsz, d, h,
                       wd, c, o, int(leaky is not None),
                       float(leaky) if leaky is not None else 0.0,
                       device=x.device)
        telemetry.count("conv3_direct")
    if x.dtype == torch.bfloat16:
        telemetry.count("conv3_bf16")
    telemetry.count("conv3")
    return y


def conv3_tc(x: torch.Tensor, wp: torch.Tensor, y: torch.Tensor,
             plan: TCPlan, leaky: Optional[float] = None,
             lib=None) -> torch.Tensor:
    """The tensor-core kernel into ``y`` (B, D-2, H-2, W-2, O) from x
    (B, D, H, W, C), contiguous on the card, with ``wp`` packed for
    ``plan`` (:func:`pack_conv3_weights`); ``lib`` another build of it
    (``kernels.build_variant``).  Counts ``conv3_tc``, and ``conv3_tc_kw``
    where the plan is the kw form's."""
    bsz, d, h, wd, c = x.shape
    kernels.launch("tem_conv3_tc", x.data_ptr(), wp.data_ptr(), y.data_ptr(),
                   kernels.DTYPE_CODES[x.dtype], bsz, d, h, wd, c, plan.o,
                   plan.cb, plan.nc, int(plan.kw), int(plan.resident),
                   int(plan.ring), int(leaky is not None),
                   float(leaky) if leaky is not None else 0.0,
                   device=x.device, lib=lib)
    telemetry.count("conv3_tc")
    if plan.kw:
        telemetry.count("conv3_tc_kw")
    return y


def conv3_act(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3 with the fused LeakyReLU(0.3) epilogue (``tconv3_act_op``)."""
    return conv3(x, w, leaky=LEAKY_SLOPE)
