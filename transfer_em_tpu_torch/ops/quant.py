"""Int8 quantized convolutions: the serving opt-in of the int8 generator.

Counterpart of ``transfer_em_tpu/ops/quant.py`` (the same scheme, the same
call shapes, 2D and 3D): activations quantized per tensor over the whole
batch, weights per output channel, both symmetric (no zero points), an
int8 x int8 -> int32 conv, dequantized straight into the requested dtype.
``UNetGenerator(int8_conv=True)`` routes every conv through here (a flag
of ``models/blocks.py``; the float convs' kernels are ``ops/convs.py``'s
choice).

A conv here is two hand-written kernels on CUDA tensors:

1. :func:`quantize_int8` (``csrc/quant_int8.cu``): the activations' abs-max
   over the whole tensor, then each code written straight into the layout
   the conv reads (:class:`Layout`): zero padding (SAME, the transposed
   conv's pad by 1), the stride-2 convs' cut and space-to-depth, the
   channels zero-padded to whole 4-byte words, and for a one-channel input
   (the stem) the kw taps packed into the channel word.  The scale stays
   on the device.  Its plain version, :func:`quantize_int8_plain`, is the
   composition of :func:`quantize_sym` and the rearrangements
   (:func:`arrange`), which is what the CPU runs.
2. ``ops/cuda_int8.conv_int8``: a stride-1 VALID conv of the codes with
   kernel extents <= 3, dequantized (and for the transposed conv
   interleaved) in its epilogue.

The JAX package's convs reduce to that stride-1 conv exactly, since
integer sums do not depend on their order:

* a stride-s VALID conv (the k4 stride-2 down convs): the kernel padded to
  a multiple of s per axis, input and kernel space-to-depth by s
  (``ops/cuda_down.py`` :func:`space_to_depth`, :func:`kernel_to_depth`,
  which the float32 down conv's plain version shares), then a stride-1
  conv with ceil(k/s) taps per axis and s^n * C channels;
* SAME at stride 1: the input zero-padded as ``lax`` pads it;
* the TF-SAME stride-2 k4 transposed conv: its phase decomposition
  (``ops/convs.py`` :func:`phase_kernel`), one k3 conv over the codes
  padded by 1 with 2^n * Cout outputs, each dequantized by its Cout's scale,
  then interleaved.  Each phase tap is one weight code, so the codes are
  those JAX quantizes from its flipped kernel (a flip moves no channel);
* a one-channel input with kw <= 4 (the stem): codes[.., w, j] = q[.., w +
  j] and the kernel's kw taps moved into its channel axis, a conv with one
  kw tap and 4 channels: a third of the stem's K words;
* every other conv (SAME at a stride > 1, more than 3 taps an axis after
  the reductions above, a transposed conv at any (k, s) but k4 s2): the
  phases of :func:`phase_plan`, the input space-to-depth by ``Q`` (the
  quantize kernel's layout) and the output ``P`` phases an axis, a conv of
  at most 3 taps an axis with P^n * Cout outputs, interleaved
  (:func:`..convs.interleave_phases`) and cropped after the kernel.  A
  transposed conv is JAX's input-dilated conv of its flipped kernel, the
  dilation's zeros dropped.

The weights' codes, scales and the kernel's packed operand are made once
per parameter (:func:`int8_weights`, cached on the parameter's memory, view
and version), which JAX redoes per call: the codes are the same function
of the weights.

Since the activation scale spans the whole batch (padded tiles included),
an int8 tile's output depends on its batch-mates: the tile-grid modes'
bit-equality across batch shapes does not carry over to int8.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels, telemetry
from .convs import (interleave_phases, phase_kernel, same_padding,
                    same_transpose_padding)
from .cuda_conv import storage_cached
from .cuda_down import kernel_to_depth, space_to_depth
from .cuda_int8 import conv_int8, pack_int8_weights

__all__ = ["quantize_sym", "conv_nd_int8", "conv_transpose_nd_int8",
           "space_to_depth", "kernel_to_depth", "Layout", "conv_layout",
           "PhasePlan", "phase_plan", "phase_plans", "phase_layout",
           "arrange", "quantize_int8", "quantize_int8_plain",
           "quantize_int8_cuda", "int8_weights"]


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


def _words(c: int) -> int:
    """c rounded up to whole 4-byte words of int8 codes."""
    return -(-c // 4) * 4


class Layout(NamedTuple):
    """Where :func:`quantize_int8` writes the codes of a (B, *S, C) input:
    each spatial axis zero-padded by ``lo`` before and cut or zero-padded
    after to ``size``, then space-to-depth by ``stride`` (channel index
    (p_1, .., p_n, c)), then, with ``wtaps`` > 1 (C = 1 only), the last
    axis's ``wtaps`` consecutive values as the channels of one voxel
    (codes[.., w, j] = q[.., w + j], the axis ``wtaps`` - 1 shorter), then
    the channels zero-padded to ``channels`` (a multiple of 4)."""
    lo: Tuple[int, ...]
    size: Tuple[int, ...]
    stride: int
    wtaps: int
    channels: int

    def shape(self, x_shape: Sequence[int]) -> Tuple[int, ...]:
        """The codes' shape for an input of ``x_shape``."""
        sp = [d // self.stride for d in self.size]
        sp[-1] -= self.wtaps - 1
        return (x_shape[0], *sp, self.channels)


def conv_layout(x_shape: Sequence[int], k_shape: Sequence[int], stride: int,
                padding: str, transpose: bool = False) -> Layout:
    """The codes' layout for a conv of an (B, *S, C) input by a ((k_i,)*n,
    C, O) kernel (module docstring): VALID or SAME at stride 1, VALID at
    stride s, or the stride-2 transposed conv (``transpose``)."""
    n = len(x_shape) - 2
    sp, c = tuple(x_shape[1:-1]), x_shape[-1]
    ks = tuple(k_shape[:n])
    if transpose:
        return Layout((1,) * n, tuple(d + 2 for d in sp), 1, 1, _words(c))
    if padding == "SAME" and stride != 1:
        raise ValueError("SAME at a stride > 1 takes phase_layout")
    if stride != 1:
        kp = [-(-k // stride) * stride for k in ks]
        outs = [(d - k) // stride + 1 for d, k in zip(sp, ks)]
        if min(outs) < 1:
            raise ValueError(f"input {tuple(x_shape)} smaller than the "
                             f"kernel {tuple(k_shape)}")
        size = tuple(stride * (o - 1) + k for o, k in zip(outs, kp))
        return Layout((0,) * n, size, stride, 1, _words(stride ** n * c))
    if padding == "SAME":
        lo = tuple((k - 1) // 2 for k in ks)
        size = tuple(d + k - 1 for d, k in zip(sp, ks))
    else:
        lo, size = (0,) * n, sp
    if c == 1 and 1 < ks[-1] <= 4:
        return Layout(lo, size, 1, ks[-1], 4)
    return Layout(lo, size, 1, 1, _words(c))


def arrange(q: torch.Tensor, layout: Layout) -> torch.Tensor:
    """Codes (B, *S, C) into ``layout`` (:class:`Layout`), in plain
    PyTorch."""
    n = q.dim() - 2
    pads = ()
    for lo, size, d in zip(reversed(layout.lo), reversed(layout.size),
                           reversed(q.shape[1:-1])):
        pads += (lo, size - lo - d)  # a negative pad cuts
    q = F.pad(q, (0, 0) + pads)
    if layout.stride != 1:
        q = space_to_depth(q, layout.stride)
    if layout.wtaps > 1:
        w = q.shape[-2] - layout.wtaps + 1
        q = torch.cat([q.narrow(n, j, w) for j in range(layout.wtaps)],
                      dim=-1)
    return F.pad(q, (0, layout.channels - q.shape[-1])).contiguous()


def quantize_int8_plain(x: torch.Tensor, layout: Layout
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_int8`'s function in plain PyTorch: per-tensor
    :func:`quantize_sym`, then :func:`arrange`."""
    q, scale = quantize_sym(x, tuple(range(x.dim())))
    return arrange(q, layout), scale


def quantize_int8(x: torch.Tensor, layout: Layout
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, *S, C) float32 or bfloat16, channels last -> (codes int8 in
    ``layout``, scale float32 of shape (1,)*x.dim()): JAX's
    ``quantize_sym`` over the whole tensor, written where the conv reads it.
    A CPU tensor takes :func:`quantize_int8_plain`; a CUDA tensor launches
    ``csrc/quant_int8.cu`` (counted as ``quantize_int8``,
    ``ops/counts.py``) or raises."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, layout)
    out = quantize_int8_cuda(x, layout)
    telemetry.count("quantize_int8")
    return out


def quantize_int8_cuda(x: torch.Tensor, layout: Layout, lib=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of :func:`quantize_int8` on a CUDA tensor (the kernel
    library's, or ``lib``'s ``tem_quantize_int8``), uncounted.  A strided
    ``x`` is read through a contiguous copy (the generator's never is)."""
    x = x.contiguous()
    kernels.check_cuda_tensor(x, "quantize_int8 x",
                              (torch.float32, torch.bfloat16))
    n = x.dim() - 2
    if n not in (2, 3) or len(layout.lo) != n:
        raise ValueError(f"quantize_int8: input {tuple(x.shape)} does not "
                         f"match layout {layout}")
    if layout.wtaps > 1 and (x.shape[-1] != 1 or layout.stride != 1):
        raise ValueError("quantize_int8: kw taps are packed for a "
                         "one-channel stride-1 input only")
    shape = layout.shape(x.shape)
    q = torch.empty(shape, dtype=torch.int8, device=x.device)
    scratch = torch.empty(2, dtype=torch.float32, device=x.device)
    sp = (1,) * (3 - n) + tuple(x.shape[1:-1])
    qsp = (1,) * (3 - n) + tuple(shape[1:-1])
    lo = (0,) * (3 - n) + tuple(layout.lo)
    kernels.launch("tem_quantize_int8", x.data_ptr(),
                   kernels.DTYPE_CODES[x.dtype], q.data_ptr(),
                   scratch.data_ptr(), x.shape[0], *sp, x.shape[-1], *qsp,
                   shape[-1], *lo, layout.stride, n, layout.wtaps,
                   device=x.device, lib=lib)
    return q, scratch[1:].view((1,) * x.dim())


# -- the phases of any other conv --------------------------------------------

class PhasePlan(NamedTuple):
    """One axis of a conv that the reductions above do not take, as a
    stride-1 conv of at most 3 taps: the output y[o] = sum_t w_t *
    x[(o * stride + t - lo) / dilation] over the taps t whose index is
    whole (``dilation`` > 1: the transposed conv's input dilation, ``lo``
    its low pad; 1: a forward conv, ``lo`` its SAME pad), w_t the kernel's
    tap t, or tap k - 1 - t with ``flip``.  Output o = P * m + r (``P``
    phases) reads block m + j of the input space-to-depth by ``Q``:
    ``entries`` holds (r, t, j, offset in the block) for every tap, j from
    0 to ``taps`` - 1; ``first`` is the first block's index (x[Q * (m +
    first) + offset])."""
    k: int
    stride: int
    dilation: int
    lo: int
    flip: bool
    P: int
    Q: int
    taps: int
    first: int
    entries: Tuple[Tuple[int, int, int, int], ...]


def phase_plan(k: int, stride: int = 1, dilation: int = 1, lo: int = 0,
               flip: bool = False, f: int = 1) -> PhasePlan:
    """The :class:`PhasePlan` of one axis with P = dilation * f phases and
    input blocks of Q = stride * f."""
    P, Q = dilation * f, stride * f
    rows = []
    for r in range(P):
        for t in range(k):
            num = r * stride + t - lo
            if num % dilation == 0:
                e = num // dilation
                rows.append((r, t, e // Q, e % Q))
    first = min(b for _, _, b, _ in rows)
    taps = max(b for _, _, b, _ in rows) - first + 1
    return PhasePlan(k, stride, dilation, lo, flip, P, Q, taps, first,
                     tuple((r, t, b - first, q) for r, t, b, q in rows))


def phase_plans(k: int, stride: int, dilation: int, los: Sequence[int],
                flip: bool = False) -> Tuple[PhasePlan, ...]:
    """One :func:`phase_plan` an axis (``los``: each axis's low pad), at
    the fewest phases (f = 1, 2, ..) that leave every axis at most 3 taps
    (f = k + 1 leaves at most 2)."""
    for f in range(1, k + 2):
        plans = tuple(phase_plan(k, stride, dilation, lo, flip, f)
                      for lo in los)
        if max(p.taps for p in plans) <= 3:
            return plans
    raise AssertionError(f"no phase plan for k={k}")


def phase_layout(x_shape: Sequence[int], plans: Sequence[PhasePlan],
                 out: Sequence[int]) -> Layout:
    """The codes' layout for ``plans`` (one an axis) over an (B, *S, C)
    input with ``out`` output voxels an axis: ceil(out / P) output blocks,
    so taps - 1 more input blocks of Q, from x[Q * first] on."""
    n = len(x_shape) - 2
    Q = plans[0].Q
    return Layout(tuple(-Q * p.first for p in plans),
                  tuple(Q * (-(-o // p.P) + p.taps - 1)
                        for p, o in zip(plans, out)),
                  Q, 1, _words(Q ** n * x_shape[-1]))


def _phase_kernel(qk: torch.Tensor, plans: Sequence[PhasePlan]
                  ) -> torch.Tensor:
    """((k,)*n, C, O) codes -> the plans' (taps_1, .., taps_n, Q^n * C,
    P^n * O) codes: input channel (q_1, .., q_n, c), output (r_1, .., r_n,
    o), first axis most significant.  Each tap is one weight code."""
    c, o = qk.shape[-2], qk.shape[-1]
    P, Q, n = plans[0].P, plans[0].Q, len(plans)
    out = qk.new_zeros(tuple(p.taps for p in plans)
                       + (Q ** n * c, P ** n * o))
    for rows in itertools.product(*[p.entries for p in plans]):
        qi = ri = 0
        for r, _, _, q in rows:
            qi, ri = qi * Q + q, ri * P + r
        taps = tuple(p.k - 1 - t if p.flip else t
                     for p, (_, t, _, _) in zip(plans, rows))
        out[tuple(j for _, _, j, _ in rows)
            + (slice(qi * c, (qi + 1) * c), slice(ri * o, (ri + 1) * o))] \
            = qk[taps]
    return out


# -- the weights, once per parameter ------------------------------------------

class Int8Weights(NamedTuple):
    """A kernel's int8 form for one conv layout: ``codes`` the stride-1
    conv's (kd, kh, kw, channels, O') codes (rank 4 in 2D), ``scales`` its
    O' output scales, ``packed`` the CUDA kernel's operand (None on the
    CPU)."""
    codes: torch.Tensor
    scales: torch.Tensor
    packed: Optional[object]


def _unit_kernel(qk: torch.Tensor, sk: torch.Tensor, layout: Layout,
                 transpose: bool, plans: Optional[Tuple[PhasePlan, ...]]
                 = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight codes and per-output scales of the stride-1 conv that
    ``layout``'s codes go through (module docstring)."""
    n = qk.dim() - 2
    sk = sk.reshape(-1)
    if plans is not None:
        qk, sk = _phase_kernel(qk, plans), sk.repeat(plans[0].P ** n)
    elif transpose:
        qk, sk = phase_kernel(qk), sk.repeat(2 ** n)
    elif layout.stride != 1:
        s, k = layout.stride, qk.shape[0]
        kp = -(-k // s) * s
        if kp != k:
            qk = F.pad(qk, (0, 0, 0, 0) + (0, kp - k) * n)
        qk = kernel_to_depth(qk, s)
    elif layout.wtaps > 1:  # (.., kw, 1, O) -> (.., 1, kw, O)
        qk = qk.movedim(n - 1, n)
    return F.pad(qk, (0, 0, 0, layout.channels - qk.shape[-2])), sk


def _make_weights(kernel: torch.Tensor, layout: Layout, transpose: bool,
                  plans: Optional[Tuple[PhasePlan, ...]] = None
                  ) -> Int8Weights:
    n = kernel.dim() - 2
    qk, sk = quantize_sym(kernel.detach(), tuple(range(n + 1)))
    codes, sk = _unit_kernel(qk, sk, layout, transpose, plans)
    codes, sk = codes.contiguous(), sk.contiguous()
    packed = (pack_int8_weights(codes) if kernel.device.type == "cuda"
              else None)
    return Int8Weights(codes, sk, packed)


def int8_weights(kernel: torch.Tensor, layout: Layout,
                 transpose: bool = False,
                 plans: Optional[Tuple[PhasePlan, ...]] = None
                 ) -> Int8Weights:
    """The kernel's :class:`Int8Weights` for ``layout`` (and ``plans``,
    :func:`phase_plans`, for the convs that take them), made once and
    cached on the kernel's STORAGE, keyed by its view (offset, shape,
    strides, dtype) and the layout, and stamped with its version counter
    (``ops/cuda_conv.storage_cached``):

    * an in-place update (an optimizer step, ``load_state_dict`` copying
      into the parameter) bumps the version, so the next call remakes it;
    * a parameter swapped for another tensor (``load_state_dict(sd,
      assign=True)``) has other memory, so it misses even at an equal
      version count;
    * a tensor made in inference mode keeps no version counter and is
      remade on every call.

    Each make counts as ``int8_weight_packs`` (``ops/counts.py``)."""
    def make():
        telemetry.count("int8_weight_packs")
        return _make_weights(kernel, layout, transpose, plans)

    return storage_cached(kernel, "_int8_weights",
                          (layout.stride, layout.wtaps, layout.channels,
                           transpose, plans), make)


# -- the convs ----------------------------------------------------------------

def _check_ranks(x: torch.Tensor, kernel: torch.Tensor) -> int:
    n = x.dim() - 2
    if n not in (2, 3) or kernel.dim() != x.dim():
        raise ValueError(f"expected NHWC x HWIO or NDHWC x DHWIO; got x "
                         f"{tuple(x.shape)}, kernel {tuple(kernel.shape)}")
    return n


def _on(kernel: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The kernel on ``device``, itself (so its cache holds) when there."""
    return kernel if kernel.device == device else kernel.to(device)


def _phase_conv(x: torch.Tensor, kernel: torch.Tensor,
                plans: Tuple[PhasePlan, ...], out: Sequence[int],
                out_dtype: Optional[torch.dtype],
                leaky: Optional[float] = None) -> torch.Tensor:
    """A conv by ``plans`` (module docstring): the codes in
    :func:`phase_layout`, one stride-1 conv_int8 of P^n * Cout outputs,
    interleaved and cropped to ``out``."""
    layout = phase_layout(x.shape, plans, out)
    w = int8_weights(_on(kernel, x.device), layout, plans=plans)
    qx, sx = quantize_int8(x, layout)
    y = conv_int8(qx, w.codes, sx, w.scales, out_dtype or torch.float32,
                  leaky, packed=w.packed)
    y = interleave_phases(y, plans[0].P)
    return y[(slice(None),) + tuple(slice(0, d) for d in out)].contiguous()


def conv_nd_int8(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
                 padding: str = "VALID",
                 out_dtype: Optional[torch.dtype] = None,
                 leaky: Optional[float] = None) -> torch.Tensor:
    """VALID/SAME N-D conv in int8: quantize both operands, integer conv,
    dequantize to ``out_dtype`` (default float32).  Same call shape as
    :func:`..convs.conv_nd` and as the JAX package's ``conv_nd_int8``
    (SAME split as XLA splits it, :func:`..convs.same_padding`); ``leaky``
    fuses a LeakyReLU on the dequantized value (rounded to ``out_dtype``
    first) into the kernel's epilogue."""
    _check_ranks(x, kernel)
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
    k = kernel.shape[0]
    if (padding == "SAME" and stride != 1) or -(-k // stride) > 3:
        sp = x.shape[1:-1]
        if padding == "SAME":
            los = [same_padding(d, k, stride)[0] for d in sp]
            out = [-(-d // stride) for d in sp]
        else:
            los, out = [0] * len(sp), [(d - k) // stride + 1 for d in sp]
        if min(out) < 1:
            raise ValueError(f"input {tuple(x.shape)} smaller than the "
                             f"kernel {tuple(kernel.shape)}")
        return _phase_conv(x, kernel, phase_plans(k, stride, 1, los), out,
                           out_dtype, leaky)
    layout = conv_layout(x.shape, kernel.shape, stride, padding)
    w = int8_weights(_on(kernel, x.device), layout)
    qx, sx = quantize_int8(x, layout)
    return conv_int8(qx, w.codes, sx, w.scales, out_dtype or torch.float32,
                     leaky, packed=w.packed)


def conv_transpose_nd_int8(x: torch.Tensor, kernel: torch.Tensor, *,
                           stride: int = 2,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """TF-exact stride-s SAME transposed conv in int8: (B, *S, Cin) *
    (k.., Cin, Cout) -> (B, *S', Cout) in ``out_dtype`` (default float32),
    S' as :func:`..convs.conv_transpose_nd` gives it.  The JAX package
    writes it as an input-dilated conv on its flipped kernel's codes; the
    generator's k4 s2 is here the phase decomposition of the same codes,
    interleaved by the conv's epilogue, any other (k, s) the phases of
    :func:`phase_plans` over the same dilated input (module docstring)."""
    n = _check_ranks(x, kernel)
    k = kernel.shape[0]
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if stride != 2 or k != 4:
        out = [(d - 1) * stride + k - max(k - stride, 0)
               for d in x.shape[1:-1]]
        lo = same_transpose_padding(k, stride)[0]
        return _phase_conv(x, kernel,
                           phase_plans(k, 1, stride, [lo] * n, True), out,
                           out_dtype)
    layout = conv_layout(x.shape, kernel.shape, 1, "VALID", transpose=True)
    w = int8_weights(_on(kernel, x.device), layout, transpose=True)
    qx, sx = quantize_int8(x, layout)
    return conv_int8(qx, w.codes, sx, w.scales, out_dtype or torch.float32,
                     packed=w.packed, phases=True)
