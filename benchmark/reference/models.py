"""Plain PyTorch U-Net generator and PatchGAN discriminator of
janelia-flyem/transfer_em (models/generator.py ``unet_generator``,
models/discriminator.py), 3D, as functions of a parameter dict.

Activations are NCDHW here; kernels come in the layout that the parameter
dict holds, ((k,) * 3, Cin, Cout), and are permuted to torch's layout at
each call.  Every conv is ``F.conv3d`` or ``F.conv_transpose3d`` in float32
(TF32 off, see ``exact``), so the reference owes nothing to any kernel of
the system under test.

    generator (width c = 64 // wf):
      stem k3 (c) -> LeakyReLU                               74 -> 72
      down1: k3 (c) -> LeakyReLU (skip0) -> k4 s2 -> LeakyReLU  -> 34
      down2: k3 (2c) -> LeakyReLU (skip1) -> k4 s2 -> LReLU     -> 15
      up1: k3 (4c) -> LReLU -> SAME k4 s2 transposed (2c) -> Dropout(0.5)
           -> LReLU; concat skip1 cropped to 26                -> 26
      mid k3 (4c) -> LReLU                                     -> 24
      up0: k3 (2c) -> LReLU -> transposed (c) -> Dropout -> LReLU; concat
           skip0 cropped to 44                                 -> 44
      head k3 (2c) -> LReLU; out k3 (1), no bias               -> 42 -> 40
    discriminator:
      down1 (c) 40 -> 18; hack k3 (16) -> LReLU 16; down2 (4c) -> 6;
      down3 (32) -> 1; LeakyReLU again; head 1x1 (4c) -> LReLU;
      out 1x1 (1) with the only bias.

LeakyReLU's slope is 0.3 (Keras's default).  Dropout keeps an element where
a random byte is below 128 and doubles it; the bytes are drawn channels-last,
``torch.randint(0, 256, (B, D, H, W, C), dtype=uint8)`` from a generator of
the caller's, so one seed gives one set of masks.

``quant``: a function applied to both operands of every conv (the lower
precision controls: ``fake_tf32``, ``fake_fp8``); None computes in
float32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

SLOPE = 0.3
GAIN = (2.0 / (1.0 + SLOPE ** 2)) ** 0.5  # keeps variance through LeakyReLU
Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def generator_spec(wf: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every generator parameter, in registration order."""
    c1, c2, c4 = 64 // wf, 128 // wf, 256 // wf
    k3, k4 = (3, 3, 3), (4, 4, 4)
    return [("stem.kernel", k3 + (1, c1)),
            ("down1.conv.kernel", k3 + (c1, c1)),
            ("down1.down.kernel", k4 + (c1, c1)),
            ("down2.conv.kernel", k3 + (c1, c2)),
            ("down2.down.kernel", k4 + (c2, c2)),
            ("up1.conv.kernel", k3 + (c2, 2 * c2)),
            ("up1.up.kernel", k4 + (2 * c2, c2)),
            ("mid.kernel", k3 + (2 * c2, c4)),
            ("up0.conv.kernel", k3 + (c4, 2 * c1)),
            ("up0.up.kernel", k4 + (2 * c1, c1)),
            ("head.kernel", k3 + (2 * c1, c2)),
            ("out.kernel", k3 + (c2, 1))]


def discriminator_spec(wf: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every discriminator parameter, in registration
    order; ``out.bias`` starts at zero, every kernel at N(0, 0.02)."""
    c1, c4 = 64 // wf, 256 // wf
    k3, k4 = (3, 3, 3), (4, 4, 4)
    return [("down1.conv.kernel", k3 + (1, c1)),
            ("down1.down.kernel", k4 + (c1, c1)),
            ("hack.kernel", k3 + (c1, 16)),
            ("down2.conv.kernel", k3 + (16, c4)),
            ("down2.down.kernel", k4 + (c4, c4)),
            ("down3.conv.kernel", k3 + (c4, 32)),
            ("down3.down.kernel", k4 + (32, 32)),
            ("head.kernel", (1, 1, 1, 32, c4)),
            ("out.kernel", (1, 1, 1, c4, 1)),
            ("out.bias", (1,))]


def fan_in_std(name: str, shape, gain: float = GAIN) -> float:
    """gain / sqrt(fan-in): taps x input channels of a conv; a k4 stride-2
    transposed conv reaches each output from 2^3 taps."""
    taps = 8 if name.endswith("up.kernel") else shape[0] * shape[1] * shape[2]
    return gain / (taps * shape[3]) ** 0.5


def make_weights(specs, seed: int, device,
                 gain: float = GAIN) -> List[Params]:
    """Kernels for each spec in ``specs`` (biases zero), drawn in ONE call
    from a generator on ``device`` seeded with ``seed``: the parameters of
    every network in order, then split and scaled to N(0, gain^2 /
    fan-in).  At the default ``GAIN`` activations keep O(1) through the
    layers, as a trained model's do (the models' own N(0, 0.02) leaves the
    output nearly flat)."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    sizes = [int(torch.Size(s).numel()) for spec in specs for _, s in spec]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    nets, i = [], 0
    for spec in specs:
        net = {}
        for name, shape in spec:
            n = int(torch.Size(shape).numel())
            t = flat[i:i + n].view(shape)
            if name.endswith("bias"):
                t = torch.zeros_like(t)
            else:
                t = t * fan_in_std(name, shape, gain)
            net[name] = t
            i += n
        nets.append(net)
    return nets


@contextlib.contextmanager
def exact():
    """cuDNN's and cuBLAS's float32 in float32 (TF32 off) inside."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _round_fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """t rounded to the float8 ``dtype`` under a per-tensor scale (the
    largest magnitude to ``top``), back in t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _GradFP8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(t):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """A conv operand as float8 training takes it: rounded to e4m3 under a
    per-tensor scale, its gradient passed straight through.  ``conv`` also
    rounds the gradient that reaches each conv's output to e5m2
    (``fake_fp8.grad``), so both backward products take float8 operands."""
    q = _round_fp8(t.detach(), torch.float8_e4m3fn, 448.0)
    return t + (q - t).detach()


fake_fp8.grad = _GradFP8.apply


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 mantissa bits, to the nearest, ties to
    even)."""
    i = t.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _GradTF32(torch.autograd.Function):
    """Identity forward; the gradient rounded to TF32."""

    @staticmethod
    def forward(t):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def fake_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 conv operand as the card's TF32 tensor cores take it,
    its gradient passed straight through; with ``fake_tf32.grad`` each
    conv's output gradient is rounded too, as TF32 backward products take
    it."""
    return t + (_round_tf32(t) - t).detach()


fake_tf32.grad = _GradTF32.apply


class _GradBF16(torch.autograd.Function):
    """Identity forward; the gradient rounded to bfloat16."""

    @staticmethod
    def forward(t):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def fake_bf16(t: torch.Tensor) -> torch.Tensor:
    """A conv operand rounded to bfloat16 (gradient straight through); with
    ``fake_bf16.grad`` each conv's output gradient rounded too."""
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t).detach()


fake_bf16.grad = _GradBF16.apply


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * SLOPE)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         quant: Quant = None, record: Optional[list] = None,
         name: str = "") -> torch.Tensor:
    """VALID conv; w ((k,)*3, Cin, Cout)."""
    wt = w.permute(4, 3, 0, 1, 2)
    if quant is not None:
        x, wt = quant(x), quant(wt)
    y = F.conv3d(x, wt, stride=stride)
    if quant is not None and hasattr(quant, "grad"):
        y = quant.grad(y)
    if record is not None:
        record.append({"name": name, "kind": "k%d" % w.shape[0],
                       "in_shape": tuple(x.shape), "kernel": tuple(w.shape),
                       "out_shape": tuple(y.shape)})
    return y


def conv_transpose(x: torch.Tensor, w: torch.Tensor, quant: Quant = None,
                   record: Optional[list] = None,
                   name: str = "") -> torch.Tensor:
    """TF-SAME k4 stride-2 transposed conv (out = 2 * in): the adjoint of a
    k4 s2 conv padded (1, 1); w ((4,)*3, Cin, Cout), taken as
    (Cin, Cout, 4, 4, 4) without a flip."""
    wt = w.permute(3, 4, 0, 1, 2)
    if quant is not None:
        x, wt = quant(x), quant(wt)
    y = F.conv_transpose3d(x, wt, stride=2, padding=1)
    if quant is not None and hasattr(quant, "grad"):
        y = quant.grad(y)
    if record is not None:
        record.append({"name": name, "kind": "transposed",
                       "in_shape": tuple(x.shape), "kernel": tuple(w.shape),
                       "out_shape": tuple(y.shape)})
    return y


def crop_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop of the spatial axes to ``size``; an odd excess goes to
    the high side."""
    lo = (x.shape[2] - size) // 2
    return x[:, :, lo:lo + size, lo:lo + size, lo:lo + size]


def crop(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` voxels off each face of every spatial axis."""
    return x[:, :, n:x.shape[2] - n, n:x.shape[3] - n, n:x.shape[4] - n]


def dropout(y: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``mask``: (B, D, H, W, C) uint8 bytes; kept (x2) where < 128."""
    if mask is None:
        return y
    keep = (mask < 128).permute(0, 4, 1, 2, 3)
    return torch.where(keep, y * 2.0, torch.zeros_like(y))


def draw_masks(gen: torch.Generator, rows: int, extent: int, wf: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two dropout byte tensors of one generator application on
    ``rows`` tiles of side ``extent``: up1's then up0's, in that order from
    ``gen``."""
    c1, c2 = 64 // wf, 128 // wf
    s = _sizes(extent)
    m1 = torch.randint(0, 256, (rows, s["up1"], s["up1"], s["up1"], c2),
                       generator=gen, device=device, dtype=torch.uint8)
    m0 = torch.randint(0, 256, (rows, s["up0"], s["up0"], s["up0"], c1),
                       generator=gen, device=device, dtype=torch.uint8)
    return m1, m0


def _sizes(n: int) -> Dict[str, int]:
    stem = n - 2
    skip0 = stem - 2
    down1 = (skip0 - 4) // 2 + 1
    skip1 = down1 - 2
    down2 = (skip1 - 4) // 2 + 1
    up1 = 2 * (down2 - 2)
    up0 = 2 * (up1 - 2 - 2)
    return {"up1": up1, "up0": up0, "out": up0 - 4}


def generator(p: Params, x: torch.Tensor,
              masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              quant: Quant = None, record: Optional[list] = None
              ) -> torch.Tensor:
    """(B, 1, S, S, S) -> (B, 1, S - 34, ..) float32; ``masks`` from
    :func:`draw_masks` (None: no dropout)."""
    k = {"quant": quant, "record": record}
    x = leaky(conv(x, p["stem.kernel"], name="stem", **k))
    skip0 = leaky(conv(x, p["down1.conv.kernel"], name="down1.conv", **k))
    x = leaky(conv(skip0, p["down1.down.kernel"], 2, name="down1.down", **k))
    skip1 = leaky(conv(x, p["down2.conv.kernel"], name="down2.conv", **k))
    x = leaky(conv(skip1, p["down2.down.kernel"], 2, name="down2.down", **k))
    x = leaky(conv(x, p["up1.conv.kernel"], name="up1.conv", **k))
    x = conv_transpose(x, p["up1.up.kernel"], name="up1.up", **k)
    up1 = leaky(dropout(x, None if masks is None else masks[0]))
    x = torch.cat([up1, crop_to(skip1, up1.shape[2])], 1)
    x = leaky(conv(x, p["mid.kernel"], name="mid", **k))
    x = leaky(conv(x, p["up0.conv.kernel"], name="up0.conv", **k))
    x = conv_transpose(x, p["up0.up.kernel"], name="up0.up", **k)
    up0 = leaky(dropout(x, None if masks is None else masks[1]))
    x = torch.cat([up0, crop_to(skip0, up0.shape[2])], 1)
    x = leaky(conv(x, p["head.kernel"], name="head", **k))
    return conv(x, p["out.kernel"], name="out", **k)


def discriminator(p: Params, x: torch.Tensor, quant: Quant = None,
                  record: Optional[list] = None) -> torch.Tensor:
    """(B, 1, 40, 40, 40) -> (B, 1, 1, 1, 1) patch logits."""
    k = {"quant": quant, "record": record}
    x = leaky(conv(x, p["down1.conv.kernel"], name="down1.conv", **k))
    x = leaky(conv(x, p["down1.down.kernel"], 2, name="down1.down", **k))
    x = leaky(conv(x, p["hack.kernel"], name="hack", **k))
    x = leaky(conv(x, p["down2.conv.kernel"], name="down2.conv", **k))
    x = leaky(conv(x, p["down2.down.kernel"], 2, name="down2.down", **k))
    x = leaky(conv(x, p["down3.conv.kernel"], name="down3.conv", **k))
    x = leaky(conv(x, p["down3.down.kernel"], 2, name="down3.down", **k))
    x = leaky(x)
    x = leaky(conv(x, p["head.kernel"], name="head", **k))
    return conv(x, p["out.kernel"], name="out", **k) + p["out.bias"].view(
        1, 1, 1, 1, 1)
