"""Building blocks: VALID conv stacks, the TF-exact transposed conv,
InstanceNorm and dropout.

Counterpart of ``transfer_em_tpu/models/blocks.py`` (reference
transfer_em/models/utils.py), as ``nn.Module``s.  Kernels are stored in the
JAX layout, ((k,) * ndim, Cin, Cout) under the name ``kernel``, so the
state_dict maps one to one onto the flax param tree (models/convert.py).
``ndim`` is the spatial rank, 3 (default) or 2; the JAX modules infer it
from the input, the port builds its kernels up front.

A block states what its conv is (kernel size, stride, padding, compute
dtype, bias, whether a LeakyReLU follows); ``ops/convs.py`` picks the
kernel that runs it (its module docstring has the routes).  A conv +
LeakyReLU without a bias passes the LeakyReLU to the conv, which fuses it
into the kernel's epilogue where its form has one; with a bias, the
LeakyReLU runs after the bias on the hand-written leaky_relu kernel
(ops/cuda_kernels.py).

``int8_conv`` (serving only, as in the JAX package, models/blocks.py:
62-66, 106-110, 143-147) is a configuration, not a route: every conv
quantizes its operands and runs on the hand-written int8 conv kernel
(ops/quant.py), as JAX's int8 branch comes before ``fast_conv``.  It
quantizes its input as it arrives (no cast to ``compute_dtype`` first, as
JAX's ``conv_nd_int8`` takes it) and dequantizes into the compute dtype;
a conv + LeakyReLU fuses the activation into the kernel's epilogue, on the
value rounded to that dtype.  No gradient.

LeakyReLU slope 0.3 (Keras default; torch's default is 0.01), rounded to
the activation's dtype as JAX's ``nn.leaky_relu`` rounds its Python scalar
(bf16: 0.30078125; :func:`leaky`), in the kernels' epilogues too.  Weight init
N(0, 0.02) (tf.random_normal_initializer(0, .02)), from an explicit
``torch.Generator``.  ``use_norm`` turns on the InstanceNorm call sites that
the reference comments out; it is off by default, as upstream.

``compute_dtype`` (None, or torch.bfloat16): every conv casts its input to
it at entry, as the JAX package's ``conv_nd`` does (ops/convs.py:50-61), and
keeps its output in it; the parameters stay float32.  So an f32 tensor that
reaches a bf16 block (InstanceNorm's output, which promotes to f32 as JAX's
``scale * x`` does, or a concatenation with such a skip) runs the next conv
in bf16 again.  None follows the input's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.convs import conv_nd, conv_transpose_nd
from ..ops.cuda_kernels import LEAKY_SLOPE, leaky_relu, slope_in
from ..ops.quant import conv_nd_int8, conv_transpose_nd_int8

WEIGHT_STD = 0.02

__all__ = ["LEAKY_SLOPE", "WEIGHT_INIT", "WEIGHT_STD", "ConvND",
           "ConvActND", "ConvTransposeND", "InstanceNorm", "DownBlock",
           "UpBlock", "dropout_half", "compute_dtype_of", "leaky"]

DTypeLike = Union[None, str, torch.dtype]


def compute_dtype_of(dtype: DTypeLike) -> Optional[torch.dtype]:
    """None / "float32" / torch.float32 -> None (plain f32); "bfloat16" /
    torch.bfloat16 -> torch.bfloat16."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    if dtype == torch.float32:
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    return dtype


def leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.3) as the JAX modules apply it: the slope in x's dtype
    (cuda_kernels.slope_in)."""
    return leaky_relu(x, slope_in(x.dtype))


def WEIGHT_INIT(shape, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, WEIGHT_STD) of ``shape``, drawn from ``generator`` (the global
    generator when None): the JAX package's ``WEIGHT_INIT``
    (``nn.initializers.normal(stddev=0.02)``), with a torch.Generator in
    place of its PRNG key."""
    w = torch.empty(shape, dtype=dtype)
    return w.normal_(0.0, WEIGHT_STD, generator=generator)


def _init_normal(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(WEIGHT_INIT(shape, generator))


class ConvND(nn.Module):
    """VALID (or ``padding="SAME"``) conv, channels last; kernel ((k,) *
    ndim, Cin, Cout); a ``bias`` (zeros at init) only with ``use_bias``
    (the discriminator's ``out``); ``int8_conv`` runs it on the int8
    kernel."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, *, padding: str = "VALID",
                 use_bias: bool = False, ndim: int = 3,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_conv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
        self.stride = stride
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.int8_conv = int8_conv
        self.kernel = _init_normal((kernel_size,) * ndim
                                   + (in_features, features), generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor, act: bool = False) -> torch.Tensor:
        """The conv, then with ``act`` LeakyReLU(0.3): passed to the conv
        where there is no bias, after the bias where there is one."""
        fuse = act and self.bias is None
        if self.int8_conv:
            dtype = self.compute_dtype or torch.float32
            y = conv_nd_int8(x, self.kernel, stride=self.stride,
                             padding=self.padding, out_dtype=dtype,
                             leaky=slope_in(dtype) if fuse else None)
        else:
            if self.compute_dtype is not None:
                x = x.to(self.compute_dtype)
            y = conv_nd(x, self.kernel, stride=self.stride,
                        padding=self.padding,
                        leaky=slope_in(x.dtype) if fuse else None)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return leaky(y) if act and not fuse else y


class ConvActND(ConvND):
    """Conv + LeakyReLU(0.3): ConvND with ``act``; same param tree (one
    ``kernel``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x, act=True)


class ConvTransposeND(nn.Module):
    """TF-exact stride-s SAME transposed conv (default k4 s2, the
    generator's); kernel ((kernel_size,) * ndim, Cin, Cout) in the
    transpose direction (TF stores (.., Cout, Cin): swap the last two axes
    to import it).  ``int8_conv`` runs it on the int8 kernel, as its phase
    decomposition."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 4, stride: int = 2, *, ndim: int = 3,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_conv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.int8_conv = int8_conv
        self.kernel = _init_normal((kernel_size,) * ndim
                                   + (in_features, features), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8_conv:
            return conv_transpose_nd_int8(
                x, self.kernel, stride=self.stride,
                out_dtype=self.compute_dtype or torch.float32)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return conv_transpose_nd(x, self.kernel, stride=self.stride)


class InstanceNorm(nn.Module):
    """Instance normalization over the spatial axes (reference
    utils.py:10-38).  ``scale`` is stored MINUS 1, as the flax module keeps
    it (init N(0, 0.02), applied as scale + 1); ``offset`` starts at 0.

    On a bf16 x, as ``jnp.mean`` / ``jnp.var`` take them: the mean and the
    variance summed in f32 and rounded to bf16, ``x - mean`` and the rsqrt
    in bf16, and the output float32 (the f32 ``scale`` promotes it)."""

    def __init__(self, features: int, epsilon: float = 1e-5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = _init_normal((features,), generator)
        self.offset = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        xf = x.to(torch.float32)
        mean = xf.mean(dim=axes, keepdim=True).to(x.dtype)
        var = xf.var(dim=axes, correction=0, keepdim=True).to(x.dtype)
        inv = torch.rsqrt(var + self.epsilon)
        return (self.scale + 1.0) * (x - mean) * inv + self.offset


class RowDraw:
    """A dropout generator for a shard of a larger batch: it draws the keep
    mask of the whole ``total``-row batch from ``generator``, as the
    unsharded application draws it, and keeps the rows ``rows`` (a 1-D
    index), so a data-parallel step gives every row the mask the
    single-device step gives it (parallel/dp.py).  ``get_state`` /
    ``set_state`` are the generator's, for remat's rewind."""

    def __init__(self, generator: torch.Generator, total: int,
                 rows: torch.Tensor):
        self.generator = generator
        self.total = int(total)
        self.rows = rows

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


def _keep_mask(y: torch.Tensor, generator) -> torch.Tensor:
    if isinstance(generator, RowDraw):
        full = torch.randint(0, 256, (generator.total,) + tuple(y.shape[1:]),
                             generator=generator.generator, device=y.device,
                             dtype=torch.uint8)
        return full.index_select(0, generator.rows.to(y.device)) < 128
    return torch.randint(0, 256, y.shape, generator=generator,
                         device=y.device, dtype=torch.uint8) < 128


class _KeepMask(torch.autograd.Function):
    """Dropout's keep mask where the network runs under ``torch.func.vmap``
    over stacked parameters (``ensemble_apps``): one generator per stacked
    network, each drawing its network's mask as that network's own
    application would (random ops inside vmap otherwise raise)."""

    @staticmethod
    def forward(y, generators):
        gen, = generators
        return _keep_mask(y, gen)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, _g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, y, generators):
        if len(generators) != info.batch_size:
            raise ValueError(f"{len(generators)} dropout generators for "
                             f"{info.batch_size} stacked networks")
        d = in_dims[0]
        return torch.stack([_keep_mask(y if d is None else y.select(d, i), g)
                            for i, g in enumerate(generators)]), 0


Generators = Union[torch.Generator, RowDraw,
                   Sequence[Union[torch.Generator, RowDraw]]]


def dropout_half(y: torch.Tensor, generator: Generators) -> torch.Tensor:
    """Dropout(0.5) as the JAX package's ``rbg8`` draws it: one random byte
    per element, kept where it is < 128 (probability 1/2 exactly), kept
    values scaled by 1/keep = 2.  The bytes come from ``generator`` (a
    torch.Generator on y's device, or a ``RowDraw`` of one), or, under
    ``torch.func.vmap`` over stacked networks, from one generator per
    network (a sequence); the
    TPU's bit stream is not reproduced, only its distribution."""
    if isinstance(generator, (torch.Generator, RowDraw)):
        keep = _keep_mask(y, generator)
    else:
        keep = _KeepMask.apply(y, tuple(generator))
    return torch.where(keep, y * 2.0, 0.0)


class DownBlock(nn.Module):
    """3x3 VALID conv -> LeakyReLU (skip tap) -> 4x4 s2 VALID conv ->
    LeakyReLU; returns (downsampled, skip) like reference ``downsample``
    (utils.py:41-85).  ``use_norm`` puts InstanceNorm (``norm1``, ``norm2``)
    before each LeakyReLU."""

    def __init__(self, in_features: int, features: int, *,
                 use_norm: bool = False, ndim: int = 3,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_conv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        k = {"ndim": ndim, "compute_dtype": compute_dtype,
             "int8_conv": int8_conv, "generator": g}
        self.use_norm = use_norm
        conv = ConvND if use_norm else ConvActND
        self.conv = conv(in_features, features, 3, **k)
        self.norm1 = InstanceNorm(features, generator=g) if use_norm else None
        self.down = ConvND(features, features, 4, stride=2, **k)
        self.norm2 = InstanceNorm(features, generator=g) if use_norm else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.use_norm:
            skip = leaky(self.norm1(self.conv(x)))
            return leaky(self.norm2(self.down(skip))), skip
        skip = self.conv(x)
        return self.down(skip, act=True), skip


class UpBlock(nn.Module):
    """3x3 VALID conv (2x filters) -> LeakyReLU -> 4x4 s2 SAME convT ->
    Dropout(0.5) -> LeakyReLU (reference utils.py:89-137).  Dropout runs
    only with ``deterministic=False``, from ``dropout_generator``, and not
    at all with ``apply_dropout=False``; ``use_norm`` puts InstanceNorm
    ``norm1`` before the first LeakyReLU."""

    def __init__(self, in_features: int, features: int, *,
                 use_norm: bool = False, apply_dropout: bool = True,
                 ndim: int = 3, compute_dtype: Optional[torch.dtype] = None,
                 int8_conv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        k = {"ndim": ndim, "compute_dtype": compute_dtype,
             "int8_conv": int8_conv, "generator": g}
        self.use_norm = use_norm
        self.apply_dropout = apply_dropout
        conv = ConvND if use_norm else ConvActND
        self.conv = conv(in_features, features * 2, 3, **k)
        self.norm1 = (InstanceNorm(features * 2, generator=g) if use_norm
                      else None)
        self.up = ConvTransposeND(features * 2, features, **k)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                dropout_generator: Optional[Generators] = None
                ) -> torch.Tensor:
        y = self.conv(x)
        if self.use_norm:
            y = leaky(self.norm1(y))
        y = self.up(y)
        if self.apply_dropout and not deterministic:
            if dropout_generator is None:
                raise ValueError("UpBlock: deterministic=False needs a "
                                 "dropout_generator")
            y = dropout_half(y, dropout_generator)
        return leaky(y)
