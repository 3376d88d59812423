"""The CycleGAN train step, 3D or 2D (counterpart of
transfer_em_tpu/train/cgan.py:79-403, reference transfer_em/cgan.py:
144-228).

One step runs the two generators four times (``batched_apps``: round 1 runs
each generator once on 2B tiles, round 2 the two cycles) and the two
discriminators four times, sums the four losses into ONE scalar with the
reference's gradient routing, takes ONE ``backward()`` and applies four
Keras-exact Adam updates in place:

* fakes enter the discriminator losses detached (the discriminators learn,
  the generators do not through that term);
* the generators' adversarial terms see the discriminators FROZEN: their
  parameters go in detached through ``torch.func.functional_call``, so the
  gradient reaches the fakes and not the discriminators;
* the cycle loss appears once and reaches both generators.

In 3D every k3 conv runs on the conv3 kernels and every standalone
LeakyReLU on the leaky_relu kernel, through their autograd Functions
(backward in plain torch: cuDNN's conv gradients in the operands' dtype,
as ``lax.conv``'s VJP in the JAX package).  In 2D
(``CycleGANConfig(is3d=False)``) every conv runs on cuDNN, as the JAX
package leaves its 2D convs to XLA, and every LeakyReLU on the leaky_relu
kernel.  ``compute_dtype="bfloat16"`` runs every conv in bf16 (f32 sums)
with float32 parameters, network outputs, losses and Adam, as the JAX
package's bf16 step does.  Each generator application draws its dropout
masks from a torch.Generator of its own on the batch's device, seeded from
(seed, step, application), as the JAX step splits its key per application:
the same seed and step give the same masks, but not the JAX package's bits.

The JAX package's opt-ins: ``remat`` (each generator application under
``torch.utils.checkpoint``, its dropout generator rewound for the
recompute), ``ensemble_apps`` (G and F, and Dx and Dy where their
parameter shapes match, stacked and run as one ``torch.func.vmap`` each
round) and the scan window (``make_scan_train_step``,
``EM2EM.train(scan_window=k)``).

``EM2EM`` (transfer_em_tpu/train/cgan.py:476-872) drives the step from
the data pipelines, with checkpoints (``train/checkpoints.py``) and metrics
(``train/metrics.py``); ``EM2EM.from_reference_checkpoint`` continues a
reference TF run (``compat``); ``create_prior_helper`` taps an exported
generator or a reference Keras asset for ``disc_prior``.  ``EM2EM.to_mesh``
and ``make_scan_train_step(mesh=)`` train data-parallel over a device mesh
(``parallel/dp.py``).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap
from torch.utils.checkpoint import checkpoint

from ..config import CycleGANConfig
from ..device import resolve_device
from ..models.discriminator import Discriminator
from ..models.generator import UNetGenerator
from ..ops import losses as L
from ..ops.convs import center_crop, zero_pad
from ..rng import derive_seed
from ..shapes import generator_shapes, is_valid_dimsize
from ..telemetry import span
from .checkpoints import (CheckpointManager, load_into, read_checkpoint,
                          snapshot)
from .state import CycleGANState, make_optimizer

# (7,) [g_gen_total, f_gen_total, disc_y, disc_x, g_gen_only, f_gen_only,
# cycle], as the JAX package orders it
LossVector = torch.Tensor


class _Tapped(Exception):
    """Ends a prior's forward at its tapped layer."""


def _tap_prior(gen: UNetGenerator, last_layer: str) -> Callable:
    """Weight-frozen intermediate tap of a generator, to pass as a
    discriminator's ``disc_prior`` (transfer_em_tpu/train/cgan.py:79-108).

    The prior's WEIGHTS never update: they go in detached, and they are not
    parameters of any network in the train state.  Its INPUT gradient flows,
    as TF's ``trainable = False`` lets it (reference cgan.py:29): the
    generator's adversarial loss through disc_y includes the path through
    the prior.  The returned callable runs ``gen`` up to the submodule
    ``last_layer`` (a DownBlock gives its downsampled output) and carries
    ``channels``, the tap's width, and ``params``, the generator's detached
    parameters by name (``compat`` holds a checkpoint's stored prior
    weights against them)."""
    sub = gen.get_submodule(last_layer)
    kernels = [p for n, p in sub.named_parameters() if n.endswith("kernel")]

    def prior(x: torch.Tensor) -> torch.Tensor:
        out = []

        def hook(_mod, _inp, o):
            out.append(o[0] if isinstance(o, tuple) else o)
            raise _Tapped

        handle = sub.register_forward_hook(hook)
        try:
            functional_call(gen, {k: v.detach()
                                  for k, v in gen.named_parameters()}, (x,))
        except _Tapped:
            pass
        finally:
            handle.remove()
        return out[0]

    def on(device) -> Callable:
        """This prior with tensors of its own on ``device`` (itself where
        they already are): a data-parallel replica of disc_y runs its
        prior on its own device (parallel/mesh.py ``replicas``)."""
        device = torch.device(device)
        if next(gen.parameters()).device == device:
            return prior
        with torch.no_grad():
            return _tap_prior(copy.deepcopy(gen).to(device), last_layer)

    prior.channels = int(kernels[-1].shape[-1])
    prior.params = {k: v.detach() for k, v in gen.named_parameters()}
    prior.on = on
    return prior


def build_models(config: CycleGANConfig, disc_prior: Optional[Callable] = None,
                 *, generator: Optional[torch.Generator] = None
                 ) -> Tuple[UNetGenerator, UNetGenerator, Discriminator,
                            Discriminator]:
    """G, F and the two discriminators, of ``config.is3d``'s rank and
    ``config.compute_dtype`` (disc_y optionally with a prior, reference
    cgan.py:58-62), initialised on the CPU from ``generator``.

    A prior with bfloat16 raises TypeError, as the JAX package does when
    its create_state initialises the discriminator: the discriminator casts
    its input to bf16 and hands it to the prior, a float32 generator, and
    ``lax.conv_general_dilated`` refuses a bf16 input with a float32
    kernel."""
    _check_prior(config, disc_prior)
    k = {"wf": config.wf, "is3d": config.is3d, "use_norm": config.use_norm,
         "compute_dtype": config.compute_dtype, "generator": generator}
    gg = UNetGenerator(**k)
    gf = UNetGenerator(**k)
    dx = Discriminator(**k)
    dy = Discriminator(**k, disc_prior=disc_prior,
                       prior_channels=(disc_prior.channels if disc_prior
                                       else 0))
    return gg, gf, dx, dy


def create_state(config: CycleGANConfig, seed: int = 0, device="cuda",
                 disc_prior: Optional[Callable] = None) -> CycleGANState:
    """All four networks, initialised from ``seed`` (N(0, 0.02) weights drawn
    on the CPU in the order G, F, Dx, Dy, then moved to ``device``), and
    four fresh Adam states."""
    dev = resolve_device(device)
    if config.dimsize < 74:
        raise ValueError("minimum dimension allowed is 74")  # cgan.py:52
    if not is_valid_dimsize(config.dimsize):
        raise ValueError(f"{config.dimsize} does not allow valid convolutions")
    nets = [n.to(dev) for n in build_models(
        config, disc_prior, generator=torch.Generator().manual_seed(seed))]
    opt = make_optimizer(config.learning_rate, config.adam_beta1)
    opts = [opt.init(dict(n.named_parameters())) for n in nets]
    return CycleGANState(0, *nets, *opts)


def _frozen(net: torch.nn.Module) -> Callable:
    """net with its parameters detached: gradients reach the input only."""
    params = {k: v.detach() for k, v in net.named_parameters()}
    return lambda x: functional_call(net, params, (x,))


Params = Dict[str, torch.Tensor]


def _stacked(a: torch.nn.Module, b: torch.nn.Module) -> Params:
    """a's and b's parameters stacked on a new leading axis, by a's names
    (the two share one architecture); gradients reach both."""
    return {k: torch.stack([p, q]) for (k, p), q in
            zip(a.named_parameters(), b.parameters())}


def _same_tree(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    """The two networks' parameters have the same names and shapes (a
    disc_prior widens disc_y's down3)."""
    return ([(k, p.shape) for k, p in a.named_parameters()]
            == [(k, p.shape) for k, p in b.named_parameters()])


def cyclegan_losses(gg: UNetGenerator, gf: UNetGenerator, dx: Discriminator,
                    dy: Discriminator, buffer: int, gamma: float,
                    real_x: torch.Tensor, real_y: torch.Tensor,
                    dropout_generators: Optional[Sequence[torch.Generator]]
                    = None, *, batched_apps: bool = True,
                    ensemble_apps: bool = False, deterministic: bool = False,
                    remat: bool = False) -> Tuple[torch.Tensor, LossVector]:
    """One combined scalar whose gradient w.r.t. each network equals the
    reference's four ``tape.gradient`` calls (cgan.py:144-215), and the
    7-loss vector (transfer_em_tpu/train/cgan.py:168-330).

    ``batched_apps=False`` runs the reference's six separate generator
    applications (same math).  ``ensemble_apps`` stacks G and F (and Dx and
    Dy where their parameter shapes match) and runs each round as one
    ``torch.func.vmap`` over ``functional_call`` with the stacked
    parameters: the same math as batched_apps, in fewer, wider calls.
    ``remat`` runs each generator application under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of kept, with the same masks and the same gradients.
    ``deterministic`` turns dropout off (tests); otherwise
    ``dropout_generators`` holds one generator per generator application,
    in the JAX package's key order: G and F on round 1, then G and F on
    the cycles (4), or the reference's six applications in order."""
    B = real_x.shape[0]
    if deterministic:
        gens = [None] * 6
    elif dropout_generators is None:
        raise ValueError("dropout on needs dropout_generators, one per "
                         "generator application")
    else:
        gens = list(dropout_generators)

    def run(fn, x, k):
        """fn(x, k), under remat checkpointed; the recompute rewinds the
        application's dropout generators, which the checkpoint's own RNG
        bookkeeping (the default generators only) would not."""
        if not remat:
            return fn(x, k)
        owned = [] if deterministic else (
            list(k) if isinstance(k, (tuple, list)) else [k])
        states = [gen.get_state() for gen in owned]

        def replay(x_):
            for gen, st in zip(owned, states):
                gen.set_state(st)
            return fn(x_, k)

        return checkpoint(replay, x, use_reentrant=False,
                          preserve_rng_state=False)

    def kw(k):
        return {"deterministic": deterministic, "dropout_generator": k}

    def g(net):
        return lambda x, k: net(x, **kw(k))

    # the crops feed the conv3 kernels, which read contiguous tensors
    real_x_c = center_crop(real_x, buffer).contiguous()
    real_y_c = center_crop(real_y, buffer).contiguous()
    real_x_c2 = center_crop(real_x, buffer * 2)
    real_y_c2 = center_crop(real_y, buffer * 2)

    if ensemble_apps:
        st_gen = _stacked(gg, gf)

        def gens_fn(x, k):
            return vmap(lambda p, xx: functional_call(gg, p, (xx,), kw(k)))(
                st_gen, x)

        def pair(i, j):
            return None if deterministic else (gens[i], gens[j])

        out1 = run(gens_fn, torch.stack([torch.cat([real_x, real_y], 0),
                                         torch.cat([real_y, real_x], 0)]),
                   pair(0, 1))
        fake_y, same_y = out1[0, :B], out1[0, B:]
        fake_x, same_x = out1[1, :B], out1[1, B:]
        out2 = run(gens_fn, torch.stack([zero_pad(fake_x, buffer),
                                         zero_pad(fake_y, buffer)]),
                   pair(2, 3))
        cycled_y, cycled_x = out2[0], out2[1]
    elif batched_apps:
        # round 1: everything from the real images, one apply a network
        out_g1 = run(g(gg), torch.cat([real_x, real_y], 0), gens[0])
        fake_y, same_y = out_g1[:B], out_g1[B:]
        out_f1 = run(g(gf), torch.cat([real_y, real_x], 0), gens[1])
        fake_x, same_x = out_f1[:B], out_f1[B:]
        # round 2: the cycles
        cycled_y = run(g(gg), zero_pad(fake_x, buffer), gens[2])
        cycled_x = run(g(gf), zero_pad(fake_y, buffer), gens[3])
    else:
        # the reference's structure (cgan.py:152-183)
        fake_y = run(g(gg), real_x, gens[0])
        cycled_x = run(g(gf), zero_pad(fake_y, buffer), gens[1])
        fake_x = run(g(gf), real_y, gens[2])
        cycled_y = run(g(gg), zero_pad(fake_x, buffer), gens[3])
        same_x = run(g(gf), real_x, gens[4])
        same_y = run(g(gg), real_y, gens[5])

    if ensemble_apps and _same_tree(dx, dy):
        st_disc = _stacked(dx, dy)

        def discs(params, x):
            return vmap(lambda p, xx: functional_call(dx, p, (xx,)))(params, x)

        dout = discs(st_disc, torch.stack([
            torch.cat([real_x_c, fake_x.detach()], 0),
            torch.cat([real_y_c, fake_y.detach()], 0)]))
        disc_real_x, disc_fake_x_d = dout[0, :B], dout[0, B:]
        disc_real_y, disc_fake_y_d = dout[1, :B], dout[1, B:]
        gout = discs({k: v.detach() for k, v in st_disc.items()},
                     torch.stack([fake_x, fake_y]))
        disc_fake_x_gen, disc_fake_y_gen = gout[0], gout[1]
    else:
        if batched_apps or ensemble_apps:
            out_dx = dx(torch.cat([real_x_c, fake_x.detach()], 0))
            disc_real_x, disc_fake_x_d = out_dx[:B], out_dx[B:]
            out_dy = dy(torch.cat([real_y_c, fake_y.detach()], 0))
            disc_real_y, disc_fake_y_d = out_dy[:B], out_dy[B:]
        else:
            disc_real_x = dx(real_x_c)
            disc_real_y = dy(real_y_c)
            disc_fake_x_d = dx(fake_x.detach())
            disc_fake_y_d = dy(fake_y.detach())
        disc_fake_x_gen = _frozen(dx)(fake_x)
        disc_fake_y_gen = _frozen(dy)(fake_y)
    cycled_x_c = center_crop(cycled_x, buffer)
    cycled_y_c = center_crop(cycled_y, buffer)

    # losses (reference cgan.py:192-203)
    gen_g_loss = L.generator_adv_loss(disc_fake_y_gen, gamma=gamma)
    gen_f_loss = L.generator_adv_loss(disc_fake_x_gen, gamma=gamma)
    total_cycle = (L.cycle_loss(real_x_c2, cycled_x_c, gamma=gamma)
                   + L.cycle_loss(real_y_c2, cycled_y_c, gamma=gamma))
    id_y = L.identity_loss(real_y_c, same_y, gamma=gamma)
    id_x = L.identity_loss(real_x_c, same_x, gamma=gamma)
    total_gen_g = gen_g_loss + total_cycle + id_y
    total_gen_f = gen_f_loss + total_cycle + id_x
    disc_x_loss = L.discriminator_loss(disc_real_x, disc_fake_x_d, gamma=gamma)
    disc_y_loss = L.discriminator_loss(disc_real_y, disc_fake_y_d, gamma=gamma)

    # the cycle term appears ONCE: its gradient reaches both generators, as
    # it does through both total_gen losses upstream
    combined = (gen_g_loss + gen_f_loss + total_cycle + id_y + id_x
                + disc_x_loss + disc_y_loss)
    loss_vec = torch.stack([total_gen_g, total_gen_f, disc_y_loss,
                            disc_x_loss, gen_g_loss, gen_f_loss,
                            total_cycle]).detach()
    return combined, loss_vec


def _dropout_generators(device: torch.device, seed: int, step: int,
                        micro: Optional[int] = None) -> list:
    """The dropout masks' generators for one step (and microbatch), one per
    generator application: seeded from (seed, step[, micro], application),
    as the JAX step folds the step (and the microbatch index) into its key
    and splits it per application."""
    words = [seed, step] if micro is None else [seed, step, micro]
    return [torch.Generator(device=device).manual_seed(
        derive_seed(*words, app)) for app in range(6)]


def _check_prior(config: CycleGANConfig, disc_prior: Optional[Callable]
                 ) -> None:
    """A ``disc_prior`` must be a callable (a device or a flag in its
    place is a positional slip), and is refused with bfloat16."""
    if disc_prior is None:
        return
    if not callable(disc_prior):
        raise TypeError(f"disc_prior must be a callable prior (a "
                        f"create_prior_helper result) or None, got "
                        f"{disc_prior!r}; pass the other options by keyword")
    if config.compute_dtype == "bfloat16":
        raise TypeError(
            "compute_dtype='bfloat16' with a disc_prior: the bf16 "
            "discriminator input meets the prior's float32 kernels (the JAX "
            "package raises this TypeError too)")


def _check_state_prior(disc_prior: Optional[Callable],
                       state: CycleGANState) -> None:
    """A step given ``disc_prior`` trains with that prior or not at all:
    the state's disc_y must hold it (the same callable, or a tap of equal
    weights, ``params``)."""
    if disc_prior is None:
        return
    held = state.dy.disc_prior
    if held is None:
        raise ValueError("the step got a disc_prior, but the state's disc_y "
                         "was built without one: make the state with "
                         "create_state(..., disc_prior=...)")
    if held is disc_prior:
        return
    a = getattr(held, "params", None)
    b = getattr(disc_prior, "params", None)
    if (a is None or b is None or a.keys() != b.keys()
            or any(a[k].shape != b[k].shape or not torch.equal(
                a[k], b[k].to(a[k].device)) for k in a)):
        raise ValueError("the step's disc_prior is not the one in the "
                         "state's disc_y: make the state with "
                         "create_state(..., disc_prior=) of the same prior")


def build_step_fn(config: CycleGANConfig,
                  disc_prior: Optional[Callable] = None, *,
                  batched_apps: bool = True,
                  deterministic: bool = False) -> Callable:
    """The train step: ``step(state, real_x, real_y, seed) -> loss7``,
    updating ``state`` in place (parameters, Adam states, ``step``).

    ``disc_prior`` is the JAX signature's (``build_step_fn(config,
    disc_prior)``): the port's prior rides in the state's disc_y
    (``create_state(config, seed, disc_prior=...)``), so given here each
    step checks it against the state's: a state whose disc_y holds no
    prior, or another prior, is refused.  The options after it are keyword-only.

    real_x / real_y: standardized float32 batches (B, D, H, W, 1), or
    (B, H, W, 1) in 2D, of ``config.dimsize``, on the state's device.  ``config.accum_steps > 1``
    splits the batch into that many microbatches, runs one backward each
    (the gradients add up in ``p.grad``), averages, and applies ONE update:
    full-batch math, since every loss is a per-sample mean.  ``seed`` with
    the state's step count seeds the dropout masks; ``deterministic`` turns
    dropout off (tests).  ``config.remat`` and ``config.ensemble_apps``
    select those forms of :func:`cyclegan_losses`."""
    _check_prior(config, disc_prior)
    accum = int(config.accum_steps)
    if accum < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum}")
    buffer = generator_shapes(config.dimsize).buffer
    gamma = config.focal_gamma
    opt = make_optimizer(config.learning_rate, config.adam_beta1)

    @span("train.step")
    def step(state: CycleGANState, real_x: torch.Tensor,
             real_y: torch.Tensor, seed: int) -> LossVector:
        _check_state_prior(disc_prior, state)
        B = real_x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by accum_steps {accum}")
        nets = (state.gg, state.gf, state.dx, state.dy)
        for net in nets:
            net.zero_grad(set_to_none=True)
        micro = B // accum
        loss_sum = None
        dev = real_x.device
        for i in range(accum):
            gens = None if deterministic else _dropout_generators(
                dev, seed, state.step, i if accum > 1 else None)
            part = slice(i * micro, (i + 1) * micro)
            with span("train.forward", dev):
                combined, lv = cyclegan_losses(
                    *nets, buffer, gamma, real_x[part], real_y[part], gens,
                    batched_apps=batched_apps,
                    ensemble_apps=config.ensemble_apps,
                    deterministic=deterministic, remat=config.remat)
            with span("train.backward", dev):
                combined.backward()
            loss_sum = lv if loss_sum is None else loss_sum + lv
        with span("train.adam", dev):
            if accum > 1:
                for net in nets:
                    for p in net.parameters():
                        if p.grad is not None:
                            p.grad.div_(accum)
                loss_sum = loss_sum / accum
            for net, o in zip(nets, (state.opt_gg, state.opt_gf,
                                     state.opt_dx, state.opt_dy)):
                opt.update_module(net, o)
        state.step += 1
        return loss_sum

    return step


def make_train_step(config: CycleGANConfig,
                    disc_prior: Optional[Callable] = None, *,
                    device="cuda") -> Callable:
    """The train step on ``device`` (default ``cuda``; raises where it is
    absent): ``step(state, real_x, real_y, seed) -> loss7``, with the
    batches moved to the device and the state checked to be there.
    ``disc_prior``: as :func:`build_step_fn` takes it."""
    _check_prior(config, disc_prior)
    dev = resolve_device(device)
    step = build_step_fn(config, disc_prior)

    def run(state: CycleGANState, real_x, real_y, seed: int) -> LossVector:
        where = next(state.gg.parameters()).device
        if where != dev:
            raise ValueError(f"state is on {where}, the step on {dev}")
        return step(state, torch.as_tensor(real_x).to(dev),
                    torch.as_tensor(real_y).to(dev), seed)

    return run


def make_scan_train_step(config: CycleGANConfig, window: int,
                         disc_prior: Optional[Callable] = None,
                         device="cuda", mesh=None) -> Callable:
    """``window`` consecutive optimization steps in one call (JAX
    ``make_scan_train_step``, transfer_em_tpu/train/cgan.py:419-473):
    ``scan(state, xs, ys, seed) -> (window, 7)`` losses, with xs / ys the
    window's batches stacked, (window, B, *spatial, 1).  Step i equals the
    i-th of ``window`` sequential ``make_train_step`` calls: the same
    (seed, step) dropout seeds and the same updates.  The JAX package scans
    the step on the device in one dispatch; eager PyTorch has no dispatch
    to save, so this is a loop over the window with the same numbers.  The
    prior, if any, rides in the state's disc_y; ``disc_prior`` is checked
    as :func:`build_step_fn` checks it.  ``mesh``: each step is the data-parallel
    step over it (``parallel.make_dp_train_step``), the stacked batches
    split on their axis 1, and ``device`` is unused."""
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if mesh is None:
        step = make_train_step(config, disc_prior, device=device)
    else:
        from ..parallel.dp import make_dp_train_step
        _check_prior(config, disc_prior)
        step = make_dp_train_step(config, mesh)

    def scan(state: CycleGANState, xs, ys, seed: int) -> torch.Tensor:
        _check_state_prior(disc_prior, state)
        if len(xs) != window or len(ys) != window:
            raise ValueError(f"stacked batches have leading dim {len(xs)}/"
                             f"{len(ys)}, expected window={window}")
        return torch.stack([step(state, xs[i], ys[i], seed)
                            for i in range(window)])

    return scan


def create_prior_helper(model_dir: str, last_layer: str, device="cuda"
                        ) -> Callable:
    """A weight-frozen tap of a generator's ``last_layer`` submodule, to
    pass as ``disc_prior`` (transfer_em_tpu/train/cgan.py:48-76, reference
    cgan.py:21-29), loaded onto ``device`` (default ``cuda``).
    ``model_dir`` is the port's export (generator.npz + meta.json), the JAX
    package's (generator.msgpack + meta.json), or a reference-architecture
    Keras asset (``.h5`` / ``.keras`` file or SavedModel directory, through
    ``compat``).  A 2D generator gives a 2D prior, for a 2D
    discriminator."""
    if (model_dir.endswith((".h5", ".keras"))
            or os.path.exists(os.path.join(model_dir, "saved_model.pb"))):
        from ..compat import prior_from_tf_generator
        return prior_from_tf_generator(model_dir, last_layer, device)
    from ..infer.export import load_generator

    gen, _ = load_generator(model_dir, device=device)
    return _tap_prior(gen, last_layer)


class BoundModel:
    """A network of the live train state, callable as the reference's Keras
    model attributes are (cgan.py:58-62): a forward with the CURRENT
    parameters, without gradients, on the model's device.  ``.module`` is
    the ``nn.Module``, ``.params`` its parameters by name."""

    def __init__(self, module: torch.nn.Module, device: torch.device):
        self.module = module
        self._device = device

    @property
    def params(self):
        return dict(self.module.named_parameters())

    def __call__(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.module(torch.as_tensor(x).to(self._device))


class EM2EM:
    """CycleGAN model for 1-channel 3D (or, ``is3d=False``, 2D) data: train
    and predict (counterpart of transfer_em_tpu/train/cgan.py:476-872,
    reference cgan.py:32-293).

    The constructor keeps the JAX package's arguments and adds ``device``
    (default ``cuda``; raises where it is absent).  ``norm_type`` is
    deprecated upstream and ``dropout_impl`` selects nothing here (dropout
    masks come from torch.Generators seeded from (seed, step, application)).
    ``compute_dtype="bfloat16"`` trains and predicts with the bf16
    networks; the state, and so every checkpoint, is float32 in both
    dtypes, and a checkpoint of either restores into the other.
    ``to_mesh`` trains data-parallel over a device mesh; the state, and so
    every checkpoint, stays one copy.

    Checkpoints (``train/checkpoints.py``): ``torch.save`` files under
    ``<checkpoint_root>/train_<exp_name>/<epoch>/``, written on a background
    thread from a synchronous host copy, committed by rename, at most 50
    kept.  The latest committed one is restored at construction, unless
    ``ckpt_restore`` (a step or a step directory of any experiment) names
    another.
    """

    def __init__(self, dimsize: int, exp_name: str, is3d: bool = True,
                 norm_type: str = "instancenorm",
                 ckpt_restore: Optional[str] = None, wf: int = 8,
                 focal_gamma: float = 2.0,
                 disc_prior: Optional[Callable] = None,
                 compute_dtype: str = "float32",
                 checkpoint_root: str = "./checkpoints",
                 seed: int = 0, remat: bool = False,
                 ensemble_apps: bool = False, accum_steps: int = 1,
                 dropout_impl: str = "rbg8", device="cuda"):
        del norm_type, dropout_impl
        self.device = resolve_device(device)
        self.config = CycleGANConfig(
            dimsize=dimsize, is3d=is3d, wf=wf, focal_gamma=focal_gamma,
            compute_dtype=compute_dtype, remat=remat,
            ensemble_apps=ensemble_apps, accum_steps=accum_steps)
        self.exp_name = exp_name
        self.is3d = is3d
        self.disc_prior = disc_prior
        self.seed = seed
        self.state = create_state(self.config, seed, self.device, disc_prior)
        shapes = generator_shapes(dimsize)
        if shapes.out % 2:  # cgan.py:64
            raise ValueError(f"dimsize {dimsize} gives an odd output size")
        self.buffer = shapes.buffer
        self.outdimsize = shapes.out
        self.mesh = None
        self._train_step = make_train_step(self.config, device=self.device)

        self.checkpoint_path = os.path.abspath(
            os.path.join(checkpoint_root, f"train_{exp_name}"))
        self._ckpt = CheckpointManager(self.checkpoint_path, max_to_keep=50)
        if ckpt_restore is not None:
            self.restore(ckpt_restore)
        elif self._ckpt.latest_step() is not None:
            self.restore(self._ckpt.latest_step())
            print("Latest checkpoint restored!!")

    # ------------------------------------------------------------------ ckpt
    def make_checkpoint(self, epoch_num: int) -> None:
        """Save the state as step ``epoch_num`` (reference cgan.py:105-108):
        a synchronous host copy now, written and committed on the
        background writer.  ``wait_until_finished`` drains it.  On a mesh
        that spans processes only rank 0 writes (every process holds the
        same state)."""
        from ..parallel.mesh import process_rank
        if self.mesh is not None and process_rank() != 0:
            return
        self._ckpt.save(epoch_num, snapshot(self.state))
        print(f"Saving checkpoint for epoch {epoch_num} at "
              f"{self.checkpoint_path}/{epoch_num}")

    def wait_until_finished(self) -> None:
        """Block until the checkpoint in flight, if any, is committed."""
        self._ckpt.wait_until_finished()

    def restore(self, ckpt_restore) -> None:
        """Restore a checkpoint into the live state, in place: a step
        number of this experiment, or a step directory
        ``.../train_<exp>/<step>`` of any experiment (reference
        cgan.py:98-100)."""
        self.wait_until_finished()
        s = str(ckpt_restore).rstrip(os.sep)
        if isinstance(ckpt_restore, int) or os.sep not in s:
            path = self._ckpt.step_path(int(s))
        else:
            path = os.path.abspath(s)
        load_into(self.state, read_checkpoint(path))
        print(f"checkpoint {ckpt_restore} restored")

    @classmethod
    def from_reference_checkpoint(cls, ckpt_path: str, exp_name: str,
                                  dimsize: int = 74,
                                  disc_prior: Optional[Callable] = None,
                                  **kwargs) -> "EM2EM":
        """Continue a REFERENCE training run here: an EM2EM whose
        parameters, Adam moments and counts and step come from a reference
        ``tf.train.Checkpoint`` (reference cgan.py:86-103; read by
        ``compat.load_reference_checkpoint``, either TF layout;
        transfer_em_tpu/train/cgan.py:589-627).  ``wf`` and 2D/3D come from
        the weights; the other keyword arguments go to ``__init__``
        (checkpoint_root, compute_dtype, device, ...).  ``disc_prior``: the
        frozen feature extractor the run was trained with, if any."""
        from ..compat import load_reference_checkpoint
        device = kwargs.get("device", "cuda")
        state, wf, is3d = load_reference_checkpoint(ckpt_path, disc_prior,
                                                    device)
        model = cls(dimsize, exp_name, is3d=is3d, wf=wf,
                    disc_prior=disc_prior, **kwargs)
        if model._ckpt.latest_step() is not None:
            raise ValueError(
                f"experiment {exp_name!r} already has checkpoints at "
                f"{model.checkpoint_path} (they would collide with the "
                "imported run's step numbering) — pass a fresh exp_name, "
                "or restore the existing run with EM2EM(...) directly")
        with torch.no_grad():
            for tree in ("gg", "gf", "dx", "dy"):
                dst = dict(getattr(model.state, tree).named_parameters())
                src = dict(getattr(state, tree).named_parameters())
                if ({k: tuple(v.shape) for k, v in dst.items()}
                        != {k: tuple(v.shape) for k, v in src.items()}):
                    raise ValueError(
                        f"imported {tree} does not match the built model")
                for k, p in dst.items():
                    p.copy_(src[k])
                setattr(model.state, "opt_" + tree,
                        getattr(state, "opt_" + tree))
        model.state.step = state.step
        return model

    def to_mesh(self, mesh=None) -> "EM2EM":
        """Train data-parallel over ``mesh`` (default: ``make_mesh()``, every
        local card): the state moves to the mesh's first device of this
        process (``parallel.shard_state``; rank 0's copy on every process)
        and ``train_step`` becomes ``parallel.make_dp_train_step``'s, each
        batch split over the mesh.  Returns self."""
        from ..parallel import make_mesh
        from ..parallel.dp import (first_local_device, make_dp_train_step,
                                   shard_state)
        if mesh is None:
            mesh = make_mesh()
        shard_state(self.state, mesh)
        self.mesh = mesh
        self.device = first_local_device(mesh)
        self._train_step = make_dp_train_step(self.config, mesh,
                                              self.disc_prior)
        return self

    # ----------------------------------------------------------------- train
    def train_step(self, real_x, real_y) -> torch.Tensor:
        """One optimization step; returns the 7-loss vector on the device
        (cgan.py:144).  On a mesh the batches are the global ones, split
        over it."""
        return self._train_step(self.state, real_x, real_y, self.seed)

    def train(self, train_input: Iterable, train_target: Iterable,
              epochs: int = 3000, start: int = 0, debug: bool = False,
              sample=None, sample_gt=None, enable_eager: bool = False,
              num_samples: int = 4096, check_freq: int = 1,
              metrics_log: Optional[str] = None,
              profile_dir: Optional[str] = None,
              scan_window: int = 1) -> None:
        """The training loop (reference cgan.py:242-287).

        train_input / train_target: batches, re-iterable per epoch (the
        data pipelines, or any pair of iterables of float batches).  Each
        epoch's loss is summed on the device and read once, at its end.
        Every ``check_freq`` epochs a checkpoint is made; with ``debug`` and
        a ``sample`` the sample is predicted, scored against ``sample_gt``
        and written as ``<exp_name>_sample.png``.  ``metrics_log``: a JSONL
        path for per-epoch losses and timing; ``profile_dir``: a
        torch.profiler trace of the run, with the port's spans
        (``telemetry``): ``train.data_wait`` around each wait for a batch
        pair, ``train.step`` and the layers under it.  ``enable_eager`` is
        accepted and changes nothing: the port runs eagerly anyway.
        ``scan_window``: the JAX package runs that many steps per device
        dispatch (:func:`make_scan_train_step`); eager PyTorch has no
        dispatch to save, so every batch runs as a single step, which gives
        the numbers of a scan window."""
        from .metrics import MetricsLogger, profile_trace

        del enable_eager
        int(scan_window)  # what the JAX package accepts
        logger = MetricsLogger(metrics_log)
        pbar = None
        try:
            with profile_trace(profile_dir):
                for epoch in range(start, start + epochs):
                    t0 = time.time()
                    pbar = None
                    if debug:
                        try:  # progress bar (reference cgan.py:256-262)
                            import tqdm
                            pbar = tqdm.tqdm(total=num_samples)
                        except ImportError:
                            pass
                    loss_acc, count = None, 0
                    pairs = zip(train_input, train_target)
                    while True:
                        with span("train.data_wait"):
                            pair = next(pairs, None)
                        if pair is None:
                            break
                        lv = self.train_step(*pair)
                        loss_acc = lv if loss_acc is None else loss_acc + lv
                        count += 1
                        if pbar is not None:
                            pbar.update(1)
                    if pbar is not None:
                        pbar.close()
                        pbar = None
                    loss = (np.zeros((7,), np.float32) if loss_acc is None
                            else loss_acc.cpu().numpy() / count)
                    print(f"Epoch {epoch+1} loss [g_gen_total, f_gen_total, "
                          f"disc_y, disc_x, g_gen_only, f_gen_only, cycle]: "
                          f"{loss}")
                    logger.log_epoch(epoch + 1, loss, time.time() - t0, count)

                    if (epoch + 1) % check_freq == 0:
                        self.make_checkpoint(epoch + 1)
                        if debug and sample is not None:  # cgan.py:275
                            self._score_sample(sample, sample_gt)
                    print(f"Time taken for epoch {epoch+1} is "
                          f"{time.time()-t0}")
        finally:
            if pbar is not None:  # left open by a mid-epoch exception
                pbar.close()
            try:
                self.wait_until_finished()  # drain the checkpoint writer
            finally:
                logger.close()

    def _score_sample(self, sample, sample_gt) -> None:
        from ..debug import accuracy, generate_images

        pred = self.predict(sample)
        if sample_gt is not None:
            gt = center_crop(torch.as_tensor(sample_gt).to(self.device),
                             self.buffer)
            print(f"Accuracy on sample: {accuracy(gt[0], pred[0])}")
        generate_images(sample, pred, show=False,
                        save_path=f"{self.exp_name}_sample.png")

    # ------------------------------------------------------------ inspection
    def plot_generator(self, location: str) -> None:
        """Write the generator's submodules and parameter shapes (reference
        cgan.py:237-240 used keras plot_model): a text table, or an image
        of it when ``location`` ends with .png."""
        self._plot_model(self.state.gg, location)

    def plot_discriminator(self, location: str) -> None:
        """The discriminator's table (reference cgan.py:232-235)."""
        self._plot_model(self.state.dx, location)

    @staticmethod
    def _plot_model(module: torch.nn.Module, location: str) -> None:
        rows = [(n, str(tuple(p.shape)), str(p.numel()))
                for n, p in module.named_parameters()]
        rows.append(("total", "", str(sum(p.numel()
                                          for p in module.parameters()))))
        w = [max(len(r[i]) for r in rows + [("parameter", "shape", "size")])
             for i in range(3)]
        lines = [str(module), ""] + [
            f"{a:<{w[0]}}  {b:<{w[1]}}  {c:>{w[2]}}"
            for a, b, c in [("parameter", "shape", "size")] + rows]
        table = "\n".join(lines) + "\n"
        if location.endswith(".png"):
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig = plt.figure(figsize=(14, max(4, table.count("\n") * 0.22)))
            fig.text(0.01, 0.99, table, family="monospace", fontsize=6,
                     va="top")
            plt.axis("off")
            plt.savefig(location, dpi=150, bbox_inches="tight")
            plt.close(fig)
        else:
            with open(location, "w") as f:
                f.write(table)

    # --------------------------------------------------------------- predict
    def predict(self, data) -> torch.Tensor:
        """Generator G forward, without dropout (reference cgan.py:289-293);
        a tensor on the model's device."""
        return self.generator_g(data)

    def predict_f(self, data) -> torch.Tensor:
        """Generator F forward (Y -> X)."""
        return self.generator_f(data)

    # ---- the reference's network attributes (cgan.py:58-62), live ----
    @property
    def generator_g(self) -> BoundModel:
        return BoundModel(self.state.gg, self.device)

    @property
    def generator_f(self) -> BoundModel:
        return BoundModel(self.state.gf, self.device)

    @property
    def discriminator_x(self) -> BoundModel:
        return BoundModel(self.state.dx, self.device)

    @property
    def discriminator_y(self) -> BoundModel:
        return BoundModel(self.state.dy, self.device)
