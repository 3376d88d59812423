"""Data-parallel training (counterpart of ``transfer_em_tpu/parallel/dp.py``).

The reference left multi-device training a TODO (cgan.py:8-11), because its
losses reduce per replica.  The JAX package jits its step with the batch
sharded and lets XLA all-reduce the gradients; every loss is a mean over
the global batch, so the DP step equals the single-device step.  Here the
same step is written out by hand:

1. every mesh position takes its rows of the global batch (``batch_sharding``:
   the batch is split over EVERY mesh axis) and runs ``cyclegan_losses`` on
   the four networks on its device: the state's own on the first device,
   elsewhere one replica a device (``mesh.replicas``: copied once,
   refreshed in place after each update);
2. each position's loss is weighted by its share of the global batch and
   back-propagated, so the gradients add up to the global batch's mean;
3. the replicas' gradients are summed onto the state's networks (positions
   that share a device accumulate theirs in its copy), then, one
   flattened buffer per network, all-reduced across processes
   (``torch.distributed``);
4. the four Keras Adams step once, on the state's networks.

``torch.nn.parallel.DistributedDataParallel`` is not used: the step applies
each generator twice and each discriminator twice (once frozen) before its
one backward, and the optimizer is the port's own Adam, which fits DDP's
per-module bucketed reducer poorly; the reduction DDP would make is the one
coalesced ``all_reduce`` a network above, after one broadcast of rank 0's
state at :func:`shard_state`.

Dropout: each position draws the GLOBAL batch's keep masks from the same
(seed, step[, microbatch], application) generators the single-device step
uses, and keeps its own rows (``models.blocks.RowDraw``), so with dropout on
too the DP step equals the single-device step (up to float32 summation
order).  With ``accum_steps`` each position runs its rows microbatch by
microbatch, under the microbatch's masks, as the JAX package's reshape of
the sharded batch does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..config import CycleGANConfig
from ..models.blocks import RowDraw
from ..shapes import generator_shapes
from ..telemetry import span
from ..train.cgan import _dropout_generators, cyclegan_losses
from ..train.state import CycleGANState, make_optimizer
from .distributed import all_reduce_sum, broadcast0
from .mesh import (Mesh, ShardedTensor, batch_sharding, host_rows,
                   place_priors, replicas)

TREES = ("gg", "gf", "dx", "dy")


def first_local_device(mesh: Mesh) -> torch.device:
    """The device of this process's first mesh position: where its copy of
    the train state lives."""
    mine = mesh.local_positions()
    if not mine:
        raise ValueError(f"this process drives no position of {mesh}")
    return mesh.devices.flat[mine[0]]


def _nets(state: CycleGANState) -> List[torch.nn.Module]:
    return [getattr(state, t) for t in TREES]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> None:
    """Copy ``flat`` back into the tensors of ``like``, in order."""
    i = 0
    for t in like:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def shard_state(state: CycleGANState, mesh: Mesh) -> CycleGANState:
    """The state on this process's first mesh device (networks and Adam
    moments moved in place), with rank 0's parameters, moments, Adam counts
    and step on every process (the counts set Keras-Adam's step size and
    the step seeds the dropout masks: a process that restored another
    checkpoint, or none, would otherwise drift apart); returns ``state``."""
    dev = first_local_device(mesh)
    with torch.no_grad():
        for t in TREES:
            net = getattr(state, t).to(dev)
            place_priors(net, dev)  # disc_y's prior beside it
            opt = getattr(state, "opt_" + t)
            opt.mu = {k: v.to(dev) for k, v in opt.mu.items()}
            opt.nu = {k: v.to(dev) for k, v in opt.nu.items()}
            group = (list(net.parameters()) + list(opt.mu.values())
                     + list(opt.nu.values()))
            _unflat(broadcast0(_flat(group)), group)
        counts = broadcast0(torch.tensor(
            [state.step] + [getattr(state, "opt_" + t).count for t in TREES],
            dtype=torch.int64, device=dev)).tolist()
    state.step = counts[0]
    for t, c in zip(TREES, counts[1:]):
        getattr(state, "opt_" + t).count = c
    return state


def shard_batch(batch, mesh: Mesh) -> ShardedTensor:
    """The global batch split over the mesh (``mesh.batch_sharding``)."""
    return batch_sharding(mesh, batch)


def host_local_batch(batch, mesh: Mesh) -> ShardedTensor:
    """The global batch of which this process passes only its own rows
    (its positions' shares, in mesh order): each process of a multi-process
    run feeds its local shard."""
    return host_rows(mesh, batch)


def _dropout_draws(gens, micro: int, lo: int, hi: int, dev: torch.device):
    """The six applications' generators as row draws of positions
    [lo, hi) of a ``micro``-row microbatch: applications 0 and 1 run on the
    2 * micro rows of round 1 (reals, then the other domain's reals)."""
    one = torch.arange(lo, hi, device=dev)
    two = torch.cat([one, one + micro])
    return [RowDraw(g, 2 * micro if a < 2 else micro, two if a < 2 else one)
            for a, g in enumerate(gens)]


def make_dp_train_step(config: CycleGANConfig, mesh: Mesh,
                       disc_prior: Optional[Callable] = None,
                       donate: bool = True, deterministic: bool = False):
    """The train step over ``mesh``: ``step(state, real_x, real_y, seed) ->
    loss7`` (the global batch's losses, on the state's device), updating
    ``state`` in place, as the single-device ``make_train_step`` does.

    ``real_x`` / ``real_y``: the global batch (numpy or tensor; each
    process takes its own positions' rows), or a ``ShardedTensor`` from
    ``shard_batch`` / ``host_local_batch``.  The global batch must divide
    over the mesh's positions and by ``config.accum_steps``.  ``state`` is
    the one ``shard_state`` placed.  ``disc_prior`` (JAX's signature) rides
    in the state's disc_y, and each replica of disc_y runs a copy of it on
    its own device (``mesh.replicas``); ``donate`` has no meaning in eager
    PyTorch; ``deterministic`` turns dropout off (tests)."""
    del disc_prior, donate
    accum = int(config.accum_steps)
    if accum < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum}")
    buffer = generator_shapes(config.dimsize).buffer
    gamma = config.focal_gamma
    opt = make_optimizer(config.learning_rate, config.adam_beta1)
    dev0 = first_local_device(mesh)
    positions = mesh.local_positions()

    def sharded(x) -> ShardedTensor:
        return x if isinstance(x, ShardedTensor) else batch_sharding(mesh, x)

    @span("train.step")
    def step(state: CycleGANState, real_x, real_y, seed: int) -> torch.Tensor:
        where = next(state.gg.parameters()).device
        if where != dev0:
            raise ValueError(f"state is on {where}, the mesh's first local "
                             f"device is {dev0}: shard_state it first")
        xs, ys = sharded(real_x), sharded(real_y)
        B = xs.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by accum_steps {accum}")
        micro = B // accum
        owned = [s.position for s in xs.addressable_shards]
        if owned != positions or [s.position for s in
                                  ys.addressable_shards] != positions:
            raise ValueError("the batches are not split over this mesh")
        devices = [s.device for s in xs.addressable_shards]
        # one copy of each network a device (the state's own on dev0):
        # shards on one device accumulate their gradients in it
        by_net = [replicas(net, devices) for net in _nets(state)]
        nets_by_shard = [list(nets) for nets in zip(*by_net)]
        copies = [[r for r in reps if r is not net]
                  for net, reps in zip(_nets(state), by_net)]
        copies = [list({id(r): r for r in c}.values()) for c in copies]
        for net, c in zip(_nets(state), copies):
            for m in [net] + c:
                m.zero_grad(set_to_none=True)
        parts = []  # each position's weighted losses, on its device
        for sx, sy, nets in zip(xs.addressable_shards, ys.addressable_shards,
                                nets_by_shard):
            lo, hi = sx.index[0].start, sx.index[0].stop
            dev = sx.device
            for i in range(lo // micro, (hi - 1) // micro + 1):
                a, b = max(lo, i * micro), min(hi, (i + 1) * micro)
                gens = None
                if not deterministic:
                    gens = _dropout_draws(
                        _dropout_generators(dev, seed, state.step,
                                            i if accum > 1 else None),
                        micro, a - i * micro, b - i * micro, dev)
                combined, lv = cyclegan_losses(
                    *nets, buffer, gamma, sx.data[a - lo:b - lo],
                    sy.data[a - lo:b - lo], gens,
                    ensemble_apps=config.ensemble_apps,
                    deterministic=deterministic, remat=config.remat)
                w = (b - a) / B
                (combined * w).backward()
                parts.append(lv * w)
        # the exchange: the positions' losses and gradients summed on dev0,
        # then across processes
        with span("dp.exchange", dev0), torch.no_grad():
            loss = torch.zeros(7, device=dev0)
            for part in parts:
                loss += part.to(dev0)
            for net, c in zip(_nets(state), copies):
                params = list(net.parameters())
                grads = []
                for j, p in enumerate(params):
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    for rep in c:
                        q = list(rep.parameters())[j]
                        if q.grad is not None:
                            g = g + q.grad.to(dev0)
                    grads.append(g)
                flat = all_reduce_sum(_flat(grads))
                for p, g in zip(params, grads):
                    p.grad = torch.empty_like(g)
                _unflat(flat, [p.grad for p in params])
            all_reduce_sum(loss)
        for net, t in zip(_nets(state), TREES):
            opt.update_module(net, getattr(state, "opt_" + t))
        state.step += 1
        return loss

    return step
