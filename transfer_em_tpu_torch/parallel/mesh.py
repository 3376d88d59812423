"""Device meshes for data ("data") and spatial ("space") parallelism.

Counterpart of ``transfer_em_tpu/parallel/mesh.py``.  A JAX ``Mesh`` names
the axes of a grid of devices that one program drives; the port keeps that
picture with a small :class:`Mesh` of ``torch.device`` s:

* ``data``  -- batch sharding: every shard of a batch runs on its device
  with a replica of the model (parallel/dp.py, the ``mesh=`` of every
  inference mode);
* ``space`` (and ``space_y`` / ``space_x``) -- spatial sharding of large
  volumes for halo-exchange inference (parallel/halo.py).

A device may appear more than once (``[torch.device("cpu")] * 8`` in the
CPU tests, ``[cuda:0] * k`` to run k shards on one card): each position of
the grid is a shard of its own.  With a ``torch.distributed`` process group
up (parallel/distributed.py), :func:`make_mesh` spans every process's local
devices in rank order, as a JAX mesh spans every host's chips, and
``Mesh.processes`` says which process drives each position; a process
touches only the shards on its own positions.

JAX's ``batch_sharding`` / ``replicated`` / ``space_sharding`` return
shardings for ``device_put``; eager PyTorch has no ``device_put``, so here
they split or copy a tensor and give back the pieces: a
:class:`ShardedTensor`, which holds this process's pieces
(``addressable_shards``) and the global shape, as a sharded ``jax.Array``
does.
"""

from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"
SPACE_Y_AXIS = "space_y"
SPACE_X_AXIS = "space_x"


def process_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """Named axes over a grid of devices (``jax.sharding.Mesh``'s role).

    ``devices``: an ndarray of ``torch.device``, one axis per name;
    ``processes``: the rank that drives each position (all 0 in one
    process); ``shape``: axis name -> size, read as ``mesh.shape["data"]``
    exactly as the JAX callers read it."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device grid for axes "
                             f"{self.axis_names}")
        self.processes = (np.zeros(self.devices.shape, np.int64)
                          if processes is None
                          else np.asarray(processes, np.int64).reshape(
                              self.devices.shape))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self, flat: int) -> bool:
        """Whether this process drives the mesh position ``flat``
        (row-major over the axes)."""
        return int(self.processes.flat[flat]) == process_rank()

    def local_positions(self) -> List[int]:
        """The flat positions this process drives, in mesh order."""
        return [i for i in range(self.size) if self.is_local(i)]

    @property
    def spans_processes(self) -> bool:
        return bool((self.processes != self.processes.flat[0]).any())

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: one
        per shard of a tensor split over ``axis`` alone (the other axes
        would hold replicas of the same work)."""
        pos = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[pos] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        devices = [str(d) for d in self.devices.flat]
        ranks = (f", processes={self.processes.ravel().tolist()}"
                 if self.spans_processes else "")
        return f"Mesh({self.shape}, devices={devices}{ranks})"


def local_cuda_devices() -> List[torch.device]:
    """This process's CUDA devices: with a process group up, one card a
    process (``parallel.distributed.local_device_index``: LOCAL_RANK, else
    the rank modulo the visible cards); alone, every visible card."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() with no devices= asked for the local CUDA devices, "
            "but torch.cuda.is_available() is False; pass devices= (e.g. "
            "[torch.device('cpu')] * 8) to build a mesh on the CPU")
    if dist.is_available() and dist.is_initialized():
        from .distributed import local_device_index
        return [torch.device("cuda", local_device_index())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so equal devices compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


_REPLICAS: "weakref.WeakKeyDictionary[torch.nn.Module, dict]" = (
    weakref.WeakKeyDictionary())


def _stamp(tensors: Sequence[torch.Tensor]) -> list:
    """What a copy was made from: each tensor's identity (a weak
    reference), memory and version counter.  The version alone misses a
    parameter swapped for another at an equal count
    (``load_state_dict(sd, assign=True)``); inference tensors keep no
    version counter and never match."""
    return [(weakref.ref(t), t.data_ptr(),
             None if t.is_inference() else t._version) for t in tensors]


def _matches(stamp: list, tensors: Sequence[torch.Tensor]) -> bool:
    return len(stamp) == len(tensors) and all(
        ref() is t and ptr == t.data_ptr() and v is not None
        and v == t._version for (ref, ptr, v), t in zip(stamp, tensors))


def _priors(module: torch.nn.Module) -> List[Tuple[torch.nn.Module, object]]:
    """The relocatable frozen priors a module holds (a discriminator's
    ``disc_prior`` from ``train.cgan._tap_prior``: a callable with its own
    ``params`` and ``on(device)``), each with the submodule holding it."""
    return [(m, m.disc_prior) for m in module.modules()
            if hasattr(getattr(m, "disc_prior", None), "on")]


def _prior_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    return [t for _, p in _priors(module) for t in p.params.values()]


def place_priors(module: torch.nn.Module, device: torch.device) -> None:
    """Give ``module``'s frozen priors their own tensors on ``device``: a
    prior holds a generator that is no submodule, so ``.to`` and a module
    copy leave it where it was."""
    for m, prior in _priors(module):
        m.disc_prior = prior.on(device)


def replicas(module: torch.nn.Module, devices: Sequence[torch.device]
             ) -> List[torch.nn.Module]:
    """``module`` on each of ``devices``, one entry a device: the module
    itself on the device its parameters live on; elsewhere one copy a
    device, made on first use and kept for the module's life.  A copy's
    parameters are refreshed in place from the module's when these changed
    since (another tensor, other memory or a moved version counter: an
    optimizer step, a restore, ``load_state_dict(assign=True)``), so conv3
    repacks a copy's weights then and only then; parameters made in
    inference mode refresh on every call.  A frozen prior (a
    discriminator's ``disc_prior``) is rebuilt on the copy's device when
    the copy is made and whenever the module's prior changed."""
    home = next(module.parameters()).device
    src = list(module.parameters())
    prior_src = _prior_tensors(module)
    made = _REPLICAS.setdefault(module, {})
    out = []
    for d in devices:
        if d == home:
            out.append(module)
            continue
        entry = made.get(d)
        if entry is None:
            with torch.inference_mode(False):  # a copy refreshable anywhere
                copy_ = copy.deepcopy(module).to(d)
                place_priors(copy_, d)
            entry = made[d] = [copy_, _stamp(src), _stamp(prior_src)]
        else:
            if not _matches(entry[1], src):
                with torch.no_grad():
                    for p, q in zip(entry[0].parameters(), src):
                        p.copy_(q)
                entry[1] = _stamp(src)
            if not _matches(entry[2], prior_src):
                for (m, _), (_, prior) in zip(_priors(entry[0]),
                                              _priors(module)):
                    m.disc_prior = prior.on(d)
                entry[2] = _stamp(prior_src)
        out.append(entry[0])
    return out


def make_mesh(n_devices: Optional[int] = None,
              data: Optional[int] = None,
              space: int = 1,
              space_y: int = 1,
              space_x: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, space[, space_y[, space_x]]) mesh.

    ``devices``: this process's devices (repeats allowed); None takes the
    local CUDA devices (every card, or with a process group up the
    process's own card) and raises without one.  With a process group up the
    mesh spans every process's ``devices`` in rank order.  Defaults: all
    devices on the data axis.  The product of the axis sizes must equal the
    device count (after ``n_devices`` truncates the list); size-1 trailing
    spatial axes are left out, as in the JAX package."""
    local = (local_cuda_devices() if devices is None
             else [_indexed(torch.device(d)) for d in devices])
    from .distributed import gather_objects
    per_rank = gather_objects([str(d) for d in local])
    flat = [(rank, torch.device(d)) for rank, devs in enumerate(per_rank)
            for d in devs]
    if n_devices is not None:
        flat = flat[:n_devices]
    n = len(flat)
    prod = space * space_y * space_x
    if data is None:
        if n % prod != 0:
            raise ValueError(
                f"device count {n} not divisible by space={space} "
                f"x space_y={space_y} x space_x={space_x}")
        data = n // prod
    if data * prod != n:
        raise ValueError(
            f"data*space*space_y*space_x = {data}*{space}*{space_y}"
            f"*{space_x} != device count {n}")
    sizes = [data, space]
    names = [DATA_AXIS, SPACE_AXIS]
    if space_y > 1 or space_x > 1:
        sizes.append(space_y)
        names.append(SPACE_Y_AXIS)
    if space_x > 1:
        sizes.append(space_x)
        names.append(SPACE_X_AXIS)
    grid = np.empty(n, dtype=object)
    grid[:] = [d for _, d in flat]
    return Mesh(grid.reshape(sizes), names,
                np.asarray([r for r, _ in flat]).reshape(sizes))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One piece of a sharded tensor: where it sits (``index``, one slice
    per axis), its data on its device, and its mesh position."""

    index: Tuple[slice, ...]
    data: torch.Tensor
    position: int

    @property
    def device(self) -> torch.device:
        return self.data.device


@dataclasses.dataclass
class ShardedTensor:
    """A tensor split over a mesh: the global ``shape`` and this process's
    pieces.  ``complete``: the pieces cover the whole tensor (every position
    is this process's), so :meth:`gather` can assemble it."""

    shape: Tuple[int, ...]
    addressable_shards: List[Shard]
    complete: bool

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        if not self.complete:
            raise ValueError("this process holds only some of the shards; "
                             "read addressable_shards instead")
        first = self.addressable_shards[0].data
        out = torch.empty(self.shape, dtype=first.dtype, device=device)
        for s in self.addressable_shards:
            out[s.index] = s.data.to(device)
        return out


def _rows(n_rows: int, parts: int, what: str) -> int:
    if n_rows % parts:
        raise ValueError(f"{what}: batch {n_rows} is not divisible by the "
                         f"mesh's {parts} devices")
    return n_rows // parts


def batch_sharding(mesh: Mesh, x) -> ShardedTensor:
    """Split axis 0 (the batch) of the global ``x`` over EVERY mesh axis,
    row-major (data and space both act as data parallelism in training, as
    in the JAX package): position p holds rows [p b, (p + 1) b) on its
    device; this process keeps its own positions' rows."""
    x = torch.as_tensor(x)
    b = _rows(x.shape[0], mesh.size, "batch_sharding")
    rest = (slice(None),) * (x.dim() - 1)
    shards = [Shard((slice(p * b, (p + 1) * b),) + rest,
                    x[p * b:(p + 1) * b].to(mesh.devices.flat[p]), p)
              for p in mesh.local_positions()]
    return ShardedTensor(tuple(x.shape), shards, not mesh.spans_processes)


def host_rows(mesh: Mesh, local_x) -> ShardedTensor:
    """The batch-sharded global tensor of which this process passes only
    its own positions' rows, in order (``parallel.dp.host_local_batch``)."""
    local_x = torch.as_tensor(local_x)
    mine = mesh.local_positions()
    b = _rows(local_x.shape[0], len(mine), "host_local_batch")
    rest = (slice(None),) * (local_x.dim() - 1)
    shards = [Shard((slice(p * b, (p + 1) * b),) + rest,
                    local_x[k * b:(k + 1) * b].to(mesh.devices.flat[p]), p)
              for k, p in enumerate(mine)]
    return ShardedTensor((b * mesh.size,) + tuple(local_x.shape[1:]), shards,
                         not mesh.spans_processes)


def replicated(mesh: Mesh, x) -> List[torch.Tensor]:
    """A copy of ``x`` on each of this process's positions (a position
    whose device already holds ``x`` gets ``x`` itself)."""
    x = torch.as_tensor(x)
    return [x.to(mesh.devices.flat[p]) for p in mesh.local_positions()]


def space_sharding(mesh: Mesh, vol, ndim_spatial: int) -> ShardedTensor:
    """Split the leading spatial axis of a batch-less (Z, ..., C) volume
    over 'space'; the positions along the other axes hold replicas, and
    this process keeps the pieces of its own positions."""
    if SPACE_AXIS not in mesh.shape:
        raise ValueError(f"mesh has no '{SPACE_AXIS}' axis (got axes "
                         f"{tuple(mesh.shape)})")
    del ndim_spatial  # the leading axis is sharded whatever the rank
    vol = torch.as_tensor(vol)
    n = mesh.shape[SPACE_AXIS]
    slab = _rows(vol.shape[0], n, "space_sharding")
    axis = mesh.axis_names.index(SPACE_AXIS)
    rest = (slice(None),) * (vol.dim() - 1)
    shards = []
    for p in mesh.local_positions():
        i = np.unravel_index(p, mesh.devices.shape)[axis]
        shards.append(Shard((slice(i * slab, (i + 1) * slab),) + rest,
                            vol[i * slab:(i + 1) * slab].to(
                                mesh.devices.flat[p]), p))
    return ShardedTensor(tuple(vol.shape), shards, not mesh.spans_processes)
