"""Multi-process setup over ``torch.distributed`` (counterpart of
``transfer_em_tpu/parallel/distributed.py``, which joins the JAX
distributed runtime).

1. every process calls :func:`initialize` (a process group: NCCL where the
   process's devices are CUDA, gloo on the CPU);
2. :func:`parallel.make_mesh` spans every process's local devices in rank
   order, as a JAX mesh spans every host's chips;
3. each process feeds its own rows (``parallel.dp.host_local_batch``;
   sources with ``shard_by_host=True`` read ``host_sharded_seed``, which
   takes the rank, for disjoint reproducible ROI streams);
4. the DP step all-reduces the gradients across processes
   (``parallel/dp.py``); halo planes cross the process boundary by
   point-to-point sends (``parallel/halo.py``).

:func:`barrier` and :func:`gather_objects` run on a gloo group of their
own, so they never touch the device collectives (NCCL's, when the default
group is NCCL).
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import List, Optional

import torch
import torch.distributed as dist

# JAX's coordinator variables: a job launched for the JAX package must not
# come up here as N isolated single-process runs either.
_JAX_MARKERS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS")
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


class _Groups:
    """The gloo group for barriers and object gathers, made once per
    default group (all ranks make it in the same call order)."""

    cpu = None
    default = None


def default_backend() -> str:
    """NCCL where this process drives CUDA devices, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def multi_process_markers() -> List[str]:
    """The environment variables that say this is one process of many."""
    env = os.environ
    markers = [k for k in _JAX_MARKERS if env.get(k)]
    hosts = env.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h]) > 1:
        markers.append("TPU_WORKER_HOSTNAMES")
    world = env.get("WORLD_SIZE", "")
    if world.isdigit() and int(world) > 1:
        markers.append("WORLD_SIZE")
    if env.get("MASTER_ADDR") and world:
        markers.append("MASTER_ADDR")
    return markers


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group (a no-op if one is up already).

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id``, join by TCP; ``num_processes=1`` with an address makes
    a one-rank group.  With no arguments, join from a launcher's
    environment (torchrun's MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE);
    where that is absent or fails, go on single-process with a warning,
    unless the environment says this is one process of many (WORLD_SIZE >
    1, MASTER_ADDR with a WORLD_SIZE, the JAX package's coordinator
    variables, several TPU_WORKER_HOSTNAMES): then raise, because every
    process would take rank 0, ``host_sharded_seed`` would hand all of them
    the same ROI stream and N models would train apart with nothing
    failing.  ``backend``: "nccl" or "gloo"; default NCCL where CUDA is
    available, else gloo (two ranks on one card need gloo: NCCL refuses
    them).  A failed join raises."""
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None and num_processes in (None, 1):
        try:
            missing = [k for k in _TORCHRUN if not os.environ.get(k)]
            if missing:
                raise RuntimeError(f"no process group in the environment "
                                   f"({', '.join(missing)} unset)")
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout)
        except (RuntimeError, ValueError) as e:
            markers = multi_process_markers()
            if markers:
                raise RuntimeError(
                    "torch.distributed auto-initialization failed but the "
                    f"environment carries multi-process markers {markers}: "
                    "refusing to degrade to isolated single-process training "
                    "(per-process ROI streams and gradient sync would "
                    "silently diverge)") from e
            warnings.warn(
                f"torch.distributed auto-initialization unavailable "
                f"({type(e).__name__}: {e}); continuing single-process",
                RuntimeWarning, stacklevel=2)
            return
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("coordinator_address, num_processes and "
                             "process_id go together")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(local_device_index())


def local_device_index() -> int:
    """The card this process drives under NCCL: LOCAL_RANK where a
    launcher set it, else the rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(1, torch.cuda.device_count())


def process_info():
    """(process index, process count, local CUDA device count)."""
    if dist.is_initialized():
        return (dist.get_rank(), dist.get_world_size(),
                torch.cuda.device_count())
    return 0, 1, torch.cuda.device_count()


def _cpu_group():
    if not dist.is_initialized():
        return None
    default = dist.group.WORLD
    if _Groups.default is not default:
        _Groups.cpu = (default if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
        _Groups.default = default
    return _Groups.cpu


def gather_objects(obj) -> list:
    """``obj`` from every process, in rank order (``[obj]`` alone)."""
    group = _cpu_group()
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(name: str = "tem_barrier", timeout_s: float = 600.0) -> None:
    """Align every process without a device collective (gloo's
    ``monitored_barrier``, which names a rank that never arrives).  No-op
    when not running distributed.  ``name`` labels the call for the
    caller's logs; the barrier matches by call order."""
    del name
    group = _cpu_group()
    if group is None:
        return
    dist.monitored_barrier(group=group,
                           timeout=datetime.timedelta(seconds=timeout_s))


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` must go through host memory: gloo moves CPU tensors
    (its point-to-point ops take no CUDA tensor)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (a CPU tensor as it is)."""
    if not t.is_cuda:
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every process, in place; no-op without a process
    group (a one-rank group runs the collective)."""
    if not dist.is_initialized():
        return t
    if _staged(t):
        h = host_copy(t)
        dist.all_reduce(h)
        t.copy_(h)
    else:
        dist.all_reduce(t)
    return t


def broadcast0(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every process, in place; no-op without a process
    group."""
    if not dist.is_initialized():
        return t
    if _staged(t):
        h = host_copy(t)
        dist.broadcast(h, 0)
        t.copy_(h)
    else:
        dist.broadcast(t, 0)
    return t


def exchange(sends, recvs) -> None:
    """Point-to-point transfers in one batch: ``sends`` as (tensor, peer,
    tag), ``recvs`` as (tensor, peer, tag), received in place.  Every
    process lists its transfers in one global order, so NCCL, which ignores
    tags, pairs them as gloo does by tag."""
    ops, back = [], []
    for t, peer, tag in sends:
        src = host_copy(t) if _staged(t) else t
        ops.append(dist.P2POp(dist.isend, src.contiguous(), peer, tag=tag))
    for t, peer, tag in recvs:
        dst = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               if _staged(t) else t)
        ops.append(dist.P2POp(dist.irecv, dst, peer, tag=tag))
        back.append((t, dst))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, dst in back:
        if dst is not t:
            t.copy_(dst)
