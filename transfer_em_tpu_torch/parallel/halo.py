"""Spatial (halo-exchange) parallel inference (counterpart of
``transfer_em_tpu/parallel/halo.py``).

One large block is split along z over the ``space`` mesh axis (and, with
``y_axis`` / ``x_axis``, along y and x over further axes); each shard
receives its neighbours' boundary planes (``buffer`` voxels a face, the
VALID convs' halo) and runs the generator on its extended slab.  The JAX
package exchanges with ``lax.ppermute`` inside one ``shard_map``; here the
planes move by device copies between the shards of one process, and by
``torch.distributed`` point-to-point sends across processes (staged through
pinned host memory under gloo, whose sends take no CUDA tensor).

Semantics: each shard's output equals the generator on its extended block
of ``zpad(vol, buffer)`` (the block plus ``buffer`` voxels a side along
each split axis), as the tiled path's output equals the generator on each
tile; the output's split extents equal vol's (the others shrink by
2*buffer).  Edge shards see zeros beyond the volume, as the reference's
ZeroPadding in training (cgan.py:160).  The shards together are not one
generator pass over the whole padded volume: the transposed convs' TF-SAME
edges make a slab's last planes differ from the whole pass's (ROADMAP.md
§C has the gap measured).  Each shard's slab keeps the global
stride-4 pooling phase: slab % 4 == 0 and slab + 2*buffer a valid dimsize.

The exchange goes one axis at a time, z then y then x; each later exchange
ships planes of the block already extended along the earlier axes, so a
diagonal neighbour's corner arrives through the shared edge neighbour in
one round per axis.  Positions that differ only along mesh axes the block
is not split over hold the same block; the JAX program computes it on each,
the port once (on the position at index 0 of those axes).

The JAX package memoises its traced ``shard_map`` programs per geometry;
eager PyTorch traces nothing, so there is nothing to memoise.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..shapes import is_valid_dimsize
from .distributed import exchange
from .mesh import (SPACE_AXIS, Mesh, Shard, ShardedTensor, process_rank,
                   replicas)


def _vol_spec(batched: bool, data_axis: Optional[str],
              space_axes: List[Optional[str]], ndim_spatial: int
              ) -> Tuple[Optional[str], ...]:
    """The mesh axis (or None) that splits each axis of the block, channel
    last: the layout of the input and of the output.

    space_axes: mesh-axis name (or None) per spatial axis, leading first."""
    lead = (data_axis,) if batched else ()
    tail = list(space_axes) + [None] * (ndim_spatial - len(space_axes))
    return (*lead, *tail, None)


def _padded_extent(extent: int, n_dev: int, buffer: int) -> int:
    """Smallest extent' >= extent with a valid slab geometry on n_dev devices
    (slab % 4 == 0, slab > buffer, extended slab a valid dimsize).

    Returns ``extent`` unchanged when it is already valid, so auto-padding
    is a no-op on aligned volumes.
    """
    slab = -(-extent // n_dev)      # ceil-divide
    slab += (-slab) % 4             # round up to the stride-4 pooling phase
    slab = max(slab, 4)
    limit = extent + 4 * n_dev + 512  # geometry search safety bound
    while slab <= buffer or not is_valid_dimsize(slab + 2 * buffer):
        slab += 4
        if slab * n_dev > limit:
            raise ValueError(
                f"no valid slab geometry found for extent {extent} on "
                f"{n_dev} devices with halo {buffer}")
    return slab * n_dev


def _check_slab(extent: int, n_dev: int, buffer: int, name: str) -> None:
    """Validate one sharded spatial axis's per-device slab geometry."""
    if extent % n_dev != 0:
        raise ValueError(
            f"{name} extent {extent} not divisible by its mesh axis {n_dev}")
    slab = extent // n_dev
    if slab % 4 != 0:
        raise ValueError(
            f"{name} slab extent {slab} breaks the stride-4 pooling phase; "
            f"choose an extent with extent/n_devices % 4 == 0")
    if slab <= buffer:
        raise ValueError(f"{name} slab {slab} must exceed halo {buffer}")
    if not is_valid_dimsize(slab + 2 * buffer):
        raise ValueError(
            f"extended {name} slab {slab + 2*buffer} not a valid dimsize")


def _check_extra_axis(mesh: Mesh, axis: str, extent: Optional[int],
                      buffer: int, pos: int, ndim_spatial: int,
                      name: str) -> int:
    """Validate an additional sharded spatial axis; returns its device count."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no '{axis}' axis (got axes "
                         f"{tuple(mesh.shape)}); use parallel.make_mesh("
                         f"n, space=, space_y=, space_x=)")
    if ndim_spatial < pos + 1:
        raise ValueError(f"{name}_axis needs >= {pos + 1} spatial dims")
    if extent is None:
        raise ValueError(f"{name}_axis requires {name}_extent")
    n_dev = int(mesh.shape[axis])
    _check_slab(extent, n_dev, buffer, name)
    return n_dev


def _appliers(gen_apply, params, devices) -> Dict[torch.device, Callable]:
    """One ``apply(batch)`` a device.  A generator module with no ``params``
    runs as its replicas (``mesh.replicas``: copied once a device, refreshed
    when its parameters change); otherwise ``gen_apply(params, batch)`` (a
    module through ``functional_call``) with ``params`` copied to each
    device for this call."""
    if isinstance(gen_apply, nn.Module) and params is None:
        return dict(zip(devices, replicas(gen_apply, devices)))
    apply = gen_apply
    if isinstance(gen_apply, nn.Module):
        module = gen_apply
        apply = lambda p, b: functional_call(module, p, (b,))  # noqa: E731
    out = {}
    for d in devices:
        if d not in out:
            out[d] = functools.partial(
                apply, {k: v.to(d) for k, v in params.items()})
    return out


def halo_predict_fn(gen_apply: Callable, mesh: Mesh, buffer: int,
                    z_extent: int, n_space: Optional[int] = None,
                    ndim_spatial: int = 3,
                    batched: bool = False, data_axis: Optional[str] = None,
                    y_axis: Optional[str] = None,
                    y_extent: Optional[int] = None,
                    x_axis: Optional[str] = None,
                    x_extent: Optional[int] = None):
    """Build the sharded predictor ``f(params, vol) -> ShardedTensor``.

    Args:
      gen_apply: the generator module, or a callable (params, batch) ->
        output with ``params`` a mapping of tensors (``functional_call``'s).
      z_extent: global size of the sharded (leading) spatial axis.
      n_space: devices on the space axis; None derives it from the mesh.
        If given it must equal ``mesh.shape['space']``: the split follows
        the mesh, so another count would build the exchange for the wrong
        ring (zero halos at interior boundaries = corrupt voxels).
      ndim_spatial: 3 for volumes (Z, Y, X, 1), 2 for images (Y, X, 1).
      batched: inputs carry a leading batch axis (B, Z, Y, X, 1); the
        generator runs on the whole local batch per shard.
      data_axis: with ``batched``, also split the batch axis over this mesh
        axis; None gives every shard the whole batch.
      y_axis / x_axis: also split the second / third spatial axis over
        these mesh axes (make_mesh(space=, space_y=, space_x=)).  Each
        requires its ``*_extent``, validated like the z slab.
    Returns:
      f(params, vol): vol the whole input (numpy or tensor, any device;
      each shard copies its block to its device); the output's sharded
      axes keep their extents, the others shrink by 2*buffer.  ``params``
      may be None for a module.
    """
    if SPACE_AXIS not in mesh.shape:
        raise ValueError(
            f"halo_predict needs a mesh with a '{SPACE_AXIS}' axis (got axes "
            f"{tuple(mesh.shape)}); use parallel.make_mesh(n, space=...)")
    if data_axis is not None and not batched:
        raise ValueError("data_axis requires batched=True")
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"mesh has no '{data_axis}' axis "
                         f"(got axes {tuple(mesh.shape)})")
    mesh_n = int(mesh.shape[SPACE_AXIS])
    if n_space is None:
        n_space = mesh_n
    elif int(n_space) != mesh_n:
        raise ValueError(
            f"n_space={n_space} != the mesh's '{SPACE_AXIS}' axis size "
            f"{mesh_n}; the volume is split over the mesh, so the halo "
            f"exchange must be built for exactly that device count")
    _check_slab(z_extent, n_space, buffer, "z")
    sharded = [(SPACE_AXIS, n_space)]
    if y_axis is not None:
        sharded.append((y_axis, _check_extra_axis(
            mesh, y_axis, y_extent, buffer, 1, ndim_spatial, "y")))
    if x_axis is not None:
        if y_axis is None:
            raise ValueError("x_axis requires y_axis (shard axes in order)")
        sharded.append((x_axis, _check_extra_axis(
            mesh, x_axis, x_extent, buffer, 2, ndim_spatial, "x")))
    spec = _vol_spec(batched, data_axis, [a for a, _ in sharded],
                     ndim_spatial)
    names = mesh.axis_names
    used = {a for a in spec if a is not None}
    # one owner per distinct block: index 0 on every axis the block ignores
    owners = [p for p in range(mesh.size)
              if all(c == 0 for c, a in zip(
                  np.unravel_index(p, mesh.devices.shape), names)
                  if a not in used)]
    coords = {p: dict(zip(names, np.unravel_index(p, mesh.devices.shape)))
              for p in owners}
    rank = process_rank()

    def block_index(p, shape) -> Tuple[slice, ...]:
        idx = []
        for extent, axis in zip(shape, spec):
            if axis is None:
                idx.append(slice(None))
            else:
                n = mesh.shape[axis]
                if extent % n:
                    raise ValueError(f"extent {extent} not divisible by "
                                     f"the '{axis}' axis' {n} devices")
                c = int(coords[p][axis])
                idx.append(slice(c * extent // n, (c + 1) * extent // n))
        return tuple(idx)

    def neighbour(p, axis, step) -> Optional[int]:
        c = dict(coords[p])
        c[axis] = int(c[axis]) + step
        if not 0 <= c[axis] < mesh.shape[axis]:
            return None
        return int(np.ravel_multi_index([c[a] for a in names],
                                        mesh.devices.shape))

    def f(params, vol) -> ShardedTensor:
        vol = torch.as_tensor(vol)
        mine = [p for p in owners if int(mesh.processes.flat[p]) == rank]
        blocks: Dict[int, torch.Tensor] = {
            p: vol[block_index(p, vol.shape)].to(
                mesh.devices.flat[p]).contiguous() for p in mine}
        lead = 1 if batched else 0
        tag = itertools.count()
        for i, (axis, _) in enumerate(sharded):
            dim = lead + i
            blocks = _exchange_axis(blocks, mesh, owners, axis, dim, buffer,
                                    neighbour, tag)
        # made outside inference mode, so conv3's weight-pack cache keeps
        # the copies' packs
        apply = _appliers(gen_apply, params,
                          [mesh.devices.flat[p] for p in mine])
        shards = []
        with torch.inference_mode():
            for p in mine:
                dev, ext = mesh.devices.flat[p], blocks[p]
                out = (apply[dev](ext) if batched
                       else apply[dev](ext[None])[0])
                shards.append(Shard(_out_index(block_index(p, vol.shape),
                                               spec, out.shape), out, p))
        shape = tuple(n if axis is not None else m for n, m, axis in
                      zip(vol.shape, shards[0].data.shape, spec))
        return ShardedTensor(shape, shards, len(mine) == len(owners))

    return f


def _out_index(idx, spec, shape) -> Tuple[slice, ...]:
    """An output shard's index: the input's slices on the split axes, the
    whole (shrunken) extent elsewhere."""
    return tuple(s if axis is not None else slice(0, n)
                 for s, axis, n in zip(idx, spec, shape))


def _exchange_axis(blocks, mesh: Mesh, owners, axis: str, dim: int,
                   buffer: int, neighbour, tag) -> Dict[int, torch.Tensor]:
    """Extend every local block along ``dim`` by ``buffer`` planes from each
    neighbour along mesh axis ``axis`` (zeros past the global edges).
    Every process walks the owners in one order, so the tags and the order
    of the sends agree on both ends."""
    lo_planes = {p: b.narrow(dim, 0, buffer) for p, b in blocks.items()}
    hi_planes = {p: b.narrow(dim, b.shape[dim] - buffer, buffer)
                 for p, b in blocks.items()}
    upper, lower = {}, {}
    sends, recvs = [], []
    for p in owners:
        for step, got, planes in ((-1, upper, hi_planes),
                                  (+1, lower, lo_planes)):
            t = next(tag)
            q = neighbour(p, axis, step)
            p_here = p in blocks
            if q is None:
                if p_here:
                    got[p] = torch.zeros_like(planes[p])
                continue
            q_here = q in blocks
            q_rank = int(mesh.processes.flat[q])
            p_rank = int(mesh.processes.flat[p])
            if p_here and q_here:
                got[p] = planes[q].to(blocks[p].device)
            elif p_here:
                got[p] = torch.empty_like(planes[p])
                recvs.append((got[p], q_rank, t))
            elif q_here:
                sends.append((planes[q], p_rank, t))
    exchange(sends, recvs)
    return {p: torch.cat([upper[p], b, lower[p]], dim)
            for p, b in blocks.items()}


def halo_predict(gen_apply: Callable, params, vol, mesh: Mesh,
                 buffer: int, batched: bool = False,
                 data_axis: Optional[str] = None,
                 y_axis: Optional[str] = None,
                 x_axis: Optional[str] = None,
                 auto_pad: bool = True):
    """One-shot wrapper: split ``vol`` over 'space' and predict.

    vol: (Z, Y, X, 1) volume or (Y, X, 1) image, leading axis split; with
    ``batched=True`` a batch of them, (B, Z, Y, X, 1), the SECOND axis
    split (and the batch too, over ``data_axis``).  ``y_axis`` /
    ``x_axis``: also split the second / third spatial axis over those mesh
    axes.  ``gen_apply`` / ``params`` as in :func:`halo_predict_fn`.

    auto_pad (default True): arbitrary extents on split axes are accepted
    by zero-padding each to the nearest valid slab geometry and cropping
    the output back (the zeros-outside-volume semantics edge shards already
    see), so the result equals the aligned call on the original extent.
    ``auto_pad=False`` keeps the strict ValueError.

    Returns the whole output as a tensor on the mesh's first device when
    this process holds every shard; across processes, the
    ``ShardedTensor`` of this process's shards (as a sharded ``jax.Array``
    is only partly addressable on each host).
    """
    n_space = mesh.shape.get(SPACE_AXIS)
    if n_space is None:
        raise ValueError(
            f"halo_predict needs a mesh with a '{SPACE_AXIS}' axis (got axes "
            f"{tuple(mesh.shape)}); use parallel.make_mesh(n, space=...)")
    vol = torch.as_tensor(vol)
    ndim_spatial = vol.dim() - (2 if batched else 1)
    off = 1 if batched else 0
    crops = []
    if auto_pad:
        # (block axis position, devices on it) per split spatial axis;
        # unknown mesh axes are left alone so halo_predict_fn raises its
        # usual diagnostic.
        sharded_pos = [(off, n_space)]
        for i, ax in enumerate((y_axis, x_axis)):
            if ax is not None and ax in mesh.shape and i + 1 < ndim_spatial:
                sharded_pos.append((off + 1 + i, int(mesh.shape[ax])))
        pad = [0] * (2 * vol.dim())  # F.pad order: last axis first
        for pos, n_dev in sharded_pos:
            extent = vol.shape[pos]
            padded = _padded_extent(extent, n_dev, buffer)
            if padded != extent:
                pad[2 * (vol.dim() - 1 - pos) + 1] = padded - extent
                crops.append((pos, extent))
        if crops:
            vol = F.pad(vol, pad)
    z_extent = vol.shape[off]
    y_extent = vol.shape[off + 1] if y_axis is not None else None
    x_extent = vol.shape[off + 2] if x_axis is not None else None
    f = halo_predict_fn(gen_apply, mesh, buffer, z_extent, n_space,
                        ndim_spatial, batched=batched, data_axis=data_axis,
                        y_axis=y_axis, y_extent=y_extent,
                        x_axis=x_axis, x_extent=x_extent)
    out = f(params, vol)
    for pos, extent in crops:
        out = _crop(out, pos, extent)
    if out.complete:
        return out.gather(mesh.devices.flat[0])
    return out


def _crop(st: ShardedTensor, pos: int, extent: int) -> ShardedTensor:
    """``st`` cut to ``extent`` along axis ``pos`` (shards past it drop)."""
    shards = []
    for s in st.addressable_shards:
        lo, hi = s.index[pos].start or 0, s.index[pos].stop
        hi = min(hi, extent)
        if hi <= lo:
            continue
        index = s.index[:pos] + (slice(lo, hi),) + s.index[pos + 1:]
        shards.append(Shard(index, s.data.narrow(pos, 0, hi - lo),
                            s.position))
    shape = st.shape[:pos] + (extent,) + st.shape[pos + 1:]
    return ShardedTensor(shape, shards, st.complete)
