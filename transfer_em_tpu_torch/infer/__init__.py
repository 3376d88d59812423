"""Inference of the port: tiled prediction, the large-volume modes
(``predict_volume``), export/load, tile batching."""

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..native import gather_blocks
from ..telemetry import span
from .batcher import TileBatcher, make_tile_batcher
from .device_stitch import device_predict_tiled
from .export import (export_generator, load_generator,
                     predict_cube_from_saved_model, save_model)
from .slab import slab_predict
from .stream import predict_streaming, predict_volume_streaming
from .tiling import (InferenceCancelled, TilePlan, default_batch_size,
                     make_tile_step, plan_tiles, predict_ng_cube,
                     predict_tiled, scatter_tiles)

__all__ = [
    "export_generator", "load_generator", "predict_cube_from_saved_model",
    "save_model", "TilePlan", "make_tile_step", "plan_tiles",
    "predict_ng_cube", "predict_tiled", "scatter_tiles", "InferenceCancelled",
    "TileBatcher", "make_tile_batcher", "slab_predict",
    "device_predict_tiled", "predict_volume", "predict_streaming",
    "predict_volume_streaming", "choose_mode",
]


def choose_mode(vol_shape, size, hbm_bytes=None, headroom=0.5,
                device="cuda"):
    """Pick "device" or "stream" for ``predict_volume(mode="auto")``.

    "device" keeps the uint8 input volume, the uint8 stitched output and a
    tile-batch workspace on the card; when input plus output exceed
    ``headroom`` of the card's memory, the streaming path (at most 2 haloed
    blocks resident, bit-identical output) is the right call.  The rule is
    deliberately coarse: both candidates compute the same function, so a
    borderline miss costs throughput, not correctness.  ``hbm_bytes``
    defaults to ``torch.cuda.get_device_properties(device).total_memory``,
    and to 16 GB for ``device="cpu"``."""
    if hbm_bytes is None:
        dev = resolve_device(device)
        hbm_bytes = (torch.cuda.get_device_properties(dev).total_memory
                     if dev.type == "cuda" else 16 << 30)
    footprint = int(np.prod(vol_shape)) + int(np.prod(size))
    return "device" if footprint <= headroom * hbm_bytes else "stream"


def _host_volume(vol_zyx) -> np.ndarray:
    """A C-contiguous uint8 numpy view or copy of the volume; an
    ``np.memmap`` is kept as it is, a tensor is brought to the host."""
    if isinstance(vol_zyx, torch.Tensor):
        return vol_zyx.to("cpu", torch.uint8).contiguous().numpy()
    if isinstance(vol_zyx, np.memmap):
        return vol_zyx
    return np.ascontiguousarray(vol_zyx, np.uint8)


@span("volume.call")
def predict_volume(vol_zyx, gen: torch.nn.Module, start, size,
                   meanstd_x, meanstd_y, *, outdimsize=40, buffer=17,
                   mode="device", batch_size: Optional[int] = None,
                   as_numpy=True, mesh=None, max_block_bytes=1 << 30,
                   out=None, device="cuda"):
    """Predict an xyz ``start``/``size`` region of an in-memory uint8 zyx
    volume (numpy array, ``np.memmap`` or tensor) with the generator module
    ``gen`` (on ``device``).

    mode:
      "auto"   -- "device" when input + output fit comfortably in the
                  card's memory, else "stream" (``choose_mode``; both are
                  bit-identical, so the choice is throughput only).
                  ``as_numpy=False`` resolves to "device" (the only auto
                  candidate that returns a device tensor); ``out=``
                  resolves to "stream" (honours a preallocated memmap);
                  passing both is contradictory and raises ValueError;
      "device" -- device-resident gather -> predict -> stitch
                  (infer/device_stitch.py), bit-identical to "tiles"; a
                  host volume goes up and a numpy result comes down in z
                  slabs, overlapped with the tile batches;
      "slab"   -- whole z-slab forwards (infer/slab.py): fewest launches,
                  about a quarter of the tile grid's conv work per voxel;
      "stream" -- chunked pipeline for volumes larger than the card
                  (infer/stream.py): at most 2 haloed blocks of
                  ``max_block_bytes`` resident, fetch / H2D / compute /
                  D2H overlapped; bit-identical to "device";
      "tiles"  -- the host tile loop (infer/tiling.py) over native gather.
    All modes read zeros outside the volume; slab sits at its own
    pooling-phase alignment, so its output can differ from the tile grid's.

    For slab and device modes a uint8 tensor already on the device is used
    in place (upload once, predict many), and ``as_numpy=False`` returns
    the result as a tensor on the device.  ``out`` (stream and tiles):
    preallocated zyx uint8 output, e.g. an np.memmap for results larger
    than host RAM; device and slab stitch on the card and reject it.
    ``mesh`` (device and stream): a ``parallel.make_mesh`` mesh with a
    'data' axis; the tile batches are dealt out over its devices, and the
    output equals the unmeshed call's at the same batch a device; the
    other modes raise ``ValueError`` (spatially sharded inference is
    ``parallel.halo_predict``).  ``batch_size=None``: width-aware
    (``infer.tiling.default_batch_size``).  ``device``: "cuda" (default)
    or "cpu"; CUDA absent raises.

    Each call is a ``volume.call`` span (``telemetry``); device mode times
    its parts under it: ``volume.upload`` (each slab's host staging and
    enqueue, the first before ``volume.prepare``, the rest inside
    ``volume.tiles``), ``volume.prepare``, ``volume.tiles`` (the batch
    loop), and for each downloaded slab ``volume.wait`` (its copy landing)
    and ``volume.download`` (its copy into the result).  The counts
    ``volume_slabs_in``, ``volume_slabs_out`` and ``volume_pageable``
    (``telemetry.totals()["counts"]``) say which copies took the slabs.
    """
    dev = resolve_device(device)
    if batch_size is None:
        batch_size = default_batch_size(gen)
    if mode == "auto":
        if not as_numpy and out is not None:
            raise ValueError(
                "mode='auto' with as_numpy=False AND out= is contradictory: "
                "as_numpy=False requests a device-resident result, out= a "
                "host-stitched one — drop one of the two")
        if not as_numpy:
            mode = "device"  # only device/slab can return a device tensor
        elif out is not None:
            mode = "stream"  # caller preallocated: honour out= (memmap)
        else:
            mode = choose_mode(tuple(vol_zyx.shape), size, device=dev)
    if out is not None and mode not in ("stream", "tiles"):
        raise ValueError(
            f"out= is only supported with mode='stream' or 'tiles' "
            f"(got {mode!r}): device/slab stitch on-device and allocate "
            "their own output")
    if mesh is not None and mode not in ("device", "stream"):
        raise ValueError(
            f"mesh= is only supported with mode='device' or 'stream' "
            f"(got {mode!r}); for spatially-sharded inference use "
            "parallel.halo_predict")
    if not as_numpy and mode in ("stream", "tiles"):
        raise ValueError(
            f"as_numpy=False is not supported with mode={mode!r}: these "
            "paths stitch on the host and always return a host array")
    if mode == "stream":
        return predict_volume_streaming(
            _host_volume(vol_zyx), gen, start, size, meanstd_x, meanstd_y,
            outdimsize=outdimsize, buffer=buffer, batch_size=batch_size,
            max_block_bytes=max_block_bytes, mesh=mesh, out=out, device=dev)
    if mode == "slab":
        return slab_predict(vol_zyx, gen, start, size, meanstd_x, meanstd_y,
                            as_numpy=as_numpy, device=dev)
    if mode == "device":
        return device_predict_tiled(vol_zyx, gen, start, size, outdimsize,
                                    buffer, meanstd_x, meanstd_y,
                                    batch_size=batch_size, as_numpy=as_numpy,
                                    mesh=mesh, device=dev)
    if mode == "tiles":
        vol = _host_volume(vol_zyx)

        def fetch_tile(corner, insize):
            return gather_blocks(vol, [corner], insize)[0]

        return predict_tiled(fetch_tile, gen, start, size, outdimsize,
                             buffer, meanstd_x, meanstd_y,
                             batch_size=batch_size, out=out, device=dev)
    raise ValueError(f"unknown mode {mode!r}")
