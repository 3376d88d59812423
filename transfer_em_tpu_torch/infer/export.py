"""Generator export / load: ``generator.npz`` + ``meta.json``.

Counterpart of ``transfer_em_tpu/infer/export.py`` (reference utils.py:
133-167 exports generator G plus a meta.json with buffer / outdimsize /
meanstd_x / meanstd_y).  The port writes ``generator.npz`` by default: flat
keys in the flax path (``stem/kernel``, ``down1/conv/kernel`` ...), kernels
in the JAX layout, so a machine with numpy alone can read it; or, with
``fmt="msgpack"``, the JAX package's ``generator.msgpack``, which that
package loads.  It reads either (msgpack when ``msgpack`` is importable:
flax stores each ndarray as msgpack ext type 1 holding ``(shape, dtype
name, bytes)``).  A 2D generator exports and loads as a 3D one does;
``meta.json``'s ``is3d`` says which to build.  ``load_generator`` also
reads the reference's own export, a Keras SavedModel directory or an
``.h5`` / ``.keras`` file with its 4-key ``meta.json`` beside it, through
``compat`` (TensorFlow needed then only).

``save_model`` (reference utils.py:133-167; transfer_em_tpu/infer/
export.py:95-110) rebuilds ``EM2EM`` from one of its checkpoints and
exports generator G; ``predict_cube_from_saved_model`` (export.py:113-123)
predicts an ng-precomputed region with an export.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ExportMeta
from ..device import resolve_device
from ..models.convert import params_from_jax, params_geometry, params_to_jax
from ..models.generator import DTypeLike, UNetGenerator

PARAMS_FILE = "generator.npz"
MSGPACK_FILE = "generator.msgpack"
META_FILE = "meta.json"


def export_generator(gen: torch.nn.Module, meta: ExportMeta, out_dir: str,
                     fmt: str = "npz") -> None:
    """Write the generator's weights and meta.json: ``fmt="npz"``
    (generator.npz) or ``"msgpack"`` (generator.msgpack, the JAX package's
    export, written as flax's ``serialization.to_bytes`` writes it)."""
    if fmt not in ("npz", "msgpack"):
        raise ValueError(f"fmt must be 'npz' or 'msgpack', got {fmt!r}")
    os.makedirs(out_dir, exist_ok=True)
    if fmt == "npz":
        arrays = {name.replace(".", "/"):
                  t.detach().to("cpu", torch.float32).numpy()
                  for name, t in gen.state_dict().items()}
        np.savez(os.path.join(out_dir, PARAMS_FILE), **arrays)
    else:
        with open(os.path.join(out_dir, MSGPACK_FILE), "wb") as f:
            f.write(write_flax_msgpack(params_to_jax(gen.state_dict())))
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        f.write(meta.to_json())


@functools.lru_cache(maxsize=16)
def generator_module(wf: int) -> UNetGenerator:
    """One ``UNetGenerator`` a width, the same object every call, as the
    JAX package caches its module so that ``gen.apply`` stays one callable.
    A torch module carries its weights: this one holds the default init on
    the CPU and is shared by every caller; ``load_generator`` builds a
    module of its own for each export."""
    return UNetGenerator(wf=wf)


def _ndarray_to_ext(x):
    import msgpack
    if not isinstance(x, np.ndarray):
        raise TypeError(f"cannot serialize {type(x)}")
    return msgpack.ExtType(1, msgpack.packb(
        (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))


def write_flax_msgpack(tree: Dict) -> bytes:
    """A param tree of numpy leaves in flax's msgpack layout (ndarrays as
    ext type 1 of ``(shape, dtype name, bytes)``)."""
    import msgpack
    return msgpack.packb(tree, default=_ndarray_to_ext, strict_types=True)


def _ndarray_from_ext(code: int, data: bytes):
    import msgpack
    if code != 1:  # flax _MsgpackExtType.ndarray
        return msgpack.ExtType(code, data)
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        raise ValueError("bfloat16 leaves in generator.msgpack are not "
                         "supported; export float32 params")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def read_flax_msgpack(path: str) -> Dict:
    """The flax param tree stored by ``flax.serialization.to_bytes``."""
    import msgpack
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ndarray_from_ext,
                               raw=False)


def _read_params(model_dir: str) -> Dict[str, torch.Tensor]:
    npz = os.path.join(model_dir, PARAMS_FILE)
    if os.path.exists(npz):
        with np.load(npz) as data:
            return {k.replace("/", "."): torch.from_numpy(data[k].copy())
                    for k in data.files}
    packed = os.path.join(model_dir, MSGPACK_FILE)
    if os.path.exists(packed):
        return params_from_jax(read_flax_msgpack(packed))
    raise FileNotFoundError(
        f"{model_dir!r} contains neither {PARAMS_FILE} / {MSGPACK_FILE} "
        "(the port's or the JAX package's export) nor saved_model.pb/.h5/"
        ".keras (a reference TF export)")


def load_generator(model_dir: str, device="cuda",
                   compute_dtype: DTypeLike = None
                   ) -> Tuple[UNetGenerator, ExportMeta]:
    """Load an exported generator onto ``device``: returns (gen, meta), gen
    in eval mode, 3D or 2D as ``meta.is3d`` says.  Reads this package's npz,
    the JAX package's msgpack, or a reference TF export: a Keras SavedModel
    directory or an ``.h5`` / ``.keras`` file, whose meta.json sits beside
    it, converted by ``compat`` with ``wf`` and 2D/3D from the weights
    (transfer_em_tpu/infer/export.py:60-83)."""
    dev = resolve_device(device)
    is_file = (model_dir.endswith((".h5", ".keras"))
               and os.path.isfile(model_dir))
    meta_dir = os.path.dirname(model_dir) if is_file else model_dir
    with open(os.path.join(meta_dir, META_FILE)) as f:
        meta = ExportMeta.from_json(f.read())
    if is_file or os.path.exists(os.path.join(model_dir, "saved_model.pb")):
        import dataclasses

        from ..compat import load_tf_generator
        _, params = load_tf_generator(model_dir, device="cpu")
        wf, is3d = params_geometry(params)
        meta = dataclasses.replace(meta, wf=wf, is3d=is3d)
        gen = UNetGenerator(wf=wf, compute_dtype=compute_dtype, is3d=is3d)
        gen.load_state_dict(params, strict=True)
        return gen.to(dev).eval(), meta
    gen = UNetGenerator(wf=meta.wf, compute_dtype=compute_dtype,
                        is3d=meta.is3d)
    gen.load_state_dict(_read_params(model_dir), strict=True)
    return gen.to(dev).eval(), meta


def save_model(name: str, ckpt_dir, meanstd_x: Tuple[float, float],
               meanstd_y: Tuple[float, float], size: int = 74,
               is3d: bool = True, wf: int = 8, device="cuda",
               fmt: str = "npz") -> None:
    """Rebuild ``EM2EM`` (3D, or 2D with ``is3d=False``) from the checkpoint
    ``ckpt_dir`` (a step directory ``.../train_<exp>/<step>``) on
    ``device`` and export its generator G to the directory ``name``
    (meta.json and generator.npz, or with ``fmt="msgpack"`` the JAX
    package's generator.msgpack).  As in the JAX package, ``size`` defaults
    to 74 (the reference's 132 is a stale recipe its own VALID_DIMS
    rejects)."""
    from ..train.cgan import EM2EM
    model = EM2EM(size, name, is3d=is3d, wf=wf, ckpt_restore=ckpt_dir,
                  device=device)
    meta = ExportMeta(buffer=model.buffer, outdimsize=model.outdimsize,
                      meanstd_x=tuple(map(float, meanstd_x)),
                      meanstd_y=tuple(map(float, meanstd_y)),
                      dimsize=size, is3d=is3d, wf=wf)
    export_generator(model.state.gg, meta, name, fmt)


def predict_cube_from_saved_model(location: str, start, size, cloudrun: str,
                                  model_dir: str, fetch_input: bool = False,
                                  batch_size: int = 8, device="cuda"):
    """Tiled inference of an ng-precomputed region with an exported model
    (either export format; reference utils.py:12-38)."""
    from .tiling import predict_ng_cube
    gen, meta = load_generator(model_dir, device=device)
    return predict_ng_cube(
        location, start, size, gen, meta.meanstd_x, meta.meanstd_y, cloudrun,
        fetch_input=fetch_input, outdimsize=meta.outdimsize,
        buffer=meta.buffer, batch_size=batch_size, device=device)
