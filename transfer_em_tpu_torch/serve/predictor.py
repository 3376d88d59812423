"""Prediction-service predictors (AI-Platform custom predictors).

Counterpart of ``transfer_em_tpu/serve/predictor.py``:

* ``TransferEMPredictor``: loads an exported generator, takes one
  ``{location, cloudrun, start, size}`` instance, runs tiled inference and
  returns the volume base64-encoded (reference predict_service.py:14-74).
* ``NgOutputPredictor``: also writes the prediction as a
  neuroglancer-precomputed volume (a plain ``info`` manifest and 64^3 gzip
  blocks) under a uuid-named destination, local or ``gs://``, and returns a
  neuroglancer viewer URL (reference custom_online/predictor.py:41-152).
"""

from __future__ import annotations

import base64
import json
import os
import threading
import uuid
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..infer.export import load_generator
from ..infer.tiling import check_generator, predict_ng_cube
from .model_service import BlockWriter, write_ng_blocks


class TransferEMPredictor:
    """Base64 predictor (reference predict_service.py).

    ``gen`` lives on ``device``.  ``cross_batch`` (default on): concurrent
    ``predict`` calls share device batches through one lazily built
    ``infer.TileBatcher`` (bit-identical results); ``close()`` stops it for
    good."""

    def __init__(self, gen, meta, cross_batch: bool = True, device="cuda"):
        self.device = resolve_device(device)
        check_generator(gen, self.device)
        self._gen = gen
        self.outdimsize = meta.outdimsize
        self.buffer = meta.buffer
        self.meanstd_x = meta.meanstd_x
        self.meanstd_y = meta.meanstd_y
        self._cross_batch = cross_batch
        self._batcher = None
        self._lock = threading.Lock()

    def _get_batcher(self):
        with self._lock:
            # read under the lock: close() clears it there, so a predict()
            # racing close() cannot start a new worker thread
            if not self._cross_batch:
                return None
            if self._batcher is None:
                from ..infer.batcher import make_tile_batcher
                self._batcher = make_tile_batcher(
                    self._gen, self.meanstd_x, self.meanstd_y,
                    self.outdimsize, self.buffer, device=self.device)
            return self._batcher

    def close(self):
        """Stop the shared batcher's worker (idempotent and terminal: later
        predict() calls run unbatched)."""
        with self._lock:
            self._cross_batch = False
            if self._batcher is not None:
                self._batcher.close()
                self._batcher = None

    def _predict_cube(self, inst: dict) -> np.ndarray:
        return predict_ng_cube(
            inst["location"], tuple(inst["start"]), tuple(inst["size"]),
            self._gen, self.meanstd_x, self.meanstd_y, inst.get("cloudrun"),
            outdimsize=self.outdimsize, buffer=self.buffer,
            batcher=self._get_batcher(), device=self.device)

    def predict(self, instances: List[dict], **kwargs) -> List[bytes]:
        """One {location, cloudrun, start, size} instance -> [base64 bytes]
        of the zyx uint8 prediction."""
        if len(instances) != 1:
            raise RuntimeError("only one instance allowed")
        res = self._predict_cube(instances[0])
        return [base64.b64encode(np.ascontiguousarray(res))]

    @classmethod
    def from_path(cls, model_dir: str, device="cuda", compute_dtype=None,
                  **kwargs) -> "TransferEMPredictor":
        gen, meta = load_generator(model_dir, device=device,
                                   compute_dtype=compute_dtype)
        return cls(gen, meta, device=device, **kwargs)


def write_ng_info(dest_dir_or_bucket, size_xyz, write_fn):
    """Write a minimal neuroglancer-precomputed ``info`` manifest through
    ``write_fn(name, bytes)`` (reference custom_online/predictor.py:
    103-127; ``dest_dir_or_bucket`` is unused, kept for the JAX package's
    signature)."""
    info = {
        "@type": "neuroglancer_multiscale_volume",
        "data_type": "uint8",
        "num_channels": 1,
        "scales": [{
            "chunk_sizes": [[64, 64, 64]],
            "encoding": "raw",
            "key": "64_64_64",
            "resolution": [8, 8, 8],
            "size": list(size_xyz),
            "voxel_offset": [0, 0, 0],
        }],
        "type": "image",
    }
    write_fn("info", json.dumps(info).encode())


class NgOutputPredictor(TransferEMPredictor):
    """Predict, publish as an ng volume under a random name in
    ``dest_root`` (a local directory or ``gs://bucket/prefix``), and return
    a viewer URL (reference custom_online/predictor.py)."""

    def __init__(self, gen, meta, dest_root: str,
                 viewer_base: str = "https://neuroglancer-demo.appspot.com",
                 cross_batch: bool = True, device="cuda"):
        super().__init__(gen, meta, cross_batch=cross_batch, device=device)
        self.dest_root = dest_root
        self.viewer_base = viewer_base

    def predict(self, instances: List[dict], **kwargs) -> List[str]:
        if len(instances) != 1:
            raise RuntimeError("only one instance allowed")
        inst = instances[0]
        vol_zyx = self._predict_cube(inst)

        name = str(uuid.uuid4())
        dest = os.path.join(self.dest_root, name)
        # the info goes up plain (custom_online/predictor.py:126-127), the
        # blocks gzip
        writer = BlockWriter(dest)
        write_ng_info(dest, inst["size"],
                      lambda n, b: writer.write(n, b, compress=False))
        write_ng_blocks(vol_zyx, dest + "/64_64_64", (0, 0, 0))

        state = {"layers": [{"type": "image",
                             "source": f"precomputed://{dest}",
                             "name": name}]}
        return [f"{self.viewer_base}/#!"
                f"{json.dumps(state, separators=(',', ':'))}"]

    @classmethod
    def from_path(cls, model_dir: str, dest_root: Optional[str] = None,
                  device="cuda", compute_dtype=None,
                  **kwargs) -> "NgOutputPredictor":
        gen, meta = load_generator(model_dir, device=device,
                                   compute_dtype=compute_dtype)
        return cls(gen, meta,
                   dest_root or os.environ.get("NG_DEST", "./ng_out"),
                   device=device, **kwargs)
