"""Clients of the serving endpoints; they load neither torch nor JAX.

Own copy of ``transfer_em_tpu/serve/client.py``:

* ``predict_cloud``: Google AI Platform ``projects.predict`` client that
  decodes the base64 volume (reference transfer_em/predict_cloud.py:11-52;
  needs googleapiclient).
* ``fetch_subvolume``: POST /volume client of the data service (reference
  cloudrun_functions/transferem.py:195-251).
* ``predict_chunk``: POST / client of the model service.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Optional

import numpy as np


def predict_cloud(project: str, model: str, location: str, cloudrun: str,
                  start, size, version: Optional[str] = None) -> np.ndarray:
    """Call a deployed predictor and decode its base64 uint8 volume, zyx of
    the xyz ``size`` (reference predict_cloud.py:11-52)."""
    import googleapiclient.discovery
    service = googleapiclient.discovery.build("ml", "v1")
    name = f"projects/{project}/models/{model}"
    if version is not None:
        name += f"/versions/{version}"
    payload = [{"location": location, "cloudrun": cloudrun,
                "start": list(start), "size": list(size)}]
    response = service.projects().predict(
        name=name, body={"instances": payload}).execute()
    if "error" in response:
        raise RuntimeError(response["error"])
    data = response["predictions"]
    if isinstance(data, str):
        # JSON transports deliver base64 as str; decodebytes takes bytes
        # (the reference passes the str through, predict_cloud.py:50-51).
        data = data.encode("ascii")
    array = np.frombuffer(base64.decodebytes(data), dtype=np.uint8)
    return array.reshape(tuple(reversed(size)))


def fetch_subvolume(service_url: str, location: str, box_zyx,
                    scale_index: int = 0) -> np.ndarray:
    """Fetch the zyx box ((z0, y0, x0), (z1, y1, x1)) from the data service;
    returns a C-order zyx array."""
    import requests
    box_zyx = np.asarray(box_zyx)
    shape_zyx = box_zyx[1] - box_zyx[0]
    config = {
        "location": location,
        "start": box_zyx[0, ::-1].tolist(),   # the service takes xyz
        "size": shape_zyx[::-1].tolist(),
        "scale_index": scale_index,
    }
    r = requests.post(service_url + "/volume", data=json.dumps(config),
                      headers={"Content-type": "application/json"})
    if r.status_code != 200:
        raise RuntimeError(r.content.decode())
    return np.frombuffer(r.content, np.uint8).reshape(tuple(shape_zyx))


def predict_chunk(service_url: str, location: str, start, size,
                  model_name: str, dest: str, glbstart=(0, 0, 0),
                  max_wait_s: float = 300.0) -> None:
    """Ask the model service to predict a 64-aligned chunk and write its ng
    blocks under ``dest`` (reference model_cloudrun/transferem.py:46-53).
    A 503 means the service is full: retry after its Retry-After, for at
    most ``max_wait_s`` in all."""
    import requests
    config = {"location": location, "start": list(start),
              "glbstart": list(glbstart), "size": list(size),
              "model_name": model_name, "dest": dest}
    deadline = time.monotonic() + max_wait_s
    while True:
        r = requests.post(service_url + "/", data=json.dumps(config),
                          headers={"Content-type": "application/json"})
        if r.status_code == 200:
            return
        if r.status_code == 503 and time.monotonic() < deadline:
            time.sleep(float(r.headers.get("Retry-After", 1)))
            continue
        raise RuntimeError(r.content.decode())
