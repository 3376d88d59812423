"""Serving layer of the port: the model service, the data service, the
predictors and their clients.

The names resolve on first use (PEP 562), as in the JAX package: the
data-plane modules (``backends``, ``data_service``, ``client``) load no
torch, since the data service forks worker processes, and an eager
``from .model_service import ...`` here would load torch into every one.
"""

import importlib

_EXPORTS = {
    "NumpyVolume": "backends",
    "TensorstoreVolume": "backends",
    "open_volume": "backends",
    "register_volume": "backends",
    "fetch_subvolume": "client",
    "predict_chunk": "client",
    "predict_cloud": "client",
    "DataService": "data_service",
    "LruCache": "data_service",
    "ModelService": "model_service",
    "write_ng_blocks": "model_service",
    "NgOutputPredictor": "predictor",
    "TransferEMPredictor": "predictor",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
