"""Data pipelines and remote-volume sources of the port.

The names resolve on first use (PEP 562): ``data.sources`` loads no torch,
and the serving data plane reads volumes through it.
"""

import importlib

_EXPORTS = {
    **{name: "pipeline" for name in (
        "BATCH_SIZE", "BUFFER_SIZE", "EPOCH_SIZE", "Dataset",
        "create_dataset_from_generator", "create_dataset_from_tensors",
        "zip_datasets")},
    **{name: "sources" for name in (
        "corner_stream", "fetch_raw_dvid", "open_tensorstore",
        "volume3d_dvid", "volume3d_ng")},
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
