"""Data and halo parallelism of the port (counterpart of
``transfer_em_tpu/parallel``): device meshes, the data-parallel train step,
halo-exchange inference and multi-process setup over ``torch.distributed``.

The names resolve on first use (PEP 562), like the port's other packages.
"""

import importlib

_EXPORTS = {
    **{name: "distributed" for name in ("initialize", "process_info")},
    **{name: "dp" for name in ("host_local_batch", "make_dp_train_step",
                               "shard_batch", "shard_state")},
    **{name: "halo" for name in ("halo_predict", "halo_predict_fn")},
    **{name: "mesh" for name in ("DATA_AXIS", "SPACE_AXIS", "SPACE_X_AXIS",
                                 "SPACE_Y_AXIS", "Mesh", "ShardedTensor",
                                 "batch_sharding", "make_mesh", "replicated",
                                 "space_sharding")},
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
