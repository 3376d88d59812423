"""PyTorch/CUDA port of transfer_em_tpu for NVIDIA Hopper (H100).

The JAX package ``transfer_em_tpu`` stays the reference; this package keeps
its module names so each counterpart is easy to find, and imports nothing of
it.  Every Pallas kernel on the ported path is a hand-written CUDA kernel
under ``csrc/`` (built with nvcc for sm_90a at first use, ``kernels/``);
each wrapper runs its plain PyTorch version only for tensors on the CPU.

Entry points (``EM2EM``, ``create_dataset_from_tensors``,
``create_dataset_from_generator``, ``save_model``, ``load_generator``,
``predict_tiled``, ``predict_ng_cube``, ``predict_volume``,
``make_tile_batcher``, ``ModelService``, the predictors) run on ``cuda``
unless the caller passes ``device="cpu"``, and raise when CUDA is asked for
but absent.

``shapes``, ``CycleGANConfig``, ``ExportMeta`` and ``__version__`` load
with the package, as in the JAX package (none of them imports torch); the
names in ``_LAZY`` resolve on first use (PEP 562): a bare ``import
transfer_em_tpu_torch`` loads no torch, so the data plane
(``serve.backends``, ``serve.client``, ``serve.data_service``, which fork
worker processes) stays free of it.  ``compat`` (the TF/Keras interop)
resolves as a submodule on first use too, and loads neither TensorFlow nor
torch until one of its functions runs.
"""

import importlib

from . import shapes
from .config import CycleGANConfig, ExportMeta
from .version import __version__

_LAZY = {
    "EM2EM": "transfer_em_tpu_torch.train.cgan",
    "create_dataset_from_generator": "transfer_em_tpu_torch.data.pipeline",
    "create_dataset_from_tensors": "transfer_em_tpu_torch.data.pipeline",
    "predict_ng_cube": "transfer_em_tpu_torch.infer.tiling",
    "predict_volume": "transfer_em_tpu_torch.infer",
    "resolve_device": "transfer_em_tpu_torch.device",
    "save_model": "transfer_em_tpu_torch.infer.export",
}

_LAZY_MODULES = ("compat",)

__all__ = ["shapes", "CycleGANConfig", "ExportMeta", "__version__",
           *_LAZY, *_LAZY_MODULES]


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_LAZY[name]), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | set(_LAZY_MODULES))
