"""PyTorch/CUDA port of transfer_em_tpu for NVIDIA Hopper (H100).

The JAX package ``transfer_em_tpu`` stays the reference; this package keeps
its module names so each counterpart is easy to find, and imports nothing of
it.  Every Pallas kernel on the ported path is a hand-written CUDA kernel
under ``csrc/`` (built with nvcc for sm_90a at first use, ``kernels/``);
each wrapper runs its plain PyTorch version only for tensors on the CPU.

Entry points (``EM2EM``, ``create_dataset_from_tensors``,
``create_dataset_from_generator``, ``save_model``, ``load_generator``,
``predict_tiled``, ``predict_volume``, ``make_tile_batcher``,
``ModelService``) run on ``cuda``
unless the caller passes ``device="cpu"``, and raise when CUDA is asked for
but absent.
"""

from .data import create_dataset_from_generator, create_dataset_from_tensors
from .device import resolve_device
from .infer import predict_volume
from .train import EM2EM

__all__ = ["EM2EM", "create_dataset_from_generator",
           "create_dataset_from_tensors", "predict_volume", "resolve_device"]
