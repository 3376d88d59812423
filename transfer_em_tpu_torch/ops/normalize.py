"""The tile step's uint8 edges (counterpart of transfer_em_tpu/ops/normalize.py).

The JAX tile step calls the jnp functions of normalize.py and leaves fusion
to XLA.  The port has no such compiler, so the same two functions run on the
hand-written kernels of ``ops/cuda_kernels.py`` (plain PyTorch on the CPU):

* ``preprocess_u8``: uint8 -> float32 scale + standardize, one affine pass
  (normalize.py:78-91), with a trailing channel axis;
* ``postprocess_to_u8``: unstandardize, rescale, round half to even, clip
  (normalize.py:94-102), here with the tile step's tpad trim folded in and
  the channel axis dropped.
"""

from __future__ import annotations

from .cuda_kernels import postprocess_u8 as postprocess_to_u8
from .cuda_kernels import preprocess_u8

__all__ = ["preprocess_u8", "postprocess_to_u8"]
