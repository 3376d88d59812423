"""Reference-named model building blocks (counterpart of
``transfer_em_tpu/models/utils.py``, reference transfer_em/models/
utils.py:10-137): ``InstanceNormalization``, ``downsample`` and ``upsample``
with the reference's signatures, over the modules of ``blocks.py``.

The reference's norm layers are commented out (utils.py:75-82, 124-131),
so ``norm_type`` and ``apply_norm`` change nothing here either.  Unlike the
JAX shim, where Flax infers the rank from the input, ``is3d`` chooses the
module's rank here, and ``infilters`` its input width: the port builds its
kernels before it sees an input.
"""

from __future__ import annotations

from .blocks import DownBlock, InstanceNorm, UpBlock


def InstanceNormalization(is3d=True, epsilon=1e-5, features: int = 1
                          ) -> InstanceNorm:
    """Reference class name and signature (utils.py:10-16; the reference
    calls it positionally, ``InstanceNormalization(is3d)``).  The module
    normalizes over every spatial axis of its input, whatever ``is3d``
    says; ``features`` is the channel count its scale and offset need."""
    del is3d  # the spatial axes are the input's
    return InstanceNorm(features, epsilon=epsilon)


def _check_filter_size(filter_size: int, where: str) -> None:
    if filter_size != 4:
        raise NotImplementedError(
            f"filter_size != 4 (the reference never uses another value; "
            f"models/utils.py:{where})")


def downsample(id, infilters, outfilters, is3d=True, filter_size=4,
               norm_type="instancenorm", apply_norm=True) -> DownBlock:
    """3x3 VALID conv -> LeakyReLU (skip tap) -> 4x4 stride-2 VALID conv ->
    LeakyReLU (reference utils.py:41-85), as ONE module whose forward
    returns ``(downsampled, skip)``, the pair the reference returns as two
    weight-sharing Keras models."""
    del id, norm_type, apply_norm
    _check_filter_size(filter_size, "41")
    return DownBlock(infilters, outfilters, ndim=3 if is3d else 2)


def upsample(id, infilters, outfilters, is3d=True, filter_size=4,
             norm_type="instancenorm", apply_dropout=True) -> UpBlock:
    """3x3 VALID conv (2x filters) -> LeakyReLU -> 4x4 stride-2 SAME
    transposed conv -> Dropout(0.5) -> LeakyReLU (reference utils.py:
    89-137).  Dropout runs when the forward is called with
    ``deterministic=False`` and ``apply_dropout`` is on."""
    del id, norm_type
    _check_filter_size(filter_size, "89")
    return UpBlock(infilters, outfilters, apply_dropout=apply_dropout,
                   ndim=3 if is3d else 2)


__all__ = ["InstanceNormalization", "downsample", "upsample"]
