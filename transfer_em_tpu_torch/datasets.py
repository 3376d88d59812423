"""The ``transfer_em.datasets`` names (reference datasets/datasets.py and
datasets/generators.py), as transfer_em_tpu/datasets.py gathers them."""

from .data.pipeline import (BATCH_SIZE, BUFFER_SIZE, EPOCH_SIZE,
                            create_dataset_from_generator,
                            create_dataset_from_tensors)
from .data.sources import fetch_raw_dvid, volume3d_dvid, volume3d_ng
from .ops.augment import augment, batch_augment
from .ops.normalize import (get_meanstd, scale_tensor, standardize_population,
                            unstandardize_population)

__all__ = [
    "BATCH_SIZE", "BUFFER_SIZE", "EPOCH_SIZE",
    "create_dataset_from_generator", "create_dataset_from_tensors",
    "fetch_raw_dvid", "volume3d_dvid", "volume3d_ng",
    "augment", "batch_augment", "get_meanstd", "scale_tensor",
    "standardize_population", "unstandardize_population",
]
