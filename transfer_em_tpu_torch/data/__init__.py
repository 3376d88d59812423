"""Data pipelines and remote-volume sources of the port."""

from .pipeline import (BATCH_SIZE, BUFFER_SIZE, EPOCH_SIZE, Dataset,
                       create_dataset_from_generator,
                       create_dataset_from_tensors, zip_datasets)
from .sources import (corner_stream, fetch_raw_dvid, open_tensorstore,
                      volume3d_dvid, volume3d_ng)

__all__ = [
    "BATCH_SIZE", "BUFFER_SIZE", "EPOCH_SIZE", "Dataset",
    "create_dataset_from_generator", "create_dataset_from_tensors",
    "zip_datasets", "corner_stream", "fetch_raw_dvid", "open_tensorstore",
    "volume3d_dvid", "volume3d_ng",
]
