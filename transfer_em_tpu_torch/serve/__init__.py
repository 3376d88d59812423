"""Serving layer of the port (model service over local volumes)."""

from .backends import NumpyVolume, open_volume, register_volume
from .model_service import ModelService, write_ng_blocks

__all__ = ["NumpyVolume", "open_volume", "register_volume", "ModelService",
           "write_ng_blocks"]
