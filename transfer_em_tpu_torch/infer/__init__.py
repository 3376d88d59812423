"""Inference of the port: tiled prediction, export/load, tile batching."""

from .batcher import TileBatcher, make_tile_batcher
from .export import export_generator, load_generator, save_model
from .tiling import (InferenceCancelled, TilePlan, make_tile_step,
                     plan_tiles, predict_tiled, scatter_tiles)

__all__ = [
    "export_generator", "load_generator", "save_model", "TilePlan",
    "make_tile_step",
    "plan_tiles", "predict_tiled", "scatter_tiles", "InferenceCancelled",
    "TileBatcher", "make_tile_batcher",
]
