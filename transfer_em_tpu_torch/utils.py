"""The reference's ``transfer_em.utils`` names (reference utils.py), as the
JAX package's ``transfer_em_tpu/utils.py`` re-exports them."""

from .infer.export import predict_cube_from_saved_model, save_model
from .infer.tiling import predict_ng_cube, predict_tiled

__all__ = ["predict_ng_cube", "predict_tiled",
           "predict_cube_from_saved_model", "save_model"]
