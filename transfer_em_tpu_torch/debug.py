"""Self-supervised evaluation tools (counterpart of transfer_em_tpu/debug.py,
reference transfer_em/debug.py).

* ``warp_tensor``: ``ops.warp.warp``, which makes an artificial source
  domain (blur + holes) from the target domain (debug.py:7-63).
* ``accuracy``: RMSE between the unwarped ground truth and a prediction
  (debug.py:65-71).
* ``generate_images``: the first batch element of an input and its output
  side by side, its first z-slice in 3D (debug.py:73-102); matplotlib is
  imported when it is called.

Each takes 3D (B, D, H, W, 1) and 2D (B, H, W, 1) batches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.losses import psnr, rmse
from .ops.warp import batch_warp, make_warp_map, warp

warp_tensor = warp


def accuracy(unwarped_orig_tensor, predicted_tensor) -> float:
    """RMSE between ground truth and prediction (reference debug.py:65-71)."""
    return float(rmse(torch.as_tensor(unwarped_orig_tensor),
                      torch.as_tensor(predicted_tensor)))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x)


def generate_images(orig, pred, show: bool = True,
                    save_path: Optional[str] = None):
    """Display and/or save an input/output pair (reference debug.py:73-102).
    The first batch element: its first z-slice for a 3D (rank-5) input, the
    image itself for a 2D (rank-4) one.  Where matplotlib is not installed,
    a save without ``show`` writes the pair side by side as a grey PNG
    through PIL (``x * 0.5 + 0.5`` on [0, 1], as the figure shows it)."""
    orig, pred = _host(orig), _host(pred)
    if orig.ndim == 5:
        orig = orig[0, 0, :, :, 0]
        pred = pred[0, 0, :, :, 0]
    else:
        orig = orig[0, :, :, 0]
        pred = pred[0, :, :, 0]
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        if show or not save_path:
            raise
        _save_pair_png(orig, pred, save_path)
        return

    fig = plt.figure(figsize=(12, 12))
    plt.subplot(121)
    plt.title("input")
    plt.imshow(orig * 0.5 + 0.5, cmap="gray", vmin=0, vmax=1)
    plt.axis("off")
    plt.subplot(122)
    plt.title("output")
    plt.imshow(pred * 0.5 + 0.5, cmap="gray", vmin=0, vmax=1)
    plt.axis("off")
    if save_path:
        plt.savefig(save_path)
    if show:
        plt.show()
    else:
        plt.close(fig)


def _save_pair_png(orig: np.ndarray, pred: np.ndarray, path: str) -> None:
    """Input and output images side by side (8 black columns between, the
    shorter one top-aligned) as an 8-bit grey PNG."""
    from PIL import Image

    h = max(orig.shape[0], pred.shape[0])
    canvas = np.full((h, orig.shape[1] + 8 + pred.shape[1]), -1.0,
                     np.float32)
    canvas[:orig.shape[0], :orig.shape[1]] = orig
    canvas[:pred.shape[0], orig.shape[1] + 8:] = pred
    grey = np.round(np.clip(canvas * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(grey).save(path, format="PNG")


__all__ = ["warp", "warp_tensor", "batch_warp", "make_warp_map", "accuracy",
           "generate_images", "rmse", "psnr"]
