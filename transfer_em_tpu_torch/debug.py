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
    image itself for a 2D (rank-4) one."""
    import matplotlib.pyplot as plt

    orig, pred = _host(orig), _host(pred)
    if orig.ndim == 5:
        orig = orig[0, 0, :, :, 0]
        pred = pred[0, 0, :, :, 0]
    else:
        orig = orig[0, :, :, 0]
        pred = pred[0, :, :, 0]

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


__all__ = ["warp", "warp_tensor", "batch_warp", "make_warp_map", "accuracy",
           "generate_images", "rmse", "psnr"]
