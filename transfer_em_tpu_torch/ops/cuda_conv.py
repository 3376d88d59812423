"""3x3x3 stride-1 VALID conv on a hand-written CUDA kernel.

Counterpart of ``transfer_em_tpu/ops/pallas_conv.py``: the kernel
(``csrc/conv3.cu``) replaces the Pallas Toeplitz-GEMM ``_tconv3_kernel``
(pallas_conv.py:69-114, ``pallas_call`` at :174) reached through ``tconv3``
(138-159), ``tconv3_op`` (196-219) and ``tconv3_act_op`` (224-246).  Unlike
the TPU kernel, whose ``supported()`` (42-53) needs W >= 128/C and so leaves
the C=1 stem to XLA at 74^3, it serves every k3 conv of the generator, the
stem included.  conv3.cu's header says what bounds it on the H100 and what
the simple design does about it.

Inference only in this slice: the backward (``F.conv3d`` gradients, the
``custom_vjp`` split of pallas_conv.py:206-216) comes with the train step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .cuda_kernels import LEAKY_SLOPE


def conv3_plain(x: torch.Tensor, w: torch.Tensor,
                leaky: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 products and sums,
    optional LeakyReLU, one rounding to x's dtype."""
    y = F.conv3d(x.to(torch.float32).permute(0, 4, 1, 2, 3),
                 w.to(torch.float32).permute(4, 3, 0, 1, 2))
    y = y.permute(0, 2, 3, 4, 1)
    if leaky is not None:
        y = torch.where(y >= 0, y, y * leaky)
    return y.to(x.dtype).contiguous()


def conv3(x: torch.Tensor, w: torch.Tensor,
          leaky: Optional[float] = None) -> torch.Tensor:
    """(B, D, H, W, C) * (3, 3, 3, C, O) -> (B, D-2, H-2, W-2, O) in x's
    dtype (float32 or bfloat16; w must have the same dtype).  ``leaky``
    fuses LeakyReLU(negative_slope=leaky) into the epilogue."""
    if x.device.type == "cpu":
        return conv3_plain(x, w, leaky)
    kernels.check_cuda_tensor(x, "conv3 x", tuple(kernels.DTYPE_CODES), 5)
    kernels.check_cuda_tensor(w, "conv3 w", (x.dtype,), 5)
    bsz, d, h, wd, c = x.shape
    o = w.shape[-1]
    if tuple(w.shape[:4]) != (3, 3, 3, c):
        raise ValueError(f"conv3: kernel {tuple(w.shape)} does not match "
                         f"input channels {c}")
    if min(d, h, wd) < 3:
        raise ValueError(f"conv3: input {tuple(x.shape)} smaller than 3^3")
    y = torch.empty((bsz, d - 2, h - 2, wd - 2, o), dtype=x.dtype,
                    device=x.device)
    kernels.launch("tem_conv3", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                   kernels.DTYPE_CODES[x.dtype], bsz, d, h, wd, c, o,
                   int(leaky is not None),
                   float(leaky) if leaky is not None else 0.0,
                   device=x.device)
    conv3.launches += 1
    return y


conv3.launches = 0


def conv3_act(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3 with the fused LeakyReLU(0.3) epilogue (``tconv3_act_op``)."""
    return conv3(x, w, leaky=LEAKY_SLOPE)
