"""The one reader of the hand-written kernels' launch counts.

Each wrapper adds one to its count where it launches its kernel, and
nowhere else (``ops/cuda_conv.py``, ``ops/cuda_down.py``,
``ops/cuda_kernels.py``, ``ops/cuda_int8.py``, ``ops/quant.py``);
``ops/convs.py`` counts which form each transposed conv and each k4
stride-2 down conv took.  The benches and ``chip_smoke.py`` read and reset
them here, so a new kernel or counter is added once."""

from __future__ import annotations

from typing import Dict

# the counts that are weight packs (plain torch), not kernel launches
PACKS = ("int8_weight_packs", "conv3_weight_packs", "down4_weight_packs")


def read_counts() -> Dict[str, int]:
    """Launches per kernel: conv3 (also by path, tc and direct, and those on
    bfloat16 operands), down4, preprocess_u8, postprocess_u8, leaky_relu
    (and on bfloat16), conv_int8 and quantize_int8; beside them the weight
    packs (:data:`PACKS`), and the transposed convs by form:
    ``transpose_phase`` (the phase conv, whose k3 conv counts under conv3
    in 3D) and ``transpose_cudnn`` (cuDNN's transposed conv; the int8
    transposed conv is neither), and the k4 stride-2 VALID convs by form:
    ``down_k4`` (the down4 kernel's route, whose launches count under
    ``down4`` on the card) and ``down_cudnn`` (``F.conv{2,3}d``; the int8
    down conv is neither)."""
    from . import convs, cuda_conv, cuda_down, cuda_int8, cuda_kernels, quant
    c3, lr = cuda_conv.conv3, cuda_kernels.leaky_relu
    return {"conv3": c3.launches,
            "down4": cuda_down.down4.launches,
            "preprocess_u8": cuda_kernels.preprocess_u8.launches,
            "postprocess_u8": cuda_kernels.postprocess_u8.launches,
            "leaky_relu": lr.launches,
            "conv_int8": cuda_int8.conv_int8.launches,
            "quantize_int8": quant.quantize_int8.launches,
            "int8_weight_packs": quant.int8_weights.packs,
            "conv3_tc": c3.launches_tc, "conv3_direct": c3.launches_direct,
            "conv3_bf16": c3.launches_bf16,
            "leaky_relu_bf16": lr.launches_bf16,
            "conv3_weight_packs": cuda_conv.packed_weights.packs,
            "down4_weight_packs": cuda_down.packed_down4_weights.packs,
            "transpose_phase": convs.conv_transpose_nd.phase_calls,
            "transpose_cudnn": convs.conv_transpose_nd.cudnn_calls,
            "down_k4": convs.conv_nd.k4_calls,
            "down_cudnn": convs.conv_nd.cudnn_calls}


def reset_counts() -> None:
    """Every count of :func:`read_counts` to 0."""
    from . import convs, cuda_conv, cuda_down, cuda_int8, cuda_kernels, quant
    c3, lr = cuda_conv.conv3, cuda_kernels.leaky_relu
    cuda_down.down4.launches = cuda_down.packed_down4_weights.packs = 0
    c3.launches = c3.launches_tc = c3.launches_direct = c3.launches_bf16 = 0
    lr.launches = lr.launches_bf16 = 0
    cuda_kernels.preprocess_u8.launches = 0
    cuda_kernels.postprocess_u8.launches = 0
    cuda_int8.conv_int8.launches = 0
    quant.quantize_int8.launches = 0
    quant.int8_weights.packs = 0
    cuda_conv.packed_weights.packs = 0
    convs.conv_transpose_nd.phase_calls = 0
    convs.conv_transpose_nd.cudnn_calls = 0
    convs.conv_nd.k4_calls = convs.conv_nd.cudnn_calls = 0
