"""The one reader of the hand-written kernels' counts.

Each wrapper counts with ``telemetry.count`` under a name of
``telemetry.LAUNCHES`` where it launches its kernel, packs weights or
picks a form, and nowhere else.  The benches and ``chip_smoke.py`` read
and reset the counts here."""

from __future__ import annotations

from typing import Dict

from .. import telemetry

# the counts that are weight packs (plain torch), not kernel launches
PACKS = ("int8_weight_packs", "conv3_weight_packs", "down4_weight_packs")


def read_counts() -> Dict[str, int]:
    """Launches per kernel: conv3 (also by path, tc and direct, those of
    tc in its kw form, ``conv3_tc_kw``, and those on bfloat16 operands),
    down4, preprocess_u8, postprocess_u8, leaky_relu
    (and on bfloat16), conv_int8 and quantize_int8; beside them the weight
    packs (:data:`PACKS`), and the transposed convs by form:
    ``transpose_phase`` (the phase conv, whose k3 conv counts under conv3
    in 3D) and ``transpose_cudnn`` (cuDNN's transposed conv; the int8
    transposed conv is neither), and the k4 stride-2 VALID convs by form:
    ``down_k4`` (the down4 kernel's form, whose launches count under
    ``down4`` on the card) and ``down_cudnn`` (``F.conv{2,3}d``; the int8
    down conv is neither)."""
    return telemetry.launches()


def reset_counts() -> None:
    """Every count of :func:`read_counts` to 0."""
    telemetry.reset_launches()
