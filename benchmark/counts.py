"""Operations and bytes of the benchmark's cells, counted from the plain
reference's layer shapes (``reference/models.py`` run on meta tensors), so
that no change to the system can move them, and the card's peaks.

Peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): 989 TFLOP/s for
bf16 operands, 495 TFLOP/s for float32 operands (TF32 on the tensor cores:
the highest rate at which the card multiplies float32 inputs; a float32
method that keeps float32 accuracy, such as three TF32 products, does more
products than the algorithm needs and is counted at the algorithm's), 3.35
TB/s of HBM.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference import models as M

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
TILE = 74          # the generator's input side
DISC_TILE = 40     # the discriminator's (the generator's output side)


def macs(layer: dict) -> int:
    """Multiply-adds of one conv: each output voxel takes taps x Cin x Cout
    of them; a transposed conv each INPUT voxel."""
    shape = layer["in_shape"] if layer["kind"] == "transposed" \
        else layer["out_shape"]
    voxels = shape[0] * math.prod(shape[2:])
    return voxels * math.prod(layer["kernel"])


@functools.lru_cache(maxsize=None)
def layers(net: str, wf: int) -> tuple:
    """Every conv of one tile's forward of ``net`` ("gen" or "disc"), in
    call order: name, kind (k3, k4, k1, transposed), NCDHW shapes, kernel
    shape and multiply-adds."""
    rec: List[dict] = []
    spec = M.generator_spec(wf) if net == "gen" else M.discriminator_spec(wf)
    p = {n: torch.empty(s, device="meta") for n, s in spec}
    side = TILE if net == "gen" else DISC_TILE
    x = torch.empty((1, 1, side, side, side), device="meta")
    with torch.no_grad():
        if net == "gen":
            M.generator(p, x, record=rec)
        else:
            M.discriminator(p, x, record=rec)
    for layer in rec:
        layer["macs"] = macs(layer)
    return tuple(rec)


def forward_flops(net: str, wf: int) -> int:
    """FLOPs (2 a multiply-add) of one tile's forward."""
    return 2 * sum(layer["macs"] for layer in layers(net, wf))


def train_step_flops(wf: int, batch: int) -> Dict[str, float]:
    """FLOPs of one train step of ``batch`` tile pairs, by pass:

    * forward: 6 generator tile applications a pair (G and F on 2B, the
      cycles on B) and 6 discriminator ones (each on the real and the
      detached fake, 2B, then frozen on the fake, B);
    * weight gradients: every generator application, the discriminators'
      4 trained ones;
    * input gradients: every layer but the first of an application whose
      input takes none (the generators' first round, the trained
      discriminators); the cycles and the frozen discriminators carry it
      to their input.
    """
    b = batch
    out = {"forward": 0, "backward_dw": 0, "backward_dx": 0}
    for net in ("gen", "disc"):
        for i, layer in enumerate(layers(net, wf)):
            if net == "gen":
                mult = {"forward": 6 * b, "backward_dw": 6 * b,
                        "backward_dx": 6 * b - (4 * b if i == 0 else 0)}
            else:
                mult = {"forward": 6 * b, "backward_dw": 4 * b,
                        "backward_dx": (4 * b if i > 0 else 0) + 2 * b}
            for k, n in mult.items():
                out[k] += 2 * n * layer["macs"]
    out["total"] = sum(out.values())
    out["per_tile_pair"] = out["total"] / b
    return out


def conv_work(calls: Dict[str, List[int]], wf: int, dtype: str,
              kinds: Tuple[str, ...] = ("k3",)) -> dict:
    """FLOPs and bytes of the convs of ``kinds`` (k3, k4, transposed) of
    forward calls on ``calls[net]`` tiles each: operations 2 x MACs (a
    transposed conv's by input voxel, the algorithm's 64 taps: not the zero
    taps that a form such as the phase conv multiplies); bytes the input
    and output activations once and the weights once a call, in the compute
    dtype.  The default, the k3 stride-1 convs, is the conv3 kernel's
    work."""
    size = DTYPE_BYTES[dtype]
    flops = byts = 0
    for net, batches in calls.items():
        for layer in layers(net, wf):
            if layer["kind"] not in kinds:
                continue
            per_tile_io = (math.prod(layer["in_shape"][1:])
                           + math.prod(layer["out_shape"][1:]))
            weights = math.prod(layer["kernel"])
            for n in batches:
                flops += 2 * layer["macs"] * n
                byts += size * (per_tile_io * n + weights)
    return {"flops": flops, "bytes": byts}


def tile_work(net: str, wf: int, dtype: str, kinds: Tuple[str, ...]
              ) -> dict:
    """:func:`conv_work` of one tile of ``net``'s forward, the weights
    apart: ``flops`` and activation ``bytes`` a tile, ``weight_bytes`` a
    call."""
    one = conv_work({net: [1]}, wf, dtype, kinds)
    weights = conv_work({net: [0]}, wf, dtype, kinds)["bytes"]
    return {"flops": one["flops"], "bytes": one["bytes"] - weights,
            "weight_bytes": weights}


def form_share(forms: Dict[str, int], taken: str, other: str) -> float:
    """The share of a window's convs that the port ran in the form counted
    as ``taken``, against those counted as ``other`` (the port's own form
    counts, ``telemetry.snapshot()["launches"]``); 0 where neither
    counted.  The counts say how many calls took each form, not which
    layer, so where both forms ran, each layer's work is counted at this
    share."""
    n, m = forms.get(taken, 0), forms.get(other, 0)
    return n / (n + m) if n + m else 0.0


def least_seconds(parts: List[Tuple[dict, float]], tiles: int, calls: int,
                  dtype: str) -> float:
    """:func:`roofline_seconds` of ``tiles`` tiles in ``calls`` calls of the
    :func:`tile_work` ``parts``, each counted at its share."""
    flops = sum(share * w["flops"] * tiles for w, share in parts)
    byts = sum(share * (w["bytes"] * tiles + w["weight_bytes"] * calls)
               for w, share in parts)
    return roofline_seconds(flops, byts, dtype)


def train_conv3_calls(batch: int) -> Dict[str, List[int]]:
    """The tiles of each forward application in one train step."""
    b = batch
    return {"gen": [2 * b, 2 * b, b, b], "disc": [2 * b, 2 * b, b, b]}


def roofline_seconds(flops: float, byts: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    at the dtype's peak and the bytes at HBM's."""
    return max(flops / PEAK_FLOPS[dtype], byts / HBM_BYTES_PER_S)
