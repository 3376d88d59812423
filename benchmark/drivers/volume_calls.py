"""Volume traffic: repeated ``infer.predict_volume`` calls with the
function's defaults (device mode, the width's default batch), each handed a
host uint8 volume and returning a host uint8 array, as a user with a volume
in memory calls it.

Set-up makes ``volumes`` seeded uint8 volumes of side ``volume_side``, the
generator (``models.UNetGenerator`` in the cell's ``dtype``, float32 where
the cell names none) with the benchmark's seeded weights, and the two
domains' (mean, std) from the seed, then makes ``warm_calls`` calls.  The
window cycles through the volumes, one call at a time, for ``--seconds``;
``samples`` of its calls, drawn from the seed, keep their outputs.
Afterwards the plain reference predicts each sampled call's region at the
configuration's precision (:data:`PRECISION`: float32, or for bfloat16 the
reference's convs on bf16-rounded operands with float32 sums) and the
outputs are compared voxel by voxel (``reference.infer.level_gaps``): the
share of a call's voxels whose level differs, the share two or more levels
off, the largest mean signed gap of one output tile, the widest gap.  Each
number is the worst sampled call's; those that the cell's ``limits`` name
are its checks, the rest go to ``detail``.

The port's counts of the form each transposed and k4 down conv ran in
(:data:`FORMS`, ``telemetry.snapshot()["launches"]``) are read before the
window opens and after it closes; their differences, the window's, tell
the kernel readers whose work to count (``obs["forms"]``), beside the work
a tile of each kind of conv at the cell's dtype (``obs["work"]``).

Cell keys: ``volume_side``, ``volumes``, ``start``, ``size`` (xyz),
``warm_calls``, ``samples``, ``dtype`` (optional: ``float32``, the
default, or ``bfloat16``), ``limits`` (any of ``off_share``,
``far_share``, ``tile_shift``).  With ``control`` (``tools/control.py``:
``reference.models.fake_tf32`` for float32, ``fake_fp8`` for bfloat16) the
reference in that precision takes the program's place in the check, and
the program's own readings go to ``detail``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import counts, inputs
from benchmark.reference import infer as RI
from benchmark.reference import models as RM
from benchmark.reference.pipeline import derive_seed


FORMS = ("transpose_phase", "transpose_cudnn", "down_k4", "down_cudnn")
PRECISION = {"float32": None, "bfloat16": RM.fake_bf16}


def form_counts() -> dict:
    """The port's count of each of :data:`FORMS` so far."""
    from transfer_em_tpu_torch import telemetry
    launches = telemetry.snapshot()["launches"]
    return {k: launches.get(k, 0) for k in FORMS}


def make_generator(ctx, dev, dtype):
    """The system's generator in ``dtype`` with the benchmark's weights;
    returns it and the weights."""
    from transfer_em_tpu_torch.models import UNetGenerator
    wf = ctx.config["wf"]
    w = RM.make_weights([RM.generator_spec(wf)], derive_seed(ctx.seed, 3),
                        dev)[0]
    gen = UNetGenerator(wf=wf, compute_dtype=dtype).to(dev).eval()
    gen.load_state_dict(w, strict=True)
    return gen, w


def run(ctx, control=None):
    from transfer_em_tpu_torch.device import float32_exact
    from transfer_em_tpu_torch.infer import predict_volume

    float32_exact()
    c = ctx.cell
    dev = ctx.devices[0]
    dtype = c.get("dtype", "float32")
    gen, w = make_generator(ctx, dev, dtype)
    ms_x, ms_y = inputs.meanstd(ctx.seed, 0), inputs.meanstd(ctx.seed, 1)
    vols = [inputs.device_volume(c["volume_side"], derive_seed(ctx.seed, 1, k),
                                 dev).cpu().numpy()
            for k in range(c["volumes"])]
    start, size = tuple(c["start"]), tuple(c["size"])

    def call(i):
        with ctx.span("port.predict_volume"):
            return predict_volume(vols[i % len(vols)], gen, start, size,
                                  ms_x, ms_y, device=dev)

    for i in range(c["warm_calls"]):
        call(i)

    rng = np.random.default_rng(derive_seed(ctx.seed, 6))
    kept = []  # (call index, output): a uniform sample of the window's calls
    before = form_counts()
    ctx.begin_window()
    calls = 0
    end = time.perf_counter() + ctx.seconds
    while time.perf_counter() < end:
        out = call(calls)
        if len(kept) < c["samples"]:
            kept.append((calls, out))
        else:
            j = int(rng.integers(0, calls + 1))
            if j < c["samples"]:
                kept[j] = (calls, out)
        calls += 1
    ctx.end_window()
    after = form_counts()
    forms = {k: after[k] - before[k] for k in FORMS}

    del gen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wf = ctx.config["wf"]
    od = RI.tile_plan(start, size)[0]
    t_ref = time.perf_counter()
    worst, low = {}, {}
    for i, out in kept:
        v = torch.from_numpy(vols[i % len(vols)]).to(dev)
        with RM.exact():
            want = RI.predict_region(v, w, start, size, ms_x, ms_y,
                                     quant=PRECISION[dtype],
                                     batch=RI.batch_for(wf)).cpu().numpy()
        _worst(worst, RI.level_gaps(out, want, od))
        if control is not None:
            with RM.exact():
                ctl = RI.predict_region(v, w, start, size, ms_x, ms_y,
                                        quant=control,
                                        batch=RI.batch_for(wf)).cpu().numpy()
            _worst(low, RI.level_gaps(ctl, want, od))
    detail = {"sampled_calls": [i for i, _ in kept], **worst,
              "reference_s": time.perf_counter() - t_ref}
    if control is not None:  # the control in the program's place
        detail["program"] = worst
        detail.update(low)
        worst = low
    vox = math.prod(size)
    tiles = math.prod(-(-s // od) for s in size)
    work = {kind: counts.tile_work("gen", wf, dtype, (kind,))
            for kind in ("k3", "k4", "transposed")}
    return {"e2e": {"volume_mvox_per_s": calls * vox / 1e6 / ctx.window_s},
            "attempted": calls, "failed": 0,
            "checks": [(k, worst[k], lim) for k, lim in c["limits"].items()],
            "detail": detail,
            "obs": {"kind": "volume", "calls": calls,
                    "tiles": calls * tiles, "dtype": dtype,
                    "gen_flops_per_tile": counts.forward_flops("gen", wf),
                    "work": work, "forms": forms}}


def _worst(acc: dict, gaps: dict) -> None:
    """Keep in ``acc`` the largest reading of each number so far."""
    for k, v in gaps.items():
        acc[k] = max(acc.get(k, v), v)
