"""The readings that a cell's limits are set from, in one process:

    python benchmark/tools/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--control] [--fault <fault>] [--leaves]

For each seed it makes one run of the cell through the harness, as
``run.py`` does but with a short window, and prints one JSON line: the
harness's own verdict (``correct``) and the numbers compared (``checks``).
With ``--control`` the control takes the program's place: the reference in
the precision below the configuration's (training, bf16: float8 e4m3
operands and e5m2 output gradients on every conv; inference, float32: TF32
operands; inference, bf16: float8 e4m3 operands), so ``correct`` has to
read false; the program's own readings of the same run are printed under
``program``.  ``--fault`` breaks the system's timed path underneath,
patched here and never in the port (:data:`FAULTS`).  Volume cells:
``tile_off_by_one``, one tile of every batch one level up where the port
turns the generator's output into uint8.  Train cells: ``half_batch``, the
step takes the first half of each batch only; ``transposed_wgrad_half``,
the transposed convs' weight gradient comes out halved (only the
generators have transposed convs); ``transposed_wgrad_flipped``, the same
gradient with its output channels reversed (its norm held);
``conv3_wgrad_half_over_40``, conv3's weight gradient comes out halved
where its input is over 40 voxels an axis (the generators' stem,
down1.conv, head and out; the discriminators' 40^3 input never is).
``--leaves`` adds the train cell's per-leaf norms.  It needs the card, as
the benchmark does."""

import argparse
import functools
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def half_batch(patch=setattr) -> None:
    """The system's train step, given half of each batch."""
    import transfer_em_tpu_torch.train as T
    real = T.make_train_step

    def half(config, device=None):
        step = real(config, device=device)
        return lambda s, x, y, seed: step(s, x[:len(x) // 2],
                                          y[:len(y) // 2], seed)
    patch(T, "make_train_step", half)


@functools.lru_cache(maxsize=None)
def _grad_fault(kind: str):
    """An autograd Function: the identity, its gradient on the way back
    halved (``half``) or with its last axis, a kernel's output channels,
    reversed (``flip``: the norm held, the direction off).  Made on first
    use: torch is imported after ``cache_env``."""
    import torch

    class GradFault(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g * 0.5 if kind == "half" else g.flip(-1)
    return GradFault


def _transposed_wgrad(kind: str, patch) -> None:
    import transfer_em_tpu_torch.models.blocks as B
    real = B.conv_transpose_nd
    fault = _grad_fault(kind)
    patch(B, "conv_transpose_nd",
          lambda x, kernel, **kw: real(x, fault.apply(kernel), **kw))


def transposed_wgrad_half(patch=setattr) -> None:
    """Every transposed conv of the models, its kernel's gradient halved."""
    _transposed_wgrad("half", patch)


def transposed_wgrad_flipped(patch=setattr) -> None:
    """Every transposed conv of the models, its kernel's gradient with the
    output channels reversed."""
    _transposed_wgrad("flip", patch)


def conv3_wgrad_half_over_40(patch=setattr) -> None:
    """conv3, its kernel's gradient halved where x is over 40 voxels an
    axis."""
    import transfer_em_tpu_torch.ops.convs as C
    real = C.conv3
    fault = _grad_fault("half")

    def conv3(x, w, leaky=None):
        if max(x.shape[1:-1]) > 40:
            w = fault.apply(w)
        return real(x, w, leaky)
    patch(C, "conv3", conv3)


def tile_off_by_one(patch=setattr) -> None:
    """Device mode's uint8 output, the first tile of every batch one level
    up (wrapping at 255)."""
    import transfer_em_tpu_torch.infer.device_stitch as D
    real = D.postprocess_to_u8

    def altered(y, ms, tpad):
        out = real(y, ms, tpad)
        out[0] += 1
        return out
    patch(D, "postprocess_to_u8", altered)


FAULTS = {f.__name__: f for f in (half_batch, transposed_wgrad_half,
                                  transposed_wgrad_flipped,
                                  conv3_wgrad_half_over_40,
                                  tile_off_by_one)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--leaves", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_env()
    import gc

    import torch

    from benchmark.reference import models as RM
    ctl = None
    if args.control:
        cell = harness.load_json("workloads", args.workload)
        ctl = {"bfloat16": RM.fake_fp8, "float32": RM.fake_tf32}[
            cell.get("dtype", "float32")]
    if args.fault:
        FAULTS[args.fault]()
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = SimpleNamespace(workload=args.workload, seed=seed,
                              seconds=args.seconds, trace=0)
        line, out = harness.measure(run, t0, control=ctl)
        if line is None:
            print(f"refused: {out} loaded in this process", file=sys.stderr)
            return 3
        detail = dict(out.get("detail") or {})
        rec = {"seed": seed, "seconds_total": time.perf_counter() - t0,
               "correct": line["correct"], "metrics": line["metrics"],
               "checks": {n: c["value"] for n, c in line["checks"].items()},
               "program": detail.pop("program", None)}
        leaves = {k: detail.pop(k) for k in list(detail)
                  if k.endswith("leaves")}
        rec["detail"] = detail
        if args.leaves:
            rec.update(leaves)
        print(json.dumps(rec, default=str), flush=True)
        del out, detail, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
