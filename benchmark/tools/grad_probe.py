"""Where the train cell's first gradients part from the reference's:

    python benchmark/tools/grad_probe.py --seeds 1,2 [--set '{"batch": 2}']
        [--f64] [--engines]

For each seed it runs the train cell's set-up and first steps (at the
cell's sizes unless ``--set`` overrides cell keys) and prints one JSON
line of gaps between first gradients, by network group (``disc``: dx and
dy; ``gen``: gg and gf): the worst leaf's norm gap against the group's
median leaf (as ``reference.train.compare`` takes it), the median leaf's
gap, the least cosine between a leaf's two gradients and the share of
elements whose gradient has the other sign.  Pairs: the system against the
reference on the reference's own batches and on the system's batches
(the pipeline's output, captured), the reference's float8 and bfloat16
controls, and with ``--f64`` the reference in float32 against float64 and
float64 on the system's batches against float64 on its own (the exact
math under the batches' rounding alone).  It also counts the voxels of the
cycle and identity losses' ``t = 1 - |real - fake| / 2`` near the loss's
clip at 1e-7, and the largest gap between the two pipelines' batches.
``--engines`` adds cuDNN's k4 and transposed convs' backward at the
model's shapes (B=2), bfloat16 and float32 against float64 on the same
operands.  It needs the card."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

GROUPS = {"disc": ("dx", "dy"), "gen": ("gg", "gf")}


def gaps(a: dict, b: dict) -> dict:
    """First gradients of ``a`` against ``b`` (the judge), by group."""
    import numpy as np
    import torch
    out = {}
    for name, nets in GROUPS.items():
        rows = []
        for k in nets:
            for n, gb in b["first_grads"][k].items():
                ga = a["first_grads"][k][n].double().to(gb.device)
                gb = gb.double()
                na, nb = float(ga.norm()), float(gb.norm())
                cos = float((ga * gb).sum() / max(na * nb, 1e-300))
                flips = float((torch.sign(ga) != torch.sign(gb)).double()
                              .mean())
                rows.append((k + "." + n, na, nb, cos, flips))
        med = float(np.median([r[2] for r in rows]))
        g = [abs(r[1] - r[2]) / max(r[2], med) for r in rows]
        w = int(np.argmax(g))
        mid = sorted(rows, key=lambda r: r[2])[len(rows) // 2]
        out[name] = {"worst": g[w], "worst_leaf": rows[w][0],
                     "median_leaf": abs(mid[1] - mid[2]) / mid[2],
                     "min_cos": min(r[3] for r in rows),
                     "flips": float(np.mean([r[4] for r in rows]))}
    return out


def clip_counts(record: list) -> dict:
    import torch
    t = torch.cat(record)
    return {"voxels": int(t.numel()), "t_le_0": int((t <= 1e-7).sum()),
            "t_1e-7_1e-5": int(((t > 1e-7) & (t < 1e-5)).sum()),
            "t_1e-5_1e-3": int(((t >= 1e-5) & (t < 1e-3)).sum()),
            "t_1e-3_1e-2": int(((t >= 1e-3) & (t < 1e-2)).sum()),
            "min_t_above_clip": float(t[t > 1e-7].min())}


def engines(wf: int) -> list:
    """cuDNN's bf16 and f32 backward of the k4 and transposed convs at the
    model's shapes, against float64 on the same (rounded) operands."""
    import torch
    import torch.nn.functional as F
    from benchmark.reference import models as RM
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    gen_w, disc_w = RM.make_weights([RM.generator_spec(wf),
                                     RM.discriminator_spec(wf)], 1, dev)
    rec: list = []
    with torch.no_grad(), RM.exact():
        x = torch.randn(2, 1, 74, 74, 74, generator=g, device=dev)
        y = RM.generator(gen_w, x, record=rec)
        RM.discriminator(disc_w, RM.crop(x, 17), record=rec)
    del y
    out = []
    for r in rec:
        if r["kind"] not in ("k4", "transposed"):
            continue
        xs, ks = r["in_shape"], r["kernel"]
        xi = torch.randn(xs, generator=g, device=dev)
        w = torch.randn(ks, generator=g, device=dev) * RM.fan_in_std(
            ("up.kernel" if r["kind"] == "transposed" else "k"), ks)
        if r["kind"] == "k4":
            def f(a, b):
                return F.conv3d(a, b.permute(4, 3, 0, 1, 2), stride=2)
        else:
            def f(a, b):
                return F.conv_transpose3d(a, b.permute(3, 4, 0, 1, 2),
                                          stride=2, padding=1)
        gy = torch.randn(r["out_shape"], generator=g, device=dev)
        row = {"conv": r["name"], "kind": r["kind"], "in": xs, "kernel": ks}
        for dt in (torch.float32, torch.bfloat16):
            a = xi.to(dt).detach().clone().requires_grad_(True)
            b = w.to(dt).detach().clone().requires_grad_(True)
            with RM.exact():
                f(a, b).backward(gy.to(dt))
            a64 = xi.to(dt).double().detach().requires_grad_(True)
            b64 = w.to(dt).double().detach().requires_grad_(True)
            f(a64, b64).backward(gy.to(dt).double())
            tag = "f32" if dt == torch.float32 else "bf16"
            for nm, got, want in (("dgrad", a.grad, a64.grad),
                                  ("wgrad", b.grad, b64.grad)):
                row[f"{tag}_{nm}"] = float(
                    (got.double() - want).norm() / want.norm())
        out.append(row)
        del xi, w, gy
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="train-wf1-bf16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--set", default="{}", help="cell keys, as JSON")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--engines", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_env()
    import gc

    import torch

    from benchmark.drivers import train_loop as D
    from benchmark.reference import models as RM
    from benchmark.reference import pipeline as RP
    from benchmark.reference import train as RT
    cell = dict(harness.load_json("workloads", args.workload),
                **json.loads(args.set))
    config = harness.load_json("configs", cell["config"])
    harness.check_card(1)
    torch.set_num_threads(4)
    if args.engines:
        for row in engines(config["wf"]):
            print(json.dumps({"engine": row}), flush=True)
    plain_tconf = RT.tconf
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        ctx = harness.Ctx(args.workload, cell, config, seed, 0.0, False, t0)
        s = D.start(ctx, capture=True)
        prog, w, els, seen = (s["prog"], s["weights"], s["elements"],
                              s["batches"])
        del s
        gc.collect()
        torch.cuda.empty_cache()
        record: list = []

        def tconf(real, other):
            record.append((1.0 - (real - other).abs() / 2.0).detach()
                          .flatten().double())
            return plain_tconf(real, other)
        RT.tconf = tconf
        ref = D.reference(ctx, w, els)
        RT.tconf = plain_tconf
        refp = D.reference(ctx, w, els, batches=seen)
        rec = {"seed": seed, "cell": {k: cell[k] for k in
                                      ("batch", "dtype", "check_steps")},
               "clip": clip_counts(record)}
        record.clear()

        sx, _ = D.dataset_seeds(ctx)
        bx = RP.batches([torch.from_numpy(e).to(ctx.devices[0])
                         for e in els[0]],
                        D.batch_of(ctx), sx, True, 1)[0]
        rec["batch_gap"] = float((seen[0][0].permute(0, 4, 1, 2, 3)
                                  - bx).abs().max())
        rec["program~ref"] = gaps(prog, ref)
        rec["program~ref_on_program_batches"] = gaps(prog, refp)
        rec["bf16_control~ref"] = gaps(D.reference(ctx, w, els,
                                                   quant=RM.fake_bf16), ref)
        rec["fp8_control~ref"] = gaps(D.reference(ctx, w, els,
                                                  quant=RM.fake_fp8), ref)
        if args.f64:
            r64 = D.reference(ctx, w, els, dtype=torch.float64)
            r64p = D.reference(ctx, w, els, dtype=torch.float64,
                               batches=seen)
            rec["ref~f64"] = gaps(ref, r64)
            rec["ref_on_program_batches~f64_on_program_batches"] = gaps(
                refp, r64p)
            rec["f64_on_program_batches~f64"] = gaps(r64p, r64)
            rec["program~f64_on_program_batches"] = gaps(prog, r64p)
            del r64, r64p
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        ctx.close()
        del prog, ref, refp, seen
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
