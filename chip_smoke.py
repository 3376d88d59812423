#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (transfer_em_tpu_torch).

    python3 chip_smoke.py [--out DIR]

``--out DIR`` also writes every JSON line (chip_smoke.jsonl) and the
compilers' output with ptxas register counts (chip_smoke_build.log) to DIR.
Needs one CUDA card and nvcc (CUDA toolkit under $CUDA_HOME or
/usr/local/cuda); imports nothing of JAX or of the JAX package.  Phases,
each printing one JSON line:

1. env      nvidia-smi name and power limit, torch/CUDA versions, TF32 off.
2. build    the kernels from transfer_em_tpu_torch/csrc/ with nvcc (sm_90a).
3. kernel   every kernel against its plain PyTorch version on the card at
            the main path's shapes (wf=8, B=128 tiles of 74^3): conv3 in
            f32 and bf16, with and without the LeakyReLU epilogue, at the
            generator's 8 k3 layer shapes (each through the kernel its
            shape picks: tensor-core or direct) and at three more (wf=4
            and wf=16 widths, a ragged small shape); preprocess,
            postprocess and LeakyReLU at theirs (LeakyReLU also at an odd
            length and a misaligned view).  Times (CUDA events) of the
            kernel, the plain version and one library call, beside the
            card's bound; LeakyReLU's and the library call's also from a
            CUDA graph replay (device time without the launches' host
            cost).
4. golden   the port's generator (kernels on) against the frozen TF output
            tests/goldens/gen_3d.npz, f32 and bf16: PSNR >= 40 dB each.
5. serve    ModelService(device="cuda") on 127.0.0.1 with the batcher on,
            over a seeded wf=8 export and a seeded, smoothed 384^3 uint8
            volume: 6 chunk requests of 128^3 (5 of them concurrent, one on
            the volume's far edge), then the same five again under
            torch.profiler (device busy share, device time by kernel).
            The written blocks must match predict_tiled through the plain
            versions on the same card (f32) within one level on at most
            1e-3 of the voxels, and every kernel's launch count must have
            risen during the timed requests.
6. the card's nvidia-smi line, then the ``kernels`` line, then the ``ok``
   line.  Any failed check exits non-zero before the last line.
"""

import concurrent.futures as cf
import contextlib
import gzip
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = None  # set by --out
LOG = []

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and
# the arithmetic rates by operand type.  Bounds use these at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32-accurate products on the tensor cores by 3xTF32 (three TF32
# products per f32 product): the f32 conv3 bound.  67 TFLOP/s (f32 on the
# CUDA cores) is kept beside it as ``bound_ms_cuda_core``.
TF32X3_FLOPS = 495e12 / 3

B = 128  # the service's device batch at wf=8 (default_batch_size)
# (layer, input side, Cin, O, LeakyReLU epilogue on the main path)
CONV_LAYERS = [("stem", 74, 1, 8, True), ("down1.conv", 72, 8, 8, True),
               ("down2.conv", 34, 8, 16, True), ("up1.conv", 15, 16, 32, True),
               ("mid", 26, 32, 32, True), ("up0.conv", 24, 32, 16, True),
               ("head", 44, 16, 16, True), ("out", 42, 16, 1, False)]
# more conv3 shapes: wf=4 widths (mid at wf=4 is 32 -> 64 at 26^3 in,
# smaller batch), wf=16 widths (down2.conv 4 -> 8), a ragged small shape
CONV_EXTRA = [("wf4.32to64", (8, 26, 26, 26), 32, 64),
              ("wf16.4to8", (16, 34, 34, 34), 4, 8),
              ("ragged", (2, 9, 11, 13), 8, 16)]
# the activations after down1.down, down2.down, up1.up, up0.up
LEAKY_SHAPES = [(B, 34, 34, 34, 8), (B, 15, 15, 15, 16), (B, 26, 26, 26, 16),
                (B, 44, 44, 44, 8)]
MS_X, MS_Y = (0.12, 0.85), (0.05, 0.6)


def emit(obj):
    line = json.dumps(obj)
    LOG.append(line)
    print(line, flush=True)


def fail(phase, msg, **extra):
    emit({"phase": phase, "ok": False, "error": msg, **extra})
    _write_log()
    sys.exit(1)


def _write_out(name, text):
    if OUT_DIR is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, name), "w") as f:
            f.write(text)


def _write_log():
    _write_out("chip_smoke.jsonl", "\n".join(LOG) + "\n")


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


def cuda_ms(fn, reps=5):
    """Mean time of fn() on the card over reps launches, after one warm-up
    (CUDA events around the run, then synchronise)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Mean device time of fn() over reps launches replayed from one CUDA
    graph: the launches' host cost (Python, ctypes, allocation) drops out,
    which cuda_ms keeps where the host is slower than the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, dtype, peak=None):
    """Least time (ms) for the work: max of bytes over the memory rate and
    operations over the peak (default: the peak for the operand type)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv3_peak(dtype):
    return TF32X3_FLOPS if dtype == torch.float32 else PEAK_FLOPS[dtype]


def psnr(got, want):
    """PSNR (dB) with the reference output's dynamic range as peak."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mse = np.mean((got - want) ** 2)
    peak = max(want.max() - want.min(), 1e-6)
    return 10 * np.log10(peak ** 2 / max(mse, 1e-20))


# -- phase 3: kernels against their plain versions ---------------------------

def _conv3_case(dev, gen, dtype, rel_tol, name, shape, c, o, act):
    """One conv3 check and its times; returns the record."""
    from transfer_em_tpu_torch.ops import cuda_conv

    x = torch.randn(shape + (c,), generator=gen, device=dev)
    w = torch.randn((3, 3, 3, c, o), generator=gen, device=dev)
    x, w = x.to(dtype), (w / (27 * c) ** 0.5).to(dtype)
    w_lib, x_lib = w.permute(4, 3, 0, 1, 2), x.permute(0, 4, 1, 2, 3)
    n_out = shape[0] * o * math.prod(s - 2 for s in shape[1:])
    nbytes = (x.numel() + w.numel() + n_out) * x.element_size()
    flops = 2.0 * n_out * 27 * c
    b_ms, b_by = bound(nbytes, flops, dtype, conv3_peak(dtype))
    leaky = 0.3 if act else None
    got = cuda_conv.conv3(x, w, leaky)
    ref = cuda_conv.conv3_plain(x, w, leaky)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    tol = rel_tol * max(1.0, ref.float().abs().max().item())
    del got, ref

    def lib():
        y = F.conv3d(x_lib, w_lib)
        return F.leaky_relu(y, 0.3) if act else y

    k_ms = cuda_ms(lambda: cuda_conv.conv3(x, w, leaky))
    rec = {"phase": "kernel", "kernel": "conv3", "layer": name,
           "path": cuda_conv.conv3_path(c, o),
           "dtype": str(dtype).replace("torch.", ""),
           "shape": list(shape) + [c], "out_channels": o, "epilogue": act,
           "max_abs_err": err, "tol": tol, "ok": err <= tol,
           "kernel_ms": k_ms,
           "plain_ms": cuda_ms(lambda: cuda_conv.conv3_plain(x, w, leaky)),
           "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "share": b_ms / k_ms, "tflops": flops / k_ms / 1e9,
           "t_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
           "t_ops": flops / conv3_peak(dtype) * 1e3}
    if dtype == torch.float32:
        rec["bound_ms_cuda_core"] = bound(nbytes, flops, dtype)[0]
    emit(rec)
    return rec


def check_conv3(dev, gen):
    """Every conv3 case in f32 (tol 1e-4 max(1, |ref|)) and bf16 (1e-2);
    per dtype, totals over the main path's 8 calls, overall and by path."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_cuda_core",
            "t_bytes", "t_ops")
    agg = {}
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        tot = {k: 0.0 for k in keys}
        tot.update(max_abs_err=0.0, checks=0, passed=0, paths={})
        cases = [(n, (B, s, s, s), c, o, m) for n, s, c, o, m in CONV_LAYERS]
        cases += [(n, shp, c, o, None) for n, shp, c, o in CONV_EXTRA]
        for name, shape, c, o, main_act in cases:
            for act in (False, True):
                rec = _conv3_case(dev, gen, dtype, rel_tol, name, shape, c, o,
                                  act)
                tot["checks"] += 1
                tot["passed"] += int(rec["ok"])
                if act != main_act:
                    continue  # not the main path's own call
                part = tot["paths"].setdefault(
                    rec["path"], {**{k: 0.0 for k in keys},
                                  "max_abs_err": 0.0, "layers": []})
                part["layers"].append(name)
                for t in (tot, part):
                    t["ms"] += rec["kernel_ms"]
                    for k in keys[1:]:
                        t[k] += rec.get(k, 0.0)
                    t["max_abs_err"] = max(t["max_abs_err"],
                                           rec["max_abs_err"])
        for t in (tot, *tot["paths"].values()):
            t["bound_by"] = ("operations" if t.pop("t_ops") > t.pop("t_bytes")
                             else "bytes")
            if dtype != torch.float32:
                t.pop("bound_ms_cuda_core")
        agg[str(dtype).replace("torch.", "")] = tot
    return agg


def _tie_voxels(y, meanstd, tpad):
    t = slice(tpad, -tpad) if tpad else slice(None)
    z = y[:, t, t, t, 0].double() * meanstd[1] + meanstd[0]
    z = (z + 1.0) * 127.5
    return (z - z.floor() - 0.5).abs() < 1e-6


def check_elementwise(dev, gen):
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    out = {}
    # preprocess: (B, 74^3) uint8 -> (B, 74^3, 1) f32
    x = torch.randint(0, 256, (B, 74, 74, 74), generator=gen, device=dev,
                      dtype=torch.uint8)
    got, ref = ck.preprocess_u8(x, MS_X), ck.preprocess_u8_plain(x, MS_X)
    err = (got - ref).abs().max().item()
    a, b = ck.preprocess_affine(MS_X)
    nbytes = x.numel() * 5
    b_ms, b_by = bound(nbytes, 2.0 * x.numel(), torch.float32)
    rec = {"max_abs_err": err, "tol": 1e-6, "ok": err <= 1e-6,
           "ms": cuda_ms(lambda: ck.preprocess_u8(x, MS_X), 20),
           "plain_ms": cuda_ms(lambda: ck.preprocess_u8_plain(x, MS_X), 20),
           "library_ms": cuda_ms(lambda: x.float() * a + b, 20),
           "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernel", "kernel": "preprocess_u8",
          "shape": list(x.shape), **rec})
    out["preprocess_u8"] = rec
    del x, got, ref

    # postprocess: (B, 40^3, 1) f32, tpad 2 read in place -> (B, 36^3) u8
    y = torch.randn((B, 40, 40, 40, 1), generator=gen, device=dev)
    got = ck.postprocess_u8(y, MS_Y, 2)
    ref = ck.postprocess_u8_plain(y, MS_Y, 2)
    diff = (got.int() - ref.int()).abs()
    ties = _tie_voxels(y, MS_Y, 2)
    off_tie = int(diff[~ties].max().item()) if (~ties).any() else 0
    ok = off_tie == 0 and int(diff.max().item()) <= 1
    n_out = got.numel()
    b_ms, b_by = bound(n_out * 5, 5.0 * n_out, torch.float32)
    lib = lambda: (y[:, 2:-2, 2:-2, 2:-2, 0] * MS_Y[1] + MS_Y[0] + 1.0).mul(
        127.5).round().clamp(0, 255).to(torch.uint8)
    rec = {"max_abs_err": float(diff.max().item()), "tol": 0,
           "tie_voxels": int(ties.sum().item()),
           "differing_voxels": int((diff > 0).sum().item()), "ok": ok,
           "ms": cuda_ms(lambda: ck.postprocess_u8(y, MS_Y, 2), 20),
           "plain_ms": cuda_ms(lambda: ck.postprocess_u8_plain(y, MS_Y, 2),
                               20),
           "library_ms": cuda_ms(lib, 20), "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernel", "kernel": "postprocess_u8",
          "shape": list(y.shape), "tpad": 2, **rec})
    out["postprocess_u8"] = rec
    del y, got, ref

    # LeakyReLU at the four activations the conv epilogue cannot absorb
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"max_abs_err": 0.0, "ok": True, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
               "graph_ms": 0.0, "library_graph_ms": 0.0}
        for shape in LEAKY_SHAPES:
            v = torch.randn(shape, generator=gen, device=dev).to(dtype)
            got, ref = ck.leaky_relu(v), ck.leaky_relu_plain(v)
            err = (got.float() - ref.float()).abs().max().item()
            b_ms, _ = bound(2 * v.numel() * v.element_size(), 2.0 * v.numel(),
                            dtype)
            rec = {"max_abs_err": err, "tol": 0.0, "ok": err == 0.0,
                   "ms": cuda_ms(lambda: ck.leaky_relu(v), 20),
                   "plain_ms": cuda_ms(lambda: ck.leaky_relu_plain(v), 20),
                   "library_ms": cuda_ms(lambda: F.leaky_relu(v, 0.3), 20),
                   "graph_ms": graph_ms(lambda: ck.leaky_relu(v)),
                   "library_graph_ms": graph_ms(
                       lambda: F.leaky_relu(v, 0.3)),
                   "bound_ms": b_ms}
            emit({"phase": "kernel", "kernel": "leaky_relu",
                  "dtype": str(dtype).replace("torch.", ""),
                  "shape": list(shape), **rec})
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms",
                      "library_graph_ms"):
                tot[k] += rec[k]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["ok"] = tot["ok"] and rec["ok"]
            del v, got, ref
        # an odd length (scalar tail) and a view 1 element off 16-byte
        # alignment (the scalar kernel): bit-identical, not timed
        base = torch.randn((1_000_004,), generator=gen, device=dev).to(dtype)
        for label, v in (("odd_length", base[:1_000_003]),
                         ("misaligned", base[1:])):
            got, ref = ck.leaky_relu(v), ck.leaky_relu_plain(v)
            ok = torch.equal(got, ref)
            emit({"phase": "kernel", "kernel": "leaky_relu", "case": label,
                  "dtype": str(dtype).replace("torch.", ""),
                  "shape": list(v.shape), "ok": ok})
            tot["ok"] = tot["ok"] and ok
        out["leaky_relu_" + str(dtype).replace("torch.", "")] = tot
    return out


# -- phase 4: golden fidelity ------------------------------------------------

def check_golden(dev):
    from transfer_em_tpu_torch.models import UNetGenerator
    from transfer_em_tpu_torch.models.convert import params_from_tf_order

    data = np.load(os.path.join(ROOT, "tests", "goldens", "gen_3d.npz"))
    sd = params_from_tf_order(data)
    x = torch.from_numpy(data["x"]).to(dev)
    res = {}
    for cd in (None, "bfloat16"):
        gen = UNetGenerator(wf=8, compute_dtype=cd)
        gen.load_state_dict(sd)
        gen = gen.to(dev).eval()
        with torch.inference_mode():
            got = gen(x).cpu().numpy()
        res[cd or "float32"] = psnr(got, data["y"])
    return res


# -- phase 5: serving --------------------------------------------------------

def seeded_generator(seed, dev):
    """wf=8 generator with numpy-seeded weights of std 1/sqrt(fan-in), so the
    outputs vary over the whole uint8 range."""
    from transfer_em_tpu_torch.models import UNetGenerator

    rng = np.random.default_rng(seed)
    gen = UNetGenerator(wf=8)
    sd = {k: torch.from_numpy(rng.normal(
        0, float(np.prod(v.shape[:-1])) ** -0.5, tuple(v.shape)).astype(
            np.float32)) for k, v in gen.state_dict().items()}
    gen.load_state_dict(sd)
    return gen.to(dev).eval()


def smooth_volume(side, seed, dev):
    """Seeded uint8 zyx volume of side^3: uniform noise smoothed on the card
    (two 3^3 box filters), standardized to mean 128, std 40 grey levels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.rand((1, 1, side, side, side), generator=g, device=dev)
    for _ in range(2):
        v = F.avg_pool3d(v, 3, stride=1, padding=1, count_include_pad=False)
    v = (v - v.mean()) / v.std() * 40.0 + 128.0
    return v[0, 0].round().clamp(0, 255).to(torch.uint8).cpu().numpy()


@contextlib.contextmanager
def plain_versions():
    """Route the model and the tile step through the plain PyTorch versions
    (on CUDA tensors too): the reference path of the serving check."""
    from transfer_em_tpu_torch.infer import tiling
    from transfer_em_tpu_torch.models import blocks
    from transfer_em_tpu_torch.ops import cuda_conv
    from transfer_em_tpu_torch.ops import cuda_kernels as ck

    swaps = [(blocks, "conv3", cuda_conv.conv3_plain),
             (blocks, "conv3_act",
              lambda x, w: cuda_conv.conv3_plain(x, w, ck.LEAKY_SLOPE)),
             (blocks, "leaky_relu", ck.leaky_relu_plain),
             (tiling, "preprocess_u8", ck.preprocess_u8_plain),
             (tiling, "postprocess_to_u8", ck.postprocess_u8_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def profile_round(run):
    """Device time by kernel over ``run()`` from torch.profiler (CUPTI):
    the device's busy share of the wall time and where its time goes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side ops; their kernels are listed on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    groups = {"port_kernels": 0.0, "copies": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        if "tem::" in name:
            groups["port_kernels"] += ms
        elif "memcpy" in name.lower() or "memset" in name.lower():
            groups["copies"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(groups.values())
    return {"wall_s": wall, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall,
            "by_group_ms": groups,
            "top": [{"name": n[:100], "ms": ms, "calls": c}
                    for n, ms, c in rows[:16]]}


def counters():
    from transfer_em_tpu_torch.ops import cuda_conv
    from transfer_em_tpu_torch.ops import cuda_kernels as ck
    return {"conv3": cuda_conv.conv3, "preprocess_u8": ck.preprocess_u8,
            "postprocess_u8": ck.postprocess_u8, "leaky_relu": ck.leaky_relu}


def reset_counts():
    from transfer_em_tpu_torch.ops import cuda_conv
    for c in counters().values():
        c.launches = 0
    cuda_conv.conv3.launches_tc = cuda_conv.conv3.launches_direct = 0
    cuda_conv.packed_weights.packs = 0


def read_counts():
    """Launches per kernel, conv3 also per path (tc, direct), and the
    weight packs (plain torch, not a kernel launch)."""
    from transfer_em_tpu_torch.ops import cuda_conv
    out = {k: c.launches for k, c in counters().items()}
    out["conv3_tc"] = cuda_conv.conv3.launches_tc
    out["conv3_direct"] = cuda_conv.conv3.launches_direct
    out["conv3_weight_packs"] = cuda_conv.packed_weights.packs
    return out


def check_serving(dev, smi):
    from transfer_em_tpu_torch.config import ExportMeta
    from transfer_em_tpu_torch.infer import export_generator, predict_tiled
    from transfer_em_tpu_torch.native import gather_box
    from transfer_em_tpu_torch.serve import (ModelService, NumpyVolume,
                                             register_volume)

    side, size = 384, 128
    vol = smooth_volume(side, seed=7, dev=dev)
    register_volume("smoke/vol", NumpyVolume(vol))
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "models", "smoke", "v1")
        meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=MS_X,
                          meanstd_y=MS_Y, dimsize=74, is3d=True, wf=8)
        gen_ref = seeded_generator(3, dev)
        export_generator(gen_ref, meta, model_dir)

        starts = [(0, 0, 0), (128, 64, 192), (256, 256, 256), (64, 192, 0),
                  (192, 0, 128), (256, 128, 64)]
        svc = ModelService(model_root=os.path.join(tmp, "models"),
                           device=dev)
        svc.start()

        def request(i, start, tag=""):
            cfg = {"location": "smoke/vol", "start": list(start),
                   "glbstart": [0, 0, 0], "size": [size] * 3,
                   "model_name": "smoke:v1",
                   "dest": os.path.join(tmp, f"out{i}{tag}")}
            t0 = time.perf_counter()
            req = urllib.request.Request(
                svc.url + "/", data=json.dumps(cfg).encode(),
                headers={"Content-type": "application/json"})
            body = urllib.request.urlopen(req, timeout=600).read()
            return body, time.perf_counter() - t0

        try:
            reset_counts()
            body, first_s = request(0, starts[0])  # includes the model load
            if body != b"success":
                fail("serve", f"request 0 answered {body!r}")
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=5) as ex:
                futs = [ex.submit(request, i, s)
                        for i, s in enumerate(starts) if i > 0]
                results = [f.result(timeout=900) for f in futs]
            wall = time.perf_counter() - t0
            launches = read_counts()
            stats = svc.cache.stats()

            def profiled():  # the same five requests again, traced
                with cf.ThreadPoolExecutor(max_workers=5) as ex:
                    futs = [ex.submit(request, i, s, "p")
                            for i, s in enumerate(starts) if i > 0]
                    if any(f.result(timeout=900)[0] != b"success"
                           for f in futs):
                        fail("serve", "a traced request failed")

            trace = profile_round(profiled)
        finally:
            svc.stop()
        for body, _ in results:
            if body != b"success":
                fail("serve", f"a request answered {body!r}")

        # Reference: the plain versions on the same card, float32.
        outs = {}
        with plain_versions():
            for i, s in enumerate(starts):
                outs[i] = predict_tiled(
                    lambda c, n: gather_box(vol, c, (n,) * 3), gen_ref, s,
                    (size,) * 3, meta.outdimsize, meta.buffer, MS_X, MS_Y,
                    batch_size=64, device=dev)
        worst, frac = 0, 0.0
        for i, s in enumerate(starts):
            got = np.zeros((size,) * 3, np.uint8)
            dest = os.path.join(tmp, f"out{i}")
            names = sorted(os.listdir(dest))
            if len(names) != (size // 64) ** 3:
                fail("serve", f"request {i}: {len(names)} blocks written")
            for nm in names:
                (x0, x1), (y0, y1), (z0, z1) = (
                    tuple(int(v) for v in p.split("-")) for p in nm.split("_"))
                raw = gzip.decompress(open(os.path.join(dest, nm), "rb").read())
                got[z0 - s[2]:z1 - s[2], y0 - s[1]:y1 - s[1],
                    x0 - s[0]:x1 - s[0]] = np.frombuffer(
                        raw, np.uint8).reshape(z1 - z0, y1 - y0, x1 - x0)
            diff = np.abs(got.astype(int) - outs[i].astype(int))
            worst = max(worst, int(diff.max()))
            frac = max(frac, float((diff > 0).mean()))
        spread = float(np.std(outs[1]))
    n_tiles = (len(starts) - 1) * (-(-size // 36)) ** 3
    rec = {"phase": "serve", "requests": len(starts), "concurrent": 5,
           "first_request_s": first_s, "concurrent_wall_s": wall,
           "tiles_per_s": n_tiles / wall,
           "mvox_per_s": (len(starts) - 1) * size ** 3 / wall / 1e6,
           "request_latency_s": [r[1] for r in results],
           "batcher": stats.get("batcher"), "launches": launches,
           "u8_max_diff": worst, "u8_frac_differing": frac,
           "output_std": spread, "card": smi, "profiled_round": trace}
    rec["ok"] = (worst <= 1 and frac <= 1e-3 and spread > 2.0
                 and all(launches[k] > 0 for k in (*counters(), "conv3_tc",
                                                    "conv3_direct")))
    emit(rec)
    return rec


def main():
    global OUT_DIR
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the JSON lines and the build log")
    OUT_DIR = ap.parse_args().out
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA card", file=sys.stderr)
        sys.exit(2)
    from transfer_em_tpu_torch import kernels
    from transfer_em_tpu_torch.device import resolve_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    built = kernels.ensure_built(ptxas_verbose=True)
    _write_out("chip_smoke_build.log", built["log"])
    emit({"phase": "build", "seconds": built["seconds"],
          "sources": [os.path.relpath(p, ROOT) for p in kernels.sources()],
          "ok": True})

    gen = torch.Generator(device=dev).manual_seed(0)
    conv = check_conv3(dev, gen)
    elem = check_elementwise(dev, gen)
    kernel_ok = (all(v["passed"] == v["checks"] for v in conv.values())
                 and all(v["ok"] for v in elem.values()))
    emit({"phase": "kernels_checked", "ok": kernel_ok})
    if not kernel_ok:
        fail("kernel", "a kernel disagrees with its plain version")

    golden = check_golden(dev)
    emit({"phase": "golden", "psnr_db": golden, "bar_db": 40,
          "ok": all(v >= 40 for v in golden.values())})
    if not all(v >= 40 for v in golden.values()):
        fail("golden", "PSNR below 40 dB")

    serve = check_serving(dev, smi)
    if not serve["ok"]:
        fail("serve", "serving check failed")

    def entry(name, source, replaces, rec, launches, extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"], **extra}

    la = serve["launches"]
    c32, c16 = conv["float32"], conv["bfloat16"]
    conv_src = {"tc": "transfer_em_tpu_torch/csrc/conv3_tc.cu",
                "direct": "transfer_em_tpu_torch/csrc/conv3_direct.cu"}
    summary = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
               "max_abs_err")
    paths = [entry(f"conv3.{p}", conv_src[p],
                   "transfer_em_tpu/ops/pallas_conv.py:174", rec,
                   la[f"conv3_{p}"],
                   {"layers": rec["layers"],
                    "bound_ms_cuda_core": rec["bound_ms_cuda_core"],
                    "bf16": {k: c16["paths"][p][k] for k in summary}})
             for p, rec in sorted(c32["paths"].items())]
    lines = [
        entry("conv3", " + ".join(conv_src.values()),
              "transfer_em_tpu/ops/pallas_conv.py:174", c32, la["conv3"],
              {"checks": c32["checks"] + c16["checks"],
               "passed": c32["passed"] + c16["passed"],
               "per": "8 k3 convs of one B=128 tile batch, float32",
               "bound_ms_cuda_core": c32["bound_ms_cuda_core"],
               "weight_packs": la["conv3_weight_packs"],
               "bf16": {k: c16[k] for k in summary}, "paths": paths}),
        entry("preprocess_u8", "transfer_em_tpu_torch/csrc/elementwise.cu",
              "transfer_em_tpu/ops/pallas_kernels.py:71",
              elem["preprocess_u8"], la["preprocess_u8"],
              {"passed": elem["preprocess_u8"]["ok"]}),
        entry("postprocess_u8", "transfer_em_tpu_torch/csrc/elementwise.cu",
              "transfer_em_tpu/ops/pallas_kernels.py:110",
              elem["postprocess_u8"], la["postprocess_u8"],
              {"passed": elem["postprocess_u8"]["ok"]}),
        entry("leaky_relu", "transfer_em_tpu_torch/csrc/elementwise.cu",
              "transfer_em_tpu/ops/pallas_kernels.py:141",
              elem["leaky_relu_float32"], la["leaky_relu"],
              {"passed": elem["leaky_relu_float32"]["ok"]
               and elem["leaky_relu_bfloat16"]["ok"],
               "graph_ms": elem["leaky_relu_float32"]["graph_ms"],
               "library_graph_ms":
                   elem["leaky_relu_float32"]["library_graph_ms"],
               "per": "4 activations of one B=128 tile batch, float32"}),
    ]
    print(smi, flush=True)
    emit({"kernels": lines})
    _write_log()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
