"""Serving-fleet benchmarks of the port over its real HTTP paths: the
counterpart of the JAX package's ``bench_serve.py``.

    python -m transfer_em_tpu_torch.bench.serve [model|data|combined|soak]
        [--models N] [--reqs N] [--soak-data-reqs N] [--soak-model-reqs N]
        [--device cuda] ...

Sections (default ``model``), each printing one JSON line (``soak`` two,
or one with ``--models``):

* ``model``: ``--reqs`` (default 16, env ``BENCH_SERVE_REQS``) concurrent
  64^3 chunk requests through ``ModelService`` and ``predict_chunk``, with
  cross-request batching off, then on: the end-to-end fleet wall (HTTP in,
  fetch, H2D, the fused tile step on the card, D2H, gzip ng blocks out).
  ``serve_fleet_mvox_per_sec`` is the batched rate, ``vs_baseline`` its
  speedup over unbatched.
* ``data``: a ``--clients``-client fleet (16) of /volume (64^3 raw) and
  /slice (256^2 PNG) requests against the data service at each of
  ``--workers`` (0, 4, 8 prefork workers).  ``data_fleet_req_per_sec`` is
  the best, ``vs_baseline`` its ratio to the single process.
* ``combined``: streamed training (``volume3d_ng`` -> warp + augment ->
  ``EM2EM.train_step``) pulling from a data service that a 16-client fleet
  loads; ``combined_stream_train_tiles74_per_sec``, ``vs_baseline`` the
  ratio to training alone.
* ``soak``: the data service under ``--soak-data-reqs`` (10000, env
  ``SOAK_DATA_REQS``) mixed requests with one prefork worker SIGKILLed at
  40% (bars: latency drift, fds, RSS, errors, respawn), then the model
  service under ``--soak-model-reqs`` (1000, env ``SOAK_MODEL_REQS``)
  chunk requests (bars: drift, fds, errors, RSS within the shipped bytes).
  ``soak --models N`` runs only the model soak, alternating N exported
  models against ``cache_size=1`` (eviction churn), every tenth response
  held byte for byte against its model's direct ``predict_tiled``.  The
  exit code is 1 when a bar fails.

The data service forks its workers, which must not inherit an initialised
CUDA context, so every section starts it as a subprocess (``python -m
transfer_em_tpu_torch.serve.data_service``, its volumes handed over as
``.npy`` files), as the JAX bench does for ``combined`` and ``soak``.
Each line carries the card's name and power limit and the launches of the
port's kernels in this process during the section.  The generators'
weights are drawn from ``torch.Generator().manual_seed(m)`` (N(0, 0.02),
the modules' own init).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import gzip
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import (DTYPES, card, emit, float32_exact, launch_counts, launches,
               log, synth_volume)
from ..device import resolve_device

CHUNK = 64
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# -- the data service in a process of its own -------------------------------

def spawn_data_service(volumes: Dict[str, np.ndarray], workers: int):
    """Start the data service as a clean subprocess (``python -m
    transfer_em_tpu_torch.serve.data_service``), its volumes written as
    ``.npy`` files for the ``DATA_VOLUMES`` contract, its stderr to
    ``service.log`` beside them.  Returns once it answers /healthz and all
    ``workers`` prefork workers are up: (url, popen, tmpdir)."""
    tmp = tempfile.mkdtemp(prefix="bench_dsvc_")
    spec = []
    for i, (name, arr) in enumerate(volumes.items()):
        path = os.path.join(tmp, f"v{i}.npy")
        np.save(path, arr)
        spec.append(f"{name}={path}")
    with socket.socket() as s:  # a free port on this host
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PORT=str(port), DATA_WORKERS=str(workers),
               DATA_VOLUMES=",".join(spec))
    with open(os.path.join(tmp, "service.log"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "transfer_em_tpu_torch.serve.data_service"],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=err)
    url = f"http://127.0.0.1:{port}"
    deadline = time.time() + 60

    def up():
        try:
            urllib.request.urlopen(url + "/healthz", timeout=1)
        except OSError:
            return False
        return len(_tree_pids(proc.pid)) > workers

    while not up():
        if time.time() > deadline or proc.poll() is not None:
            proc.kill()
            proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError("data service subprocess failed to start")
        time.sleep(0.2)
    return url, proc, tmp


def stop_data_service(proc, tmp):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def _service_log(tmp) -> str:
    try:
        with open(os.path.join(tmp, "service.log")) as f:
            return f.read()
    except OSError:
        return ""


def _volume_req(session, url, location, start):
    cfg = {"location": location, "start": list(start), "size": [64, 64, 64]}
    r = session.post(url + "/volume", data=json.dumps(cfg), timeout=30)
    return r.status_code == 200 and len(r.content) == 64 ** 3


def _slice_req(session, url, location, z, side):
    r = session.get(f"{url}/slice/0_0_{z}/{side}_{side}_1/png"
                    f"?location={location}", timeout=30)
    return r.status_code == 200


def _served(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"the data service failed a {what} request")


# -- data ---------------------------------------------------------------------

def bench_data_fleet(dev, n_clients=16, reqs_per_client=24,
                     worker_grid: Sequence[int] = (0, 4, 8), reps=3,
                     side=256) -> dict:
    """The /volume + /slice fleet against the data service at each worker
    count (the reference ran 9 gunicorn workers x 2 threads)."""
    import requests

    vol = np.random.default_rng(0).integers(0, 255, size=(side,) * 3,
                                            dtype=np.uint8)
    per = side // 64

    def client(url, cid, session):
        vox = 0
        for i in range(reqs_per_client):
            if i % 2 == 0:
                start = [64 * ((cid + i) % per), 64 * (cid % per),
                         64 * (i % per)]
                _served(_volume_req(session, url, "benchbucket/vol", start),
                        "/volume")
                vox += 64 ** 3
            else:
                z = (cid * reqs_per_client + i) % side
                _served(_slice_req(session, url, "benchbucket/vol", z, side),
                        "/slice")
                vox += side * side
        return vox

    results = {}
    for workers in worker_grid:
        url, proc, tmp = spawn_data_service({"benchbucket/vol": vol},
                                            workers)
        try:
            sessions = [requests.Session() for _ in range(n_clients)]
            best = None
            for rep in range(1 + reps):  # rep 0 warms connections, caches
                t0 = time.perf_counter()
                with cf.ThreadPoolExecutor(max_workers=n_clients) as ex:
                    vox = sum(ex.map(lambda c: client(url, c[0], c[1]),
                                     enumerate(sessions)))
                dt = time.perf_counter() - t0
                if rep:
                    best = min(best, dt) if best else dt
            nreq = n_clients * reqs_per_client
            results[workers] = {"req_per_sec": nreq / best,
                                "mvox_per_sec": vox / best / 1e6,
                                "best_s": best}
            log(f"data fleet workers={workers}: {nreq} reqs best {best:.2f}s"
                f" = {nreq / best:.0f} req/s, {vox / best / 1e6:.1f} Mvox/s")
        finally:
            stop_data_service(proc, tmp)
    single = results[worker_grid[0]]["req_per_sec"]
    best_w = max(results, key=lambda w: results[w]["req_per_sec"])
    return {"bench": "serve", "section": "data",
            "metric": "data_fleet_req_per_sec",
            "value": results[best_w]["req_per_sec"], "unit": "req/s",
            "vs_baseline": results[best_w]["req_per_sec"] / single,
            "note": f"{n_clients} clients; best workers={best_w}; "
                    "vs_baseline = vs single-process threaded",
            "by_workers": {str(w): r for w, r in results.items()},
            "clients": n_clients, "reqs_per_client": reqs_per_client}


# -- model --------------------------------------------------------------------

def export_models(root: str, n_models: int, wf: int):
    """``n_models`` wf generators under root/m<i>/v (npz), each its own
    seed and meanstd; returns their ExportMetas."""
    from ..config import ExportMeta
    from ..infer import export_generator
    from ..models import UNetGenerator

    metas = []
    for m in range(n_models):
        gen = UNetGenerator(wf=wf, generator=torch.Generator().manual_seed(m))
        meta = ExportMeta(buffer=17, outdimsize=40,
                          meanstd_x=(0.1 + 0.01 * m, 0.9),
                          meanstd_y=(0.2, 1.1 + 0.01 * m),
                          dimsize=74, is3d=True, wf=wf)
        export_generator(gen, meta, os.path.join(root, f"m{m}", "v"))
        metas.append(meta)
    return metas


def bench_model(dev, n_req=16, reps=3, wf=8, side=256) -> dict:
    """``n_req`` concurrent chunk requests, batching off then on."""
    from ..serve import ModelService, NumpyVolume, predict_chunk
    from ..serve import register_volume

    vol = np.random.default_rng(0).integers(0, 255, size=(side,) * 3,
                                            dtype=np.uint8)
    register_volume("benchbucket/vol", NumpyVolume(vol))
    root = tempfile.mkdtemp(prefix="bench_serve_")
    export_models(root, 1, wf)
    os.rename(os.path.join(root, "m0"), os.path.join(root, "m"))
    per_dim = side // CHUNK
    n = min(n_req, per_dim ** 3)
    if n < n_req:
        log(f"clamping --reqs {n_req} -> {n} (only {per_dim}^3 disjoint "
            f"chunks fit in {side}^3)")
    starts = [(CHUNK * (i % per_dim), CHUNK * ((i // per_dim) % per_dim),
               CHUNK * (i // per_dim ** 2)) for i in range(n)]
    vox = n * CHUNK ** 3

    def run_fleet(svc):
        dest_root = tempfile.mkdtemp(prefix="bench_serve_out_")
        try:
            def req(i):
                predict_chunk(svc.url, "benchbucket/vol", start=starts[i],
                              size=(CHUNK,) * 3, model_name="m:v",
                              dest=os.path.join(dest_root, str(i)))
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=n) as ex:
                list(ex.map(req, range(n)))
            return time.perf_counter() - t0
        finally:
            shutil.rmtree(dest_root, ignore_errors=True)

    before = launch_counts()
    results, stats = {}, None
    try:
        for tag, cross in (("unbatched", False), ("batched", True)):
            # admit the whole fleet at once: the bench isolates batching
            svc = ModelService(model_root=root, max_inflight=n,
                               cross_batch=cross, device=dev)
            svc.start()
            try:
                warm = run_fleet(svc)  # loads the model, first batches
                log(f"{tag}: warmup fleet {warm:.2f}s")
                times = [run_fleet(svc) for _ in range(reps)]
                results[tag] = {"best_s": min(times), "all_s": times,
                                "mvox_per_sec": vox / min(times) / 1e6}
                log(f"{tag}: fleet of {n} x {CHUNK}^3 best {min(times):.2f}s"
                    f" ({vox / min(times) / 1e6:.1f} Mvox/s e2e)")
                if cross:
                    stats = json.loads(urllib.request.urlopen(
                        svc.url + "/stats").read()).get("batcher")
                    log(f"batcher stats: {stats}")
            finally:
                svc.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"bench": "serve", "section": "model",
            "metric": "serve_fleet_mvox_per_sec",
            "value": results["batched"]["mvox_per_sec"], "unit": "Mvox/s",
            "vs_baseline": (results["unbatched"]["best_s"]
                            / results["batched"]["best_s"]),
            "requests": n, "wf": wf, "reps": reps, "modes": results,
            "batcher": stats, "launches": launches(before)}


# -- combined -----------------------------------------------------------------

def _stream_model(url, location, extent, batch, epoch_size, wf, dtype, dev,
                  ckpt_root, exp):
    """The streamed-training config (BASELINE config 4): two volume3d_ng
    sources over HTTP, warp and augmentation, and an EM2EM."""
    from ..data import create_dataset_from_generator, volume3d_ng
    from ..debug import warp
    from ..train import EM2EM

    bbox = ((0, 0, 0), (extent,) * 3)
    src_y = volume3d_ng(location, bbox, size=74, seed=22, cloudrun=url)
    src_x = volume3d_ng(location, bbox, size=74, seed=11, cloudrun=url)
    ds_y, _ = create_dataset_from_generator(
        src_y, batch_size=batch, epoch_size=epoch_size,
        enable_augmentation=True, device=dev)
    ds_x, _ = create_dataset_from_generator(
        src_x, batch_size=batch, epoch_size=epoch_size, custom_map=warp,
        enable_augmentation=True, device=dev)
    model = EM2EM(74, exp, is3d=True, wf=wf, compute_dtype=dtype,
                  checkpoint_root=ckpt_root, device=dev)
    return ds_x, ds_y, model


def _epoch(ds_x, ds_y, model, batch) -> int:
    n, losses = 0, None
    for bx, by in zip(ds_x, ds_y):
        losses = model.train_step(bx, by)
        n += batch
    if losses is not None:
        np.asarray(losses.detach().cpu())  # the epoch's work is done
    return n


def bench_combined(dev, n_clients=16, batch=8, epoch_size=32, extent=192,
                   workers=8, wf=8, dtype="bfloat16") -> dict:
    """Streamed training and a fleet sharing one data service."""
    import requests

    url, proc, tmp = spawn_data_service(
        {"benchbucket/em": synth_volume(extent=extent)}, workers)
    log(f"data service subprocess on {url} (workers={workers})")
    stop_fleet = threading.Event()
    fleet_reqs = [0]
    lock = threading.Lock()
    side = min(128, extent)

    def fleet_client(cid):
        session = requests.Session()
        i = 0
        while not stop_fleet.is_set():
            if i % 2 == 0:
                start = [64 * ((cid + i) % 2), 64 * (cid % 2), 64 * (i % 2)]
                ok = _volume_req(session, url, "benchbucket/em", start)
            else:
                ok = _slice_req(session, url, "benchbucket/em",
                                (cid * 97 + i) % extent, side)
            _served(ok, "fleet")
            with lock:
                fleet_reqs[0] += 1
            i += 1

    ckpt = tempfile.mkdtemp(prefix="bench_comb_")
    before = launch_counts()
    try:
        ds_x, ds_y, model = _stream_model(url, "benchbucket/em", extent,
                                          batch, epoch_size, wf, dtype, dev,
                                          ckpt, "bench_comb")
        _epoch(ds_x, ds_y, model, batch)  # warm: first steps, prefetch
        t0 = time.perf_counter()
        alone = _epoch(ds_x, ds_y, model, batch) / (time.perf_counter() - t0)
        log(f"combined: train alone {alone:.2f} tiles/s")
        with cf.ThreadPoolExecutor(max_workers=n_clients) as ex:
            futs = [ex.submit(fleet_client, c) for c in range(n_clients)]
            time.sleep(1.0)  # let the fleet saturate
            with lock:
                fleet_reqs[0] = 0
            t0 = time.perf_counter()
            n = _epoch(ds_x, ds_y, model, batch)
            dt = time.perf_counter() - t0
            with lock:
                fleet_rate = fleet_reqs[0] / dt
            stop_fleet.set()
            for f in futs:
                f.result(timeout=60)  # a failed fleet request fails here
        contended = n / dt
        log(f"combined: train under {n_clients}-client fleet "
            f"{contended:.2f} tiles/s; fleet sustained {fleet_rate:.0f} "
            "req/s during the epoch")
    finally:
        stop_fleet.set()
        stop_data_service(proc, tmp)
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"bench": "serve", "section": "combined",
            "metric": "combined_stream_train_tiles74_per_sec",
            "value": contended, "unit": "tiles/s",
            "vs_baseline": contended / alone,
            "note": f"config-4 streaming train while {n_clients} clients "
                    f"read (fleet {fleet_rate:.0f} req/s); vs_baseline = "
                    f"vs train alone; DataService workers={workers}",
            "alone_tiles_per_sec": alone, "fleet_req_per_sec": fleet_rate,
            "batch": batch, "epoch_size": epoch_size, "wf": wf,
            "dtype": dtype, "launches": launches(before)}


# -- soak ---------------------------------------------------------------------

def _tree_pids(root_pid: int) -> List[int]:
    """root and all its descendants (/proc/<pid>/task/*/children)."""
    out, todo = [], [root_pid]
    while todo:
        pid = todo.pop()
        out.append(pid)
        try:
            for task in os.listdir(f"/proc/{pid}/task"):
                with open(f"/proc/{pid}/task/{task}/children") as f:
                    todo.extend(int(c) for c in f.read().split())
        except OSError:
            pass
    return out


def _tree_rss_mb(root_pid: int) -> float:
    total = 0
    for pid in _tree_pids(root_pid):
        try:
            with open(f"/proc/{pid}/statm") as f:
                total += int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except OSError:
            pass
    return total / 1e6


def _fd_count(pid: int) -> int:
    try:
        return len(os.listdir(f"/proc/{pid}/fd"))
    except OSError:
        return -1


def _drift_stats(latencies):
    """(p50 of the first decile, p50 of the last, p95 overall) in ms."""
    lat = np.asarray(latencies)
    n = max(len(lat) // 10, 1)
    return (float(np.median(lat[:n]) * 1e3),
            float(np.median(lat[-n:]) * 1e3),
            float(np.percentile(lat, 95) * 1e3))


def bench_soak_data(total_reqs=10_000, n_clients=8, workers=4,
                    fleet_clients=16, fleet_reqs=24, side=256) -> dict:
    """The data service under sustained mixed load with one prefork worker
    SIGKILLed at 40%, then the fleet again on the soaked service."""
    import requests

    vol = np.random.default_rng(0).integers(0, 255, size=(side,) * 3,
                                            dtype=np.uint8)
    per = side // 64
    url, proc, tmp = spawn_data_service({"soakbucket/vol": vol}, workers)
    log(f"soak: data service on {url} (workers={workers}, target "
        f"{total_reqs} reqs, one worker kill mid-run)")
    counter, errors, killed = [0], [0], [None]
    lock = threading.Lock()
    latencies = []

    def worker_pids():
        return [p for p in _tree_pids(proc.pid) if p != proc.pid]

    def client(cid):
        session = requests.Session()
        mine = []
        while True:
            with lock:
                i = counter[0]
                if i >= total_reqs:
                    break
                counter[0] += 1
            t0 = time.perf_counter()
            try:
                if i % 2 == 0:
                    ok = _volume_req(session, url, "soakbucket/vol",
                                     [64 * ((cid + i) % per), 64 * (i % per),
                                      64 * ((i // 7) % per)])
                else:
                    ok = _slice_req(session, url, "soakbucket/vol",
                                    i % side, side)
            except Exception:  # noqa: BLE001 — counted, as the bar says
                ok = False
                # a killed worker resets its connections: reconnect
                session = requests.Session()
            if not ok:
                with lock:
                    errors[0] += 1
            mine.append((i, time.perf_counter() - t0))
        with lock:
            latencies.extend(mine)

    try:
        rss0 = _tree_rss_mb(proc.pid)
        fds0 = _fd_count(proc.pid)
        n_workers0 = len(worker_pids())

        rss_samples = []

        def killer():
            while counter[0] < total_reqs * 2 // 5:
                time.sleep(0.05)
            for pid in worker_pids():  # one that is alive now
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    continue
                killed[0] = pid
                log(f"soak: SIGKILLed worker {pid} at req ~{counter[0]}")
                break
            while counter[0] < total_reqs:  # the tree's RSS after the kill
                rss_samples.append(_tree_rss_mb(proc.pid))
                time.sleep(0.25)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        kt = threading.Thread(target=killer, daemon=True)
        for t in threads:
            t.start()
        kt.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        kt.join(timeout=5)
        time.sleep(1.5)  # let the monitor finish a respawn
        n_workers1 = len(worker_pids())
        rss1 = _tree_rss_mb(proc.pid)
        fds1 = _fd_count(proc.pid)
        latencies.sort(key=lambda p: p[0])
        p50a, p50b, p95 = _drift_stats([d for _, d in latencies])
        bars = {
            "latency_drift_ok": p50b < 2 * p50a + 2.0,  # +2 ms floor
            "fd_stable_ok": fds1 <= fds0 + 16,
            "rss_bounded_ok": rss1 - rss0 < 200.0,
            "errors_ok": errors[0] <= max(2 * n_clients, total_reqs * 0.005),
            "respawn_ok": killed[0] is not None and n_workers1 == n_workers0,
        }
        ok = all(bars.values())
        log(f"soak data: {total_reqs} reqs in {wall:.1f}s "
            f"({total_reqs / wall:.0f} req/s), errors {errors[0]}, p50 "
            f"first/last decile {p50a:.1f}/{p50b:.1f} ms p95 {p95:.1f} ms, "
            f"rss {rss0:.0f}->{rss1:.0f} MB, fds {fds0}->{fds1}, workers "
            f"{n_workers0}->{n_workers1} (killed {killed[0]})")

        # the fleet again, on the soaked service with its respawned worker
        def fleet_client(args):
            cid, session = args
            for i in range(fleet_reqs):
                if i % 2 == 0:
                    _served(_volume_req(session, url, "soakbucket/vol",
                                        [64 * ((cid + i) % per),
                                         64 * (cid % per), 64 * (i % per)]),
                            "/volume")
                else:
                    _served(_slice_req(session, url, "soakbucket/vol",
                                       (cid * fleet_reqs + i) % side, side),
                            "/slice")
            return fleet_reqs

        sessions = [requests.Session() for _ in range(fleet_clients)]
        best = None
        for rep in range(3):  # rep 0 warms connections
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=fleet_clients) as ex:
                sum(ex.map(fleet_client, enumerate(sessions)))
            dt = time.perf_counter() - t0
            if rep:
                best = min(best, dt) if best else dt
        post_fleet = fleet_clients * fleet_reqs / best
        log(f"soak data: post-soak fleet rerun {post_fleet:.0f} req/s")
        # the service's own report of workers it found dead and reforked
        deaths = _service_log(tmp).count("reforking")
    finally:
        stop_data_service(proc, tmp)
    return {"bench": "serve", "section": "soak_data",
            "metric": "serve_soak_data_req_per_sec",
            "value": total_reqs / wall, "unit": "req/s",
            "vs_baseline": 1.0 if ok else 0.0, "pass": ok, "bars": bars,
            "errors": errors[0], "p50_first_ms": p50a, "p50_last_ms": p50b,
            "p95_ms": p95, "rss_mb": [rss0, rss1],
            "rss_mb_after_kill": rss_samples, "fds": [fds0, fds1],
            "workers": [n_workers0, n_workers1], "workers_reforked": deaths,
            "post_soak_fleet_req_per_sec": post_fleet,
            "requests": total_reqs}


def bench_soak_model(dev, total_reqs=1000, n_clients=8, n_models=1, wf=8,
                     side=256) -> dict:
    """Sustained concurrent chunk requests through the model service
    (batching on); with ``n_models`` > 1 the requests alternate between
    models against ``cache_size=1`` and every VERIFY_EVERY-th response is
    held byte for byte against its model's direct prediction."""
    from ..infer import load_generator, predict_tiled
    from ..native import gather_blocks
    from ..serve import ModelService, NumpyVolume, predict_chunk
    from ..serve import register_volume
    from ..shapes import tile_plan_outdimsize

    log(f"soak model: {dev}; {total_reqs} x 64^3 chunk requests, "
        f"{n_clients} clients, {n_models} model(s), cache_size=1")
    vol = np.random.default_rng(0).integers(0, 255, size=(side,) * 3,
                                            dtype=np.uint8)
    register_volume("soakbucket/vol", NumpyVolume(vol))
    root = tempfile.mkdtemp(prefix="soak_model_")
    dest_root = tempfile.mkdtemp(prefix="soak_model_out_")
    metas = export_models(root, n_models, wf)
    per_dim = side // CHUNK
    verify_every = max(1, total_reqs // 10)
    while n_models > 1 and math.gcd(verify_every, n_models) != 1:
        verify_every += 1  # verified indices must cycle through every model
    expected: Dict = {}
    direct: Dict[int, torch.nn.Module] = {}
    lock = threading.Lock()
    latencies = []
    errors = [0]

    def start_of(i):
        return (CHUNK * (i % per_dim), CHUNK * ((i // per_dim) % per_dim),
                CHUNK * ((i // per_dim ** 2) % per_dim))

    if n_models > 1:  # loaded before the RSS baseline
        for m in range(n_models):
            direct[m] = load_generator(os.path.join(root, f"m{m}", "v"),
                                       device=dev)[0]

    def direct_chunk(m, start):
        meta = metas[m]
        return predict_tiled(
            lambda corner, insize: gather_blocks(vol, [corner], insize)[0],
            direct[m], start, (CHUNK,) * 3, meta.outdimsize, meta.buffer,
            meta.meanstd_x, meta.meanstd_y, batch_size=8, device=dev)

    def verify(i, dest):
        m, start = i % n_models, start_of(i)
        with lock:
            want = expected.get((m, start))
        if want is None:
            want = direct_chunk(m, start).tobytes()
            with lock:
                expected[(m, start)] = want
        x, y, z = start
        name = f"{x}-{x + CHUNK}_{y}-{y + CHUNK}_{z}-{z + CHUNK}"
        with open(os.path.join(dest, name), "rb") as f:
            got = gzip.decompress(f.read())
        if got != want:
            raise AssertionError(f"req {i}: served bytes != model m{m}'s "
                                 "direct prediction (a cross-model mixup "
                                 "under eviction churn?)")

    def req(i):
        t0 = time.perf_counter()
        checking = n_models > 1 and i % verify_every == 0
        # a verified request writes to a private dest: the shared i % 64
        # dirs are rewritten by other requests of the same start
        dest = os.path.join(dest_root, f"v{i}" if checking else str(i % 64))
        try:
            predict_chunk(svc.url, "soakbucket/vol", start=start_of(i),
                          size=(CHUNK,) * 3, model_name=f"m{i % n_models}:v",
                          dest=dest)
            if checking:
                verify(i, dest)
            ok = True
        except Exception as e:  # noqa: BLE001 — counted, as the bar says
            ok = False
            log(f"soak model req {i} failed: {e}")
        with lock:
            if not ok:
                errors[0] += 1
            latencies.append((i, time.perf_counter() - t0))

    svc = ModelService(model_root=root, max_inflight=n_clients, cache_size=1,
                       device=dev)
    svc.start()
    me = os.getpid()
    before = launch_counts()
    try:
        for m in range(n_models):  # warm: every model's first batch
            req(m)
        latencies.clear()
        errors[0] = 0
        rss0, fds0 = _tree_rss_mb(me), _fd_count(me)
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=n_clients) as ex:
            list(ex.map(req, range(total_reqs)))
        wall = time.perf_counter() - t0
        rss1, fds1 = _tree_rss_mb(me), _fd_count(me)
        latencies.sort(key=lambda p: p[0])
        lat = [d for _, d in latencies]
        p50a, p50b, p95 = _drift_stats(lat)
        # judge drift against max(first decile, median decile): a slow or
        # fast edge decile alone is weather, a monotone rise is a leak
        n10 = max(len(lat) // 10, 1)
        deciles = [float(np.median(lat[i:i + n10]) * 1e3)
                   for i in range(0, len(lat) - n10 + 1, n10)]
        log("soak model: per-decile p50 ms: "
            + " ".join(f"{d:.0f}" for d in deciles))
        p50_ref = max(p50a, float(np.median(deciles)))
        stats = json.loads(urllib.request.urlopen(
            svc.url + "/stats").read()).get("batcher") or {}
        eff_out, eff_buf, _ = tile_plan_outdimsize(metas[0].outdimsize,
                                                   metas[0].buffer)
        insize = eff_out + 2 * eff_buf
        if n_models > 1:
            # the live counters cover the resident model only: 8 tiles a
            # chunk, and one weight upload a request bounds the reloads
            pbytes = sum(os.path.getsize(os.path.join(root, f"m{m}", "v",
                                                      "generator.npz"))
                         for m in range(n_models)) / n_models
            h2d_mb = (total_reqs * 8 * insize ** 3
                      + total_reqs * pbytes) / 1e6
        else:
            h2d_mb = (stats.get("tiles", 0) + stats.get("padded", 0)) \
                * insize ** 3 / 1e6
        tiles = stats.get("tiles", 0)
        occupancy = tiles / max(1, tiles + stats.get("padded", 0))
        bars = {
            "latency_drift_ok": p50b < 2 * p50_ref,
            "fd_stable_ok": fds1 <= fds0 + 16,
            "errors_ok": errors[0] == 0,
            "rss_within_h2d_budget_ok": rss1 - rss0 < 1.5 * h2d_mb + 300,
        }
        ok = all(bars.values())
        log(f"soak model: {total_reqs} reqs in {wall:.1f}s "
            f"({total_reqs / wall:.2f} req/s), errors {errors[0]}, p50 "
            f"first/last {p50a:.0f}/{p50b:.0f} ms p95 {p95:.0f} ms, rss "
            f"{rss0:.0f}->{rss1:.0f} MB (shipped ~{h2d_mb:.0f} MB, "
            f"occupancy {occupancy:.0%}), fds {fds0}->{fds1}")
    finally:
        svc.stop()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(dest_root, ignore_errors=True)
    return {"bench": "serve", "section": "soak_model",
            "metric": ("serve_soak_model_req_per_sec" if n_models == 1 else
                       f"serve_soak_model_churn{n_models}_req_per_sec"),
            "value": total_reqs / wall, "unit": "req/s",
            "vs_baseline": 1.0 if ok else 0.0, "pass": ok, "bars": bars,
            "errors": errors[0], "models": n_models,
            "verified": len(expected),
            "verified_models": sorted({m for m, _ in expected}),
            "p50_first_ms": p50a, "p50_last_ms": p50b, "p95_ms": p95,
            "decile_p50_ms": deciles, "rss_mb": [rss0, rss1],
            "h2d_mb": h2d_mb, "occupancy": occupancy, "fds": [fds0, fds1],
            "requests": total_reqs, "mvox_per_sec":
                total_reqs * CHUNK ** 3 / wall / 1e6,
            "launches": launches(before)}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="serving fleets of the port (one JSON line a section).")
    ap.add_argument("section", nargs="?", default="model",
                    choices=("model", "data", "combined", "soak"))
    ap.add_argument("--models", type=int, default=None,
                    help="soak: only the model soak, over N models "
                         "(eviction churn)")
    ap.add_argument("--reqs", type=int,
                    default=_env_int("BENCH_SERVE_REQS", 16),
                    help="model: concurrent chunk requests")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--soak-data-reqs", type=int,
                    default=_env_int("SOAK_DATA_REQS", 10_000))
    ap.add_argument("--soak-model-reqs", type=int,
                    default=_env_int("SOAK_MODEL_REQS", 1000))
    ap.add_argument("--clients", type=int, default=16,
                    help="data / combined: fleet clients")
    ap.add_argument("--reqs-per-client", type=int, default=24,
                    help="data: requests a client a round")
    ap.add_argument("--workers", default="0,4,8",
                    help="data: prefork worker counts to run")
    ap.add_argument("--combined-workers", type=int, default=8)
    ap.add_argument("--soak-workers", type=int, default=4)
    ap.add_argument("--side", type=int, default=256,
                    help="the served uint8 volume's side (a multiple of 64)")
    ap.add_argument("--wf", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8,
                    help="combined: train batch")
    ap.add_argument("--epoch-size", type=int, default=32)
    ap.add_argument("--extent", type=int, default=192,
                    help="combined: the training volume's side")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="combined: the train step's dtype")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    float32_exact()
    if args.side % 64 or args.side < 64:
        ap.error("--side must be a positive multiple of 64")
    dev = resolve_device(args.device)
    rc = 0
    if args.section == "model":
        rec = bench_model(dev, args.reqs, args.reps, args.wf, args.side)
        emit({**rec, **card(dev)})
    elif args.section == "data":
        grid = [int(w) for w in args.workers.split(",") if w]
        rec = bench_data_fleet(dev, args.clients, args.reqs_per_client,
                               grid, args.reps, args.side)
        emit({**rec, "launches": {}, **card(dev)})
    elif args.section == "combined":
        rec = bench_combined(dev, args.clients, args.batch, args.epoch_size,
                             args.extent, args.combined_workers, args.wf,
                             DTYPES[args.dtype])
        emit({**rec, **card(dev)})
    else:
        recs = []
        if args.models is None:
            recs.append({**bench_soak_data(args.soak_data_reqs,
                                           workers=args.soak_workers,
                                           side=args.side),
                         "launches": {}})
        recs.append(bench_soak_model(dev, args.soak_model_reqs,
                                     n_models=args.models or 1, wf=args.wf,
                                     side=args.side))
        info = card(dev)
        for rec in recs:
            emit({**rec, **info})
        rc = 0 if all(r["pass"] for r in recs) else 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
