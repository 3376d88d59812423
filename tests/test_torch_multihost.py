"""Two (or four) processes on the CPU joined by
``parallel.distributed.initialize`` (gloo), each with one or two CPU
positions in one global mesh: the port's counterpart of
tests/test_multihost.py.

The workers run once per topology (a module-scoped fixture) and record
every proof on their own, so one failure does not mask the rest; each test
asserts one proof:

* ``host_local_batch`` assembles the global batch from each process's rows;
* one DP step (dropout on) gives every process the same losses, equal to
  the single-process step on the global batch: 2x1, 2x2 and 4x1;
* ``shard_state`` gives every process rank 0's step and Adam counts too, so
  a process that starts from another step takes the same DP step;
* ``host_sharded_seed`` ROI streams are disjoint between processes and
  reproducible;
* a meshed ``EM2EM``'s checkpoint (written by rank 0) restores bit-equal on
  both processes;
* the halo exchange crosses the process boundaries: every addressable
  shard equals the generator on its slab of the padded image: 2x1, 2x2
  and 4x1 (a ring with three boundaries);
* ``shard_by_host`` streaming sources feed the DP step.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys, traceback
pid = int(sys.argv[1]); port = sys.argv[2]; outdir = sys.argv[3]
NDEV = int(sys.argv[4]); PROOFS = set(sys.argv[5].split(","))
NPROC = int(sys.argv[6])
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(2)

from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.data.sources import corner_stream, host_sharded_seed
from transfer_em_tpu_torch.parallel import (halo_predict, host_local_batch,
                                            make_dp_train_step, make_mesh,
                                            shard_state)
from transfer_em_tpu_torch.parallel.distributed import (barrier, initialize,
                                                        process_info)
from transfer_em_tpu_torch.train import EM2EM, create_state

CPU = torch.device("cpu")
initialize("127.0.0.1:" + port, num_processes=NPROC, process_id=pid,
           backend="gloo", timeout_s=300)
assert process_info()[:2] == (pid, NPROC), process_info()
mesh = make_mesh(devices=[CPU] * NDEV)
GDEV = NPROC * NDEV
assert mesh.size == GDEV and mesh.spans_processes
assert mesh.local_positions() == list(range(pid * NDEV, (pid + 1) * NDEV))

result = {{"pid": pid, "errors": {{}}}}

def guard(name):
    # record a proof's failure and go on, so the barriers still pair up
    def deco(fn):
        try:
            fn()
        except BaseException:
            result["errors"].setdefault(name, traceback.format_exc())
    return deco

cfg = CycleGANConfig(dimsize=74, is3d=False, wf=32)
rng = np.random.default_rng(7)
gx = (0.3 * rng.normal(size=(8, 74, 74, 1))).astype(np.float32)
gy = (0.3 * rng.normal(size=(8, 74, 74, 1))).astype(np.float32)
per = 8 // NPROC
rows = slice(pid * per, (pid + 1) * per)
x = y = None

@guard("hlb")
def _hlb():
    global x, y
    x = host_local_batch(gx[rows], mesh)
    y = host_local_batch(gy[rows], mesh)
    assert x.shape == (8, 74, 74, 1) and not x.complete, x.shape
    assert len(x.addressable_shards) == NDEV
    for s in x.addressable_shards:
        np.testing.assert_array_equal(s.data.numpy(), gx[s.index[0]])

@guard("dp")
def _dp():
    state = shard_state(create_state(cfg, 0, device="cpu"), mesh)
    loss = make_dp_train_step(cfg, mesh)(state, x, y, 1)
    result["loss"] = loss.tolist()
    result["stem_sum"] = float(state.gg.stem.kernel.abs().sum())

if "skew" in PROOFS:
    @guard("skew")
    def _skew():
        # rank 1 starts from another state: other weights, step and Adam
        # counts (a process that restored another checkpoint, or none)
        state = create_state(cfg, 0 if pid == 0 else 99, device="cpu")
        if pid != 0:
            state.step = 5
            for t in ("gg", "gf", "dx", "dy"):
                getattr(state, "opt_" + t).count = 5
        shard_state(state, mesh)
        result["skew_after_shard"] = [state.step] + [
            getattr(state, "opt_" + t).count for t in ("gg", "gf", "dx", "dy")]
        loss = make_dp_train_step(cfg, mesh)(state, x, y, 1)
        result["skew_loss"] = loss.tolist()
        result["skew_stem_sum"] = float(state.gg.stem.kernel.abs().sum())
        result["skew_counts"] = [state.step] + [
            getattr(state, "opt_" + t).count for t in ("gg", "gf", "dx", "dy")]

@guard("corners")
def _corners():
    seed = host_sharded_seed(42)
    result["seed"] = seed
    result["corners"] = [list(c) for c, _ in zip(
        corner_stream(((0, 0, 0), (100, 100, 100)), 74, seed), range(5))]

if "ckpt" in PROOFS:
    live = []

    @guard("ckpt")
    def _save():
        m = EM2EM(74, "mh", is3d=False, wf=32, device="cpu", seed=0,
                  checkpoint_root=os.path.join(outdir, "ck"))
        m.to_mesh(mesh)
        m.train_step(x, y)
        m.make_checkpoint(1)
        m.wait_until_finished()
        live.append(m)

    barrier("mh_ckpt_saved")

    @guard("ckpt")
    def _restore():
        m = live[0]
        r = EM2EM(74, "mh", is3d=False, wf=32, device="cpu", seed=99,
                  checkpoint_root=os.path.join(outdir, "ck"))
        ok = r.state.step == m.state.step == 1
        for t in ("gg", "gf", "dx", "dy"):
            for p, q in zip(getattr(r.state, t).parameters(),
                            getattr(m.state, t).parameters()):
                ok = ok and torch.equal(p, q)
            o, w = getattr(r.state, "opt_" + t), getattr(m.state, "opt_" + t)
            ok = ok and all(torch.equal(o.nu[k], w.nu[k]) for k in w.nu)
        result["ckpt_roundtrip_ok"] = bool(ok)
        result["ckpt_files"] = sorted(os.listdir(os.path.join(
            outdir, "ck", "train_mh")))

@guard("halo")
def _halo():
    from transfer_em_tpu_torch.models import UNetGenerator
    from transfer_em_tpu_torch.ops.convs import zero_pad
    gen = UNetGenerator(wf=32, is3d=False,
                        generator=torch.Generator().manual_seed(3))
    slab = 20  # slab % 4 == 0, slab + 34 = 54 valid
    vol = torch.from_numpy(np.random.default_rng(21).normal(
        size=(GDEV * slab, 74, 1)).astype(np.float32))
    smesh = make_mesh(devices=[CPU] * NDEV, data=1, space=GDEV)
    out = halo_predict(gen, None, vol, smesh, 17)
    padded = zero_pad(vol[None], 17)[:, :, 17:-17]
    with torch.no_grad():
        whole = gen(padded)[0]
    exact, diff, n = True, 0.0, 0
    for s in out.addressable_shards:
        lo = s.index[0].start
        with torch.no_grad():
            ref = gen(padded[:, lo:lo + slab + 34])[0]
        exact = exact and torch.equal(s.data, ref)
        diff = max(diff, float((s.data - whole[s.index]).abs().max()))
        n += 1
    result.update(halo_exact=exact, halo_max_diff=diff, halo_shards=n)

if "stream" in PROOFS:
    from transfer_em_tpu_torch.data import create_dataset_from_generator
    from transfer_em_tpu_torch.data.sources import volume3d_ng
    ngdir = os.path.join(outdir, "ngvol")

    @guard("stream")
    def _ngvol_write():
        if pid != 0:
            return
        import tensorstore as tsm
        vdata = np.random.default_rng(17).integers(
            0, 256, size=(128, 128, 128), dtype=np.uint8)  # xyz
        spec = {{"driver": "neuroglancer_precomputed",
                "kvstore": {{"driver": "file", "path": ngdir}},
                "create": True,
                "schema": {{"dtype": "uint8",
                           "domain": {{"shape": [128, 128, 128, 1]}},
                           "chunk_layout": {{"chunk": {{
                               "shape": [128, 128, 128, 1]}}}}}}}}
        tsm.open(spec).result()[...] = vdata[..., None]

    barrier("mh_ngvol_ready")

    @guard("stream")
    def _stream():
        src = volume3d_ng("file://" + ngdir, bbox=((0, 0, 0), (54, 54, 54)),
                          size=74, seed=42, shard_by_host=True,
                          num_threads=2)
        ds, _ = create_dataset_from_generator(
            src, batch_size=4, epoch_size=8, meanstd=(0.0, 1.0),
            enable_augmentation=False, fetch_threads=0, device="cpu")
        bx, by = (b[:, 37].numpy() for b in ds.take_batches(2))
        state = shard_state(create_state(cfg, 0, device="cpu"), mesh)
        loss = make_dp_train_step(cfg, mesh)(
            state, host_local_batch(bx, mesh), host_local_batch(by, mesh), 2)
        result["stream_loss"] = loss.tolist()
        result["stream_x_sum"] = float(np.abs(bx).sum())
        result["stream_y_sum"] = float(np.abs(by).sum())

barrier("mh_done")
with open(os.path.join(outdir, "result_%d.json" % pid), "w") as f:
    json.dump(result, f)
print("WORKER_OK", pid)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(tmpdir, ndev, proofs, nproc=2, timeout=600):
    worker = os.path.join(tmpdir, "worker.py")
    with open(worker, "w") as f:
        f.write(WORKER.format(repo=REPO))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), port, tmpdir, str(ndev), proofs,
         str(nproc)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:  # a failed or timed-out pair must not linger
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    results = {}
    for pid in range(nproc):
        with open(os.path.join(tmpdir, f"result_{pid}.json")) as f:
            results[pid] = json.load(f)
    return results


@pytest.fixture(scope="module")
def mh(tmp_path_factory):
    """2 processes x 1 position each: the full proof set."""
    return _run_group(str(tmp_path_factory.mktemp("mh_2x1")), 1,
                      "hlb,dp,skew,corners,ckpt,halo,stream")


@pytest.fixture(scope="module")
def mh_2x2(tmp_path_factory):
    """2 processes x 2 positions each: the process boundary in the middle
    of a 4-position ring, two shards a process."""
    return _run_group(str(tmp_path_factory.mktemp("mh_2x2")), 2,
                      "hlb,dp,halo")


@pytest.fixture(scope="module")
def mh_4x1(tmp_path_factory):
    """4 processes x 1 position each: the process boundary between every
    pair of neighbours (the layout of one process per card)."""
    return _run_group(str(tmp_path_factory.mktemp("mh_4x1")), 1,
                      "hlb,dp,halo", nproc=4)


def _no_error(results, name):
    for pid in results:
        err = results[pid]["errors"].get(name)
        assert err is None, f"proof {name!r} failed on pid {pid}:\n{err}"


def _single_step_loss(gx, gy, seed):
    """The single-process step on the global batch, and G's stem sum."""
    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import create_state, make_train_step
    cfg = CycleGANConfig(dimsize=74, is3d=False, wf=32)
    state = create_state(cfg, 0, device="cpu")
    loss = make_train_step(cfg, device="cpu")(state, gx, gy, seed)
    return loss.numpy(), float(state.gg.stem.kernel.detach().abs().sum())


def _check_dp(results):
    _no_error(results, "dp")
    for pid in results:
        np.testing.assert_allclose(results[pid]["loss"], results[0]["loss"],
                                   rtol=1e-6, atol=1e-7)
        assert results[pid]["stem_sum"] == pytest.approx(
            results[0]["stem_sum"], rel=1e-6)
    rng = np.random.default_rng(7)
    gx = (0.3 * rng.normal(size=(8, 74, 74, 1))).astype(np.float32)
    gy = (0.3 * rng.normal(size=(8, 74, 74, 1))).astype(np.float32)
    loss, stem = _single_step_loss(gx, gy, 1)
    np.testing.assert_allclose(results[0]["loss"], loss, rtol=2e-4,
                               atol=1e-5)
    assert results[0]["stem_sum"] == pytest.approx(stem, rel=1e-4)


def _check_halo(results, shards):
    _no_error(results, "halo")
    for pid in results:
        r = results[pid]
        assert r["halo_shards"] == shards, r
        assert r["halo_exact"], r
        assert r["halo_max_diff"] < 1e-4, r


def test_mh_host_local_batch(mh):
    _no_error(mh, "hlb")


def test_mh_dp_parity(mh):
    _check_dp(mh)


def test_mh_shard_state_aligns_steps(mh):
    _no_error(mh, "skew")
    for pid in mh:
        assert mh[pid]["skew_after_shard"] == [0] * 5, mh[pid]
        assert mh[pid]["skew_counts"] == [1] * 5, mh[pid]
        assert mh[pid]["skew_stem_sum"] == mh[0]["skew_stem_sum"]
        np.testing.assert_allclose(mh[pid]["skew_loss"], mh[0]["skew_loss"],
                                   rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(7)
    gx = (0.3 * rng.normal(size=(8, 74, 74, 1))).astype(np.float32)
    gy = (0.3 * rng.normal(size=(8, 74, 74, 1))).astype(np.float32)
    loss, stem = _single_step_loss(gx, gy, 1)
    np.testing.assert_allclose(mh[0]["skew_loss"], loss, rtol=2e-4,
                               atol=1e-5)
    assert mh[0]["skew_stem_sum"] == pytest.approx(stem, rel=1e-4)


def test_mh_corner_streams_disjoint_reproducible(mh):
    _no_error(mh, "corners")
    from transfer_em_tpu_torch.data.sources import corner_stream
    assert mh[0]["seed"] == 42 * 1_000_003 + 0
    assert mh[1]["seed"] == 42 * 1_000_003 + 1
    c0, c1 = mh[0]["corners"], mh[1]["corners"]
    assert not any(tuple(a) == tuple(b) for a in c0 for b in c1)
    for pid in (0, 1):
        want = [c for c, _ in zip(
            corner_stream(((0, 0, 0), (100, 100, 100)), 74,
                          mh[pid]["seed"]), range(5))]
        assert [tuple(c) for c in mh[pid]["corners"]] == want


def test_mh_checkpoint_roundtrip(mh):
    _no_error(mh, "ckpt")
    assert mh[0]["ckpt_roundtrip_ok"] and mh[1]["ckpt_roundtrip_ok"]
    assert mh[0]["ckpt_files"] == ["1"]  # one copy, written by rank 0


def test_mh_halo_ring(mh):
    _check_halo(mh, shards=1)


def test_mh_stream_shards_feed_dp(mh):
    _no_error(mh, "stream")
    assert mh[0]["stream_x_sum"] != mh[1]["stream_x_sum"]
    assert mh[0]["stream_y_sum"] != mh[1]["stream_y_sum"]
    np.testing.assert_allclose(mh[0]["stream_loss"], mh[1]["stream_loss"],
                               rtol=1e-6, atol=1e-7)
    from transfer_em_tpu_torch.data.sources import corner_stream
    vdata = np.random.default_rng(17).integers(
        0, 256, size=(128, 128, 128), dtype=np.uint8)

    def host_elements(pid, n=8):
        cs = corner_stream(((0, 0, 0), (54, 54, 54)), 74,
                           42 * 1_000_003 + pid)
        return [vdata[cx:cx + 74, cy:cy + 74, cz:cz + 74].astype(
            np.float32) / 127.5 - 1.0 for (cx, cy, cz), _ in zip(cs, range(n))]

    els = {pid: host_elements(pid) for pid in (0, 1)}
    gx = np.stack(els[0][0:4] + els[1][0:4])[:, 37][..., None]
    gy = np.stack(els[0][4:8] + els[1][4:8])[:, 37][..., None]
    loss, _ = _single_step_loss(gx, gy, 2)
    np.testing.assert_allclose(mh[0]["stream_loss"], loss, rtol=5e-4,
                               atol=1e-5)


def test_mh_host_local_batch_2x2(mh_2x2):
    _no_error(mh_2x2, "hlb")


def test_mh_dp_parity_2x2(mh_2x2):
    _check_dp(mh_2x2)


def test_mh_halo_ring_2x2(mh_2x2):
    _check_halo(mh_2x2, shards=2)


def test_mh_host_local_batch_4x1(mh_4x1):
    _no_error(mh_4x1, "hlb")


def test_mh_dp_parity_4x1(mh_4x1):
    _check_dp(mh_4x1)


def test_mh_halo_ring_4x1(mh_4x1):
    _check_halo(mh_4x1, shards=1)
