"""Device mode's host copies in z slabs (``infer/device_stitch.py``
``slab_schedule`` and ``_SlabCopies``) on the CPU, where the slabs move as
plain copies through the same slots, in the same pieces, as through the
card's pinned ones.

The schedule as a pure function: every tile's read lies in the planes
staged before its batch, no plane is staged that no tile reads, and each
result plane is downloaded once, after the last batch that writes it; the
walk it assumes is the one the batch loop takes.  The staged path bit-equal
to tiles mode at one-plane and few-plane slots (the slot ring wraps), from
a tensor used in place and with a tensor result.  The counts
(``volume_slabs_in``, ``volume_slabs_out``, ``volume_pageable``) by path,
a fresh array a call, and slots reused across calls.
"""

import numpy as np
import pytest
import torch

from transfer_em_tpu_torch import telemetry
from transfer_em_tpu_torch.infer import device_stitch, plan_tiles
from transfer_em_tpu_torch.infer import predict_volume
from transfer_em_tpu_torch.infer.device_stitch import padding, slab_schedule
from transfer_em_tpu_torch.infer.tiling import tile_batch
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

MS_X, MS_Y = (0.1, 0.9), (0.05, 1.1)
DEPTH = 120  # the test volume's side
COUNTS = ("volume_slabs_in", "volume_slabs_out", "volume_pageable")

# (start xyz, size xyz, batch, source depth): reads inside the volume;
# sizes no multiple of the 36 output tile; reads before the origin; the
# last z row past the volume's end; every read past it; one tile; a batch
# larger than the tile count; the benchmark's request (1000 tiles, B=128,
# 400 deep); no tile at all.
SCHEDULES = {
    "interior": ((40, 40, 40), (72, 36, 72), 3, DEPTH),
    "ragged": ((30, 40, 20), (50, 40, 100), 4, DEPTH),
    "before_origin": ((-50, 10, -30), (72, 36, 108), 2, DEPTH),
    "far_past_edge": ((100, 100, 110), (36, 36, 72), 2, DEPTH),
    "wholly_past_edge": ((10, 10, 500), (36, 72, 72), 3, DEPTH),
    "single_tile": ((40, 40, 40), (36, 36, 36), 8, DEPTH),
    "batch_over_tiles": ((20, 30, 20), (72, 72, 72), 64, DEPTH),
    "volume_cell": ((20, 20, 20), (360, 360, 360), 128, 400),
    "zero_extent": ((0, 0, 0), (64, 0, 64), 8, DEPTH),
}

# predict_volume's bit-equality cases (tests/test_torch_predict_volume.py)
# with more z rows, so that requests span several slabs each way
CASES = {
    "interior": ((40, 40, 40), (72, 36, 72), 3),
    "far_past_edge": ((100, 100, 110), (36, 36, 72), 2),
    "before_origin": ((-50, 10, -20), (72, 36, 72), 2),
    "single_tile": ((40, 40, 40), (36, 36, 36), 8),
    "ragged_batch": ((20, 30, 10), (72, 36, 108), 3),
    "unaligned": ((30, 40, 20), (50, 40, 64), 4),
}


def _plan(case):
    start, size, bs, depth = SCHEDULES[case]
    plan = plan_tiles(start, size, 40, 17)
    return plan, tile_batch(plan.num_tiles, bs), depth


def _rows(plan, batch):
    """The z row of each tile slot of each batch, walked z outermost, the
    last batch padded with repeats of the last tile."""
    od = plan.outdimsize
    _, py, px = plan.padded_size
    row, T = (py // od) * (px // od), plan.num_tiles
    return [[min(t, T - 1) // row for t in range(k * batch, (k + 1) * batch)]
            for k in range(-(-T // batch))]


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_stages_every_read_before_its_batch(case):
    plan, batch, depth = _plan(case)
    slabs = slab_schedule(plan, batch, depth)
    assert len(slabs) == len(_rows(plan, batch))
    z_first = plan.corners[0][2] if plan.num_tiles else 0
    od, s = plan.outdimsize, plan.insize
    staged, read = set(), set()
    for ((z0, z1), _), rows in zip(slabs, _rows(plan, batch)):
        assert 0 <= z0 <= z1 <= depth
        new = set(range(z0, z1))
        assert not new & staged  # each plane staged once
        staged |= new
        for r in rows:
            planes = set(range(max(z_first + r * od, 0),
                               min(z_first + r * od + s, depth)))
            assert planes <= staged, (r, min(planes), max(planes))
            read |= planes
    assert staged == read  # nothing staged that no tile reads


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_downloads_each_plane_after_its_last_writer(case):
    plan, batch, depth = _plan(case)
    slabs = slab_schedule(plan, batch, depth)
    od, sz = plan.outdimsize, plan.size[2]
    last = {}
    for k, rows in enumerate(_rows(plan, batch)):
        for r in rows:
            for o in range(r * od, min((r + 1) * od, sz)):
                last[o] = k
    downloaded = {}
    for k, (_, (o0, o1)) in enumerate(slabs):
        assert 0 <= o0 <= o1 <= sz
        for o in range(o0, o1):
            assert o not in downloaded  # each plane once
            downloaded[o] = k
    assert downloaded == last
    assert sorted(downloaded) == list(range(sz if plan.num_tiles else 0))


@pytest.fixture(scope="module")
def gen():
    """The wf=32 generator, each kernel drawn at std 1/sqrt(fan-in), so
    that the outputs spread over the uint8 range."""
    torch.manual_seed(3)
    g = UNetGenerator(wf=32)
    with torch.no_grad():
        for p in g.parameters():
            p.normal_(0.0, float(np.prod(p.shape[:-1])) ** -0.5)
    return g.eval()


@pytest.fixture(scope="module")
def vol():
    return np.random.default_rng(7).integers(0, 255, (DEPTH,) * 3,
                                             dtype=np.uint8)


def test_batch_loop_walks_the_schedules_tiles(gen, vol):
    """The z rows of the batch loop's tile slots (``_prepare``'s grid
    cells) are the rows the schedule assumes."""
    for case in ("ragged", "before_origin", "batch_over_tiles"):
        plan, batch, _ = _plan(case)
        vol_t = torch.from_numpy(vol)
        pad = padding(plan, vol_t.shape, False)
        vol_t = torch.nn.functional.pad(vol_t, (pad,) * 6)
        _, cells, _, _, per = device_stitch._prepare(
            vol_t, gen, plan, batch, pad, False, torch.device("cpu"), None)
        rows = _rows(plan, batch)
        assert per == len(rows)
        assert cells[0].tolist() == [r for b in rows for r in b]


def _device(vol, gen, start, size, bs, **kw):
    return predict_volume(vol, gen, start, size, MS_X, MS_Y, mode="device",
                          batch_size=bs, device="cpu", **kw)


def _counts():
    c = telemetry.totals()["counts"]
    return {k: c.get(k, 0) for k in COUNTS}


def _since(before):
    now = _counts()
    return {k: now[k] - before[k] for k in COUNTS}


@pytest.mark.parametrize("slot_planes", [None, 1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_device_mode_bit_equal(gen, vol, case, slot_planes,
                                      monkeypatch):
    """Device mode from a host array equals tiles mode; at slots of one or
    three source planes (a fresh staging, two slots a direction, so the
    ring wraps) the slabs move in several pieces and still do."""
    start, size, bs = CASES[case]
    want = predict_volume(vol, gen, start, size, MS_X, MS_Y, mode="tiles",
                          batch_size=bs, device="cpu")
    assert want.std() > 2
    if slot_planes is not None:
        monkeypatch.setattr(device_stitch, "_STAGING", {})
        monkeypatch.setattr(device_stitch, "SLOTS", 2)
        monkeypatch.setattr(device_stitch, "SLOT_BYTES",
                            slot_planes * DEPTH ** 2)
    before = _counts()
    got = _device(vol, gen, start, size, bs)
    np.testing.assert_array_equal(got, want)
    n = _since(before)
    plan = plan_tiles(start, size, 40, 17)
    slabs = slab_schedule(plan, tile_batch(plan.num_tiles, bs), DEPTH)
    assert n == {"volume_slabs_in": sum(z1 > z0 for (z0, z1), _ in slabs),
                 "volume_slabs_out": sum(o1 > o0 for _, (o0, o1) in slabs),
                 "volume_pageable": 0}
    assert n["volume_slabs_in"] > 0 and n["volume_slabs_out"] > 0


@pytest.mark.parametrize("case", ["before_origin", "ragged_batch"])
def test_in_place_source_and_tensor_result(gen, vol, case):
    """A tensor already on the device is used in place (no slab uploaded)
    and a tensor result downloads none; both equal the staged path."""
    start, size, bs = CASES[case]
    want = _device(vol, gen, start, size, bs)
    before = _counts()
    got = _device(torch.from_numpy(vol), gen, start, size, bs)
    n = _since(before)
    np.testing.assert_array_equal(got, want)
    assert n["volume_slabs_in"] == 0 and n["volume_slabs_out"] > 0
    before = _counts()
    got = _device(vol, gen, start, size, bs, as_numpy=False)
    n = _since(before)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    assert n["volume_slabs_in"] > 0 and n["volume_slabs_out"] == 0
    assert n["volume_pageable"] == 0


def test_unstaged_paths_count_pageable(gen, vol):
    """mesh= and slab mode copy their volume whole (``volume_pageable``,
    no slab); stream mode moves its own blocks and counts none of the
    three."""
    start, size, bs = CASES["interior"]
    want = _device(vol, gen, start, size, bs)
    mesh = Mesh(np.array([torch.device("cpu")] * 2, dtype=object),
                ("data",))
    before = _counts()
    np.testing.assert_array_equal(
        _device(vol, gen, start, size, bs, mesh=mesh), want)
    assert _since(before) == {"volume_slabs_in": 0, "volume_slabs_out": 0,
                              "volume_pageable": 1}
    before = _counts()
    predict_volume(vol, gen, start, size, MS_X, MS_Y, mode="slab",
                   device="cpu")
    assert _since(before) == {"volume_slabs_in": 0, "volume_slabs_out": 0,
                              "volume_pageable": 1}
    before = _counts()
    np.testing.assert_array_equal(
        predict_volume(vol, gen, start, size, MS_X, MS_Y, mode="stream",
                       batch_size=bs, device="cpu"), want)
    assert _since(before) == dict.fromkeys(COUNTS, 0)


def test_fresh_result_and_reused_slots(gen, vol, monkeypatch):
    """Each call returns a fresh array it owns; the staging's slots are
    made on the first call, held at 2 * SLOTS slots of SLOT_BYTES, and
    reused by the next."""
    monkeypatch.setattr(device_stitch, "_STAGING", {})
    start, size, bs = CASES["unaligned"]
    first = _device(vol, gen, start, size, bs)
    staging = device_stitch._staging(torch.device("cpu"))
    ptrs = [s.data_ptr() for s in staging.slots]
    assert len(ptrs) == 2 * device_stitch.SLOTS
    assert all(s.numel() == device_stitch.SLOT_BYTES for s in staging.slots)
    second = _device(vol, gen, start, size, bs)
    assert [s.data_ptr() for s in staging.slots] == ptrs
    np.testing.assert_array_equal(first, second)
    assert first.flags.owndata and second.flags.owndata
    assert first.flags.writeable and not np.shares_memory(first, second)
    assert device_stitch.pinned_staging_bytes() == 0  # nothing pinned here
