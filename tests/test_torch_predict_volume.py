"""The port's large-volume inference (``predict_volume`` and its modes:
device, slab, stream, tiles, auto) against itself and against the JAX
package, on the CPU.

The modes that share the trimmed tile grid (device, tiles, stream, auto)
must agree bit for bit, and slab must equal one aligned whole-volume
generator pass; each port mode is held against the JAX package's same mode
within one grey level on at most 1e-3 of the voxels.  The weights are the
JAX ``UNetGenerator(wf=32)``'s from ``PRNGKey(0)``, each kernel scaled to
std 1/sqrt(fan-in) so that the outputs spread over the uint8 range (at the
N(0, 0.02) init every voxel would round to the same level), converted with
``models/convert.py``.  Requests stay at 36-72 voxels a side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.infer import choose_mode as jchoose_mode
from transfer_em_tpu.infer import predict_volume as jpredict_volume
from transfer_em_tpu.infer.stream import plan_chunks as jplan_chunks
from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu_torch.infer import (choose_mode, device_predict_tiled,
                                         predict_volume)
from transfer_em_tpu_torch.infer.slab import _next_valid, slab_predict
from transfer_em_tpu_torch.infer.stream import plan_chunks
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.convert import params_from_jax
from transfer_em_tpu_torch.native import gather_box
from transfer_em_tpu_torch.ops.normalize import (postprocess_to_u8,
                                                 preprocess_u8)

torch.set_num_threads(1)

MS_X, MS_Y = (0.1, 0.9), (0.05, 1.1)
OD, B_EFF, TILE = 36, 19, 74  # effective tile plan of (40, 17)


@pytest.fixture(scope="module")
def jax_model():
    jgen = JaxUNet(wf=32)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 74, 74, 74, 1)))
    params = jax.tree_util.tree_map(
        lambda w: np.asarray(w) * (np.prod(w.shape[:-1]) ** -0.5 / 0.02),
        params)
    return jgen, params


@pytest.fixture(scope="module")
def gen(jax_model):
    g = UNetGenerator(wf=32)
    g.load_state_dict(params_from_jax(jax_model[1]))
    return g.eval()


@pytest.fixture(scope="module")
def vol():
    return np.random.default_rng(5).integers(0, 255, (120, 120, 120),
                                             dtype=np.uint8)


def _port(vol, gen, start, size, mode, **kw):
    kw.setdefault("batch_size", 3)
    return predict_volume(vol, gen, start, size, MS_X, MS_Y, mode=mode,
                          device="cpu", **kw)


def _assert_close_u8(got, want):
    """Within one level on at most 1e-3 of the voxels (float32 sums in
    another order may cross a rounding boundary)."""
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


# (start xyz, size xyz, batch): interior; the second z tile starting past
# the volume's end (its read lies wholly more than a tile past the edge);
# reads before the origin; a single tile; 4 tiles in batches of 3 (two
# padding tiles); sizes that are no multiple of the 36 output tile.
CASES = {
    "interior": ((40, 40, 40), (72, 36, 36), 3),
    "far_past_edge": ((100, 100, 110), (36, 36, 72), 2),
    "before_origin": ((-50, 10, 60), (72, 36, 36), 2),
    "single_tile": ((40, 40, 40), (36, 36, 36), 8),
    "ragged_batch": ((20, 30, 40), (72, 72, 36), 3),
    "unaligned": ((30, 40, 20), (50, 40, 64), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_grid_modes_bit_equal(vol, gen, case):
    """device == tiles == stream, at a one-tile budget (a multi-chunk grid
    for every request of more than one tile) and a two-tile one."""
    start, size, bs = CASES[case]
    want = _port(vol, gen, start, size, "device", batch_size=bs)
    assert want.shape == size[::-1] and want.std() > 2
    np.testing.assert_array_equal(
        _port(vol, gen, start, size, "tiles", batch_size=bs), want)
    for budget in (TILE ** 3, (2 * OD + 2 * B_EFF) * TILE ** 2):
        if budget == TILE ** 3 and np.prod(size) > OD ** 3:
            assert plan_chunks(start, size, 40, 17, budget).num_chunks > 1
        got = _port(vol, gen, start, size, "stream", batch_size=bs,
                    max_block_bytes=budget)
        np.testing.assert_array_equal(got, want)


def test_auto_equals_device(vol, gen):
    start, size, bs = CASES["unaligned"]
    np.testing.assert_array_equal(
        _port(vol, gen, start, size, "auto", batch_size=bs),
        _port(vol, gen, start, size, "device", batch_size=bs))


@pytest.mark.parametrize("mode", ["device", "tiles", "stream", "slab"])
def test_modes_match_jax(vol, gen, jax_model, mode):
    jgen, params = jax_model
    start, size, bs = CASES["unaligned"]
    kw = {"max_block_bytes": TILE ** 3} if mode == "stream" else {}
    want = np.asarray(jpredict_volume(vol, jgen.apply, params, start, size,
                                      MS_X, MS_Y, mode=mode, batch_size=bs,
                                      **kw))
    got = _port(vol, gen, start, size, mode, batch_size=bs, **kw)
    _assert_close_u8(got, want)


def test_device_far_past_edge_matches_jax(vol, gen, jax_model):
    jgen, params = jax_model
    start, size, bs = CASES["far_past_edge"]
    want = np.asarray(jpredict_volume(vol, jgen.apply, params, start, size,
                                      MS_X, MS_Y, mode="device",
                                      batch_size=bs))
    _assert_close_u8(_port(vol, gen, start, size, "device", batch_size=bs),
                     want)


def test_slab_matches_aligned_generator_passes(vol, gen):
    """Slab == the generator over each slab's aligned, haloed input box, at
    a non-cubic y/x extent (74 x 90 inputs), two slabs deep (80 z = 2 x
    40), the box reading past the volume's y edge (zeros).  Compared slab
    by slab, at the slab's own input shape: on the CPU a conv's summation
    order depends on the extents, so one 114-deep pass would differ in
    the last bit."""
    start, size = (30, 90, 20), (56, 40, 80)
    got = slab_predict(vol, gen, start, size, MS_X, MS_Y, device="cpu")
    assert got.shape == (80, 40, 56)
    b = 17
    y_in, x_in = _next_valid(40 + 2 * b), _next_valid(56 + 2 * b)
    assert (y_in, x_in) == (74, 90)
    for i in range(2):
        box = gather_box(vol, (30 - b, 90 - b, 20 - b + 40 * i),
                         (x_in, y_in, 74))
        with torch.inference_mode():
            y = gen(preprocess_u8(torch.from_numpy(box)[None], MS_X))
            want = postprocess_to_u8(y, MS_Y)[0].numpy()
        np.testing.assert_array_equal(got[40 * i:40 * (i + 1)],
                                      want[:, :40, :56])


@pytest.mark.parametrize("start,size,budget", [
    ((0, 0, 0), (100, 40, 80), (2 * OD + 2 * B_EFF) * TILE ** 2),
    ((30, 40, 20), (76, 40, 72), TILE ** 3),
    ((20, 20, 20), (360, 360, 360), 160 << 20),
    ((20, 20, 20), (360, 360, 360), 120 * 398 ** 2),
    ((-5, 7, 3), (1000, 500, 2000), 1 << 30),
    ((0, 0, 0), (64, 0, 64), 1 << 20),
])
def test_plan_chunks_matches_jax(start, size, budget):
    got = plan_chunks(start, size, 40, 17, budget)
    want = jplan_chunks(start, size, 40, 17, budget)
    for field in ("start", "size", "outdimsize", "buffer", "chunk", "grid",
                  "block"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.num_chunks == want.num_chunks
    assert [got.chunk_xyz(k) for k in range(got.num_chunks)] == [
        want.chunk_xyz(k) for k in range(want.num_chunks)]


def test_plan_chunks_raises_as_jax():
    for plan in (plan_chunks, jplan_chunks):
        with pytest.raises(ValueError, match="cannot hold even one"):
            plan((0, 0, 0), (36, 36, 36), 40, 17, TILE ** 3 - 1)


@pytest.mark.parametrize("mode", ["device", "tiles", "stream", "slab"])
def test_zero_extent_request(vol, gen, mode):
    got = _port(vol, gen, (0, 0, 0), (64, 0, 64), mode)
    assert got.shape == (64, 0, 64) and got.dtype == np.uint8


@pytest.mark.parametrize("mode", ["tiles", "stream"])
def test_out_must_be_uint8_c_contiguous(vol, gen, mode):
    start, size, _ = CASES["single_tile"]
    for bad in (np.zeros((36, 36, 36), np.float32),
                np.zeros((36, 36, 36), np.uint8, order="F")):
        with pytest.raises(ValueError, match="C-contiguous uint8"):
            _port(vol, gen, start, size, mode, out=bad)


@pytest.mark.parametrize("mode", ["tiles", "stream", "auto"])
def test_out_memmap(vol, gen, mode, tmp_path):
    """out= (an np.memmap) is filled and returned by tiles and stream, and
    resolves auto to stream."""
    start, size, bs = CASES["ragged_batch"]
    want = _port(vol, gen, start, size, "device", batch_size=bs)
    out = np.memmap(tmp_path / "out.u8", np.uint8, "w+", shape=want.shape)
    got = _port(vol, gen, start, size, mode, batch_size=bs, out=out,
                max_block_bytes=TILE ** 3)
    assert got is out
    np.testing.assert_array_equal(np.asarray(out), want)


@pytest.mark.parametrize("mode", ["device", "slab"])
def test_out_refused_by_device_modes(vol, gen, mode):
    with pytest.raises(ValueError, match="out="):
        _port(vol, gen, (40, 40, 40), (36, 36, 36), mode,
              out=np.zeros((36, 36, 36), np.uint8))


@pytest.mark.parametrize("mode", ["device", "tiles", "stream", "slab"])
def test_ndarray_meanstd(vol, gen, mode):
    start, size, bs = CASES["interior"]
    want = _port(vol, gen, start, size, mode, batch_size=bs)
    got = predict_volume(vol, gen, start, size, np.array(MS_X),
                         np.array(MS_Y), mode=mode, batch_size=bs,
                         device="cpu")
    np.testing.assert_array_equal(got, want)


def test_choose_mode_matches_jax():
    cases = [((160, 160, 160), (36, 36, 36), {}),
             ((2048, 2048, 3072), (2048, 2048, 3072), {}),
             ((2048, 2048, 3072), (64, 64, 64), {"headroom": 2.0})]
    answers = []
    for shape, size, kw in cases:
        got = choose_mode(shape, size, hbm_bytes=16 << 30, **kw)
        assert got == jchoose_mode(shape, size, hbm_bytes=16 << 30, **kw)
        answers.append(got)
    assert answers == ["device", "stream", "device"]
    # device="cpu" reads no card: the 16 GB default
    assert choose_mode((2048, 2048, 3072), (2048, 2048, 3072),
                       device="cpu") == "stream"


def test_auto_resolution(vol, gen):
    start, size, bs = CASES["interior"]
    want = _port(vol, gen, start, size, "device", batch_size=bs)
    got = _port(vol, gen, start, size, "auto", batch_size=bs,
                as_numpy=False)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="contradictory"):
        _port(vol, gen, start, size, "auto", as_numpy=False,
              out=np.zeros(want.shape, np.uint8))


@pytest.mark.parametrize("mode", ["device", "slab"])
def test_tensor_source_as_tensor(vol, gen, mode):
    """A uint8 tensor source (used in place) and as_numpy=False give a
    uint8 tensor equal to the numpy path's result."""
    start, size, bs = CASES["unaligned"]
    want = _port(vol, gen, start, size, mode, batch_size=bs)
    got = _port(torch.from_numpy(vol), gen, start, size, mode,
                batch_size=bs, as_numpy=False)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["tiles", "stream"])
def test_tensor_source_host_modes(vol, gen, mode):
    start, size, bs = CASES["interior"]
    np.testing.assert_array_equal(
        _port(torch.from_numpy(vol), gen, start, size, mode, batch_size=bs),
        _port(vol, gen, start, size, "device", batch_size=bs))
    with pytest.raises(ValueError, match="as_numpy=False"):
        _port(vol, gen, start, size, mode, as_numpy=False)


def test_mesh_and_unknown_mode(vol, gen):
    """mesh= needs a 'data' axis in device and stream modes and is refused
    by the others (tests/test_torch_parallel.py runs the meshed modes)."""
    from transfer_em_tpu_torch.parallel.mesh import Mesh
    args = ((40, 40, 40), (36, 36, 36))
    space_only = Mesh(np.array([torch.device("cpu")] * 2, dtype=object),
                      ("space",))
    for mode in ("device", "stream"):
        with pytest.raises(ValueError, match="'data' axis"):
            _port(vol, gen, *args, mode, mesh=space_only)
    for mode in ("slab", "tiles"):
        with pytest.raises(ValueError, match="mode='device' or 'stream'"):
            _port(vol, gen, *args, mode, mesh=object())
    with pytest.raises(ValueError, match="unknown mode"):
        _port(vol, gen, *args, "nope")


def test_prepadded_block_must_cover_every_tile(gen):
    """prepadded=True skips the zero pad, so a block that does not hold
    every tile's halo is refused before any compute."""
    block = np.zeros((73, 74, 74), np.uint8)
    with pytest.raises(ValueError, match="prepadded"):
        device_predict_tiled(block, gen, (19, 19, 19), (36, 36, 36), 40, 17,
                             MS_X, MS_Y, prepadded=True, device="cpu")
    got = device_predict_tiled(np.zeros((74, 74, 74), np.uint8), gen,
                               (19, 19, 19), (36, 36, 36), 40, 17, MS_X,
                               MS_Y, prepadded=True, device="cpu")
    assert got.shape == (36, 36, 36)


def test_stream_chunk_batch_rule(vol, gen, monkeypatch):
    """Chunks of one tile under a batch of 8: on the CPU every chunk runs
    at the whole request's batch (8 tiles -> 8) and the stream equals
    device mode bit for bit; on CUDA a chunk's batch is fitted to the chunk
    (tile_batch of its own tile count, the JAX package's min)."""
    from transfer_em_tpu_torch.infer import stream

    start, size = (30, 40, 20), (72, 72, 36)  # 2 x 2 x 1 tiles
    plan = plan_chunks(start, size, 40, 17, TILE ** 3)
    assert plan.num_chunks == 4 and plan.chunk == (OD,) * 3
    assert stream.chunk_batch_tiles(plan, 1, torch.device("cpu")) == 4
    assert stream.chunk_batch_tiles(plan, 1, torch.device("cuda")) == 1
    batches = []
    orig = stream.stitch_plan

    def recording(block, g, tiles, batch, *a, **kw):
        batches.append((tiles.num_tiles, batch))
        return orig(block, g, tiles, batch, *a, **kw)

    monkeypatch.setattr(stream, "stitch_plan", recording)
    got = _port(vol, gen, start, size, "stream", batch_size=8,
                max_block_bytes=TILE ** 3)
    assert batches == [(1, 4)] * 4
    np.testing.assert_array_equal(
        got, _port(vol, gen, start, size, "device", batch_size=8))
