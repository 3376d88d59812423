"""The port's data pipelines and sources against the JAX package, on the
CPU, and the pipelines' semantics (as tests/test_data.py holds the JAX
package's).  Inputs come from numpy seeds; each test states its
tolerance."""

import threading
import time

import numpy as np
import pytest
import torch

from transfer_em_tpu.data import create_dataset_from_generator as jax_gen_ds
from transfer_em_tpu.data import create_dataset_from_tensors as jax_tensor_ds
from transfer_em_tpu.data.sources import corner_stream as jax_corner_stream
from transfer_em_tpu_torch.data import (Dataset,
                                        create_dataset_from_generator,
                                        create_dataset_from_tensors,
                                        zip_datasets)
from transfer_em_tpu_torch.data.sources import (_parallel_fetch,
                                                corner_stream,
                                                host_sharded_seed)
from transfer_em_tpu_torch.ops.normalize import scale_tensor
from transfer_em_tpu_torch.ops.warp import make_warp_map

torch.set_num_threads(1)


def _cubes(seed, n, side=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (side,) * 3, dtype=np.uint8)
            for _ in range(n)]


def _restandardize(x, frm, to):
    return ((x * frm[1] + frm[0]) - to[0]) / to[1]


CASES = {
    "no_adjust": dict(global_adjust=False),
    "meanstd_given": dict(meanstd=(0.05, 0.55)),
    "meanstd_computed": dict(),
    "padding": dict(padding=((2, 3), (1, 1), (0, 2))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_dataset_matches_jax(case):
    """enable_augmentation=False, no custom map, randomize=False: the same
    number of batches (5 elements, batch 2, drop remainder) and the same
    values as the JAX pipeline to 1e-6.  Where each package computes its
    own meanstd, they agree to 5e-5 relative (JAX's float32 jnp.mean sums
    in order, see test_torch_warp_augment.py), and the values are compared
    after restandardizing JAX's with the port's meanstd."""
    kw = CASES[case]
    cubes = _cubes(1, 5)
    jds, jms = jax_tensor_ds(cubes, batch_size=2, enable_augmentation=False,
                             **kw)
    ds, ms = create_dataset_from_tensors(cubes, batch_size=2,
                                         enable_augmentation=False,
                                         device="cpu", **kw)
    want = [np.asarray(b) for b in jds]
    got = [b.numpy() for b in ds]
    assert len(got) == len(want) == 2
    if ms is None:
        assert jms is None
    else:
        np.testing.assert_allclose(ms, jms, rtol=5e-5)
        want = [_restandardize(w, jms, ms) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_generator_dataset_matches_jax():
    """The streaming path over the same element stream, meanstd computed by
    its eager pass: the epoch bound (9 elements, batch 4 -> 2 batches),
    meanstd to 5e-5 relative, values to 1e-6 after restandardizing."""
    cubes = _cubes(2, 12)
    kw = dict(batch_size=4, epoch_size=9, fetch_threads=2)
    jds, jms = jax_gen_ds(lambda: iter(cubes), **kw)
    ds, ms = create_dataset_from_generator(lambda: iter(cubes), device="cpu",
                                           **kw)
    np.testing.assert_allclose(ms, jms, rtol=5e-5)
    want = [_restandardize(np.asarray(b), jms, ms) for b in jds]
    got = [b.numpy() for b in ds]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


CORNER_CASES = {
    "bbox": dict(bbox=((0, 5, 10), (100, 60, 300)), seed=3),
    "array_once": dict(bbox=None, seed=None,
                       array=[(1, 2, 3), (4, 5, 6), (7, 8, 9)]),
    "sample_array": dict(bbox=None, seed=4, sample_array=True,
                         array=[((0, 0, 0), (10, 10, 10)),
                                ((50, 60, 70), (90, 99, 120))]),
    "stratified": dict(bbox=None, seed=5, sample_array=True,
                       sample_class=True,
                       array=[[((0, 0, 0), (10, 10, 10))],
                              [((100, 100, 100), (110, 120, 130)),
                               ((200, 0, 0), (300, 5, 9))]]),
}


@pytest.mark.parametrize("case", list(CORNER_CASES))
def test_corner_stream_identical_to_jax(case):
    """The same corners as the JAX package's for the same seed: exact."""
    kw = dict(CORNER_CASES[case])
    args = (kw.pop("bbox"), 74, kw.pop("seed"))
    take = lambda it: [c for _, c in zip(range(60), it)]
    got = take(corner_stream(*args, **kw))
    assert got == take(jax_corner_stream(*args, **kw))
    assert len(got) == (3 if case == "array_once" else 60)


def test_host_sharded_seed_uses_the_process_rank():
    """seed * 1_000_003 + rank: rank 0 outside a process group, and the
    group's rank inside one (a gloo group of one process here)."""
    import torch.distributed as dist

    assert host_sharded_seed(None) is None
    assert host_sharded_seed(7) == 7 * 1_000_003
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                            world_size=1, rank=0)
    try:
        assert host_sharded_seed(7) == 7 * 1_000_003 + dist.get_rank()
    finally:
        dist.destroy_process_group()


# -- pipeline semantics -------------------------------------------------------

def test_warp_fixed_across_epochs_and_under_shuffling():
    """Post-warp cache semantics (reference datasets.py:47-60): element i's
    warp depends on (seed, i) alone, so without shuffling two epochs are
    equal, and with shuffling each epoch holds the same warped elements in
    another order (batch 1, 6 elements)."""
    cubes = _cubes(3, 6, 20)
    kw = dict(custom_map=make_warp_map(2), global_adjust=False,
              enable_augmentation=False, device="cpu")
    ds, _ = create_dataset_from_tensors(cubes, batch_size=3, **kw)
    e1, e2 = [b for b in ds], [b for b in ds]
    assert all(torch.equal(a, b) for a, b in zip(e1, e2))

    ds, _ = create_dataset_from_tensors(cubes, batch_size=1, randomize=True,
                                        seed=9, **kw)
    e1 = [b[0] for b in ds]
    e2 = [b[0] for b in ds]
    key = lambda t: t.numpy().tobytes()
    assert [key(t) for t in e1] != [key(t) for t in e2]
    assert sorted(map(key, e1)) == sorted(map(key, e2))
    warped = {key(make_warp_map(2)(scale_tensor(torch.from_numpy(c)), k))
              for c, k in zip(cubes, _element_keys(cubes, 9))}
    assert set(map(key, e1)) == warped


def _element_keys(cubes, seed):
    """The keys the pipeline passes to the custom map, recorded."""
    seen = {}

    def record(el, key):
        seen.setdefault(len(seen), key)
        return el

    create_dataset_from_tensors(cubes, custom_map=record, seed=seed,
                                enable_augmentation=False, device="cpu")
    return [seen[i] for i in range(len(cubes))]


def test_meanstd_uses_the_training_draws():
    """The meanstd pass maps each element with the key training uses for
    it, so the statistics describe the elements trained on: a key-sensitive
    map, the recorded keys equal, and the batch equals (mapped - mean) /
    std of its own statistics (1e-6)."""
    cubes = _cubes(4, 6)
    stats_keys, train_keys = [], []

    def keyed_map(el, key):
        (train_keys if len(stats_keys) == len(cubes) else stats_keys).append(
            key)
        return el + (key % 1000) / 500.0

    ds, ms = create_dataset_from_tensors(cubes, batch_size=6,
                                         custom_map=keyed_map,
                                         enable_augmentation=False, seed=3,
                                         device="cpu")
    batch = next(iter(ds))
    assert train_keys == stats_keys and len(set(stats_keys)) == 6
    mapped = torch.stack([scale_tensor(torch.from_numpy(c)) + (k % 1000) / 500
                          for c, k in zip(cubes, stats_keys)])
    torch.testing.assert_close(batch, (mapped - ms[0]) / ms[1], rtol=0,
                               atol=1e-6)
    want = [float(m.mean()) for m in mapped]
    np.testing.assert_allclose(ms[0], np.mean(want), rtol=1e-6)


def test_streams_are_separate():
    """The epochs' streams differ from the elements': augmentation re-rolls
    each epoch, shuffling reorders, and a different seed changes both."""
    cubes = _cubes(5, 4, 10)
    ds, _ = create_dataset_from_tensors(cubes, batch_size=4,
                                        global_adjust=False, device="cpu")
    a, b = next(iter(ds)), next(iter(ds))
    assert not torch.equal(a, b)
    ds2, _ = create_dataset_from_tensors(cubes, batch_size=4,
                                         global_adjust=False, device="cpu")
    assert torch.equal(next(iter(ds2)), a)  # same seed, same first epoch
    ds3, _ = create_dataset_from_tensors(cubes, batch_size=4, seed=1,
                                         global_adjust=False, device="cpu")
    assert not torch.equal(next(iter(ds3)), a)


def test_reflect_padding_and_drop_remainder():
    """np.pad REFLECT on the host; 7 elements at batch 3 give 2 batches."""
    cubes = _cubes(6, 7, 8)
    pad = ((1, 2), (0, 3), (2, 2))
    ds, _ = create_dataset_from_tensors(cubes, batch_size=3, padding=pad,
                                        global_adjust=False,
                                        enable_augmentation=False,
                                        device="cpu")
    batches = list(ds)
    assert len(batches) == 2 and batches[0].shape == (3, 11, 11, 12, 1)
    want = np.pad(cubes[0], pad, mode="reflect").astype(np.float32) / 127.5
    np.testing.assert_allclose(batches[0][0, ..., 0].numpy(), want - 1,
                               atol=1e-6)


def test_zip_and_device_placement():
    """zip_datasets pairs batches; the datasets put them on the device
    they were given."""
    a, _ = create_dataset_from_tensors(_cubes(7, 4, 8), batch_size=2,
                                       device="cpu")
    b, _ = create_dataset_from_tensors(_cubes(8, 4, 8), batch_size=2,
                                       device=torch.device("cpu"))
    pairs = list(zip_datasets(a, b))
    assert len(pairs) == 2
    assert all(x.device.type == "cpu" and x.shape == (2, 8, 8, 8, 1)
               for p in pairs for x in p)


def test_generator_dataset_epoch_bound():
    """An infinite source is cut at epoch_size per epoch; the source is
    called again for each epoch."""
    calls = []

    def source():
        calls.append(1)

        def it():
            rng = np.random.default_rng(len(calls))
            while True:
                yield rng.integers(0, 255, (6, 6, 6), dtype=np.uint8)
        return it()

    ds, _ = create_dataset_from_generator(source, batch_size=4, epoch_size=8,
                                          meanstd=(0.0, 1.0),
                                          fetch_threads=0, device="cpu")
    assert len(list(ds)) == 2 and len(list(ds)) == 2
    assert len(calls) == 2


def test_threaded_and_parallel_fetch_leak_no_thread():
    """Abandoning an epoch of a streaming dataset (zip with a shorter one)
    stops its pull thread; closing _parallel_fetch cancels its queued
    fetches instead of running them."""
    def source():
        def it():
            i = 0
            while True:
                yield np.full((4, 4, 4), i % 255, np.uint8)
                i += 1
        return it()

    ds, _ = create_dataset_from_generator(source, batch_size=1,
                                          epoch_size=1000, meanstd=(0.0, 1.0),
                                          fetch_threads=2, device="cpu")
    before = threading.active_count()
    for _ in range(5):
        it = iter(ds)
        next(it)
        del it
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before

    started = []
    lock = threading.Lock()

    def slow_fetch(corner):
        with lock:
            started.append(corner)
        time.sleep(0.05)
        return np.zeros((2, 2, 2), np.uint8)

    gen = _parallel_fetch(iter([(i, 0, 0) for i in range(200)]), slow_fetch,
                          num_threads=4)
    next(gen)
    t0 = time.perf_counter()
    gen.close()
    assert time.perf_counter() - t0 < 0.5
    time.sleep(0.2)
    assert len(started) <= 1 + 2 * 4


def test_source_errors_propagate():
    """A failing source raises in the consumer instead of ending the epoch
    early."""
    def bad_source():
        def it():
            yield np.zeros((4, 4, 4), np.uint8)
            raise RuntimeError("fetch exploded")
        return it()

    ds, _ = create_dataset_from_generator(bad_source, batch_size=1,
                                          epoch_size=4, meanstd=(0.0, 1.0),
                                          fetch_threads=2, device="cpu")
    with pytest.raises(RuntimeError, match="fetch exploded"):
        list(ds)


def test_take_batches_pulls_exactly_n():
    produced = []

    def epoch():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    assert Dataset(epoch).take_batches(3) == [0, 1, 2]
    assert produced == [0, 1, 2]
    ds, _ = create_dataset_from_tensors(_cubes(9, 6, 6), batch_size=1,
                                        global_adjust=False, device="cpu")
    assert len(ds.take_batches(4)) == 4
