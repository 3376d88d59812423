"""Host data pipelines feeding a transform on the device (counterpart of
transfer_em_tpu/data/pipeline.py, reference transfer_em/datasets/
datasets.py):

* ``create_dataset_from_tensors`` (datasets.py:14-67): in memory; reflect
  pad -> scale -> custom map -> population standardize -> cache -> shuffle
  -> augment -> batch (drop_remainder) -> prefetch.
* ``create_dataset_from_generator`` (datasets.py:69-119): streaming; the
  same without cache and shuffle, bounded by ``epoch_size``.

The host moves uint8 only.  Each batch goes from a pinned host buffer to
the device with ``non_blocking=True``, and the transform runs there in the
JAX package's order (pipeline.py:104-129): scale, custom map, standardize,
augment.  Batches are (B, *spatial, 1) float32 on ``device``.

Randomness comes from integer keys, pure functions of ``seed`` and a path
(``rng.derive_seed``), in separate streams as the JAX package's fold-ins
777 / 5000 / 911: the statistics pass of a streaming dataset (777, i), the
elements (5000, i), the epochs (911, e, ...).  A custom map is called per
element as ``custom_map(element, key)`` with an integer key; in memory,
element i's key depends on (seed, i) alone, so its draw is the same in
every epoch, under ``randomize=True`` and in the meanstd pass: the
reference caches the mapped elements (datasets.py:47-60).  The statistics
are the reference's mean of means and mean of variances
(datasets.py:173-190).
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..device import resolve_device
from ..ops.augment import batch_augment
from ..ops.normalize import get_meanstd, scale_tensor, standardize_population
from ..rng import derive_seed
from ..telemetry import span

BATCH_SIZE = 64     # reference datasets.py:10
EPOCH_SIZE = 4096   # reference datasets.py:11
BUFFER_SIZE = 4096  # reference datasets.py:12

# the streams' roots (the JAX package's fold-in constants)
_STATS, _ELEMENTS, _EPOCHS = 777, 5000, 911

MeanStd = Tuple[float, float]


def _reflect_pad_np(x: np.ndarray, padding) -> np.ndarray:
    """Host-side REFLECT pad (reference datasets.py:41-43 tf.pad REFLECT)."""
    return np.pad(x, padding, mode="reflect")


class _DevicePrefetcher:
    """Iterate host (meta, uint8 batch) items, keeping up to ``depth``
    copies to ``device`` in flight.

    On CUDA each batch is copied into pinned memory and sent with
    ``non_blocking=True``; the pinned buffer is held, with an event recorded
    after its copy, until the event has completed (the caching host
    allocator also defers reusing it until then).  On the CPU the batch is
    wrapped without a copy.  Its spans, ``data.gather`` (the host batch:
    the in-memory gather, or the stream's queue) and on CUDA ``data.pin``
    and ``data.h2d``, close before an item is handed out."""

    def __init__(self, it: Iterator, device: torch.device, depth: int = 2):
        self._it = it
        self._device = device
        self._depth = depth
        self._in_flight: deque = deque()  # (event, pinned buffer)

    def _transfer(self, item):
        meta, host = item
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self._device.type != "cuda":
            return meta, t
        while self._in_flight and self._in_flight[0][0].query():
            self._in_flight.popleft()
        with span("data.pin"):
            pinned = t.pin_memory()
        with span("data.h2d"):
            dev = pinned.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self._in_flight.append((event, pinned))
        return meta, dev

    def _pull(self, n: int) -> list:
        """The next ``n`` host items (fewer at the end), each sent."""
        with span("data.gather"):
            items = list(itertools.islice(self._it, n))
        return [self._transfer(x) for x in items]

    def __iter__(self):
        buf: List = self._pull(self._depth)
        while buf:
            nxt = buf.pop(0)
            buf.extend(self._pull(1))
            yield nxt


class Dataset:
    """Re-iterable batched dataset; each ``iter()`` is one epoch.

    Yields (B, *spatial, 1) float32 tensors on the dataset's device,
    scaled / standardized / augmented, with drop_remainder semantics."""

    def __init__(self, epoch_fn: Callable[[], Iterator[torch.Tensor]]):
        self._epoch_fn = epoch_fn

    def __iter__(self):
        return iter(self._epoch_fn())

    def take_batches(self, n: int) -> List[torch.Tensor]:
        """Exactly the first ``n`` batches of a new epoch (nothing is pulled
        beyond them)."""
        return list(itertools.islice(self, n))


def _spanned(batches: Iterable, transform: Callable,
             dev: torch.device) -> Iterator[torch.Tensor]:
    """``transform(i, meta, batch)`` of each (meta, uint8 batch) item of
    ``batches``, in order.  A ``data.batch`` span covers pulling an item
    (``data.gather``, ``data.pin``, ``data.h2d``) and its ``data.transform``
    and closes before the batch is handed out, so no span covers the
    consumer's work."""
    it = iter(batches)
    for bi in itertools.count():
        with span("data.batch"):
            item = next(it, None)
            if item is not None:
                with span("data.transform", dev):
                    x = transform(bi, *item)
        if item is None:
            return
        yield x


def _device_transform(custom_map, global_adjust, meanstd,
                      enable_augmentation) -> Callable:
    """The device map: uint8 batch -> float batch.  ``cm_keys`` are the
    custom map's integer keys, one per element; ``aug_key`` seeds the
    augmentation."""

    def tx(batch_u8: torch.Tensor, cm_keys: Optional[Sequence[int]],
           aug_key: int) -> torch.Tensor:
        x = scale_tensor(batch_u8)
        if custom_map is not None:
            x = torch.stack([custom_map(x[i], k)
                             for i, k in enumerate(cm_keys)])
        if global_adjust:
            x = standardize_population(x, meanstd)
        if enable_augmentation:
            x = batch_augment(x, aug_key)
        return x

    return tx


def _scaled_stream_for_stats(tensors_u8, custom_map, key_fn, device):
    """Scaled (and custom-mapped) elements for the meanstd pass; element i
    gets ``key_fn(i)`` (reference datasets.py:54-56)."""
    for i, t in enumerate(tensors_u8):
        x = scale_tensor(torch.from_numpy(np.ascontiguousarray(t)).to(device))
        if custom_map is not None:
            x = custom_map(x, key_fn(i))
        yield x


def create_dataset_from_tensors(
        tensors: Sequence[np.ndarray],
        custom_map: Optional[Callable] = None,
        batch_size: int = BATCH_SIZE,
        enable_augmentation: bool = True,
        global_adjust: bool = True,
        meanstd: Optional[MeanStd] = None,
        randomize: bool = False,
        padding=None,
        seed: int = 0,
        device="cuda",
) -> Tuple[Dataset, Optional[MeanStd]]:
    """In-memory dataset (reference ``create_dataset_from_tensors``,
    datasets.py:14-67).

    Args:
      tensors: 2D/3D uint8 arrays of one shape.
      custom_map: ``f(scaled_element, key) -> element`` applied after
        scaling (e.g. ``ops.warp.make_warp_map(seed)``).  Element i's key
        is a pure function of (seed, i): the same in every epoch and under
        ``randomize``, as the reference's post-map cache.
      randomize: shuffle the element order each epoch.
      padding: np.pad-style reflect padding.
      device: where batches are made (default ``cuda``; raises where it is
        absent).
    Returns:
      (Dataset, meanstd)
    """
    dev = resolve_device(device)
    tensors = [np.asarray(t, np.uint8) for t in tensors]
    if padding is not None:
        tensors = [_reflect_pad_np(t, padding) for t in tensors]
    stacked = np.stack(tensors)  # the cache: all in host memory
    n = len(tensors)
    element_keys = [derive_seed(seed, _ELEMENTS, i) for i in range(n)]

    if global_adjust and meanstd is None:
        meanstd = get_meanstd(_scaled_stream_for_stats(
            tensors, custom_map, element_keys.__getitem__, dev))

    tx = _device_transform(custom_map, global_adjust, meanstd,
                           enable_augmentation)
    epoch_counter = [0]

    def epoch() -> Iterator[torch.Tensor]:
        e = epoch_counter[0]
        epoch_counter[0] += 1
        order = np.arange(n)
        if randomize:
            order = np.random.default_rng(
                derive_seed(seed, _EPOCHS, e, 0)).permutation(n)

        def host_batches():
            # drop remainder
            for s in range(0, n - batch_size + 1, batch_size):
                idx = order[s:s + batch_size]
                yield idx, stacked[idx]

        def transform(bi, idx, hb):
            keys = [element_keys[i] for i in idx]
            return tx(hb, keys, derive_seed(seed, _EPOCHS, e, 1000 + bi))

        return _spanned(_DevicePrefetcher(host_batches(), dev), transform,
                        dev)

    return Dataset(epoch), meanstd


def create_dataset_from_generator(
        sample_iter_fn: Callable[[], Iterator[np.ndarray]],
        shape=None,
        custom_map: Optional[Callable] = None,
        batch_size: int = BATCH_SIZE,
        epoch_size: int = EPOCH_SIZE,
        global_adjust: bool = True,
        meanstd: Optional[MeanStd] = None,
        padding=None,
        enable_augmentation: bool = False,
        seed: int = 0,
        fetch_threads: int = 8,
        device="cuda",
) -> Tuple[Dataset, Optional[MeanStd]]:
    """Streaming dataset (reference ``create_dataset_from_generator``,
    datasets.py:69-119).

    Args:
      sample_iter_fn: zero-arg callable returning a (possibly infinite)
        iterator of uint8 arrays, e.g. the volume sources in
        ``data.sources``; called once per epoch.
      shape: deprecated and ignored (as in the reference).
      epoch_size: elements per epoch (bounds the stream).
      fetch_threads: > 0 pulls the source on one background thread through
        a bounded queue of depth ``max(2 * fetch_threads, 8)`` (0 pulls
        inline).  The volume sources fan their fetches out themselves
        (``num_threads``).
      device: where batches are made (default ``cuda``).
    Returns:
      (Dataset, meanstd).  Without ``meanstd`` a full eager epoch computes
      it; its draws necessarily differ from training's, since a stream's
      elements are one-shot (as the reference's get_meanstd pass).
    """
    del shape
    dev = resolve_device(device)

    def bounded_elements() -> Iterator[np.ndarray]:
        for el in itertools.islice(sample_iter_fn(), epoch_size):
            el = np.asarray(el, np.uint8)
            if padding is not None:
                el = _reflect_pad_np(el, padding)
            yield el

    if global_adjust and meanstd is None:
        meanstd = get_meanstd(_scaled_stream_for_stats(
            bounded_elements(), custom_map,
            lambda i: derive_seed(seed, _STATS, i), dev))

    tx = _device_transform(custom_map, global_adjust, meanstd,
                           enable_augmentation)
    epoch_counter = [0]

    def epoch() -> Iterator[torch.Tensor]:
        e = epoch_counter[0]
        epoch_counter[0] += 1

        def host_batches():
            batch = []
            for el in _threaded(bounded_elements, fetch_threads):
                batch.append(el)
                if len(batch) == batch_size:
                    yield None, np.stack(batch)
                    batch = []
            # drop remainder

        def transform(bi, _, hb):
            k = (seed, _EPOCHS, e, 1000 + bi)
            keys = [derive_seed(*k, 1, j) for j in range(hb.shape[0])]
            return tx(hb, keys, derive_seed(*k, 2))

        return _spanned(_DevicePrefetcher(host_batches(), dev), transform,
                        dev)

    return Dataset(epoch), meanstd


def _threaded(elements_fn: Callable[[], Iterator[np.ndarray]],
              num_threads: int) -> Iterator[np.ndarray]:
    """Run the element iterator on a background thread with a bounded queue.

    The thread stops once the consumer abandons the iterator (e.g. zip()
    with a shorter dataset), and a source's exception is raised in the
    consumer."""
    if num_threads <= 0:
        yield from elements_fn()
        return
    q: "queue.Queue" = queue.Queue(maxsize=max(2 * num_threads, 8))
    _SENTINEL = object()
    err: list = []
    stop = threading.Event()  # set when the consumer abandons the iterator

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for el in elements_fn():
                if not _put(el):
                    return  # consumer gone; drop the source iterator too
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            el = q.get()
            if el is _SENTINEL:
                if err:
                    raise err[0]
                break
            yield el
    finally:
        stop.set()  # reached on GeneratorExit when abandoned mid-epoch


def zip_datasets(a: Iterable, b: Iterable) -> Iterator:
    """tf.data.Dataset.zip equivalent (reference cgan.py:260)."""
    return zip(a, b)
