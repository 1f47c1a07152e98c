"""Host-side data pipeline: pickle readers, shuffling batchers, and a
double-buffered background prefetcher feeding sharded device arrays.

Replaces the reference's ``tf.data`` pipelines with a TPU-idiomatic feed:

- Hippocampus: one pickle ``(x_train, y_train, x_test, y_test)``; the last
  test sample is dropped (`Hippocampus.py:479-484`); shuffle/batch/prefetch
  (`Hippocampus.py:493-510`).
- BraTS: many 20-sample pickles ``{training,validation,test}_batch_*.pkl``
  with images stored NCHW -> transposed to NHWC and cast to f32
  (`Brats_functions.py:549-562`); file-order shuffle + interleave + unbatch +
  sample shuffle(1000) + batch + prefetch (`Brats.py:538-555`). Here: a
  background-thread streaming reader with a bounded queue (the tf.data
  AUTOTUNE analog). For the canonical .npy shard format the native C++
  streamer (supernet_tpu_torch/native + data/shards.py) replaces this path.

Device placement is the caller's job (the train step moves each batch to
the parameters' device): batches yielded here are contiguous NumPy arrays.

The port's own copy of ``supernet_tpu/data/loaders.py``, NumPy only.
"""

from __future__ import annotations

import glob
import pickle
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np


def center_crop_np(x: np.ndarray, size: int) -> np.ndarray:
    """Center-crop spatial dims of [B, H, W, ...] to ``size``
    (`Hippocampus_functions.py:336-351`)."""
    start = (x.shape[1] - size) // 2
    end = x.shape[1] - start
    return x[:, start:end, start:end, ...]


def expand_to_shape(x: np.ndarray, size: int, fill: float = 0.0) -> np.ndarray:
    """Center-pad spatial dims of [B, H, W, ...] up to ``size``
    (``expand_to_shape``, `Hippocampus_functions.py:323-334` — the inverse of
    ``center_crop_np``; e.g. re-embedding a 54x54 prediction in the 64x64
    input frame for overlays)."""
    lo = (size - x.shape[1]) // 2
    hi = size - x.shape[1] - lo
    pad = [(0, 0), (lo, hi), (lo, hi)] + [(0, 0)] * (x.ndim - 3)
    return np.pad(x, pad, constant_values=fill)


def load_hippocampus_pickle(
    path: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train, y_train, x_test, y_test) with the reference's last-test-
    sample drop (`Hippocampus.py:479-484`)."""
    with open(path, "rb") as f:
        x_train, y_train, x_test, y_test = pickle.load(f)
    n_test = x_test.shape[0] - 1
    return (
        np.asarray(x_train, np.float32),
        np.asarray(y_train),
        np.asarray(x_test[:n_test], np.float32),
        np.asarray(y_test[:n_test]),
    )


def _ensure_nhwc(x: np.ndarray, in_channels: int) -> np.ndarray:
    """Add / move the channel axis to NHWC."""
    if x.ndim == 3:
        x = x[..., None]
    elif x.shape[1] == in_channels and x.shape[-1] != in_channels:
        x = x.transpose(0, 2, 3, 1)  # NCHW -> NHWC (Brats_functions.py:555)
    return np.ascontiguousarray(x, dtype=np.float32)


class PickleDataset:
    """In-memory dataset of (images NHWC f32, integer labels [B, H, W])."""

    def __init__(self, x: np.ndarray, y: np.ndarray, in_channels: int = 1):
        self.x = _ensure_nhwc(np.asarray(x), in_channels)
        y = np.asarray(y)
        if y.ndim == 4:  # one-hot labels -> integer map
            y = np.argmax(y, axis=-1)
        self.y = np.ascontiguousarray(y)
        assert len(self.x) == len(self.y)

    def __len__(self) -> int:
        return len(self.x)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        epoch: int = 0,
        drop_remainder: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) batches; the shuffle order is a function of
        ``seed + epoch``. ``drop_remainder=True`` keeps shapes static for
        jit (the reference's partial final batch breaks its own
        ``get_pooled``, SURVEY §2.7.7)."""
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        stop = len(self) - (len(self) % batch_size) if drop_remainder else len(self)
        for i in range(0, stop, batch_size):
            j = idx[i : i + batch_size]
            yield self.x[j], self.y[j]

    def steps_per_epoch(self, batch_size: int) -> int:
        return len(self) // batch_size


class StreamingPickleDataset:
    """BraTS-style sharded-pickle stream: files -> interleave -> unbatch ->
    shuffle buffer -> fixed-size batches, with background-thread prefetch.

    Mirrors `Brats.py:538-555` semantics; the shuffle buffer (1000) and
    file-order shuffle match the reference defaults.
    """

    def __init__(
        self,
        pattern: str,
        in_channels: int = 4,
        shuffle_files: bool = True,
        shuffle_buffer: int = 1000,
        seed: int = 0,
    ):
        self.files: List[str] = sorted(glob.glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no pickles match {pattern}")
        self.in_channels = in_channels
        self.shuffle_files = shuffle_files
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed

    def _samples(self, rng: np.random.Generator, shuffle_files: bool):
        files = list(self.files)
        if shuffle_files:
            rng.shuffle(files)
        buf: List[Tuple[np.ndarray, np.ndarray]] = []
        for fn in files:
            with open(fn, "rb") as f:
                x, y = pickle.load(f)
            x = _ensure_nhwc(np.asarray(x), self.in_channels)
            y = np.asarray(y)
            if y.ndim == 4:
                y = np.argmax(y, axis=-1)
            for i in range(len(x)):
                buf.append((x[i], y[i]))
                if len(buf) >= self.shuffle_buffer:
                    k = int(rng.integers(len(buf)))
                    yield buf.pop(k)
        while buf:
            k = int(rng.integers(len(buf)))
            yield buf.pop(k)

    def batches(
        self,
        batch_size: int,
        epoch: int = 0,
        drop_remainder: bool = True,
        shuffle: bool = None,
        seed: int = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``shuffle``/``seed`` override the constructor defaults for THIS
        iteration only (no constructor state is mutated) so all dataset
        classes share one batches() calling convention (the Trainer passes
        shuffle/seed/epoch uniformly)."""
        shuffle_files = (
            self.shuffle_files if shuffle is None else bool(shuffle)
        )
        base = self.seed if seed is None else seed
        rng = np.random.default_rng(base + epoch)
        xs, ys = [], []
        for x, y in self._samples(rng, shuffle_files):
            xs.append(x)
            ys.append(y)
            if len(xs) == batch_size:
                yield np.stack(xs), np.stack(ys)
                xs, ys = [], []
        if xs and not drop_remainder:
            yield np.stack(xs), np.stack(ys)


class BatchIterator:
    """Background-thread prefetcher (the tf.data ``prefetch(AUTOTUNE)``
    analog): overlaps host pickle IO / numpy prep with device compute."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._exc: Exception = None
        self.thread = threading.Thread(
            target=self._fill, args=(it,), daemon=True
        )
        self.thread.start()

    def _fill(self, it):
        try:
            for item in it:
                self.q.put(item)
        except Exception as e:  # surface producer errors to the consumer
            self._exc = e
        finally:
            self.q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._DONE:
            if self._exc is not None:
                # don't let a corrupt shard silently truncate the epoch
                raise RuntimeError(
                    "data pipeline producer failed mid-epoch"
                ) from self._exc
            raise StopIteration
        return item
