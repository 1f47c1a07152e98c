""".npy shard datasets: the framework's on-disk training format.

The reference stores data as Python pickles (one blob for Hippocampus,
20-sample pickles for BraTS — `Hippocampus.py:479-481`,
`Brats_functions.py:549-562`), which forces every decode through the Python
interpreter. Here the canonical format is pairs of .npy shards
(``x_%05d.npy`` float32 [N,H,W,C], ``y_%05d.npy`` int32 [N,H,W]) that the
native C++ runtime (supernet_tpu_torch.native) streams and batches off-thread;
``convert_pickles`` migrates reference pickles once.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Iterator, List, Optional, Tuple

import numpy as np

from supernet_tpu_torch.data.loaders import _ensure_nhwc


def write_shards(
    out_dir: str,
    x: np.ndarray,
    y: np.ndarray,
    shard_size: int = 256,
    start_index: int = 0,
    volumetric: bool = False,
) -> List[Tuple[str, str]]:
    """Write (x, y) as .npy shard pairs; returns the (x_path, y_path) list.

    A 4-D ``y`` is ambiguous: 2-D one-hot [N, H, W, C] vs volumetric cube
    labels [N, S, S, S]. ``volumetric`` resolves it explicitly — the
    caller knows which family it is converting (a dtype heuristic would
    silently misroute integer-typed one-hot labels)."""
    os.makedirs(out_dir, exist_ok=True)
    x = np.ascontiguousarray(x, np.float32)
    y = np.asarray(y)
    if y.ndim == 4 and not volumetric:
        y = np.argmax(y, axis=-1)  # one-hot -> integer class labels
    y = np.ascontiguousarray(y, np.int32)
    pairs: List[Tuple[str, str]] = []
    idx = start_index
    for i in range(0, len(x), shard_size):
        xp = os.path.join(out_dir, f"x_{idx:05d}.npy")
        yp = os.path.join(out_dir, f"y_{idx:05d}.npy")
        np.save(xp, x[i : i + shard_size])
        np.save(yp, y[i : i + shard_size])
        pairs.append((xp, yp))
        idx += 1
    return pairs


def shard_pairs(shard_dir: str) -> List[Tuple[str, str]]:
    xs = sorted(glob.glob(os.path.join(shard_dir, "x_*.npy")))
    pairs = []
    for xp in xs:
        # replace only in the basename — a directory whose own name
        # contains 'x_' must not be rewritten
        d, base = os.path.split(xp)
        yp = os.path.join(d, "y_" + base[len("x_") :])
        if os.path.exists(yp):
            pairs.append((xp, yp))
    return pairs


def convert_pickles(
    src: str,
    out_dir: str,
    in_channels: int = 1,
    shard_size: int = 256,
    split: str = "train",
) -> List[Tuple[str, str]]:
    """Convert reference pickles to shards.

    ``src``: either the single Hippocampus pickle (splits extracted by
    position, `Hippocampus.py:479-484`) or a glob of BraTS-style 20-sample
    pickles (`Brats_functions.py:549-562`, NCHW transposed to NHWC).
    """
    if "*" in src:
        pairs: List[Tuple[str, str]] = []
        idx = 0
        for fn in sorted(glob.glob(src)):
            with open(fn, "rb") as f:
                x, y = pickle.load(f)
            x = _ensure_nhwc(np.asarray(x), in_channels)
            pairs += write_shards(
                out_dir, x, np.asarray(y), shard_size, start_index=idx
            )
            idx = len(pairs)
        return pairs
    with open(src, "rb") as f:
        x_train, y_train, x_test, y_test = pickle.load(f)
    if split == "train":
        x, y = x_train, y_train
    else:  # drop the last test sample like the reference
        x, y = x_test[:-1], y_test[:-1]
    x = _ensure_nhwc(np.asarray(x), in_channels)
    return write_shards(out_dir, x, np.asarray(y), shard_size)


class ShardDataset:
    """Batched iteration over a shard directory.

    Prefers the native C++ streaming runtime (supernet_tpu_torch.native); falls
    back to a pure-NumPy reader with identical semantics (shard shuffle +
    shuffle-buffer + fixed batches; ``drop_remainder=False`` yields the
    trailing partial batch on both paths).
    """

    def __init__(
        self,
        shard_dir: str,
        shuffle: bool = True,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        use_native: Optional[bool] = None,
    ):
        self.pairs = shard_pairs(shard_dir)
        if not self.pairs:
            raise FileNotFoundError(f"no x_*.npy shards in {shard_dir}")
        self.shuffle = shuffle
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        if use_native is None:
            from supernet_tpu_torch.native import native_available

            use_native = native_available()
        self.use_native = use_native
        self._native = None
        self._native_key = None
        # probe per-sample shapes + total count from headers (mmap_mode
        # reads only the header — no data pages are touched)
        n = 0
        for xp, _ in self.pairs:
            shp = np.load(xp, mmap_mode="r").shape
            n += shp[0]
            self.x_shape = shp[1:]
        self._len = n

    def __len__(self) -> int:
        return self._len

    def steps_per_epoch(
        self, batch_size: int, drop_remainder: bool = True
    ) -> int:
        if drop_remainder:
            return self._len // batch_size
        return -(-self._len // batch_size)

    def _python_batches(
        self,
        batch_size: int,
        epoch: int,
        drop_remainder: bool,
        shuffle: bool,
        seed: int,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(seed + epoch)
        order = list(self.pairs)
        if shuffle:
            rng.shuffle(order)
        buf: List[Tuple[np.ndarray, np.ndarray]] = []
        xs, ys = [], []

        def emit(item):
            xs.append(item[0])
            ys.append(item[1])

        for xp, yp in order:
            x = np.load(xp)
            y = np.load(yp)
            for i in range(len(x)):
                if not shuffle:
                    emit((x[i], y[i]))
                else:
                    buf.append((x[i], y[i]))
                    if len(buf) >= self.shuffle_buffer:
                        k = int(rng.integers(len(buf)))
                        buf[k], buf[-1] = buf[-1], buf[k]
                        emit(buf.pop())
                while len(xs) >= batch_size:
                    yield np.stack(xs[:batch_size]), np.stack(
                        ys[:batch_size]
                    )
                    del xs[:batch_size], ys[:batch_size]
        while buf:
            k = int(rng.integers(len(buf)))
            buf[k], buf[-1] = buf[-1], buf[k]
            emit(buf.pop())
            while len(xs) >= batch_size:
                yield np.stack(xs[:batch_size]), np.stack(ys[:batch_size])
                del xs[:batch_size], ys[:batch_size]
        if xs and not drop_remainder:
            yield np.stack(xs), np.stack(ys)

    def batches(
        self,
        batch_size: int,
        epoch: int = 0,
        shuffle: bool = None,
        seed: int = None,
        drop_remainder: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Uniform calling convention with the other datasets: shuffle/seed
        override construction defaults for THIS iteration only (constructor
        state is never mutated); shuffle order varies with epoch."""
        shuffle = self.shuffle if shuffle is None else bool(shuffle)
        seed = self.seed if seed is None else seed
        if not self.use_native:
            yield from self._python_batches(
                batch_size, epoch, drop_remainder, shuffle, seed
            )
            return
        key = (batch_size, drop_remainder, shuffle, seed)
        if self._native is None or self._native_key != key:
            from supernet_tpu_torch.native import NativeShardLoader

            if self._native is not None:
                self._native.close()
            self._native = NativeShardLoader(
                self.pairs,
                batch_size,
                shuffle=shuffle,
                shuffle_buffer=self.shuffle_buffer,
                drop_remainder=drop_remainder,
                seed=seed,
            )
            self._native_key = key
        yield from self._native.batches(batch_size, epoch=epoch)
