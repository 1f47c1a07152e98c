"""ctypes bindings for the native (C++) data-pipeline runtime.

``libsupernet_io.so`` (built from ``io.cc``) streams .npy shard pairs into
fixed-size batches on a background thread — the framework's native
equivalent of the reference's tf.data C++ input runtime (`Brats.py:538-555`)
minus its per-shard Python-pickle bounce (`Brats_functions.py:549-562`).

The port's own copy of ``supernet_tpu/native`` (``io.cc`` is the same file,
byte for byte). The library is compiled on first use with ``g++`` into
``build/torch_native/`` at the root of the checkout, named by a hash of the
source; if no compiler is available the callers fall back to the
pure-Python loaders in ``supernet_tpu_torch.data``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "io.cc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_DIR)), "build", "torch_native"
)


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsupernet_io_{h}.so")


_lib = None
_lib_lock = threading.Lock()


def _build(so: str) -> bool:
    # compile to a per-process temp name, then os.rename (atomic on POSIX):
    # two processes importing concurrently never see a half-written .so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++",
        "-O3",
        "-shared",
        "-fPIC",
        "-std=c++17",
        "-pthread",
        _SRC,
        "-o",
        tmp,
    ]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.rename(tmp, so)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """The shared library, building it on demand; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        lib.sn_open.restype = ctypes.c_void_p
        lib.sn_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
        lib.sn_shapes.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sn_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.sn_next.restype = ctypes.c_int
        lib.sn_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sn_error.restype = ctypes.c_char_p
        lib.sn_error.argtypes = [ctypes.c_void_p]
        lib.sn_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


class NativeShardLoader:
    """Streams (x, y) batches from .npy shard pairs via the C++ runtime.

    Semantics mirror the reference's input pipeline: shard-order shuffle +
    sample shuffle buffer (1000, `Brats.py:549`) + fixed batches with
    remainder dropped (static batch shapes) + bounded prefetch.
    """

    def __init__(
        self,
        shard_pairs: Sequence[Tuple[str, str]],
        batch_size: int,
        shuffle: bool = True,
        shuffle_buffer: int = 1000,
        drop_remainder: bool = True,
        prefetch_depth: int = 4,
        seed: int = 0,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native io library unavailable")
        self._lib = lib
        self.seed = seed
        self.batch_size = batch_size
        flat: List[str] = []
        for x, y in shard_pairs:
            flat += [os.path.abspath(x), os.path.abspath(y)]
        self._h = lib.sn_open(
            "\x1f".join(flat).encode(),
            batch_size,
            shuffle_buffer,
            int(shuffle),
            int(drop_remainder),
            prefetch_depth,
        )
        if not self._h:
            raise ValueError("sn_open failed (bad shards or dtypes)")
        dims = (ctypes.c_int64 * 16)()
        lib.sn_shapes(self._h, dims)
        xr = dims[0]
        self.x_shape = tuple(dims[1 : 1 + xr])
        yr = dims[1 + xr]
        self.y_shape = tuple(dims[2 + xr : 2 + xr + yr])
        self._x_buf = np.empty((batch_size, *self.x_shape), np.float32)
        self._y_buf = np.empty((batch_size, *self.y_shape), np.int32)

    def batches(
        self, batch_size: Optional[int] = None, epoch: int = 0, **_
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Iterate one epoch; yields copies safe to hold across steps."""
        assert batch_size is None or batch_size == self.batch_size
        self._lib.sn_start_epoch(self._h, self.seed + epoch)
        xp = self._x_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        yp = self._y_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while True:
            n = self._lib.sn_next(self._h, xp, yp)
            if n < 0:
                raise RuntimeError(self._lib.sn_error(self._h).decode())
            if n == 0:
                return
            yield self._x_buf[:n].copy(), self._y_buf[:n].copy()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sn_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
