"""Build and load the port's hand-written CUDA kernels.

At first use every ``supernet_tpu_torch/csrc/*.cu`` is compiled for Hopper
(``sm_90a``) by ``nvcc``, one process per source, all started together, and
linked into one shared library with a plain C interface. The library goes to
``build/torch_kernels/`` at the root of the checkout and is named by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. It is loaded with ``ctypes``: every pointer and the
stream are passed as ``c_void_p`` (a bare Python int would be cut to 32
bits), and every entry point returns ``cudaGetLastError()`` after its launch,
which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module, and a
CPU-only machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of supernet_tpu_torch are built from source at first use"
    )


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsupernet_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library of the same sources exists;
    return its path. Raises with the compiler's output on failure."""
    so = _library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(_CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = [
            (
                src,
                subprocess.Popen(
                    [nvcc, *_ARCH, *_FLAGS, "-Xptxas", "-v", "-c", str(src),
                     "-o", os.path.join(tmp, src.stem + ".o")],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
            )
            for src in sources
        ]
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", tmp_so,
             *(os.path.join(tmp, s.stem + ".o") for s in sources)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # the build log keeps ptxas' register and shared-memory report
        so.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, so)  # atomic: a reader never sees half a library
    return so


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.supernet_vdp_conv_fwd.argtypes = [_P] * 8 + [_I] * 10 + [_P]
            lib.supernet_vdp_conv_fwd.restype = _I
            lib.supernet_vmaxpool_fwd.argtypes = [_P] * 5 + [_I] * 4 + [_P]
            lib.supernet_vmaxpool_fwd.restype = _I
            lib.supernet_vmaxpool_bwd.argtypes = [_P] * 5 + [_I] * 4 + [_P]
            lib.supernet_vmaxpool_bwd.restype = _I
            lib.supernet_sigma_bwd.argtypes = [_P] * 5 + [_I] * 6 + [_P]
            lib.supernet_sigma_bwd.restype = _I
            lib.supernet_cuda_error_string.argtypes = [_I]
            lib.supernet_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_input(op: str, name: str, t, shape) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``
    (the kernels take no other)."""
    import torch

    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{op}: {name} must be a contiguous float32 CUDA tensor "
            f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{op}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = load().supernet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
