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
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# the dtypes a kernel takes for a moment tensor (csrc/dtype.cuh), by the
# code its C entry point takes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MOMENT_DTYPES = tuple(_DTYPE_CODES)


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
            lib.supernet_vdp_conv_fwd.argtypes = [_P] * 10 + [_I] * 17 + [_LL] * 3 + [_P]
            lib.supernet_vdp_conv_fwd.restype = _I
            lib.supernet_vmaxpool_fwd.argtypes = [_P] * 5 + [_I] * 7 + [_P]
            lib.supernet_vmaxpool_fwd.restype = _I
            lib.supernet_vmaxpool_bwd.argtypes = [_P] * 5 + [_I] * 6 + [_P]
            lib.supernet_vmaxpool_bwd.restype = _I
            lib.supernet_sigma_bwd.argtypes = [_P] * 5 + [_I] * 9 + [_P]
            lib.supernet_sigma_bwd.restype = _I
            lib.supernet_sigma_bwd_vec.argtypes = [_P] * 7 + [_I] * 11 + [_P]
            lib.supernet_sigma_bwd_vec.restype = _I
            lib.supernet_vdp_norm_rows_fwd.argtypes = [_P] * 7 + [_LL, _I, _F, _I, _I, _P]
            lib.supernet_vdp_norm_rows_fwd.restype = _I
            lib.supernet_vdp_norm_rows_bwd.argtypes = [_P] * 11 + [_LL, _I, _I, _I, _P]
            lib.supernet_vdp_norm_rows_bwd.restype = _I
            lib.supernet_vdp_norm_slices_fwd.argtypes = (
                [_P] * 8 + [_I, _LL, _I, _F] + [_I] * 4 + [_LL, _P])
            lib.supernet_vdp_norm_slices_fwd.restype = _I
            lib.supernet_vdp_norm_slices_bwd.argtypes = (
                [_P] * 13 + [_I, _LL, _I] + [_I] * 4 + [_LL, _P])
            lib.supernet_vdp_norm_slices_bwd.restype = _I
            lib.supernet_empty_launch.argtypes = [_P]
            lib.supernet_empty_launch.restype = _I
            lib.supernet_cuda_error_string.argtypes = [_I]
            lib.supernet_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def dtype_code(dtype) -> int:
    """The dtype argument of the kernels' C entry points: 0 float32, 1 bf16
    (``csrc/dtype.cuh``)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernels take float32 or bfloat16, not {dtype}")
    return _DTYPE_CODES[dtype]


def wide(t):
    """``t`` in the dtype the plain versions compute in: a bf16 tensor
    converted to float32, float32 and float64 as they are; None stays
    None."""
    return None if t is None else t.to(torch.promote_types(t.dtype, torch.float32))


def check_input(op: str, name: str, t, shape, dtypes=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` whose
    dtype is one of ``dtypes`` (default float32 alone: the weights). A
    moment tensor takes ``MOMENT_DTYPES``, or the dtype of the moment it
    must match; every other dtype raises, naming those the kernel takes."""
    dtypes = (torch.float32,) if dtypes is None else tuple(dtypes)
    if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous():
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(
            f"{op}: {name} must be a contiguous {names} CUDA tensor "
            f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{op}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The streaming multiprocessors of the card holding ``device`` (132 on
    an H100 SXM, 114 on an H100 PCIe): what the planners fill."""
    device = torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None
                     else device.index)


def aligned(t):
    """``t``, copied if its data does not start on 16 bytes (a contiguous
    view into a larger tensor may not): the kernels that move 16-byte pieces
    take no other. ``None`` stays ``None``."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = load().supernet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
