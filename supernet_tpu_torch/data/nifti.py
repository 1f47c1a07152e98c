"""Raw-data ingestion: NIfTI-1 volumes -> 2D training slices -> .npy shards.

The reference starts from PRE-EXTRACTED pickles
(`Hippocampus.py:479-481`, `Brats_functions.py:549-562`) and its extraction
code is absent from the snapshot; the datasets themselves ship as NIfTI-1
(.nii.gz) volumes in the Medical-Segmentation-Decathlon layout
(``TaskNN_Name/imagesTr/*.nii.gz`` + ``labelsTr/*.nii.gz``). This module
closes that first-step gap (SURVEY §7.2 step 7):
a dependency-free NIfTI-1 reader/writer (the format is a 348-byte header +
optional gzip) and the slice-extraction protocol that produces the shapes
the reference trains on:

- axial slices along the 3rd axis of each volume (H, W, D[, C] -> D images
  of H x W[, C] — MSD stores BraTS modalities as a trailing 4th axis);
- per-volume, per-modality min-max normalization to [0, 1] (the reference
  clips noisy images to the clean batch range and comments ``np.clip(x,0,1)``
  — `Hippocampus.py:1286` — i.e. its inputs live in [0, 1]);
- center-crop / zero-pad each slice to the dataset's ``image_size``
  (Hippocampus volumes are ~35x50 -> padded to 64; BraTS 240x240 -> cropped
  to 204), labels transformed identically with background fill;
- by default only slices whose label contains foreground are kept (the
  reference's training pickles are foreground-bearing slices), and the
  result streams through ``write_shards`` into the native loader's format.
"""

from __future__ import annotations

import glob
import gzip
import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# NIfTI-1 datatype code -> numpy dtype (the subset medical data uses)
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


def _open(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, Dict[str, object]]:
    """Read a .nii / .nii.gz volume; returns (data, header dict).

    Handles both endiannesses, the single-file ``n+1`` and detached ``ni1``
    magic (voxels read from the sibling ``.img``/``.img.gz``; if none
    exists but the data follows the header in the same file, that inline
    form is accepted too), and applies ``scl_slope``/``scl_inter`` when
    set. Data is returned in NIfTI's Fortran order as an (X, Y, Z[, T])
    array.
    """
    with _open(path) as f:
        raw = f.read()
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")
    for bo in ("<", ">"):
        (sizeof_hdr,) = struct.unpack_from(bo + "i", raw, 0)
        if sizeof_hdr == _HDR_SIZE:
            break
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr != 348)")
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    dim = struct.unpack_from(bo + "8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack_from(bo + "h", raw, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    (vox_offset,) = struct.unpack_from(bo + "f", raw, 108)
    slope, inter = struct.unpack_from(bo + "2f", raw, 112)
    pixdim = struct.unpack_from(bo + "8f", raw, 76)

    dt = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    n = int(np.prod(shape))
    if magic[:3] == b"n+1":
        offset = int(vox_offset)
    else:  # detached 'ni1' pair: voxels live in the sibling .img[.gz]
        img_path = re.sub(r"\.hdr(\.gz)?$", "", path, flags=re.IGNORECASE)
        for cand in (img_path + ".img", img_path + ".img.gz"):
            if os.path.exists(cand):
                with _open(cand) as f:
                    raw = f.read()
                offset = int(vox_offset)
                break
        else:
            # some pipelines ship ni1-magic files with the data inline
            # after the header; honor the header's vox_offset when it
            # points inside this buffer (it can differ from 352 when an
            # extension block follows the header), else assume the
            # canonical 352 = header + 4-byte extension flag
            offset = (
                int(vox_offset)
                if _HDR_SIZE <= int(vox_offset) < len(raw)
                else _HDR_SIZE + 4
            )
            if len(raw) < offset + n * dt.itemsize:
                raise ValueError(
                    f"{path}: detached NIfTI ('ni1') with no companion "
                    f".img[.gz] next to it and no inline data"
                )
    data = np.frombuffer(raw, dtype=dt, count=n, offset=offset)
    data = data.reshape(shape, order="F")
    if slope not in (0.0, 1.0) or (slope != 0.0 and inter != 0.0):
        data = data.astype(np.float32) * slope + inter
    header = {
        "shape": shape,
        "datatype": int(datatype),
        "pixdim": tuple(float(p) for p in pixdim[1 : 1 + ndim]),
        "byteorder": bo,
    }
    return np.asarray(data), header


def write_nifti(path: str, data: np.ndarray) -> None:
    """Write a minimal single-file NIfTI-1 (.nii or .nii.gz) volume —
    enough for round-trip tests and interop with standard viewers."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * 7))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope / inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    with _open(path, "wb") as f:
        f.write(payload)


def _fit_axes(
    a: np.ndarray, size: int, axes: Tuple[int, ...], fill: float = 0.0
) -> np.ndarray:
    """Center-crop / symmetric zero-pad the given axes to ``size`` each
    (labels use fill=0 = background; no interpolation, so label values stay
    exact)."""
    for axis in axes:
        n = a.shape[axis]
        if n > size:
            lo = (n - size) // 2
            a = a.take(range(lo, lo + size), axis=axis)
        elif n < size:
            lo = (size - n) // 2
            pad = [(0, 0)] * a.ndim
            pad[axis] = (lo, size - n - lo)
            a = np.pad(a, pad, constant_values=fill)
    return a


def _fit_2d(a: np.ndarray, size: int, fill: float = 0.0) -> np.ndarray:
    return _fit_axes(a, size, (0, 1), fill)


def volume_to_cube(
    img: np.ndarray,
    lbl: Optional[np.ndarray],
    size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, label) volume -> a single (size^3) cube pair for the 3-D
    model family (`models/unet3d.py`): per-modality min-max normalization
    then center crop / symmetric zero-pad on all three axes.

    ``img``: (X, Y, Z) or (X, Y, Z, C); ``lbl``: (X, Y, Z) or None. Returns
    (x [size, size, size, C] f32, y [size, size, size] i32). Random
    sub-volume sampling, when wanted, composes on top as a training-time
    crop (`data/augment.py` handles the flips/rotations)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img[..., None]
    if img.ndim != 4:
        raise ValueError(f"expected 3D/4D image volume, got {img.shape}")
    flat = img.reshape(-1, img.shape[-1])
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    img = (img - lo) / np.maximum(hi - lo, 1e-8)
    if lbl is None:
        lbl = np.zeros(img.shape[:3], np.int32)
    lbl = np.asarray(lbl)
    if lbl.shape != img.shape[:3]:
        raise ValueError(
            f"label shape {lbl.shape} does not match image {img.shape[:3]}"
        )
    y = np.rint(np.asarray(lbl, np.float64)).astype(np.int32)
    return (
        _fit_axes(img, size, (0, 1, 2)).astype(np.float32),
        _fit_axes(y, size, (0, 1, 2)),
    )


def volume_to_slices(
    img: np.ndarray,
    lbl: Optional[np.ndarray],
    image_size: int,
    keep_empty: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, label) volume pair -> (x [N, S, S, C] f32, y [N, S, S] i32).

    ``img``: (X, Y, Z) or (X, Y, Z, C); ``lbl``: (X, Y, Z) or None (test
    volumes without labels get all-background labels). Normalization is
    per-volume per-modality min-max to [0, 1]; slices are taken along Z.
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img[..., None]
    if img.ndim != 4:
        raise ValueError(f"expected 3D/4D image volume, got {img.shape}")
    # per-modality min-max over the whole volume
    flat = img.reshape(-1, img.shape[-1])
    lo = flat.min(axis=0)
    hi = flat.max(axis=0)
    img = (img - lo) / np.maximum(hi - lo, 1e-8)

    if lbl is None:
        lbl = np.zeros(img.shape[:3], np.int32)
    lbl = np.asarray(lbl)
    if lbl.shape != img.shape[:3]:
        raise ValueError(
            f"label shape {lbl.shape} does not match image {img.shape[:3]}"
        )
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    for z in range(img.shape[2]):
        y2 = np.rint(np.asarray(lbl[:, :, z], np.float64)).astype(np.int32)
        # crop BEFORE the foreground filter: a slice whose only foreground
        # lies in the cropped-off border would otherwise be kept with an
        # all-background label, breaking the "slices contain foreground"
        # invariant of keep_empty=False
        y2 = _fit_2d(y2, image_size)
        if not keep_empty and not (y2 > 0).any():
            continue
        x2 = _fit_2d(img[:, :, z, :], image_size)
        xs.append(x2.astype(np.float32))
        ys.append(y2)
    if not xs:
        c = img.shape[-1]
        return (
            np.zeros((0, image_size, image_size, c), np.float32),
            np.zeros((0, image_size, image_size), np.int32),
        )
    return np.stack(xs), np.stack(ys)


def _label_path(img_path: str, labels_dir: str) -> Optional[str]:
    p = os.path.join(labels_dir, os.path.basename(img_path))
    return p if os.path.exists(p) else None


def convert_nifti_dir(
    src: str,
    out_dir: str,
    image_size: int,
    split: str = "train",
    shard_size: int = 256,
    keep_empty: bool = False,
    max_volumes: int = 0,
) -> List[Tuple[str, str]]:
    """Walk a Medical-Segmentation-Decathlon-layout directory and write .npy
    shards the native loader streams (`data/shards.py`).

    ``src``: the task root (contains ``imagesTr``/``labelsTr``[/``imagesTs``])
    or a directory of .nii[.gz] images directly (labels then expected in a
    sibling ``labels`` dir, or absent). MSD hides macOS ``._*`` resource
    files in the tarballs; those are skipped.
    """
    images_dir = os.path.join(src, "imagesTr" if split == "train" else "imagesTs")
    labels_dir = os.path.join(src, "labelsTr")
    if not os.path.isdir(images_dir):
        images_dir = src
        labels_dir = os.path.join(src, "labels")
    files = sorted(
        f
        for f in glob.glob(os.path.join(images_dir, "*.nii*"))
        if not os.path.basename(f).startswith("._")
    )
    if not files:
        raise FileNotFoundError(f"no .nii/.nii.gz volumes under {images_dir}")
    if max_volumes:
        files = files[:max_volumes]

    from supernet_tpu_torch.data.shards import write_shards

    pairs: List[Tuple[str, str]] = []
    buf_x: List[np.ndarray] = []
    buf_y: List[np.ndarray] = []
    buffered = 0
    idx = 0

    def flush(final: bool = False):
        nonlocal buf_x, buf_y, buffered, idx
        if not buf_x:
            return
        x = np.concatenate(buf_x)
        y = np.concatenate(buf_y)
        stop = len(x) if final else len(x) - (len(x) % shard_size)
        if stop:
            pairs.extend(
                write_shards(
                    out_dir, x[:stop], y[:stop], shard_size, start_index=idx
                )
            )
            idx = len(pairs)
        buf_x = [x[stop:]] if stop < len(x) else []
        buf_y = [y[stop:]] if stop < len(x) else []
        buffered = len(x) - stop

    for fn in files:
        img, _ = read_nifti(fn)
        lp = _label_path(fn, labels_dir) if split == "train" else None
        lbl = read_nifti(lp)[0] if lp else None
        x, y = volume_to_slices(img, lbl, image_size, keep_empty=keep_empty)
        if len(x) == 0:
            continue
        buf_x.append(x)
        buf_y.append(y)
        buffered += len(x)
        if buffered >= shard_size:
            flush()
    flush(final=True)
    return pairs
