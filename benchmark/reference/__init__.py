"""The plain reference of the VDP U-Net: forward (moment propagation),
loss, per-tensor clip and Adam, in plain PyTorch, float32 with TF32 off.

Written from the published model (Hippocampus.py / Brats.py of the SUPER-Net
reference repository) and imports nothing of the program under test."""

import contextlib


@contextlib.contextmanager
def arithmetic(tf32: bool = False):
    """The reference's arithmetic inside the block, restored after it:
    PyTorch's own convolutions (im2col and cuBLAS; cuDNN off) and matrix
    products, in float32 with TF32 off, or with ``tf32`` on: the control,
    the nearest precision below float32.

    cuDNN stays off because its float32 algorithms on the card err by a
    share of a tensor's largest value: small variances come out far off in
    relative terms, and the loss's ``1 / (sigma + 1e-3)`` turns that into
    2.6-6.1e-4 of the BraTS loss against float64, where PyTorch's own
    convolutions read 0.4-1.5e-6 (see PERF.md)."""
    import torch

    flags = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.enabled = False
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
