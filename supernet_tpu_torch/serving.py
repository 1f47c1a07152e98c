"""Padded-batch inference session: the meshless 2-D counterpart of
``supernet_tpu.serving.InferenceSession``.

The parameters stay resident on the session's device and every request is
cut into chunks of the session's fixed batch size; the last chunk is padded
by repeating its last row and the padding is sliced off the outputs (the
scheme of ``supernet_tpu/serving.py:293-315``), so every forward runs at one
shape. On a CUDA device each forward goes through the hand-written kernels
(``ops/kernels``); on the CPU through their plain versions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from supernet_tpu_torch.checkpoint import params_from_jax
from supernet_tpu_torch.configs import ModelConfig
from supernet_tpu_torch.models import forward_images


def _make_recalibrate(variance_scale: float, temperature: float):
    """Post-hoc recalibration: the global variance scale and the
    probability-space temperature fitted by ``calibration`` (identity at
    the 1.0 defaults)."""
    if variance_scale <= 0.0 or temperature <= 0.0:
        raise ValueError(
            "variance_scale and temperature must be positive "
            f"(got {variance_scale}, {temperature})"
        )

    def _recalibrate(probs: torch.Tensor, sigma: torch.Tensor):
        if temperature != 1.0:
            p = torch.pow(torch.clamp_min(probs, 1e-30), 1.0 / temperature)
            probs = p / p.sum(dim=-1, keepdim=True)
        if variance_scale != 1.0:
            sigma = sigma * variance_scale
        return probs, sigma

    return _recalibrate


class InferenceSession:
    """Fixed-batch inference on one device.

    ``params`` is a JAX-layout parameter dict (numpy arrays, JAX arrays or
    tensors); it is copied to ``device`` (the card unless the caller names
    another) once. ``predict(x)`` takes any
    leading batch size. ``variance_scale`` / ``temperature`` apply a fitted
    recalibration to every answer.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        batch_size: int = 8,
        *,
        device="cuda",
        variance_scale: float = 1.0,
        temperature: float = 1.0,
    ):
        self.cfg = cfg
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = torch.device(device)
        self._params = params_from_jax(params, self.device)
        self._recalibrate = _make_recalibrate(variance_scale, temperature)

    @torch.inference_mode()
    def _run(self, x: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        xt = torch.from_numpy(x).to(self.device)
        return self._recalibrate(*forward_images(self._params, xt, self.cfg))

    def warmup(self) -> "InferenceSession":
        """Build the kernels (on a CUDA device) and run one batch outside
        the request path."""
        s, c = self.cfg.image_size, self.cfg.in_channels
        self._run(np.zeros((self.batch_size, s, s, c), np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def predict(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """[N, H, W, C] -> (probs, sigma), each [N, out, out, n_classes]."""
        x = np.asarray(x, np.float32)
        n = len(x)
        if n == 0:
            o = self.cfg.out_size
            shape = (0, o, o, self.cfg.n_classes)
            return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
        probs_out, sigma_out = [], []
        for i in range(0, n, self.batch_size):
            chunk = x[i : i + self.batch_size]
            b = len(chunk)
            if b < self.batch_size:
                reps = np.repeat(chunk[-1:], self.batch_size - b, axis=0)
                chunk = np.concatenate([chunk, reps], axis=0)
            p, s = self._run(np.ascontiguousarray(chunk))
            probs_out.append(p[:b].cpu().numpy())
            sigma_out.append(s[:b].cpu().numpy())
        return np.concatenate(probs_out), np.concatenate(sigma_out)

    def predict_image(
        self,
        img: np.ndarray,
        overlap: int = 0,
        weight: str = "gaussian",
        pad_mode: str = "reflect",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sliding-window ``(probs, sigma)`` over ONE 2-D image of any
        spatial shape (``[H, W]`` or ``[H, W, C]``) through the fixed
        model geometry (``tiling.predict_image``)."""
        from supernet_tpu_torch.tiling import predict_image as _pi

        return _pi(
            self.predict,
            img,
            self.cfg.image_size,
            self.cfg.out_size,
            overlap=overlap,
            weight=weight,
            pad_mode=pad_mode,
        )
