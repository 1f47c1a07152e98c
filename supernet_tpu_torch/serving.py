"""Serving: the padded-batch inference session, the deep-ensemble session and
the export bundle, the counterparts of ``supernet_tpu/serving.py``, for
images and (``volumetric=True``) for the 3-D family's cubes, on one device
or (``mesh=``) on one process per device: a chunk's images split over the
ranks (``shard="batch"``), a volume's D axis split over them
(``shard="scan"``, volumetric), or an ensemble's members split over them;
every rank answers the whole request.

The parameters stay resident on the session's device and every request is
cut into chunks of the session's fixed batch size; the last chunk is padded
by repeating the request's last row and the padding is sliced off the
outputs (the scheme of ``supernet_tpu/serving.py:293-315``), so every
forward runs at one shape. On a CUDA device each forward goes through the
hand-written kernels (``ops/kernels``); on the CPU through their plain
versions. A request is enqueued whole: its images go to the card from a
pinned host buffer, every chunk's outputs are copied into pinned host
buffers without waiting, and the host waits once, at the end. The pinned
buffers belong to the session and are reused by the next request (a lock
keeps two threads from sharing them).

A volumetric session answers cubes [N, S, S, S, C] with [N, o, o, o, K]
moments through ``forward3d`` (cuDNN ``conv3d`` and PyTorch ops on the card;
the 3-D family has no hand-written kernel), and ``predict_volume`` tiles one
whole volume of any shape through it (``tiling.predict_volume``).

``export_bundle`` writes ``params.npz``, ``model.pt2`` (a ``torch.export``
of the plain PyTorch composition at the fixed batch, recalibration and the
ensemble mixture baked in; the kernels are ctypes calls and cannot be
exported) and ``export_meta.json``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from supernet_tpu_torch import tracing
from supernet_tpu_torch.checkpoint import params_from_jax, save_params_npz
from supernet_tpu_torch.configs import ModelConfig
from supernet_tpu_torch.models import forward, forward3d, forward_images

Tensor = torch.Tensor


def _make_recalibrate(variance_scale: float, temperature: float):
    """Post-hoc recalibration: the global variance scale and the
    probability-space temperature fitted by ``calibration`` (identity at
    the 1.0 defaults)."""
    if variance_scale <= 0.0 or temperature <= 0.0:
        raise ValueError(
            "variance_scale and temperature must be positive "
            f"(got {variance_scale}, {temperature})"
        )

    def _recalibrate(probs: Tensor, sigma: Tensor):
        if temperature != 1.0:
            p = torch.pow(torch.clamp_min(probs, 1e-30), 1.0 / temperature)
            probs = p / p.sum(dim=-1, keepdim=True)
        if variance_scale != 1.0:
            sigma = sigma * variance_scale
        return probs, sigma

    return _recalibrate


def _shaped_forward(params, x: Tensor, cfg: ModelConfig, volumetric: bool = False):
    """``(probs, sigma)`` shaped like the input's spatial axes: [B, o, o, K]
    images, or [B, o, o, o, K] cubes with ``volumetric``."""
    if not volumetric:
        return forward_images(params, x, cfg)
    probs, sigma = forward3d(params, x, cfg)
    o = cfg.out_size
    shape = (x.shape[0], o, o, o, cfg.n_classes)
    return probs.reshape(shape), sigma.reshape(shape)


def mixture(
    probs: Sequence[Tensor], sigmas: Sequence[Tensor]
) -> Tuple[Tensor, Tensor]:
    """Uniform-mixture moments over K members' ``(p_k, s_k)``:

        mean = sum_k w p_k,   var = sum_k w (s_k + (p_k - mean)^2),   w = 1/K

    the within-member variance plus the members' disagreement, in the form
    of ``supernet_tpu/serving.py:438-446`` that does not cancel (``s`` of
    1e-5 under ``p^2`` of 1) and is non-negative by construction. Equal
    members give the member's own moments."""
    w = 1.0 / len(probs)
    mean = sum(w * p for p in probs)
    var = sum(w * (s + torch.square(p - mean)) for p, s in zip(probs, sigmas))
    return mean, var


class InferenceSession:
    """Fixed-batch inference on one device.

    ``params`` is a JAX-layout parameter dict (numpy arrays, JAX arrays or
    tensors); it is copied to ``device`` (the card unless the caller names
    another) once. ``predict(x)`` takes any leading batch size.
    ``variance_scale`` / ``temperature`` apply a fitted recalibration to
    every answer. ``volumetric=True`` serves the 3-D family: cubes in, cubes
    out, and ``predict_volume`` for whole volumes.

    ``mesh`` (a ``parallel.make_mesh`` mesh; every rank builds the session
    and sends the same requests) splits each chunk: ``shard="batch"`` its
    images over the ranks (``batch_size`` divisible by the mesh),
    ``shard="scan"`` each volume's D axis (volumetric only; for volumes
    whose activations do not fit one device). Every rank gets the whole
    answer.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        batch_size: int = 8,
        *,
        device="cuda",
        volumetric: bool = False,
        variance_scale: float = 1.0,
        temperature: float = 1.0,
        mesh=None,
        shard: str = "batch",
    ):
        self.cfg = cfg
        self.volumetric = bool(volumetric)
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        _check_shard(mesh, shard, self.volumetric, self.batch_size)
        self.device = torch.device(device)
        self._params = params_from_jax(params, self.device)
        self._recalibrate = _make_recalibrate(variance_scale, temperature)
        self._host = None  # (images, probs, sigma) host buffers of a request
        self._lock = threading.Lock()
        self._mesh = mesh
        self._run = lambda x: _shaped_forward(self._params, x, self.cfg, self.volumetric)
        if mesh is not None:
            from supernet_tpu_torch import parallel

            parallel.replicate(mesh, self._params)
            self._run = _mesh_run(self, mesh, shard)

    def _buffers(self, n: int):
        """Host buffers for ``n`` images (a whole number of chunks): pinned
        on a CUDA session, allocated once and grown when a request is
        larger than any before it."""
        if self._host is None or len(self._host[0]) < n:
            tracing.count("session.buffer_grows")
            pin = self.device.type == "cuda"
            self._host = (
                torch.empty((n,) + self._in_shape(), pin_memory=pin),
                torch.empty((n,) + self._out_shape(), pin_memory=pin),
                torch.empty((n,) + self._out_shape(), pin_memory=pin),
            )
        return self._host

    def _in_shape(self) -> Tuple[int, ...]:
        s = self.cfg.image_size
        return (s,) * (3 if self.volumetric else 2) + (self.cfg.in_channels,)

    def _out_shape(self) -> Tuple[int, ...]:
        o = self.cfg.out_size
        return (o,) * (3 if self.volumetric else 2) + (self.cfg.n_classes,)

    def _forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """One chunk on the device -> recalibrated image- or cube-shaped
        moments."""
        return self._recalibrate(*self._run(x))

    def warmup(self) -> "InferenceSession":
        """Build the kernels (on a CUDA device) and run one batch outside
        the request path."""
        with torch.inference_mode():
            self._forward(torch.zeros((self.batch_size,) + self._in_shape(),
                                      device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def predict(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """[N, H, W, C] -> (probs, sigma), each [N, out, out, n_classes]
        ([N, D, H, W, C] -> [N, out, out, out, n_classes] volumetric).

        Spans (``tracing``): ``session.predict`` around the request, and in
        it ``session.stage_in`` (twice: the request made float32, then, under
        the session's lock, copied into the pinned buffer and the tail
        padded), ``session.dispatch`` (every chunk's copy in, forward and
        copies out enqueued), ``session.wait`` (the one synchronisation) and
        ``session.stage_out`` (the answers copied out of the pinned buffers).
        Counters: ``session.requests``, ``session.slices`` (the request's),
        ``session.slices_computed`` (padded to whole chunks) and
        ``session.buffer_grows``."""
        with tracing.span("session.predict"):
            with tracing.span("session.stage_in"):
                x = np.asarray(x, np.float32)
            n, bs = len(x), self.batch_size
            padded = -(-n // bs) * bs
            tracing.count("session.requests")
            tracing.count("session.slices", n)
            tracing.count("session.slices_computed", padded)
            if n == 0:
                shape = (n,) + self._out_shape()
                return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
            with self._lock, torch.inference_mode():
                with tracing.span("session.stage_in"):
                    xh, probs, sigma = self._buffers(padded)
                    images = xh.numpy()
                    images[:n] = x
                    images[n:padded] = x[-1]  # the tail chunk repeats the last image
                with tracing.span("session.dispatch"):
                    for i in range(0, n, bs):
                        b = min(bs, n - i)
                        p, s = self._forward(xh[i : i + bs].to(self.device, non_blocking=True))
                        probs[i : i + b].copy_(p[:b], non_blocking=True)
                        sigma[i : i + b].copy_(s[:b], non_blocking=True)
                with tracing.span("session.wait"):
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                with tracing.span("session.stage_out"):
                    return probs[:n].numpy().copy(), sigma[:n].numpy().copy()

    def predict_image(
        self,
        img: np.ndarray,
        overlap: int = 0,
        weight: str = "gaussian",
        pad_mode: str = "reflect",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sliding-window ``(probs, sigma)`` over ONE 2-D image of any
        spatial shape (``[H, W]`` or ``[H, W, C]``) through the fixed
        model geometry (``tiling.predict_image``). 2-D sessions only."""
        from supernet_tpu_torch.tiling import predict_image as _pi

        if self.volumetric:
            raise ValueError("predict_image is for 2-D sessions; use predict_volume")
        return _pi(
            self.predict,
            img,
            self.cfg.image_size,
            self.cfg.out_size,
            overlap=overlap,
            weight=weight,
            pad_mode=pad_mode,
        )

    def predict_volume(
        self,
        vol: np.ndarray,
        overlap: int = 0,
        weight: str = "gaussian",
        pad_mode: str = "reflect",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sliding-window ``(probs, sigma)`` over ONE whole volume of any
        spatial shape (``[D, H, W]`` or ``[D, H, W, C]``): overlapping model
        cubes batched through :meth:`predict` and blended per voxel
        (``tiling.predict_volume``). Volumetric sessions only."""
        from supernet_tpu_torch.tiling import predict_volume as _pv

        if not self.volumetric:
            raise ValueError("predict_volume requires volumetric=True")
        return _pv(
            self.predict,
            vol,
            self.cfg.image_size,
            self.cfg.out_size,
            overlap=overlap,
            weight=weight,
            pad_mode=pad_mode,
        )


def _check_shard(mesh, shard: str, volumetric: bool, batch_size: int) -> None:
    """The JAX session's guards on ``mesh`` / ``shard``."""
    if shard not in ("batch", "scan"):
        raise ValueError(f"unknown shard mode {shard!r}")
    if shard == "scan" and not volumetric:
        raise ValueError(
            "shard='scan' shards a volume's D axis — volumetric only"
        )
    if shard == "scan" and mesh is None:
        raise ValueError(
            "shard='scan' needs a mesh to shard the D axis over — the "
            "whole point of the mode is multi-chip whole-volume serving"
        )
    if mesh is not None and shard == "batch":
        n_dev = int(mesh.mesh.numel())
        if batch_size % n_dev != 0:
            raise ValueError(
                f"batch_size {batch_size} is not divisible by the "
                f"{n_dev}-device mesh; the compiled batch must shard "
                "evenly over the data axis"
            )


def _mesh_run(session: "InferenceSession", mesh, shard: str):
    """A chunk's shaped ``(probs, sigma)`` under ``mesh``: the chunk's images
    over the ranks, or (``scan``) each volume's D axis, gathered."""
    from supernet_tpu_torch import parallel
    from supernet_tpu_torch.parallel.data_parallel import sharded_apply

    cfg = session.cfg
    if shard == "batch":
        return sharded_apply(
            lambda xs: _shaped_forward(session._params, xs, cfg, session.volumetric),
            mesh)
    f = parallel.make_spatial_forward3d(cfg, mesh)

    def run(x):
        probs, sigma = f(session._params, x)
        shape = (x.shape[0],) + session._out_shape()
        return probs.reshape(shape), sigma.reshape(shape)

    return run


def members_forward(stacked, x: Tensor, cfg: ModelConfig, volumetric: bool = False):
    """``(probs, sigma)`` of every member of member-stacked parameters on
    one batch ``x``, each [K, B, o, o(, o), n_classes]: the batch is read by
    all K members through a stride-0 view (never copied), and each layer
    runs once for all of them (each kernel once per layer in 2-D)."""
    k_members = next(iter(stacked.values()))["w_mu"].shape[0]
    xs = x.expand(k_members, *x.shape)
    if volumetric:
        probs, sigma = forward3d(stacked, xs, cfg)
    else:
        probs, sigma = forward(stacked, xs, cfg)
    o = cfg.out_size
    shape = (k_members, x.shape[0]) + (o,) * (3 if volumetric else 2) + (cfg.n_classes,)
    return probs.reshape(shape), sigma.reshape(shape)


class EnsembleSession(InferenceSession):
    """Deep-ensemble serving: K parameter dicts of the same config, stacked
    along a member axis on the session's device; each chunk runs through all
    K members in one member-stacked forward (:func:`members_forward`: every
    kernel once per layer for all members, the chunk shared by stride 0;
    the counterpart of the JAX session's ``jax.vmap``), and the members'
    moments are mixed by :func:`mixture`. Recalibration applies after the
    mixture. ``predict`` / ``predict_image`` / ``predict_volume`` are
    inherited.

    With a ``mesh`` the MEMBER axis is split over the ranks: each rank runs
    its block of members on the whole chunk and the mixture's sums are
    all-reduced. When K does not divide the mesh, the member axis is padded
    with repeats of the last member whose mixture weight is 0, so any K
    serves on any mesh."""

    def __init__(
        self,
        params_list,
        cfg: ModelConfig,
        batch_size: int = 8,
        *,
        device="cuda",
        volumetric: bool = False,
        variance_scale: float = 1.0,
        temperature: float = 1.0,
        mesh=None,
    ):
        params_list = list(params_list)
        if not params_list:
            raise ValueError("params_list must hold at least one member")
        self.n_members = k = len(params_list)
        self._axis = None
        self._weights = [1.0 / k] * k
        if mesh is not None:
            from supernet_tpu_torch.parallel._comm import axis

            self._axis = ax = axis(mesh, "data")
            padded = params_list + [params_list[-1]] * ((-k) % ax.size)
            per = len(padded) // ax.size
            first = ax.index * per
            params_list = padded[first:first + per]
            self._weights = [1.0 / k if first + i < k else 0.0 for i in range(per)]
        super().__init__(
            params_list[0], cfg, batch_size, device=device, volumetric=volumetric,
            variance_scale=variance_scale, temperature=temperature,
        )
        from supernet_tpu_torch.train import stack_trees

        self._params = stack_trees([self._params] + [
            params_from_jax(p, self.device) for p in params_list[1:]
        ])

    def _forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        probs, sigma = members_forward(self._params, x, self.cfg, self.volumetric)
        if self._axis is None:
            return self._recalibrate(*mixture(probs.unbind(0), sigma.unbind(0)))
        # the mixture of ``mixture`` over every rank's members: the weighted
        # sums of the mean and of the variance, each all-reduced
        from supernet_tpu_torch.parallel._comm import all_reduce_sum_

        mean = sum(w * p for w, p in zip(self._weights, probs.unbind(0)))
        all_reduce_sum_([mean], self._axis)
        var = sum(w * (s + torch.square(p - mean))
                  for w, p, s in zip(self._weights, probs.unbind(0), sigma.unbind(0)))
        all_reduce_sum_([var], self._axis)
        return self._recalibrate(mean, var)


class _Member(torch.nn.Module):
    """One member's parameters as buffers of an exportable module."""

    def __init__(self, params):
        super().__init__()
        self._names = list(params)
        for layer, ws in params.items():
            for name, t in ws.items():
                self.register_buffer(f"{layer}__{name}", t)

    def params(self):
        return {layer: {name: getattr(self, f"{layer}__{name}")
                        for name in ("w_mu", "w_sigma")}
                for layer in self._names}


class _Exported(torch.nn.Module):
    """``x -> (probs, sigma)`` of a session: the members' forwards, their
    mixture for an ensemble, and the recalibration."""

    def __init__(self, members: List, cfg: ModelConfig, ensemble: bool,
                 variance_scale: float, temperature: float, volumetric: bool):
        super().__init__()
        self.members = torch.nn.ModuleList(_Member(p) for p in members)
        self.cfg, self.ensemble, self.volumetric = cfg, ensemble, volumetric
        self.recalibrate = _make_recalibrate(variance_scale, temperature)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        outs = [_shaped_forward(m.params(), x, self.cfg, self.volumetric)
                for m in self.members]
        if self.ensemble:
            p, s = mixture([p for p, _ in outs], [s for _, s in outs])
        else:
            p, s = outs[0]
        return self.recalibrate(p, s)


def export_bundle(
    params,
    cfg: ModelConfig,
    out_dir: str,
    batch_size: int = 8,
    config_name: str = "",
    volumetric: bool = False,
    variance_scale: float = 1.0,
    temperature: float = 1.0,
) -> dict:
    """Write a serving bundle (after ``supernet_tpu/serving.py:465-543``):

    - ``model.pt2``: ``torch.export`` of the session's computation at
      ``batch_size``, in the StableHLO module's place, traced on the CPU,
      where every kernel op is its plain PyTorch composition, under the
      current activation dtype, with the recalibration and the ensemble
      mixture baked in; load it with ``torch.export.load(path).module()``;
    - ``params.npz``: ``checkpoint.save_params_npz``'s layout (``{layer}/
      w_mu``, ``{layer}/w_sigma``), a leading member axis for an ensemble;
    - ``export_meta.json``: the JAX package's keys and values, ``files``
      naming ``model.pt2``, ``ensemble_members`` for a list of members, and
      ``program`` saying what ``model.pt2`` holds.

    ``params`` is one parameter dict or a list of members. Returns the meta
    (also printed by ``cli export``). ``volumetric=True`` exports the 3-D
    family's forward (cubes in, cubes out)."""
    from supernet_tpu_torch.flops import forward_flops, forward_flops3d
    from supernet_tpu_torch.ops import get_act_dtype

    ensemble = isinstance(params, (list, tuple))
    members = [params_from_jax(p, "cpu") for p in (params if ensemble else [params])]
    os.makedirs(out_dir, exist_ok=True)
    module = _Exported(members, cfg, ensemble, variance_scale, temperature,
                       volumetric).eval()
    s, o = cfg.image_size, cfg.out_size
    rank = 3 if volumetric else 2
    in_shape = [batch_size, *([s] * rank), cfg.in_channels]
    with torch.no_grad():
        ep = torch.export.export(module, (torch.zeros(in_shape),))
    torch.export.save(ep, os.path.join(out_dir, "model.pt2"))
    if ensemble:
        np.savez(os.path.join(out_dir, "params.npz"), **{
            f"{layer}/{name}": np.stack([m[layer][name].numpy() for m in members])
            for layer, ws in members[0].items() for name in ws})
    else:
        save_params_npz(os.path.join(out_dir, "params.npz"), members[0])
    meta = {
        "config": config_name,
        "volumetric": bool(volumetric),
        "variance_scale": float(variance_scale),
        "temperature": float(temperature),
        "batch_size": batch_size,
        "input_shape": in_shape,
        "input_dtype": "float32",
        "output_shape": [batch_size, *([o] * rank), cfg.n_classes],
        "outputs": ["probs", "sigma"],
        "forward_gflops_per_image": round(
            (forward_flops3d(cfg, 1) if volumetric else forward_flops(cfg, 1)) / 1e9, 3),
        "param_count": int(sum(v.numel() for p in members[0].values()
                               for v in p.values())),
        "files": ["model.pt2", "params.npz"],
        "program": "torch.export of the plain PyTorch composition (no "
                   f"hand-written kernels), activations {str(get_act_dtype())[6:]}",
    }
    if ensemble:
        meta["ensemble_members"] = len(members)
    with open(os.path.join(out_dir, "export_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta
