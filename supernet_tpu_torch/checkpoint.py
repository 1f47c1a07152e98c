"""Parameters and train states in and out of the port: the counterpart of
``supernet_tpu/checkpoint.py``.

A parameter dict is ``{layer: {"w_mu": [k,k,Cin,Cout] (HWIO), "w_sigma":
[Cout]}}``, in the JAX package's layout.

- npz: the layout of ``supernet_tpu/checkpoint.py:save_params_npz`` (keys
  ``{layer}/w_mu`` and ``{layer}/w_sigma``), so the ``params.npz`` of a JAX
  ``export_bundle`` loads directly.
- train states: ``root/epoch_{N}/state.pt`` (the reference's ``epoch_{N}``
  directory scheme; Orbax in the JAX package, ``torch.save`` here) holding
  the parameters, Adam's ``exp_avg`` / ``exp_avg_sq`` / ``step`` and the
  state's step counter as CPU tensors. A file is written under a temporary
  name and renamed, so ``latest_epoch`` never sees a half-written one.
  ``AsyncEpochCheckpointer`` copies the state to the host before it returns
  (the train step updates the parameters in place) and writes on a
  background thread.
- ``state_from_jax`` / ``state_to_jax`` carry a whole train state (optax's
  ``ScaleByAdamState.mu/nu/count``) between the two packages.
- Keras H5: ``import_keras_h5`` / ``export_keras_h5`` read and write the
  reference's ``vdp_UNET_model.weights.h5`` layout (``h5py`` is imported
  when they are called).
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from supernet_tpu_torch.configs import ModelConfig, TrainConfig

Params = Dict[str, Dict[str, torch.Tensor]]
STATE_FILE = "state.pt"


def _tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        t = v.detach().to(device=device, dtype=torch.float32, copy=True)
    else:
        t = torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
    return t.contiguous()


def params_from_jax(params_np, device="cuda") -> Params:
    """Turn a JAX-layout parameter dict (numpy arrays, JAX arrays or
    tensors on any device) into fresh contiguous float32 tensors on
    ``device``; the caller's arrays are never aliased."""
    return {
        layer: {name: _tensor(v, device) for name, v in ws.items()}
        for layer, ws in params_np.items()
    }


def save_params_npz(path: str, params: Params) -> None:
    """Flat npz dump with keys ``{layer}/{w_mu|w_sigma}``."""
    flat = {
        f"{layer}/{name}": v.detach().cpu().numpy()
        for layer, ws in params.items()
        for name, v in ws.items()
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str, device="cuda") -> Params:
    """Read a :func:`save_params_npz` (or JAX ``save_params_npz``) file onto
    ``device``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as f:
        for key in f.files:
            layer, name = key.rsplit("/", 1)
            out.setdefault(layer, {})[name] = f[key]
    return params_from_jax(out, device)


# ------------------------------------------------------------- train states


def _adam_slot(opt: torch.optim.Adam, p: torch.Tensor) -> dict:
    """Adam's state of ``p``, created as the optimizer's first step would
    (zero moments, a float32 host scalar ``step``) if it has taken none."""
    st = opt.state[p]
    if not st:
        st["step"] = torch.tensor(0.0, dtype=torch.get_default_dtype())
        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return st


def snapshot_state(state) -> dict:
    """A host copy of a ``train.TrainState``: nested dicts of fresh CPU
    tensors (parameters and Adam moments by layer and name) and the two
    step counters. Later in-place updates of the state do not reach it."""

    def cpu(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    snap = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}, "adam_step": 0.0,
            "step": int(state.step)}
    for layer, ws in state.params.items():
        for key in ("params", "exp_avg", "exp_avg_sq"):
            snap[key][layer] = {}
        for name, p in ws.items():
            st = state.opt_state.state.get(p, {})
            snap["params"][layer][name] = cpu(p)
            for key in ("exp_avg", "exp_avg_sq"):
                snap[key][layer][name] = (
                    cpu(st[key]) if st else torch.zeros(p.shape, dtype=p.dtype)
                )
            if st:
                snap["adam_step"] = float(st["step"])
    return snap


def state_from_snapshot(snap: dict, tc: TrainConfig, device="cuda"):
    """A fresh ``train.TrainState`` on ``device`` holding ``snap``'s
    parameters, Adam moments and step counters."""
    from supernet_tpu_torch.train import create_train_state

    state, opt = create_train_state(snap["params"], tc, device)
    with torch.no_grad():
        for layer, ws in state.params.items():
            for name, p in ws.items():
                st = _adam_slot(opt, p)
                st["step"].fill_(float(snap["adam_step"]))
                for key in ("exp_avg", "exp_avg_sq"):
                    st[key].copy_(_tensor(snap[key][layer][name], device))
    state.step = int(snap["step"])
    return state


def _epoch_dir(root: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(root), f"epoch_{epoch}")


def _write_snapshot(root: str, epoch: int, snap: dict) -> str:
    d = _epoch_dir(root, epoch)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, STATE_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(snap, tmp)
    os.replace(tmp, path)  # atomic: a reader never sees half a file
    return path


def save_state(root: str, epoch: int, state) -> str:
    """Save a TrainState under ``root/epoch_{N}/state.pt``."""
    return _write_snapshot(root, epoch, snapshot_state(state))


def restore_state(root: str, epoch: int, tc: TrainConfig, device="cuda"):
    """Restore a TrainState saved by ``save_state`` or the async writer as
    a fresh state (and optimizer) on ``device``."""
    path = os.path.join(_epoch_dir(root, epoch), STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    snap = torch.load(path, map_location="cpu", weights_only=True)
    return state_from_snapshot(snap, tc, device)


def resolve_checkpoint(src: str) -> Tuple[str, Optional[int]]:
    """(root, epoch) from a checkpoint path: ``.../epoch_{N}`` names that
    exact epoch (the reference's ``saved_model_epochs`` selector); anything
    else is a root whose latest epoch is picked. ``epoch`` is None when the
    root holds no checkpoints."""
    m = re.fullmatch(r"epoch_(\d+)", os.path.basename(os.path.normpath(src)))
    if m:
        return os.path.dirname(os.path.normpath(src)), int(m.group(1))
    return src, latest_epoch(src)


def latest_epoch(root: str) -> Optional[int]:
    """Highest N with a finished ``epoch_{N}/state.pt`` under root, or
    None. A directory whose file is still being written (it has a temporary
    name until then) does not count."""
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m and os.path.isfile(os.path.join(root, name, STATE_FILE)):
            n = int(m.group(1))
            best = n if best is None or n > best else best
    return best


class AsyncEpochCheckpointer:
    """Non-blocking per-epoch checkpointing: ``save`` copies the state to
    the host (that part blocks: the next train step overwrites the
    parameters in place) and a background thread writes the file while the
    next epoch trains; ``wait()`` drains, ``close()`` joins the thread.
    With ``keep``, only the newest ``keep`` checkpoints of this writer stay
    on disk. The directory scheme is ``save_state``'s."""

    def __init__(self, root: str, keep: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.keep = keep
        self._saved: List[int] = []
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    _write_snapshot(self.root, *item)
            except Exception as e:  # kept for wait() to raise
                self._error = e
            finally:
                self._queue.task_done()

    def save(self, epoch: int, state) -> None:
        """Queue ``state`` (a TrainState, or a ``snapshot_state`` dict
        already on the host) for ``root/epoch_{epoch}``."""
        snap = state if isinstance(state, dict) else snapshot_state(state)
        self._queue.put((epoch, snap))
        self._saved.append(epoch)
        if self.keep is not None and len(self._saved) > self.keep:
            victim = self._saved.pop(0)
            self.wait()
            shutil.rmtree(_epoch_dir(self.root, victim), ignore_errors=True)

    def restore(self, epoch: int, tc: TrainConfig, device="cuda"):
        self.wait()
        return restore_state(self.root, epoch, tc, device)

    def wait(self) -> None:
        self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        if self._thread.is_alive():
            self._queue.put(None)
            self._thread.join()


# ------------------------------------------------- states across packages


def state_from_jax(params, mu, nu, count, tc: TrainConfig, device="cuda"):
    """A port ``TrainState`` from the pieces of a JAX one: ``params`` and
    the optax ``ScaleByAdamState``'s ``mu`` and ``nu`` as JAX-layout dicts
    (numpy or JAX arrays), its ``count`` (which is also the JAX state's
    ``step``)."""
    snap = {
        "params": params_from_jax(params, "cpu"),
        "exp_avg": params_from_jax(mu, "cpu"),
        "exp_avg_sq": params_from_jax(nu, "cpu"),
        "adam_step": float(int(count)),
        "step": int(count),
    }
    return state_from_snapshot(snap, tc, device)


def state_to_jax(state):
    """``(params, mu, nu, count)`` of a port ``TrainState`` as numpy dicts
    in the JAX layout: what ``state_from_jax`` takes."""
    snap = snapshot_state(state)

    def as_np(tree):
        return {layer: {name: t.numpy() for name, t in ws.items()}
                for layer, ws in tree.items()}

    return (as_np(snap["params"]), as_np(snap["exp_avg"]),
            as_np(snap["exp_avg_sq"]), int(snap["adam_step"]))


# ---------------------------------------------------------------- keras h5


def _keras_layer_name(index: int) -> str:
    """Keras auto-name of the i-th conv layer in creation order."""
    if index == 0:
        return "my_conv_input"
    if index == 1:
        return "my_conv_intermediate"
    return f"my_conv_intermediate_{index - 1}"


def _h5_weight_map(f) -> Dict[str, np.ndarray]:
    """Flatten an H5 weights file to {layer_name/weight_name: array}."""
    import h5py

    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    f.visititems(visit)
    return out


def import_keras_h5(path: str, cfg: ModelConfig, device="cuda") -> Params:
    """Read a reference ``vdp_UNET_model.weights.h5`` into a parameter dict
    on ``device``. Matching is by Keras creation-order layer name and
    weight suffix (``w_mu1``/``w_sigma1`` on the input conv), with a shape
    check against ``layer_names(cfg)``."""
    import h5py

    from supernet_tpu_torch.models import layer_names

    params: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        flat = _h5_weight_map(f)
    for i, (name, k, cin, cout) in enumerate(layer_names(cfg)):
        klayer = _keras_layer_name(i)
        suffix = "1" if i == 0 else ""
        found = {}
        for w in ("w_mu", "w_sigma"):
            keys = [key for key in flat
                    if klayer in key.split("/") and f"{w}{suffix}" in key]
            if len(keys) != 1:
                raise KeyError(
                    f"layer {name} ({klayer}): expected exactly one "
                    f"{w}{suffix}, found {keys}"
                )
            found[w] = flat[keys[0]].astype(np.float32)
        if found["w_mu"].shape != (k, k, cin, cout) or found["w_sigma"].shape != (cout,):
            raise ValueError(
                f"layer {name}: shape mismatch, h5 has "
                f"{found['w_mu'].shape}/{found['w_sigma'].shape}, model "
                f"expects {(k, k, cin, cout)}/{(cout,)}"
            )
        params[name] = found
    return params_from_jax(params, device)


def export_keras_h5(path: str, params: Params, cfg: ModelConfig) -> None:
    """Write a parameter dict in the reference's H5 layout (Keras-2 style
    groups ``{layer}/{layer}/{weight}:0`` plus the layer_names /
    weight_names attributes)."""
    import h5py

    from supernet_tpu_torch.models import layer_names

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        layer_list: List[bytes] = []
        for i, (name, _, _, _) in enumerate(layer_names(cfg)):
            klayer = _keras_layer_name(i)
            layer_list.append(klayer.encode())
            suffix = "1" if i == 0 else ""
            g = f.create_group(klayer)
            wnames = []
            for w in ("w_mu", "w_sigma"):
                wkey = f"{w}{suffix}:0"
                g.create_dataset(
                    wkey,
                    data=params[name][w].detach().cpu().numpy().astype(np.float32),
                )
                wnames.append(f"{klayer}/{wkey}".encode())
            g.attrs["weight_names"] = wnames
        f.attrs["layer_names"] = layer_list
