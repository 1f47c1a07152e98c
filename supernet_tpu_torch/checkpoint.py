"""Parameters in and out of the port, in the JAX package's layout.

A parameter dict is ``{layer: {"w_mu": [k,k,Cin,Cout] (HWIO), "w_sigma":
[Cout]}}``. The npz layout is that of ``supernet_tpu/checkpoint.py:
save_params_npz`` (keys ``{layer}/w_mu`` and ``{layer}/w_sigma``), so the
``params.npz`` of a JAX ``export_bundle`` loads directly.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

Params = Dict[str, Dict[str, torch.Tensor]]


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
