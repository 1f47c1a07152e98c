"""Hybrid data x spatial partitioning over a 2-D mesh: the counterpart of
``supernet_tpu/parallel/hybrid.py``.

One ``DeviceMesh`` with a ``data`` dim and a ``space`` dim: the batch is
split over ``data`` and each image's H (each volume's D) over ``space``,
in the same step. The row bookkeeping is ``parallel.spatial``'s along
``space``; the weight gradient is summed over ``space`` (the shards of one
image) and averaged over ``data`` (the shards of the batch), which is the
all-reduce over both dims GSPMD derives in JAX. ``space`` is the minor dim
(adjacent ranks), because its halo exchanges run once per window op while
the gradient reduction runs once per step. H need not divide ``n_space``:
the row split is as even as it can be and may leave a rank a shorter block.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from supernet_tpu_torch.configs import ModelConfig, TrainConfig
from supernet_tpu_torch.parallel._comm import default_device_type, require_group
from supernet_tpu_torch.parallel.spatial import make_rows_forward, make_rows_step

_AXES: Tuple[str, str] = ("data", "space")


def make_mesh2d(
    n_data: int,
    n_space: int,
    axis_names: Tuple[str, str] = _AXES,
    device_type: str | None = None,
):
    """A (n_data, n_space) mesh over the first ``n_data * n_space`` ranks,
    ``axis_names[1]`` (space) the minor dim. Every rank of the world must
    call it."""
    from torch.distributed.device_mesh import DeviceMesh

    require_group("make_mesh2d")
    n = n_data * n_space
    world = dist.get_world_size()
    if world < n:
        raise ValueError(
            f"mesh needs {n_data}x{n_space}={n} devices, {world} available"
        )
    return DeviceMesh(
        device_type or default_device_type(),
        torch.arange(n).reshape(n_data, n_space),
        mesh_dim_names=tuple(axis_names),
    )


def make_hybrid_train_step(
    cfg: ModelConfig,
    tc: TrainConfig,
    mesh,
    data_axis: str = "data",
    space_axis: str = "space",
):
    """The 2-D model's training step on a (data, space) mesh: ``step(state,
    x, y) -> (state, metrics)`` for the whole batch on every rank (batch %
    n_data == 0; H any size), the state replicated and updated in place;
    the signature and semantics of ``train.make_train_step``."""
    return make_rows_step(cfg, tc, mesh, space_axis, data_axis)


def make_hybrid_forward(
    cfg: ModelConfig,
    mesh,
    data_axis: str = "data",
    space_axis: str = "space",
):
    """Inference twin of ``make_hybrid_train_step``: ``f(params, x) ->
    (probs, sigma)`` for the whole batch, the same on every rank, flattened
    like ``models.forward``."""
    return make_rows_forward(cfg, mesh, space_axis, data_axis)


def make_hybrid_train_step3d(
    cfg: ModelConfig,
    tc: TrainConfig,
    mesh,
    data_axis: str = "data",
    space_axis: str = "space",
):
    """Volumetric training step on a (data, space) mesh: the batch over
    ``data_axis``, each volume's D axis over ``space_axis``; the step body
    of ``train3d._train_step3d``."""
    return make_rows_step(cfg, tc, mesh, space_axis, data_axis, three_d=True)
