"""The process-group plumbing the parallel modules share: which ranks a mesh
dim holds and where this rank sits on it, the device of a mesh, and the
collectives on lists of tensors (gradients, metrics, gathered outputs).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with one rank per
device; every function here needs an initialised process group and raises
without one: a mesh never falls back to one device on its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def require_group(what: str = "a device mesh") -> None:
    """Raise unless ``torch.distributed`` has a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialised process group: call "
            "parallel.initialize_from_env() under torchrun or with "
            "SUPERNET_COORDINATOR set, or torch.distributed.init_process_group"
        )


def default_device_type() -> str:
    """``"cuda"`` when the process group runs NCCL, else ``"cpu"``."""
    require_group()
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def in_mesh(mesh) -> bool:
    """Whether this rank is one of ``mesh``'s (a mesh may hold fewer ranks
    than the world: ``make_mesh_for_batch``)."""
    return mesh.get_coordinate() is not None


@dataclass(frozen=True)
class Axis:
    """One dim of a mesh as this rank sees it: the process group, the
    global ranks along the dim (this rank's row of the mesh), this rank's
    index among them and their count."""

    group: object
    ranks: tuple
    index: int
    size: int


def axis(mesh, name: str) -> Axis:
    """The dim ``name`` of ``mesh`` for this rank; raises when the rank is
    not in the mesh or the dim does not exist."""
    require_group()
    if not in_mesh(mesh):
        raise RuntimeError(
            f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}"
        )
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no dim {name!r} (dims {names})")
    d = names.index(name)
    coord = mesh.get_coordinate()
    idx = [slice(None) if i == d else c for i, c in enumerate(coord)]
    ranks = tuple(int(r) for r in mesh.mesh[tuple(idx)].reshape(-1).tolist())
    return Axis(mesh.get_group(name), ranks, coord[d], len(ranks))


def all_reduce_sum_(tensors: Sequence[Tensor], ax: Axis) -> None:
    """Sum ``tensors`` over ``ax`` in place, as one flat buffer (one
    collective for all of them). Every rank ends with the same bits."""
    tensors = list(tensors)
    if ax.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=ax.group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_reduce_(t: Tensor, ax: Axis, op) -> Tensor:
    """``t`` reduced over ``ax`` with ``op`` (MIN, MAX, SUM), in place."""
    if ax.size > 1:
        dist.all_reduce(t, op=op, group=ax.group)
    return t


def gather_rows(t: Tensor, counts: Sequence[int], ax: Axis, dim: int = 0) -> Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in rank order; rank i
    holds ``counts[i]`` entries there (counts may differ; the collective
    moves equal blocks padded to the largest)."""
    if ax.size == 1:
        return t
    top = max(counts)
    pad = list(t.shape)
    pad[dim] = top - t.shape[dim]
    block = torch.cat([t, t.new_zeros(pad)], dim=dim).contiguous()
    parts: List[Tensor] = [torch.empty_like(block) for _ in range(ax.size)]
    dist.all_gather(parts, block, group=ax.group)
    return torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)], dim=dim)


def broadcast_object(obj, mesh):
    """The mesh's first rank's ``obj`` (any picklable value) on every rank
    of ``mesh``."""
    for name in mesh.mesh_dim_names:
        ax = axis(mesh, name)
        if ax.size > 1:
            box = [obj]
            dist.broadcast_object_list(box, src=ax.ranks[0], group=ax.group)
            obj = box[0]
    return obj


@torch.no_grad()
def broadcast_(tensors: Sequence[Tensor], mesh) -> None:
    """Overwrite ``tensors`` with the values of the mesh's first rank: one
    broadcast per mesh dim, from index 0 of each (after dim d every rank
    holds the value of its dim-d index 0). A tensor on another device than
    the mesh's (Adam's step counters sit on the CPU) goes through a copy."""
    dev = mesh_device(mesh)
    for name in mesh.mesh_dim_names:
        ax = axis(mesh, name)
        if ax.size == 1:
            continue
        for t in tensors:
            buf = t if t.device == dev else t.to(dev)
            dist.broadcast(buf, src=ax.ranks[0], group=ax.group)
            if buf is not t:
                t.copy_(buf)
