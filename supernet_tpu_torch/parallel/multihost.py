"""Process bring-up and per-rank data loading: the counterpart of
``supernet_tpu/parallel/multihost.py``.

JAX drives every device of a host from one process and joins hosts with
``jax.distributed.initialize``. The port runs one process per device, so a
world of more than one rank exists on one host too; the bring-up is
``torch.distributed.init_process_group`` (NCCL for the card, gloo for the
CPU), and each process loads the rows of the global batch its mesh
coordinate names. The three things the JAX module supplies map so:

1. ``initialize_from_env`` joins the process group from the JAX package's
   variables (``SUPERNET_COORDINATOR`` host:port, ``SUPERNET_NUM_PROCESSES``,
   ``SUPERNET_PROCESS_ID``) or from torchrun's (``RANK``, ``WORLD_SIZE``,
   ``MASTER_ADDR``, ``MASTER_PORT``);
2. ``process_local_rows`` is the same pure function;
3. ``global_batch`` keeps this rank's rows as tensors on its device: the
   rows start at ``rank * len(rows)`` of the global batch (the mesh
   coordinate times the rows), the offset the data-parallel step keys its
   augmentation with.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from supernet_tpu_torch.parallel._comm import (
    default_device_type,
    in_mesh,
    mesh_device,
    require_group,
)

_SUPERNET_VARS = ("SUPERNET_NUM_PROCESSES", "SUPERNET_PROCESS_ID")
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_from_env(device="cuda") -> bool:
    """Join the process group the environment describes; ``True`` once
    joined (also when it already was), ``False`` (a no-op) when neither
    ``SUPERNET_COORDINATOR`` nor torchrun's variables are set.

    The backend is NCCL for a CUDA ``device`` (the process takes the card
    ``LOCAL_RANK`` names, else rank modulo the card count) and gloo for the
    CPU."""
    if dist.is_available() and dist.is_initialized():
        return True
    coord = os.environ.get("SUPERNET_COORDINATOR")
    if coord:
        missing = [k for k in _SUPERNET_VARS if k not in os.environ]
        if missing:
            # fail the whole job legibly: a bare KeyError on one worker
            # leaves the others waiting at the rendezvous
            raise ValueError(
                f"SUPERNET_COORDINATOR={coord} is set but {missing} "
                "is not; the three variables (SUPERNET_COORDINATOR, "
                "SUPERNET_NUM_PROCESSES, SUPERNET_PROCESS_ID) must be "
                "set together on every worker"
            )
        world = int(os.environ["SUPERNET_NUM_PROCESSES"])
        rank = int(os.environ["SUPERNET_PROCESS_ID"])
        init_method = f"tcp://{coord}"
    elif all(k in os.environ for k in _TORCHRUN_VARS):
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    else:
        return False
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        card = int(local) if local is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        kw["device_id"] = torch.device("cuda", card)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, world_size=world, rank=rank, **kw,
    )
    return True


def _rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    """The world size (1 without a process group)."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def process_local_rows(
    global_batch_size: int,
    process_index: int | None = None,
    process_count: int | None = None,
) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this process loads: contiguous
    equal blocks in rank order. Requires the global batch to divide by the
    process count."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    if global_batch_size % pc != 0:
        raise ValueError(
            f"global batch {global_batch_size} must divide over "
            f"{pc} processes"
        )
    per = global_batch_size // pc
    return pi * per, (pi + 1) * per


def global_mesh(axis_name: str = "data", device_type: str | None = None):
    """1-D mesh over every rank of the world, in rank order."""
    from torch.distributed.device_mesh import DeviceMesh

    require_group("global_mesh")
    return DeviceMesh(
        device_type or default_device_type(),
        torch.arange(dist.get_world_size()),
        mesh_dim_names=(axis_name,),
    )


def global_batch(mesh, *arrays, axis_name: str = "data"):
    """This rank's rows (the block ``process_local_rows`` assigned it) as
    tensors on the mesh's device; one tensor or a tuple. With one process
    per device the global batch is the rows times the mesh's ranks, which
    always divides over the mesh: the check of the JAX twin (rows times
    processes over devices) has nothing left to refuse."""
    require_group("global_batch")
    if not in_mesh(mesh):
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    dev = mesh_device(mesh)
    out = tuple(
        (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a))).to(dev)
        for a in arrays
    )
    return out[0] if len(out) == 1 else out


def multi_node() -> bool:
    """Whether the world spans more than one node (torchrun's
    ``LOCAL_WORLD_SIZE`` below ``WORLD_SIZE``): the counterpart of JAX's
    ``jax.process_count() > 1``. One process per device makes a world of
    several ranks on one node too, which keeps the single-host surface."""
    world = _world()
    return int(os.environ.get("LOCAL_WORLD_SIZE", world)) < world


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 (the parameters
    are replicated, so one copy of each file is the run's)."""
    return _rank() == 0
