"""Data-parallel training and inference over a mesh of ranks: the
counterpart of ``supernet_tpu/parallel/data_parallel.py``.

JAX jits the step over a ``Mesh`` and lets GSPMD insert the gradient psum.
The port runs one process per device (``torch.distributed``: NCCL on the
card, gloo on the CPU) and places the collectives by hand:

- the mesh is a 1-D ``DeviceMesh`` whose dim is named ``data``;
- each rank holds the rows of the global batch its coordinate names
  (``shard_batch``), parameters and Adam state are replicated
  (``replicate`` broadcasts them from the mesh's first rank);
- the step is the JAX ``shard_map`` branch: value-and-grad of the loss on
  the rank's rows, then one ``all_reduce`` of every gradient, divided by
  the mesh size (the mean of equal per-shard means is the global mean).
  Every rank then clips and applies the same bits, so the replicas stay
  equal bit for bit. ``use_shard_map`` is kept for the JAX signature; both
  of its values are this path.

Augmentation is keyed by the global image index (the shard's offset), and
the adversarial examples clip to the global batch's range (``all_reduce``
MIN / MAX, JAX's ``pmin`` / ``pmax``).

Inference (``make_sharded_forward``) takes the whole batch, runs the
rank's rows, and gathers the outputs, so every rank holds the answer a
single device gives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from supernet_tpu_torch.configs import ModelConfig, TrainConfig
from supernet_tpu_torch.parallel._comm import (
    Axis,
    all_reduce_,
    all_reduce_sum_,
    axis,
    broadcast_,
    default_device_type,
    gather_rows,
    mesh_device,
    require_group,
)
from supernet_tpu_torch.train import (
    StepMetrics,
    TrainState,
    _accuracy,
    _to_device,
    _update,
    ensure_one_hot,
    leaves,
    maybe_augment,
    training_loss,
)

Tensor = torch.Tensor


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    axis_name: str = "data",
    device_type: Optional[str] = None,
):
    """A 1-D mesh over the batch axis: the ranks ``devices`` (default every
    rank of the world), the first ``n_devices`` of them when given. Every
    rank of the world must call it (the mesh's process groups are made
    collectively)."""
    from torch.distributed.device_mesh import DeviceMesh

    require_group("make_mesh")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return DeviceMesh(
        device_type or default_device_type(), torch.tensor(ranks),
        mesh_dim_names=(axis_name,),
    )


def make_mesh_for_batch(batch_size: int, axis_name: str = "data"):
    """1-D mesh over the largest rank count that divides ``batch_size``
    (the first ranks of the world; the others sit the mesh out)."""
    require_group("make_mesh_for_batch")
    n = dist.get_world_size()
    while n > 1 and batch_size % n != 0:
        n -= 1
    return make_mesh(n, axis_name=axis_name)


def _rows(n: int, ax: Axis) -> slice:
    if n % ax.size != 0:
        raise ValueError(
            f"batch {n} must divide over the {ax.size}-rank mesh"
        )
    per = n // ax.size
    return slice(ax.index * per, (ax.index + 1) * per)


def shard_batch(mesh, *arrays, axis_name: str = "data"):
    """This rank's rows of each global array (the batch divides over the
    mesh), as tensors on the mesh's device; one tensor or a tuple."""
    ax = axis(mesh, axis_name)
    dev = mesh_device(mesh)
    out = tuple(torch.as_tensor(a[_rows(len(a), ax)]).to(dev) for a in arrays)
    return out[0] if len(out) == 1 else out


def replicate(mesh, tree):
    """Give every rank of ``mesh`` the first rank's values of ``tree``, in
    place: a parameter dict, a list of tensors, or a ``TrainState``
    (parameters, Adam moments and step counters, the state's ``step``)."""
    if isinstance(tree, TrainState):
        tensors = leaves(tree.params) + [
            v for st in tree.opt_state.state.values() for v in st.values()
            if isinstance(v, Tensor)
        ]
        step = torch.tensor([tree.step], dtype=torch.int64)
        broadcast_(tensors + [step], mesh)
        tree.step = int(step)
        return tree
    if isinstance(tree, dict):
        broadcast_(leaves(tree), mesh)
        return tree
    broadcast_(list(tree), mesh)
    return tree


def pad_rows(x: Tensor, n: int) -> Tensor:
    """``x`` padded along dim 0 to a multiple of ``n`` by repeating its last
    row (the JAX evaluation's ``_pad_batch``: repeats keep the batch's
    min and max)."""
    pad = -len(x) % n
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def sharded_apply(fn, mesh, axis_name: str = "data", n_sharded: int = 1):
    """``g(*batch, *rest) -> outputs`` running ``fn`` on this rank's rows of
    the first ``n_sharded`` arguments (whole batches of one length, padded
    to the mesh, see ``pad_rows``) with ``rest`` passed as they are, and
    gathering every tensor output along dim 0, cut back to the batch: every
    rank holds the single-device answer."""
    ax = axis(mesh, axis_name)

    def g(*args):
        b = len(args[0])
        per = -(-b // ax.size)
        rows = slice(ax.index * per, (ax.index + 1) * per)
        batch = [pad_rows(a, ax.size)[rows] for a in args[:n_sharded]]
        out = fn(*batch, *args[n_sharded:])
        single = isinstance(out, Tensor)
        outs = tuple(gather_rows(o, [per] * ax.size, ax)[:b]
                     for o in ((out,) if single else out))
        return outs[0] if single else outs

    return g


def make_sharded_forward(cfg: ModelConfig, mesh, axis_name: str = "data"):
    """Batch-sharded inference: ``f(params, x) -> (probs, sigma)`` for the
    whole batch ``x`` on every rank of the mesh (any batch size: the tail
    is padded and cut); each rank runs its rows, the outputs are gathered."""
    from supernet_tpu_torch.models import forward

    run = sharded_apply(lambda xs, p: forward(p, xs, cfg), mesh, axis_name)

    @torch.no_grad()
    def f(params, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=mesh_device(mesh))
        return run(x, params)

    return f


def global_range(x: Tensor, ax: Axis):
    """``(min, max)`` of ``x`` over every rank of ``ax`` (0-dim tensors)."""
    lo = all_reduce_(x.detach().min().reshape(1), ax, dist.ReduceOp.MIN)
    hi = all_reduce_(x.detach().max().reshape(1), ax, dist.ReduceOp.MAX)
    return lo[0], hi[0]


def mean_gradients(params, ax: Axis) -> None:
    """Average every parameter's ``.grad`` over ``ax``: one ``all_reduce``
    of the flat buffer, divided by the rank count (gloo has no AVG)."""
    grads = [t.grad for t in leaves(params)]
    all_reduce_sum_(grads, ax)
    if ax.size > 1:
        for g in grads:
            g.div_(ax.size)


def _mean_metrics(values, ax: Axis):
    v = torch.stack([t.detach().float().reshape(()) for t in values])
    all_reduce_sum_([v], ax)
    return v / ax.size


def make_sharded_train_step(
    cfg: ModelConfig,
    tc: TrainConfig,
    mesh,
    axis_name: str = "data",
    use_shard_map: bool = False,
    with_pred: bool = False,
):
    """Data-parallel train step over ``mesh``: ``step(state, x, y) ->
    (state, metrics)`` with ``x``, ``y`` this rank's rows (``shard_batch`` /
    ``global_batch``) and ``state`` replicated; the state is updated in
    place on every rank. ``with_pred`` also returns the argmax [B, H*W] of
    the whole batch, gathered from the ranks. Metrics are the global
    batch's: loss, NLL and accuracy averaged over the ranks, the KL (a
    function of the replicated parameters) taken as it is."""
    del use_shard_map  # one path: the per-shard value_and_grad + all_reduce
    ax = axis(mesh, axis_name)

    def step(state: TrainState, x, y):
        x, y = _to_device(state.params, x, y)
        x, y = maybe_augment(state.step, x, y, cfg, tc, index_offset=ax.index * len(x))
        y = ensure_one_hot(y, cfg.n_classes)
        x_range = None if tc.adversarial_training == "none" else global_range(x, ax)
        state.opt_state.zero_grad(set_to_none=True)
        loss, (nll, kl, probs, _) = training_loss(state.params, x, y, cfg, tc, x_range)
        loss.backward()
        mean_gradients(state.params, ax)
        _update(state, tc)
        pred, acc = _accuracy(probs, y)
        loss_g, nll_g, acc_g = _mean_metrics((loss, nll, acc), ax)
        m = StepMetrics(loss_g, nll_g, kl, acc_g)
        if not with_pred:
            return state, m
        return state, m, gather_rows(pred, [len(pred)] * ax.size, ax)

    return step


def make_dp_train_step3d(cfg: ModelConfig, tc: TrainConfig, mesh, axis_name: str = "data"):
    """Batch-sharded volumetric train step: ``step(state, x, y) -> (state,
    metrics)`` with ``x`` [b, S, S, S, C] and ``y`` [b, o, o, o] this rank's
    volumes, the 2-D recipe over the shared 3-D step body
    (``train3d._train_step3d``; augmentation keyed by the global volume
    index, the noise field apart: it is drawn per shard)."""
    from supernet_tpu_torch.train3d import _train_step3d

    ax = axis(mesh, axis_name)

    def reduce(state: TrainState) -> None:
        mean_gradients(state.params, ax)

    def step(state: TrainState, x, y):
        state, m = _train_step3d(state, x, y, cfg, tc, index_offset=ax.index * len(x),
                                 reduce=reduce)
        loss, nll, acc = _mean_metrics((m.loss, m.nll, m.accuracy), ax)
        return state, StepMetrics(loss, nll, m.kl, acc)

    return step
