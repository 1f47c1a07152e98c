"""Gloo worlds for the port's parallel tests: ``spawn`` runs a rank function
in N fresh processes that meet through a ``FileStore`` (no port to collide
across test workers), each with one torch thread, and returns what every
rank returned. ``world_of_one`` (and the ``mesh1`` fixture) opens a
one-rank world in the calling process. Imports neither JAX nor the JAX
package: the ranks run the port alone."""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 240  # a whole world; a rank that misses a collective fails it


def _entry(rank: int, world: int, store_path: str, out_dir: str, fn, args,
           init: bool) -> None:
    torch.set_num_threads(1)
    result = None
    try:
        if init:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store_path, world), rank=rank,
                world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S // 2),
            )
        result = ("ok", fn(rank, world, *args))
    except BaseException:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp_dir, *args, init: bool = True):
    """``[fn(rank, world, *args) for every rank]``, each in its own process
    of a gloo world of ``world`` ranks (``init=False``: ``fn`` joins the
    world itself). ``fn`` must be a module-level function. Raises with a
    rank's traceback when one failed, and when the world does not finish
    within ``TIMEOUT_S``."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.start_processes(
        _entry, args=(world, store, tmp_dir, fn, args, init), nprocs=world,
        join=False, start_method="spawn",
    )
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=TIMEOUT_S)
    try:
        while not ctx.join(timeout=5):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"a {world}-rank world did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        out.append(value)
    return out


@contextlib.contextmanager
def world_of_one(tmp_dir):
    """A one-rank gloo world in this process, destroyed on exit."""
    store = os.path.join(str(tmp_dir), "store1")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def mesh1(tmp_path):
    """A 1-D mesh over a one-rank gloo world opened in the test process
    (import the fixture into a test module to use it)."""
    from supernet_tpu_torch import parallel

    with world_of_one(tmp_path):
        yield parallel.make_mesh()


def to_numpy(tree):
    """Tensors of a nested dict / list as numpy arrays (for the parent)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ------------------------------------------------------------ rank functions
# Each runs on every rank of a spawned world and returns numpy values.


def _params(params_np):
    from supernet_tpu_torch.checkpoint import params_from_jax

    return params_from_jax(params_np, "cpu")


def _mesh(kind: str, world: int, n_data: int = 1):
    from supernet_tpu_torch import parallel

    if kind == "hybrid":
        return parallel.make_mesh2d(n_data, world // n_data)
    return parallel.make_mesh()


def rank_halo(rank, world, x_global, halo, weights):
    """``halo_exchange_rows`` of this rank's block of ``x_global`` and the
    gradient, with respect to the block, of the sum of the result times
    this rank's block of ``weights`` (laid out as the assembled output)."""
    from supernet_tpu_torch import parallel

    mesh = parallel.make_mesh()
    h = x_global.shape[1] // world
    x = torch.from_numpy(x_global[:, rank * h:(rank + 1) * h]).requires_grad_(True)
    y = parallel.halo_exchange_rows(x, mesh, halo=halo)
    w = torch.from_numpy(weights[:, rank * y.shape[1]:(rank + 1) * y.shape[1]])
    (g,) = torch.autograd.grad((y * w).sum(), x)
    return to_numpy((y, g))


def rank_block(rank, world, what, arrays):
    """``make_spatial_vconv`` (``what="vconv"``) or
    ``make_spatial_encoder_block`` (``"block"``) on this rank's rows of the
    two moments; weights replicated."""
    from supernet_tpu_torch import parallel

    mesh = parallel.make_mesh()
    mu, sg = arrays[0], arrays[1]
    h = mu.shape[1] // world
    loc = [torch.from_numpy(a[:, rank * h:(rank + 1) * h]) for a in (mu, sg)]
    ws = [torch.from_numpy(a) for a in arrays[2:]]
    f = (parallel.make_spatial_vconv if what == "vconv"
         else parallel.make_spatial_encoder_block)(mesh)
    return to_numpy(f(*loc, *ws))


def rank_forward(rank, world, kind, cfg, params_np, x, n_data=1, three_d=False):
    """The gathered ``(probs, sigma)`` of a sharded forward: ``kind`` is
    ``"dp"``, ``"spatial"`` or ``"hybrid"``."""
    from supernet_tpu_torch import parallel

    mesh = _mesh(kind, world, n_data)
    params = _params(params_np)
    if kind == "dp":
        f = parallel.make_sharded_forward(cfg, mesh)
    elif kind == "spatial":
        f = (parallel.make_spatial_forward3d if three_d
             else parallel.make_spatial_forward)(cfg, mesh)
    else:
        f = parallel.make_hybrid_forward(cfg, mesh)
    return to_numpy(f(params, torch.from_numpy(x)))


def rank_train(rank, world, kind, cfg, tc, params_np, xs, ys, n_data=1,
               three_d=False, with_pred=False):
    """``len(xs)`` sharded train steps from ``params_np``; returns the
    final parameters, the per-step metrics and (``with_pred``) the last
    step's gathered prediction. ``kind``: ``"dp"`` (the rows of
    ``shard_batch``), ``"spatial"`` or ``"hybrid"`` (the whole batch)."""
    from supernet_tpu_torch import parallel
    from supernet_tpu_torch.train import create_train_state

    mesh = _mesh(kind, world, n_data)
    state, _ = create_train_state(params_np, tc, "cpu")
    state = parallel.replicate(mesh, state)
    if kind == "dp":
        step = (parallel.make_dp_train_step3d(cfg, tc, mesh) if three_d
                else parallel.make_sharded_train_step(cfg, tc, mesh, with_pred=with_pred))
    elif kind == "spatial":
        step = (parallel.make_spatial_train_step3d if three_d
                else parallel.make_spatial_train_step)(cfg, tc, mesh)
    else:
        step = (parallel.make_hybrid_train_step3d if three_d
                else parallel.make_hybrid_train_step)(cfg, tc, mesh)
    metrics, pred = [], None
    for x, y in zip(xs, ys):
        if kind == "dp":
            x, y = parallel.shard_batch(mesh, x, y)
        out = step(state, x, y)
        state, m = out[0], out[1]
        if with_pred:
            pred = out[2]
        metrics.append([float(v) for v in m])
    return to_numpy({"params": state.params, "metrics": metrics, "pred": pred,
                     "step": state.step})


def rank_env_bringup(rank, world, env):
    """``initialize_from_env`` from ``env`` (``{RANK}`` in a value is this
    rank), then one all-reduce, the global mesh and this rank's rows."""
    import os

    from supernet_tpu_torch import parallel

    for k, v in env.items():
        os.environ[k] = v.replace("{RANK}", str(rank))
    assert parallel.initialize_from_env("cpu") is True
    assert parallel.initialize_from_env("cpu") is True  # joined already
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    mesh = parallel.global_mesh()
    lo, hi = parallel.process_local_rows(4 * world)
    rows = parallel.global_batch(mesh, torch.arange(4 * world)[lo:hi])
    return {"sum": float(t), "mesh": mesh.mesh.tolist(), "rows": rows.tolist()}


def rank_eval(rank, world, runner, exp, params_np, x, y, out_dir):
    """An evaluation runner (``evaluate.run_testing`` / ``run_adversarial``)
    on a ``make_mesh_for_batch`` mesh; each rank writes under its own
    directory."""
    import os

    from supernet_tpu_torch import evaluate, parallel
    from supernet_tpu_torch.data import PickleDataset

    mesh = parallel.make_mesh_for_batch(exp.train.batch_size)
    res = getattr(evaluate, runner)(exp, params_np, PickleDataset(x, y, 1),
                                    out_dir=os.path.join(out_dir, f"r{rank}"),
                                    mesh=mesh, device="cpu")
    return {k: v for k, v in res.items() if isinstance(v, (int, float))}


def rank_trainer(rank, world, exp, x, y, out_dir):
    """``Trainer`` on ``make_mesh_for_batch``: returns what this rank
    trained and the files it wrote (a rank outside the mesh trains and
    writes nothing); plus the divisibility guard on the whole world."""
    import os

    from supernet_tpu_torch import parallel
    from supernet_tpu_torch.data import PickleDataset
    from supernet_tpu_torch.trainer import Trainer

    guard = None
    try:
        Trainer(exp, PickleDataset(x, y, 1), mesh=parallel.make_mesh(), device="cpu")
    except ValueError as e:
        guard = str(e)
    mesh = parallel.make_mesh_for_batch(exp.train.batch_size)
    d = os.path.join(out_dir, "run")
    tr = Trainer(exp, PickleDataset(x, y, 1), PickleDataset(x[:4], y[:4], 1),
                 out_dir=d, mesh=mesh, device="cpu")
    state = tr.run(epochs=1, log=lambda *_: None)
    dist.barrier()
    files = sorted(os.listdir(d)) if rank == 0 and os.path.isdir(d) else None
    return to_numpy({"guard": guard, "mesh": int(mesh.mesh.numel()),
                     "params": None if state is None else state.params,
                     "history": tr.history, "files": files})


def rank_session(rank, world, cfg, members_np, x, batch_size, volumetric=False,
                 shard="batch"):
    """``InferenceSession`` (one member) or ``EnsembleSession`` (several) on
    a mesh over the world: the answer every rank gets."""
    from supernet_tpu_torch import parallel, serving

    mesh = parallel.make_mesh()
    if len(members_np) == 1:
        sess = serving.InferenceSession(members_np[0], cfg, batch_size, device="cpu",
                                        volumetric=volumetric, mesh=mesh, shard=shard)
    else:
        sess = serving.EnsembleSession(members_np, cfg, batch_size, device="cpu",
                                       volumetric=volumetric, mesh=mesh)
    return sess.predict(x)


def rank_ensemble_trainer(rank, world, exp, k_members, x, y, out_dir):
    """``EnsembleTrainer`` with the member axis sharded over the world (K
    padded to it): the members' parameters and histories on every rank."""
    import os

    from supernet_tpu_torch import ensemble, parallel
    from supernet_tpu_torch.data import PickleDataset

    tr = ensemble.EnsembleTrainer(exp, k_members, PickleDataset(x, y, 1),
                                  out_dir=os.path.join(out_dir, "ens"), mesh=parallel.make_mesh(),
                                  track_curves=False, device="cpu")
    state = tr.run(epochs=1, log=lambda *_: None)
    return to_numpy({"params": state.params, "histories": tr.histories,
                     "n_train": tr.n_train})


def rank_ensemble_step(rank, world, cfg, tc, members_np, xs, ys, act_dtype="float32"):
    """``make_ensemble_train_step(mesh=)`` over the world: each rank trains
    its block of the K members (K divisible by the world), every rank ends
    with every member's parameters; returns them and the losses per step."""
    from supernet_tpu_torch import ops, parallel, train

    ops.set_act_dtype(act_dtype)
    try:
        mesh = parallel.make_mesh()
        state = train.stack_trees([train.create_train_state(p, tc, "cpu")[0]
                                   for p in members_np])
        step = train.make_ensemble_train_step(cfg, tc, mesh=mesh)
        losses = []
        for x, y in zip(xs, ys):
            state, m = step(state, x, y)
            losses.append(m.loss.tolist())
        return to_numpy({"params": state.params, "losses": losses})
    finally:
        ops.set_act_dtype("float32")


def rank_fold(rank, world, kind, cfg, tc, params_np, x, y, n_data=1, three_d=False):
    """The sharded forward of ``x`` and one sharded train step on ``(x, y)``
    under ``glue_fold="none"`` and under ``"fold"`` (``kind``: ``"spatial"``
    or ``"hybrid"``): ``{mode: {"out": (probs, sigma), "params": ...,
    "metrics": [...]}}``."""
    from supernet_tpu_torch import parallel
    from supernet_tpu_torch.ops.moments import lowering
    from supernet_tpu_torch.parallel.spatial import make_rows_forward
    from supernet_tpu_torch.train import create_train_state

    mesh = _mesh(kind, world, n_data)
    if kind == "hybrid":
        # the volumetric forward on a (data, space) mesh has no named maker
        fwd = make_rows_forward(cfg, mesh, "space", "data", three_d)
        step = (parallel.make_hybrid_train_step3d if three_d
                else parallel.make_hybrid_train_step)(cfg, tc, mesh)
    else:
        fwd = (parallel.make_spatial_forward3d if three_d
               else parallel.make_spatial_forward)(cfg, mesh)
        step = (parallel.make_spatial_train_step3d if three_d
                else parallel.make_spatial_train_step)(cfg, tc, mesh)
    out = {}
    for mode in ("none", "fold"):
        with lowering(glue_fold=mode):
            pred = fwd(_params(params_np), torch.from_numpy(x))
            state, _ = create_train_state(params_np, tc, "cpu")
            state, m = step(state, x, y)
        out[mode] = to_numpy({"out": pred, "params": state.params,
                              "metrics": [float(v) for v in m]})
    return out
