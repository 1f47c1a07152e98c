"""The port's InferenceSession (supernet_tpu_torch/serving.py) on the CPU
against supernet_tpu.serving.InferenceSession on the same parameters, and
the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu import serving as jserving  # noqa: E402
from supernet_tpu.configs import HIPPOCAMPUS  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import serving  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dataclasses.replace(HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4)
ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return jinit(jax.random.PRNGKey(3), CFG)


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, 32, 32, 1)).astype(np.float32)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize("n", [4, 7, 0])
def test_session_matches_jax_session(params, n):
    """An exact batch, a chunked request with a padded tail (7 at batch 4),
    and the empty request."""
    sess = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    assert sess.warmup() is sess
    x = _x(n, seed=n)
    got = sess.predict(x)
    assert got[0].shape == (n, 22, 22, 3)
    _assert_same(got, jserving.InferenceSession(params, CFG, batch_size=4).predict(x))


def test_padding_rows_never_leak(params):
    sess = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    x = _x(7, seed=1)
    p, s = sess.predict(x)
    tail_p, tail_s = sess.predict(np.concatenate([x[4:7], x[6:7]]))
    np.testing.assert_array_equal(p[4:7], tail_p[:3])
    np.testing.assert_array_equal(s[4:7], tail_s[:3])


def test_request_of_45_equals_chunk_by_chunk(params):
    """``predict`` enqueues every chunk and copies each into its rows of
    the answer: a request of 45 images at batch 20 gives the bits of running
    the three chunks (the last padded with its final image) one by one."""
    sess = serving.InferenceSession(params, CFG, batch_size=20, device="cpu")
    x = _x(45, seed=5)
    got = sess.predict(x)
    for g, w in zip(got, _chunk_by_chunk(sess, x)):
        assert g.shape == (45, 22, 22, 3)
        np.testing.assert_array_equal(g, w)


BS = 4


def _chunk_by_chunk(sess, x):
    """The answers of ``x`` run chunk by chunk through ``sess._forward``,
    the last chunk padded with its final row, each cut to its real rows."""
    n, bs = len(x), sess.batch_size
    outs = [], []
    with torch.inference_mode():
        for i in range(0, n, bs):
            chunk = x[i : i + bs]
            b = len(chunk)
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - b, axis=0)])
            for out, a in zip(outs, sess._forward(torch.from_numpy(chunk))):
                out.append(a[:b].numpy())
    empty = np.zeros((0,) + sess._out_shape(), np.float32)
    return tuple(np.concatenate(o) if o else empty for o in outs)


def _counter(name):
    from supernet_tpu_torch import tracing

    return tracing.counters().get(name, 0)


def _assert_staged_like_chunk_by_chunk(sess, x):
    """``predict(x)`` bit-equal to the chunk-by-chunk answers, with one
    ``session.chunks_overlapped`` per chunk after the first."""
    before = _counter("session.chunks_overlapped")
    got = sess.predict(x)
    chunks = -(-len(x) // sess.batch_size)
    assert _counter("session.chunks_overlapped") - before == max(chunks - 1, 0)
    want = _chunk_by_chunk(sess, x)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("n", [0, 1, BS - 1, BS, BS + 1, 3 * BS, 3 * BS + 2])
def test_chunks_staged_in_the_dispatch_equal_chunk_by_chunk(params, n):
    """Each chunk is copied into the pinned input buffer just before its
    dispatch: the empty request, one row, a short, an exact and a padded
    chunk, three chunks, three and a padded one."""
    sess = serving.InferenceSession(params, CFG, batch_size=BS, device="cpu")
    _assert_staged_like_chunk_by_chunk(sess, _x(n, seed=30 + n))


def _volumetric_session():
    from supernet_tpu_torch import configs
    from supernet_tpu_torch.models import init_params3d

    cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=16, out_size=10,
                              base_kernels=2, depth=2)
    params = init_params3d(torch.Generator().manual_seed(6), cfg, "cpu")
    return serving.InferenceSession(params, cfg, batch_size=2, device="cpu", volumetric=True)


@pytest.mark.parametrize("case", ["grow_shrink_grow", "over_budget", "ensemble", "volumetric"])
def test_chunks_staged_in_the_dispatch_on_every_path(params, monkeypatch, case):
    """The staging chunk by chunk where the input buffer grows and is
    reused (larger, smaller, larger again: the smaller request's padding
    rows written over the larger one's), over the answer budget, in the
    ensemble session and in the volumetric one."""
    sess, sizes = _session("single", params), [3 * BS + 2]
    if case == "grow_shrink_grow":
        sizes = [BS + 2, 3 * BS + 2, BS + 1, 3 * BS + 1, 4 * BS + 2]
    elif case == "over_budget":
        monkeypatch.setattr(serving, "ANSWER_BUDGET", 0)
    elif case == "ensemble":
        sess = _session("ensemble", params)
    else:
        sess, sizes = _volumetric_session(), [5]
    grows, copied = _counter("session.buffer_grows"), _counter("session.answers_copied")
    held = []
    for k, n in enumerate(sizes):
        shape = (n,) + sess._in_shape()
        x = np.random.default_rng(40 + k).normal(0, 1, shape).astype(np.float32)
        got = _assert_staged_like_chunk_by_chunk(sess, x)
        held.append((got, [a.copy() for a in got]))
    for got, bits in held:
        _assert_bits(got, bits)
    grew = _counter("session.buffer_grows") - grows
    if case == "grow_shrink_grow":
        assert grew == 3  # 8, 16 and 20 rows; the 5 and the 13 reuse the buffer
    elif case == "over_budget":
        assert grew == 3 and _counter("session.answers_copied") - copied == 1
    else:
        assert grew == 1


def _session(kind, params, batch_size=4):
    if kind == "ensemble":
        p2 = jinit(jax.random.PRNGKey(4), CFG)
        return serving.EnsembleSession([params, p2], CFG, batch_size=batch_size, device="cpu")
    return serving.InferenceSession(params, CFG, batch_size=batch_size, device="cpu")


def _in_place_and_copied():
    from supernet_tpu_torch import tracing

    c = tracing.counters()
    return c.get("session.answers_in_place", 0), c.get("session.answers_copied", 0)


def _assert_bits(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["single", "ensemble"])
def test_a_held_answer_keeps_its_bits(params, kind):
    """An answer is handed over in the memory its copies wrote: three later
    requests with other images write their own answers, never the held
    one."""
    sess = _session(kind, params)
    held = sess.predict(_x(7, seed=10))
    bits = [a.copy() for a in held]
    later = [sess.predict(_x(7, seed=11 + k)) for k in range(3)]
    _assert_bits(held, bits)
    for answer in later:
        assert not any(np.shares_memory(a, h) for a in answer for h in held)
        assert not np.array_equal(answer[0], held[0])


def test_answers_are_the_copy_paths_bits(params, monkeypatch):
    """A request of 45 at batch 20 answered in place: exactly 45 rows,
    float32, C-contiguous and writeable, with the bits of the same request
    copied out of the session's buffers (the path over the budget)."""
    sess = serving.InferenceSession(params, CFG, batch_size=20, device="cpu")
    x = _x(45, seed=5)
    before = _in_place_and_copied()
    got = sess.predict(x)
    monkeypatch.setattr(serving, "ANSWER_BUDGET", 0)
    want = sess.predict(x)
    after = _in_place_and_copied()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    for g, w in zip(got, want):
        assert g.shape == (45, 22, 22, 3) and g.dtype == np.float32
        assert g.flags.c_contiguous and g.flags.writeable
        np.testing.assert_array_equal(g, w)
        assert not np.shares_memory(g, w)


def test_over_the_budget_answers_are_copied(params, monkeypatch):
    """Below one answer's bytes every request is copied into fresh arrays
    (counted, right, unaliased); at one answer's bytes a held answer sends
    the next request through the copy, and dropping it brings the one after
    back in place."""
    sess = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    xs = [_x(5, seed=20 + k) for k in range(3)]
    want = [tuple(a.copy() for a in sess.predict(x)) for x in xs]
    pair = sum(a.nbytes for a in want[0])
    assert sess._handed.live == 0
    monkeypatch.setattr(serving, "ANSWER_BUDGET", pair - 1)
    before = _in_place_and_copied()
    got = [sess.predict(x) for x in xs]
    after = _in_place_and_copied()
    assert (after[0] - before[0], after[1] - before[1]) == (0, 3)
    for g, w in zip(got, want):
        _assert_bits(g, w)
    assert not any(np.shares_memory(a, b) for a in got[0] for b in got[1] + got[2])

    monkeypatch.setattr(serving, "ANSWER_BUDGET", pair)
    held = sess.predict(xs[0])
    assert sess._handed.live == pair
    copied = sess.predict(xs[1])
    assert _in_place_and_copied()[1] - after[1] == 1
    del held
    again = sess.predict(xs[2])
    assert _in_place_and_copied() == (after[0] + 2, after[1] + 1)
    assert sess._handed.live == pair
    _assert_bits(copied, want[1])
    _assert_bits(again, want[2])
    del again
    assert sess._handed.live == 0


def test_answers_dropped_on_many_threads_are_all_released(params):
    """The live bytes are updated under a lock: answers dropped on eight
    threads at a short switch interval leave none counted."""
    import threading

    sess = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    answers = [sess.predict(_x(2, seed=k)) for k in range(64)]
    assert sess._handed.live == sum(a.nbytes for ans in answers for a in ans)
    chunks = [answers[k::8] for k in range(8)]
    del answers
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=chunk.clear) for chunk in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert sess._handed.live == 0


def test_recalibration_matches_jax(params):
    x = _x(3, seed=2)
    got = serving.InferenceSession(
        params, CFG, batch_size=2, device="cpu", variance_scale=2.0, temperature=1.5
    ).predict(x)
    want = jserving.InferenceSession(
        params, CFG, batch_size=2, variance_scale=2.0, temperature=1.5
    ).predict(x)
    _assert_same(got, want)
    np.testing.assert_allclose(got[0].sum(-1), 1.0, atol=1e-5)
    for bad in ({"temperature": 0.0}, {"variance_scale": 0.0}):
        with pytest.raises(ValueError):
            serving.InferenceSession(params, CFG, batch_size=2, device="cpu", **bad)


def test_predict_image_matches_jax(params):
    img = np.random.default_rng(4).uniform(0, 1, (40, 29)).astype(np.float32)
    got = serving.InferenceSession(params, CFG, batch_size=4, device="cpu").predict_image(
        img, overlap=6
    )
    want = jserving.InferenceSession(params, CFG, batch_size=4).predict_image(
        img, overlap=6
    )
    assert got[0].shape == (40, 29, 3)
    _assert_same(got, want)


@pytest.mark.parametrize("fn,shape,overlap", [("predict_image", (23, 17), 5),
                                               ("predict_volume", (9, 14, 11), 2)])
@pytest.mark.parametrize("weight", ["gaussian", "uniform"])
def test_tiling_copy_matches_jax(fn, shape, overlap, weight):
    """The port's copy of supernet_tpu/tiling.py stitches the same maps
    from the same tile predictions (tiles of 12, outputs of 6)."""
    from supernet_tpu import tiling as jtiling
    from supernet_tpu_torch import tiling

    def predict(t):  # a deterministic stand-in for the model: [N,T..,C] -> [N,O..,2]
        core = t[(slice(None),) + (slice(3, -3),) * (t.ndim - 2)]
        return np.concatenate([core, core ** 2], -1), np.concatenate([-core, core], -1)

    arr = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    got = getattr(tiling, fn)(predict, arr, 12, 6, overlap=overlap, weight=weight)
    want = getattr(jtiling, fn)(predict, arr, 12, 6, overlap=overlap, weight=weight)
    for g, w in zip(got, want):
        assert g.shape == shape + (2,)
        np.testing.assert_array_equal(g, w)
    assert tiling.tile_positions(23, 6, 4) == jtiling.tile_positions(23, 6, 4)
    assert tiling.output_margins(64, 54) == jtiling.output_margins(64, 54)


def test_port_imports_no_jax():
    """A fresh interpreter that refuses to import ``jax`` and the JAX
    package ``supernet_tpu`` (a meta-path blocker) imports every module of
    the port (the data modules, the trainer, the CLI and the evaluation
    surface among them), builds
    the CLI's parser, runs one tiny CPU forward through the serving session,
    takes one CPU train step and one ensemble step, and under bf16
    activations builds an
    ``EnsembleSession`` and an export bundle (``flops.py``, ``hlo_profile.py``
    and ``xplane.py`` among the modules), runs a forward under the
    glue fold and a conv fold, and takes one data-parallel step in a gloo
    world of one (``supernet_tpu_torch.parallel`` and
    ``supernet_tpu_torch.bench`` among the modules)."""
    code = textwrap.dedent("""
        import dataclasses, importlib, pkgutil, sys

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "supernet_tpu"):
                    raise ImportError(f"the port imported {name}")
                return None

        sys.meta_path.insert(0, Blocker())
        import numpy as np
        import torch
        import supernet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            supernet_tpu_torch.__path__, "supernet_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert {"supernet_tpu_torch.train", "supernet_tpu_torch.losses",
                "supernet_tpu_torch.configs", "supernet_tpu_torch.tiling",
                "supernet_tpu_torch.ops.kernels.sigma_bwd",
                "supernet_tpu_torch.trainer", "supernet_tpu_torch.cli",
                "supernet_tpu_torch.attacks", "supernet_tpu_torch.perturb",
                "supernet_tpu_torch.evaluate", "supernet_tpu_torch.calibration",
                "supernet_tpu_torch.ops.naive", "supernet_tpu_torch.flops",
                "supernet_tpu_torch.serving", "supernet_tpu_torch.ensemble",
                "supernet_tpu_torch.metrics", "supernet_tpu_torch.reports",
                "supernet_tpu_torch.utils", "supernet_tpu_torch.native",
                "supernet_tpu_torch.data.augment",
                "supernet_tpu_torch.data.loaders",
                "supernet_tpu_torch.data.nifti",
                "supernet_tpu_torch.data.shards",
                "supernet_tpu_torch.data.synthetic",
                "supernet_tpu_torch.hlo_profile",
                "supernet_tpu_torch.xplane",
                "supernet_tpu_torch.parallel",
                "supernet_tpu_torch.parallel.data_parallel",
                "supernet_tpu_torch.parallel.spatial",
                "supernet_tpu_torch.parallel.hybrid",
                "supernet_tpu_torch.parallel.multihost",
                "supernet_tpu_torch.bench"} <= set(names), names
        from supernet_tpu_torch import cli
        assert cli.build_parser().parse_args(
            ["train", "--synthetic", "4"]).device == "cuda"
        from supernet_tpu_torch import train
        from supernet_tpu_torch.configs import HIPPOCAMPUS
        from supernet_tpu_torch.models import init_params
        from supernet_tpu_torch.serving import InferenceSession
        cfg = dataclasses.replace(HIPPOCAMPUS.model, image_size=32,
                                  out_size=22, base_kernels=2)
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        p, s = InferenceSession(params, cfg, batch_size=2, device="cpu").predict(
            np.zeros((1, 32, 32, 1), np.float32))
        assert p.shape == (1, 22, 22, 3) and np.isfinite(s).all()
        from supernet_tpu_torch.models import forward
        from supernet_tpu_torch.ops.moments import lowering
        with lowering(glue_fold="fold", conv_fold="sigma"), torch.no_grad():
            pf, _ = forward(params, torch.zeros(1, 32, 32, 1), cfg)
        assert pf.shape == (1, 22 * 22, 3)
        state, _ = train.create_train_state(params, HIPPOCAMPUS.train, "cpu")
        rng = np.random.default_rng(0)
        state, m = train.make_train_step(cfg, HIPPOCAMPUS.train)(
            state, rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32),
            rng.integers(0, 3, (2, 22, 22)).astype(np.int32))
        assert state.step == 1 and all(np.isfinite(float(v)) for v in m)
        members = train.stack_trees([train.create_train_state(
            init_params(torch.Generator().manual_seed(k), cfg, "cpu"),
            HIPPOCAMPUS.train, "cpu")[0] for k in range(2)])
        members, m = train.make_ensemble_train_step(cfg, HIPPOCAMPUS.train)(
            members, rng.normal(0, 1, (2, 2, 32, 32, 1)).astype(np.float32),
            rng.integers(0, 3, (2, 2, 22, 22)).astype(np.int32))
        assert members.step == 1 and m.loss.shape == (2,)
        import torch.distributed as dist
        from supernet_tpu_torch import parallel
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        mesh = parallel.make_mesh()
        state = parallel.replicate(mesh, state)
        xs, ys = parallel.shard_batch(
            mesh, rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32),
            rng.integers(0, 3, (2, 22, 22)).astype(np.int32))
        state, m = parallel.make_sharded_train_step(cfg, HIPPOCAMPUS.train, mesh)(
            state, xs, ys)
        assert state.step == 2 and all(np.isfinite(float(v)) for v in m)
        dist.destroy_process_group()
        import tempfile
        from supernet_tpu_torch import ops
        from supernet_tpu_torch.serving import EnsembleSession, export_bundle
        ops.set_act_dtype("bfloat16")
        p, s = EnsembleSession([params, params], cfg, batch_size=2, device="cpu").predict(
            np.zeros((3, 32, 32, 1), np.float32))
        assert p.shape == (3, 22, 22, 3) and p.dtype == np.float32
        with tempfile.TemporaryDirectory() as d:
            meta = export_bundle([params, params], cfg, d, batch_size=2)
        assert meta["ensemble_members"] == 2 and "bfloat16" in meta["program"]
        ops.set_act_dtype("float32")
        bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "supernet_tpu")]
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
