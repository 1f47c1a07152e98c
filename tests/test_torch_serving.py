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
    """``predict`` enqueues every chunk and copies into preallocated host
    buffers: a request of 45 images at batch 20 gives the bits of running
    the three chunks (the last padded with its final image) one by one."""
    sess = serving.InferenceSession(params, CFG, batch_size=20, device="cpu")
    x = _x(45, seed=5)
    got = sess.predict(x)
    want = [], []
    with torch.inference_mode():
        for i in range(0, 45, 20):
            chunk = x[i : i + 20]
            b = len(chunk)
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], 20 - b, axis=0)])
            for out, a in zip(want, sess._forward(torch.from_numpy(chunk))):
                out.append(a[:b].numpy())
    for g, w in zip(got, want):
        assert g.shape == (45, 22, 22, 3)
        np.testing.assert_array_equal(g, np.concatenate(w))


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
    and ``xplane.py`` among the modules), and runs a forward under the
    glue fold and a conv fold."""
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
                "supernet_tpu_torch.xplane"} <= set(names), names
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
