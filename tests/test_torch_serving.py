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


def test_port_imports_no_jax():
    """A fresh interpreter runs one tiny CPU forward through the port's
    serving module without importing JAX."""
    code = textwrap.dedent("""
        import dataclasses, sys
        import numpy as np
        import torch
        from supernet_tpu_torch.configs import HIPPOCAMPUS
        from supernet_tpu_torch.models import init_params
        from supernet_tpu_torch.serving import InferenceSession
        cfg = dataclasses.replace(HIPPOCAMPUS.model, image_size=32,
                                  out_size=22, base_kernels=2)
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        p, s = InferenceSession(params, cfg, batch_size=2, device="cpu").predict(
            np.zeros((1, 32, 32, 1), np.float32))
        assert p.shape == (1, 22, 22, 3) and np.isfinite(s).all()
        assert "jax" not in sys.modules, "the port imported jax"
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
