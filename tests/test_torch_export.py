"""The rest of the port's serving surface on the CPU: ``EnsembleSession``
against the JAX package's, the export bundle (``params.npz`` read by the JAX
package, ``model.pt2`` reloaded, ``export_meta.json`` against the JAX meta)
and ``cli export`` (after ``tests/test_serving.py:89-137``, ``:269``,
``:294-348``)."""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu import serving as jserving  # noqa: E402
from supernet_tpu.checkpoint import load_params_npz as jload_npz  # noqa: E402
from supernet_tpu.configs import HIPPOCAMPUS as JHIPPOCAMPUS  # noqa: E402
from supernet_tpu.models import forward_images as jforward_images  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import cli, configs, serving  # noqa: E402
from supernet_tpu_torch.models import forward_images  # noqa: E402
from _torch_parallel_ranks import mesh1  # noqa: E402,F401  (a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(image_size=32, out_size=22, base_kernels=4)
CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, **TINY)
JCFG = dataclasses.replace(JHIPPOCAMPUS.model, **TINY)
# float32 in two implementations on the CPU (the serving test's limit)
ATOL = 1e-5


@pytest.fixture(scope="module")
def members():
    return [jinit(jax.random.PRNGKey(k), JCFG) for k in (3, 61, 99)]


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, 32, 32, 1)).astype(np.float32)


def test_ensemble_session_matches_jax(members):
    """Three members, a request of 3 at batch 2 (a padded tail)."""
    x = _x(3, seed=1)
    got = serving.EnsembleSession(members, CFG, batch_size=2, device="cpu").predict(x)
    want = jserving.EnsembleSession(members, JCFG, batch_size=2).predict(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 22, 22, 3) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_identical_members_equal_one_session(members):
    single = serving.InferenceSession(members[0], CFG, batch_size=2, device="cpu")
    ens = serving.EnsembleSession([members[0]] * 3, CFG, batch_size=2, device="cpu")
    x = _x(2, seed=11)
    p1, s1 = single.predict(x)
    pk, sk = ens.predict(x)
    np.testing.assert_allclose(pk, p1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sk, s1, rtol=1e-4, atol=1e-6)
    assert ens.n_members == 3


def test_disagreement_raises_the_variance(members):
    """The served variance is the mixture formula over the members' own
    outputs (float64 here), at least the mean member variance everywhere
    and above it where the members disagree."""
    ens = serving.EnsembleSession(members[:2], CFG, batch_size=2, device="cpu")
    x = _x(2, seed=12)
    pk, sk = ens.predict(x)
    with torch.no_grad():
        outs = [np.asarray(a, np.float64) for m in members[:2]
                for a in forward_images(ckpt.params_from_jax(m, "cpu"),
                                        torch.from_numpy(x), CFG)]
    p_mean = (outs[0] + outs[2]) / 2
    within = (outs[1] + outs[3]) / 2
    want_var = within + ((outs[0] - p_mean) ** 2 + (outs[2] - p_mean) ** 2) / 2
    np.testing.assert_allclose(sk, want_var, rtol=1e-5, atol=1e-9)
    gap = want_var - within
    assert gap.min() >= 0.0 and gap.max() > 0.0
    assert float(sk.min()) >= 0.0
    np.testing.assert_allclose(pk, p_mean, atol=1e-6)
    np.testing.assert_allclose(pk.sum(-1), 1.0, atol=1e-5)


def test_recalibration_after_the_mixture(members, mesh1):
    x = _x(2, seed=13)
    raw_p, raw_s = serving.EnsembleSession(members[:2], CFG, batch_size=2,
                                           device="cpu").predict(x)
    cal_p, cal_s = serving.EnsembleSession(members[:2], CFG, batch_size=2, device="cpu",
                                           variance_scale=3.0, temperature=1.5).predict(x)
    np.testing.assert_allclose(cal_s, 3.0 * raw_s, rtol=1e-6)
    want = np.power(np.maximum(raw_p, 1e-30), 1.0 / 1.5)
    np.testing.assert_allclose(cal_p, want / want.sum(-1, keepdims=True), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="at least one member"):
        serving.EnsembleSession([], CFG, device="cpu")
    # on a mesh (a one-rank gloo world; more ranks and the zero-weight
    # member padding in test_torch_parallel.py) the members are split over
    # the ranks and the mixture's sums all-reduced: the meshless answer
    for got, want in zip(serving.EnsembleSession(members, CFG, batch_size=2, device="cpu",
                                                 mesh=mesh1).predict(x),
                         serving.EnsembleSession(members, CFG, batch_size=2,
                                                 device="cpu").predict(x)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ensemble", [False, True])
def test_export_meta_params_and_program(members, ensemble, tmp_path):
    """The meta holds the JAX meta's keys and values (``files`` names
    ``model.pt2``; ``program`` is the port's one added key); ``params.npz``
    loads in the JAX package (stacked on a leading member axis for an
    ensemble) and gives the JAX forward's outputs; ``model.pt2`` reloaded
    gives the port session's answers with the recalibration baked in."""
    params = members[:2] if ensemble else members[0]
    kw = dict(batch_size=2, config_name="hippocampus", variance_scale=2.0, temperature=1.5)
    meta = serving.export_bundle(params, CFG, str(tmp_path / "port"), **kw)
    want = jserving.export_bundle(params, JCFG, str(tmp_path / "jax"), **kw)
    assert set(meta) - set(want) == {"program"}
    for k, v in want.items():
        assert meta[k] == (["model.pt2", "params.npz"] if k == "files" else v), k
    with open(tmp_path / "port" / "export_meta.json") as f:
        assert json.load(f) == meta

    loaded = jload_npz(str(tmp_path / "port" / "params.npz"))
    x = _x(2, seed=3)
    for k, m in enumerate(members[:2] if ensemble else [members[0]]):
        mine = {layer: {n: (a[k] if ensemble else a) for n, a in ws.items()}
                for layer, ws in loaded.items()}
        for a, b in zip(jforward_images(mine, jnp.asarray(x), JCFG),
                        jforward_images(m, jnp.asarray(x), JCFG)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    program = torch.export.load(str(tmp_path / "port" / "model.pt2")).module()
    p, s = program(torch.from_numpy(x))
    cls = serving.EnsembleSession if ensemble else serving.InferenceSession
    sp, ss = cls(params, CFG, batch_size=2, device="cpu", variance_scale=2.0,
                 temperature=1.5).predict(x)
    np.testing.assert_allclose(p.numpy(), sp, atol=1e-7)
    np.testing.assert_allclose(s.numpy(), ss, rtol=1e-6, atol=1e-12)


def test_export_volumetric_ensemble(tmp_path):
    """A volumetric bundle of a two-member ensemble: the stacked npz and a
    ``model.pt2`` that answers cubes as the volumetric EnsembleSession does
    (tests/test_torch_eval3d.py holds the single-member bundle against the
    JAX package's)."""
    from supernet_tpu_torch.models import init_params3d

    cfg3 = dataclasses.replace(CFG, image_size=16, out_size=10, base_kernels=2, depth=2)
    ps = [init_params3d(torch.Generator().manual_seed(s), cfg3, "cpu") for s in (0, 1)]
    meta = serving.export_bundle(ps, cfg3, str(tmp_path), batch_size=2, volumetric=True)
    assert meta["volumetric"] and meta["ensemble_members"] == 2
    assert meta["input_shape"] == [2, 16, 16, 16, 1]
    assert meta["output_shape"] == [2, 10, 10, 10, 3]
    with np.load(str(tmp_path / "params.npz")) as f:
        assert f["conv1/w_mu"].shape == (2, 3, 3, 3, 2, 2)
    x = np.random.default_rng(0).normal(0, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    program = torch.export.load(str(tmp_path / "model.pt2")).module()
    with torch.no_grad():
        p, s = program(torch.from_numpy(x))
    sp, ss = serving.EnsembleSession(ps, cfg3, batch_size=2, device="cpu",
                                     volumetric=True).predict(x)
    np.testing.assert_allclose(p.numpy(), sp, atol=1e-7)
    np.testing.assert_allclose(s.numpy(), ss, rtol=1e-6, atol=1e-12)


@pytest.fixture
def tiny(monkeypatch):
    exp = configs.HIPPOCAMPUS.replace(model=CFG)
    monkeypatch.setitem(configs._CONFIGS, "hippocampus", exp)
    return exp


def test_cli_export(members, tiny, tmp_path, capsys):
    """``cli export`` prints the meta as one JSON line and writes the three
    files, for one checkpoint and for a comma-separated ensemble."""
    npz = []
    for k, m in enumerate(members[:2]):
        npz.append(str(tmp_path / f"m{k}.npz"))
        ckpt.save_params_npz(npz[-1], ckpt.params_from_jax(m, "cpu"))
    for srcs in (npz[:1], npz):
        out = str(tmp_path / f"bundle{len(srcs)}")
        assert cli.main(["export", "--config", "hippocampus", "--checkpoint", ",".join(srcs),
                         "--device", "cpu", "--out-dir", out, "--export-batch-size", "2",
                         "--variance-scale", "2.0", "--temperature", "1.5"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        meta = json.loads(lines[-1])
        assert len(lines) == 1 and meta["config"] == "hippocampus"
        assert (meta["batch_size"], meta["variance_scale"], meta["temperature"]) == (2, 2.0, 1.5)
        assert meta.get("ensemble_members", 1) == len(srcs)
        assert sorted(os.listdir(out)) == ["export_meta.json", "model.pt2", "params.npz"]
        with open(os.path.join(out, "export_meta.json")) as f:
            assert json.load(f) == meta
