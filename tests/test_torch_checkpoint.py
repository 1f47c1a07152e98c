"""The port's checkpoints (``supernet_tpu_torch/checkpoint.py``) on the CPU:
``epoch_{N}`` train states (save, restore, the background writer, resume
helpers), whole train states carried to and from the JAX package mid-run,
and Keras-H5 weights exchanged between the two packages."""

import dataclasses
import inspect
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import checkpoint as jckpt  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import configs, train  # noqa: E402
from supernet_tpu_torch.models import forward, init_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                          base_kernels=4)
JCFG = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                           base_kernels=4)
TC = configs.HIPPOCAMPUS.train
JTC = jconfigs.HIPPOCAMPUS.train


def _data(k, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (k, b, 32, 32, 1)).astype(np.float32),
            rng.integers(0, 3, (k, b, 22, 22)).astype(np.int32))


def _trained_state(steps=2, seed=0):
    params = init_params(torch.Generator().manual_seed(seed), CFG, "cpu")
    state, _ = train.create_train_state(params, TC, "cpu")
    step = train.make_train_step(CFG, TC)
    x, y = _data(steps)
    for i in range(steps):
        state, _ = step(state, x[i], y[i])
    return state


def _flat(state):
    snap = ckpt.snapshot_state(state)
    out = {f"{kind}/{layer}/{name}": t
           for kind in ("params", "exp_avg", "exp_avg_sq")
           for layer, ws in snap[kind].items() for name, t in ws.items()}
    return out, (snap["adam_step"], snap["step"])


def _assert_states_equal(a, b):
    (fa, sa), (fb, sb) = _flat(a), _flat(b)
    assert sa == sb and fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


# ------------------------------------------------------------- train states


@pytest.mark.parametrize("steps", [0, 3])
def test_state_roundtrip_and_training_goes_on_bit_for_bit(tmp_path, steps):
    """Parameters, Adam moments and both step counters survive the file,
    also for a state that has taken no step yet; two more steps from the
    restored state equal two more from the original."""
    state = _trained_state(steps)
    path = ckpt.save_state(str(tmp_path), 4, state)
    assert path == str(tmp_path / "epoch_4" / "state.pt")
    back = ckpt.restore_state(str(tmp_path), 4, TC, "cpu")
    _assert_states_equal(state, back)
    assert back.step == steps and all(t.requires_grad for t in train.leaves(back.params))
    step = train.make_train_step(CFG, TC)
    x, y = _data(2, seed=1)
    for i in range(2):
        state, m = step(state, x[i], y[i])
        back, mb = step(back, x[i], y[i])
        assert float(m.loss) == float(mb.loss)
    _assert_states_equal(state, back)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(str(tmp_path), 5, TC, "cpu")


def test_snapshot_is_a_copy():
    """The step updates the parameters in place: a snapshot taken before
    must not move with them."""
    state = _trained_state(1)
    snap = ckpt.snapshot_state(state)
    before = {k: v.clone() for k, v in snap["params"]["conv1"].items()}
    x, y = _data(1, seed=2)
    train.make_train_step(CFG, TC)(state, x[0], y[0])
    for k, v in before.items():
        assert torch.equal(snap["params"]["conv1"][k], v)
        assert not torch.equal(state.params["conv1"][k].detach(), v)


def test_latest_epoch_and_resolve_checkpoint(tmp_path):
    root = str(tmp_path / "run")
    assert ckpt.latest_epoch(root) is None
    assert ckpt.resolve_checkpoint(root) == (root, None)
    state = _trained_state(0)
    for e in (0, 2, 10):
        ckpt.save_state(root, e, state)
    # a directory whose file is still under its temporary name, a stray
    # directory and a stray file do not count
    os.makedirs(os.path.join(root, "epoch_11"))
    open(os.path.join(root, "epoch_11", "state.pt.123.tmp"), "wb").close()
    os.makedirs(os.path.join(root, "epoch_x"))
    open(os.path.join(root, "epoch_12"), "wb").close()
    assert ckpt.latest_epoch(root) == 10
    assert ckpt.resolve_checkpoint(root) == (root, 10)
    assert ckpt.resolve_checkpoint(os.path.join(root, "epoch_2")) == (root, 2)
    assert ckpt.resolve_checkpoint(os.path.join(root, "epoch_2") + "/") == (root, 2)
    assert jckpt.resolve_checkpoint(os.path.join(root, "epoch_2"))[1] == 2


def test_async_checkpointer_snapshots_before_it_returns(tmp_path):
    """The file of epoch N holds epoch N's weights although training went
    on while it was written; ``keep`` prunes the oldest; ``wait`` drains and
    ``close`` joins the thread."""
    root = str(tmp_path)
    state = _trained_state(1)
    w = ckpt.AsyncEpochCheckpointer(root, keep=2)
    step = train.make_train_step(CFG, TC)
    x, y = _data(4, seed=3)
    kept = {}
    try:
        for e in range(4):
            state, _ = step(state, x[e], y[e])
            kept[e] = _flat(state)
            w.save(e, state)
        w.wait()
        assert sorted(os.listdir(root)) == ["epoch_2", "epoch_3"]
        back = w.restore(2, TC, "cpu")
        got, steps = _flat(back)
        assert steps == kept[2][1] == (4.0, 4)
        for k in got:
            assert torch.equal(got[k], kept[2][0][k]), k
    finally:
        w.close()
    assert not w._thread.is_alive()
    w.close()  # closing twice is harmless


def test_async_checkpointer_reports_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    w = ckpt.AsyncEpochCheckpointer(str(blocker))
    try:
        w.save(0, _trained_state(0))
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            w.wait()
    finally:
        w.close()


def test_entry_points_default_to_the_card():
    for fn in (ckpt.restore_state, ckpt.import_keras_h5, ckpt.state_from_jax,
               ckpt.state_from_snapshot, ckpt.AsyncEpochCheckpointer.restore):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


# ------------------------------------------------- states across packages


def _adam(jstate):
    """The optax ScaleByAdamState inside a JAX TrainState."""
    return jstate.opt_state[1][0]


def _np_tree(tree):
    return {layer: {name: np.asarray(v) for name, v in ws.items()}
            for layer, ws in tree.items()}


def test_state_carried_across_mid_run():
    """The JAX package takes 3 steps; the whole state (parameters, Adam
    moments, counters) is carried into the port; both take 2 more steps:
    the same losses (rtol 1e-5, as tests/test_torch_train.py holds single
    steps) and parameters within 2 * lr * 2. Then the port's state goes
    back and the JAX package's next step agrees with the port's."""
    x, y = _data(6, seed=4)
    jstate, _ = jtrain.create_train_state(jinit(jax.random.PRNGKey(0), JCFG), JTC)
    jstep = jtrain.make_train_step(JCFG, JTC)
    for i in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]))
    adam = _adam(jstate)
    state = ckpt.state_from_jax(_np_tree(jstate.params), _np_tree(adam.mu),
                                _np_tree(adam.nu), int(adam.count), TC, "cpu")
    assert state.step == 3 and int(jstate.step) == 3
    params, mu, nu, count = ckpt.state_to_jax(state)
    assert count == 3
    for got, want in ((params, jstate.params), (mu, adam.mu), (nu, adam.nu)):
        for layer in want:
            for name in want[layer]:
                np.testing.assert_array_equal(got[layer][name], np.asarray(want[layer][name]))

    step = train.make_train_step(CFG, TC)
    for i in (3, 4):
        jstate, jm = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]))
        state, m = step(state, x[i], y[i])
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    assert state.step == 5
    for layer, ws in state.params.items():
        for name, t in ws.items():
            d = np.abs(t.detach().numpy() - np.asarray(jstate.params[layer][name])).max()
            assert d <= 2 * TC.lr * 2, (layer, name, d)

    # and back: the JAX package goes on from the port's state
    params, mu, nu, count = ckpt.state_to_jax(state)
    as_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    new_adam = adam._replace(count=jnp.int32(count), mu=as_jnp(mu), nu=as_jnp(nu))
    opt_state = (jstate.opt_state[0], (new_adam,) + tuple(jstate.opt_state[1][1:]))
    jback = jtrain.TrainState(as_jnp(params), opt_state, jnp.int32(count))
    jback, jm = jstep(jback, jnp.asarray(x[5]), jnp.asarray(y[5]))
    state, m = step(state, x[5], y[5])
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
    assert int(jback.step) == state.step == 6


# ---------------------------------------------------------------- keras h5


def _forward_np(params_t, x):
    with torch.no_grad():
        p, s = forward(params_t, torch.from_numpy(x), CFG)
    return p.numpy(), s.numpy()


def test_keras_h5_jax_export_to_port_import_same_forward(tmp_path):
    pytest.importorskip("h5py")
    jparams = jinit(jax.random.PRNGKey(1), JCFG)
    path = str(tmp_path / "vdp_UNET_model.weights.h5")
    jckpt.export_keras_h5(path, jparams, JCFG)
    params = ckpt.import_keras_h5(path, CFG, device="cpu")
    for layer, ws in params.items():
        for name, t in ws.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jparams[layer][name]))
    x = np.random.default_rng(5).normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    p, s = _forward_np(params, x)
    jp, js = jforward(jparams, jnp.asarray(x), JCFG)
    np.testing.assert_allclose(p, np.asarray(jp), atol=2e-5)
    np.testing.assert_allclose(s, np.asarray(js), atol=2e-5)


def test_keras_h5_port_export_to_jax_import_and_back(tmp_path):
    pytest.importorskip("h5py")
    params = init_params(torch.Generator().manual_seed(2), CFG, "cpu")
    path = str(tmp_path / "sub" / "w.h5")
    ckpt.export_keras_h5(path, params, CFG)
    jparams = jckpt.import_keras_h5(path, JCFG)
    back = ckpt.import_keras_h5(path, CFG, device="cpu")
    for layer, ws in params.items():
        for name, t in ws.items():
            np.testing.assert_array_equal(np.asarray(jparams[layer][name]), t.numpy())
            assert torch.equal(back[layer][name], t)
    # the two packages write the same groups, datasets and attributes
    import h5py

    jpath = str(tmp_path / "j.h5")
    jckpt.export_keras_h5(jpath, jparams, JCFG)
    with h5py.File(path, "r") as a, h5py.File(jpath, "r") as b:
        names_a, names_b = [], []
        a.visit(names_a.append)
        b.visit(names_b.append)
        assert names_a == names_b
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        for g in a:
            assert list(a[g].attrs["weight_names"]) == list(b[g].attrs["weight_names"])


def test_keras_h5_mismatches_raise(tmp_path):
    h5py = pytest.importorskip("h5py")
    params = init_params(torch.Generator().manual_seed(3), CFG, "cpu")
    path = str(tmp_path / "w.h5")
    ckpt.export_keras_h5(path, params, CFG)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.import_keras_h5(path, dataclasses.replace(CFG, base_kernels=8), "cpu")
    with h5py.File(path, "a") as f:
        del f["my_conv_intermediate_3"]
    with pytest.raises(KeyError, match="expected exactly one"):
        ckpt.import_keras_h5(path, CFG, "cpu")
