"""The port's process bring-up and per-rank data loading
(``supernet_tpu_torch/parallel/multihost.py``) against the JAX module: the
row partition, the variables ``initialize_from_env`` reads (none, all three,
torchrun's), the global mesh and a rank's rows, and the data-parallel step
fed from process-local rows in a spawned gloo world against the JAX
single-device step."""

import dataclasses
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu.parallel import multihost as jmultihost  # noqa: E402
from supernet_tpu_torch import configs, parallel  # noqa: E402
from _torch_parallel_ranks import mesh1, rank_env_bringup, rank_train, spawn  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                          base_kernels=4)
JCFG = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                           base_kernels=4)
TC, JTC = configs.HIPPOCAMPUS.train, jconfigs.HIPPOCAMPUS.train
_ENV = ("SUPERNET_COORDINATOR", "SUPERNET_NUM_PROCESSES", "SUPERNET_PROCESS_ID",
        "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_process_local_rows_partition():
    """Equal contiguous blocks in rank order, the JAX function's, for
    several world sizes; divisibility enforced; without a process group the
    defaults are one process."""
    for n, pc in ((24, 4), (8, 2), (6, 3), (5, 1)):
        for pi in range(pc):
            assert (parallel.process_local_rows(n, pi, pc)
                    == jmultihost.process_local_rows(n, pi, pc))
    with pytest.raises(ValueError, match="must divide over 4 processes"):
        parallel.process_local_rows(10, 0, 4)
    assert not dist.is_initialized()
    assert parallel.process_local_rows(8) == (0, 8)


def test_initialize_from_env_none_or_partial(monkeypatch):
    """No variable: a no-op that returns False, as JAX's; the coordinator
    without the other two: the JAX module's ValueError, word for word."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_from_env("cpu") is False
    assert jmultihost.initialize_from_env() is False
    assert not dist.is_initialized()
    monkeypatch.setenv("SUPERNET_COORDINATOR", "localhost:1")
    monkeypatch.setenv("SUPERNET_PROCESS_ID", "0")
    errors = []
    for fn in (lambda: parallel.initialize_from_env("cpu"), jmultihost.initialize_from_env):
        with pytest.raises(ValueError, match="must be set together") as e:
            fn()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", ["supernet", "torchrun"])
def test_initialize_from_env_joins_a_two_rank_world(tmp_path, kind):
    """All three SUPERNET_* variables (or torchrun's four) bring up a
    two-rank gloo world: one all-reduce, the global mesh in rank order, and
    each rank's rows of a global batch."""
    port = str(_free_port())
    env = ({"SUPERNET_COORDINATOR": f"localhost:{port}", "SUPERNET_NUM_PROCESSES": "2",
            "SUPERNET_PROCESS_ID": "{RANK}"} if kind == "supernet" else
           {"RANK": "{RANK}", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
            "MASTER_PORT": port})
    outs = spawn(rank_env_bringup, 2, tmp_path, env, init=False)
    assert [o["sum"] for o in outs] == [3.0, 3.0]
    assert all(o["mesh"] == [0, 1] for o in outs)
    assert [o["rows"] for o in outs] == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_global_batch_equals_shard_batch(mesh1):
    """In a world of one, the process-local rows are the whole batch:
    ``global_batch`` of them equals ``shard_batch`` of the global batch
    and JAX's ``global_batch``."""
    x = np.random.default_rng(0).normal(0, 1, (8, 4, 4, 1)).astype(np.float32)
    got = parallel.global_batch(parallel.global_mesh(), x)
    assert torch.equal(got, parallel.shard_batch(mesh1, x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmultihost.global_batch(jmultihost.global_mesh(), x)))


@pytest.mark.slow
def test_train_step_on_process_local_rows(tmp_path):
    """Two ranks, each fed the rows ``process_local_rows`` assigns it
    (``shard_batch`` is the same split), take two data-parallel steps equal
    to the JAX single-device steps on the global batch."""
    rng = np.random.default_rng(1)
    xs = [rng.normal(0, 1, (4, 32, 32, 1)).astype(np.float32) for _ in range(2)]
    ys = [rng.integers(0, 3, (4, 22, 22)).astype(np.int32) for _ in range(2)]
    jparams = jinit(jax.random.PRNGKey(0), JCFG)
    pnp = jax.tree.map(np.asarray, jparams)
    outs = spawn(rank_train, 2, tmp_path, "dp", CFG, TC, pnp, xs, ys)
    state, _ = jtrain.create_train_state(jparams, JTC)
    step = jtrain.make_train_step(JCFG, JTC)
    for i in range(2):
        state, m = step(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        assert outs[0]["metrics"][i][0] == pytest.approx(float(m.loss), rel=1e-5)
    for layer, ws in state.params.items():
        for k, v in ws.items():
            np.testing.assert_allclose(outs[0]["params"][layer][k], np.asarray(v),
                                       rtol=2e-5, atol=1e-6)
            np.testing.assert_array_equal(outs[0]["params"][layer][k],
                                          outs[1]["params"][layer][k])
