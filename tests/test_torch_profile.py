"""The port's profiler (supernet_tpu_torch/{profiling,xplane,hlo_profile}.py
and ``cli profile``) on the CPU: ``profiling.trace`` writes a trace that
``xplane.op_buckets`` reads; the op classifier on the kernel names of the
four hand-written kernels, cuDNN's and PyTorch's; the exact join on a
hand-written trace with known answers (forward kernels joined by their
launching call's ``correlation``, backward ones through the autograd node's
sequence number to the forward layer, an unjoined remainder on its own row);
the join of a real CPU profile of a tiny train step, every layer attributed;
``cli profile --device cpu`` writing ``exact_join.json`` with the keys of
``supernet_tpu/hlo_profile.py:374-386``; ``enable_nan_debugging`` raising on
a NaN made in the forward and on one made in the backward."""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from supernet_tpu_torch import cli, configs, hlo_profile, profiling, xplane  # noqa: E402
from supernet_tpu_torch.models import layer_names  # noqa: E402
from supernet_tpu_torch.ops import get_act_dtype  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = configs.HIPPOCAMPUS.replace(
    model=dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                              base_kernels=4))
# the keys of the JAX twin's exact_join.json (supernet_tpu/hlo_profile.py:373-386)
JAX_KEYS = {"model", "batch", "k_steps", "n_iters", "wall_ms_per_step",
            "device_steps_ms_per_step", "control_ms_per_step", "classes",
            "unmatched_ms_per_step", "total_ms_per_step"}


@pytest.fixture
def tiny(monkeypatch):
    """``--config hippocampus`` (and ``unet3d``, which takes its geometry)
    at the tiny test size, two steps per call."""
    monkeypatch.setitem(configs._CONFIGS, "hippocampus", TINY)
    monkeypatch.setenv("SUPERNET_BENCH_DISPATCH", "2")
    return TINY


def test_trace_writes_a_trace_that_op_buckets_reads(tmp_path):
    a, b = torch.randn(16, 16), torch.randn(16, 16)
    with profiling.trace(str(tmp_path)):
        (a @ b).sum()
    (path,) = os.listdir(tmp_path)
    assert path.endswith(".pt.trace.json")
    buckets = xplane.op_buckets(str(tmp_path))
    assert buckets[xplane.GEMM][1] >= 1 and buckets[xplane.REDUCE][1] >= 1
    assert all(ps >= 0 for ps, _ in buckets.values())


def test_xplane_main_prints_the_table(tmp_path, capsys):
    with profiling.trace(str(tmp_path)):
        torch.randn(8, 8).sum()
    assert xplane.main(["xplane", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "TOTAL" in out and xplane.REDUCE in out


K1F, K1T = xplane.KERNEL_CLASSES["forward"], xplane.KERNEL_CLASSES["transposed"]


@pytest.mark.parametrize("name,cat,backward,cls,counter", [
    ("void vdp_conv_kernel<32, true, true, true>(VdpArgs)", "kernel", False, K1F, "vdp_conv"),
    ("void vdp_conv_kernel<64, true, false, false>(VdpArgs)", "kernel", True, K1T,
     "vdp_conv_dgrad"),
    ("void vdp_conv_kernel_wgmma<64, true, true, false, true>(WgArgs)", "kernel", False, K1F,
     "vdp_conv"),
    ("void vdp_conv_kernel_wgmma<32, (bool)1, (bool)0, (bool)1, (bool)0>(WgArgs)", "kernel",
     True, K1T, "vdp_conv_dgrad"),
    # one bf16 pass: the precision flag follows the element type, the
    # namespace is the kernels' header's
    ("void supernet::vdp::(anonymous namespace)::tc::vdp_conv_kernel_wgmma<64, true, true, "
     "false, true, __nv_bfloat16, true>(WgArgs)", "kernel", False, K1F, "vdp_conv"),
    ("void supernet::vdp::(anonymous namespace)::vdp_conv_kernel<32, false, false, false, "
     "float, true>(VdpArgs)", "kernel", True, K1T, "vdp_conv_dgrad"),
    ("void vdp_conv_kernel_splitk_reduce<true, true, false>(RedArgs)", "kernel", False, K1F,
     "vdp_conv_reduce"),
    ("void vdp_conv_kernel_splitk_reduce<false, false, true>(RedArgs)", "kernel", True, K1T,
     "vdp_conv_dgrad_reduce"),
    ("vmaxpool_fwd_kernel(float const*, float const*, float*, float*, unsigned char*)",
     "kernel", False, xplane.POOL_FWD, "vmaxpool"),
    ("vmaxpool_bwd_kernel(unsigned char const*, float const*)", "kernel", True,
     xplane.POOL_BWD, "vmaxpool_bwd"),
    ("vmaxpool_bwd_vec_kernel(unsigned char const*, float const*)", "kernel", True,
     xplane.POOL_BWD, "vmaxpool_bwd"),
    ("void sigma_bwd_dt_kernel<4, 8, 2>(float const*)", "kernel", True, xplane.SIGMA_BWD,
     "sigma_bwd"),
    ("sigma_bwd_spread_kernel(float const*)", "kernel", True, xplane.SIGMA_BWD, None),
    ("sigma_bwd_rows_kernel(float const*)", "kernel", True, xplane.SIGMA_BWD, "sigma_bwd"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize64x64x8",
     "kernel", False, xplane.CONV_FWD, None),
    ("sm80_xmma_dgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nchw", "kernel",
     True, xplane.CONV_DGRAD, None),
    ("sm80_xmma_wgrad_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc", "kernel", True,
     xplane.CONV_WGRAD, None),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<false, true>(...)", "kernel", True,
     xplane.CONV_BWD, None),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false>(...)",
     "kernel", False, xplane.CONV_FWD, None),
    ("void nchwToNhwcKernel<float, float, float, true, false>(...)", "kernel", False,
     xplane.COPY, None),
    ("ampere_sgemm_128x64_nn", "kernel", False, xplane.GEMM, None),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(...)", "kernel",
     False, xplane.REDUCE, None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>(...)",
     "kernel", False, xplane.ELEMENTWISE, None),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(...)", "kernel",
     False, xplane.COPY, None),
    ("void at::native::multi_tensor_apply_kernel<FusedAdamMathFunctor>(...)", "kernel",
     False, xplane.OPTIMIZER, None),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", False, xplane.MEM, None),
    ("Memset (Device)", "gpu_memset", False, xplane.MEM, None),
    ("aten::mkldnn_convolution", "cpu_op", False, xplane.CONV_FWD, None),
    ("aten::convolution_backward", "cpu_op", True, xplane.CONV_BWD, None),
    ("aten::bmm", "cpu_op", False, xplane.GEMM, None),
    ("aten::sum", "cpu_op", False, xplane.REDUCE, None),
    ("aten::cat", "cpu_op", False, xplane.COPY, None),
    ("aten::empty", "cpu_op", False, xplane.MEM, None),
    ("aten::mul", "cpu_op", True, xplane.ELEMENTWISE, None),
])
def test_op_class_and_launch_counter(name, cat, backward, cls, counter):
    """Each kernel of the four ports by its template flags and name, the
    cuDNN, cuBLAS and PyTorch kernels by theirs, host operators by theirs;
    the counter a kernel adds to is the one its wrapper increments."""
    assert xplane.op_class(name, cat, backward) == cls
    assert hlo_profile.launch_counter(name) == counter


def _ev(name, cat, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def _fixture_trace():
    """A forward layer ``conv1`` (kernel 1 and its split-K reduce, a copy), a
    pool outside every layer, the layer's backward on autograd's thread
    (cuDNN's filter gradient, an unnamed kernel inside the convolution
    backward, kernel 4's two kernels and kernel 1 transposed), the Adam
    step, and one kernel whose launching call is not in the trace."""
    rt = "cuda_runtime"
    host = [
        _ev("conv1", "user_annotation", 0, 160),
        _ev("VDPConv", "cpu_op", 10, 80, **{"Sequence number": 5, "Fwd thread id": 0}),
        _ev("cudaLaunchKernel", rt, 20, 5, correlation=100),
        _ev("cudaLaunchKernel", rt, 40, 5, correlation=101),
        _ev("cudaMemcpyAsync", rt, 150, 2, correlation=106),
        _ev("VMaxPool", "cpu_op", 170, 20, **{"Sequence number": 6, "Fwd thread id": 0}),
        _ev("cudaLaunchKernel", rt, 175, 2, correlation=107),
        _ev("Optimizer.step#Adam.step", "user_annotation", 400, 50),
        _ev("cudaLaunchKernel", rt, 405, 2, correlation=105),
        _ev("autograd::engine::evaluate_function: VDPConvBackward", "cpu_op", 200, 100, tid=2,
            **{"Sequence number": 5, "Fwd thread id": 1}),
        _ev("VDPConvBackward", "cpu_op", 201, 98, tid=2,
            **{"Sequence number": 5, "Fwd thread id": 1}),
        _ev("aten::convolution_backward", "cpu_op", 210, 50, tid=2),
        _ev("cudaLaunchKernel", rt, 215, 2, tid=2, correlation=102),
        _ev("cuLaunchKernel", "cuda_driver", 240, 2, tid=2, correlation=104),
        _ev("cudaLaunchKernel", rt, 262, 1, tid=2, correlation=108),
        _ev("cudaLaunchKernelExC", rt, 264, 1, tid=2, correlation=109),
        _ev("cudaLaunchKernel", rt, 290, 2, tid=2, correlation=103),
    ]
    dev = [
        ("void vdp_conv_kernel_wgmma<64, true, true, true, true>(A)", "kernel", 30, 40, 100),
        ("void vdp_conv_kernel_splitk_reduce<true, true, false>(R)", "kernel", 70, 10, 101),
        ("vmaxpool_fwd_kernel(P)", "kernel", 100, 6, 107),
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 150, 3, 106),
        ("sm90_xmma_wgrad_implicit_gemm_f32f32", "kernel", 220, 30, 102),
        ("cutlass_80_tensorop_s1688gemm_64x64_32x6_nn_align4", "kernel", 250, 5, 104),
        ("void sigma_bwd_dt_kernel<4, 8, 2>(S)", "kernel", 260, 4, 108),
        ("sigma_bwd_spread_kernel(S)", "kernel", 264, 2, 109),
        ("void vdp_conv_kernel<32, true, false, false>(A)", "kernel", 295, 20, 103),
        ("void at::native::multi_tensor_apply_kernel<Adam>(T)", "kernel", 420, 8, 105),
        ("void at::native::vectorized_elementwise_kernel<4, F>(E)", "kernel", 500, 7, 999),
    ]
    events = host + [_ev(n, c, ts, d, tid=7, pid=0, correlation=corr)
                     for n, c, ts, d, corr in dev]
    events.append({"ph": "i", "name": "marker", "ts": 0})  # not a complete event
    return events


def test_join_fixture_known_answers(tmp_path):
    path = tmp_path / "fixture.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": _fixture_trace()}))
    out = hlo_profile.join(xplane.load_trace(xplane.newest_trace(str(tmp_path))), 1,
                           by_layer=True)
    got = {r["class"]: (round(r["ms_per_step"] * 1e3, 6), r["events"]) for r in out["classes"]}
    assert got == {K1F: (50.0, 2), K1T: (20.0, 1), xplane.CONV_WGRAD: (30.0, 1),
                   xplane.CONV_BWD: (5.0, 1), xplane.POOL_FWD: (6.0, 1),
                   xplane.SIGMA_BWD: (6.0, 2), xplane.MEM: (3.0, 1),
                   xplane.OPTIMIZER: (8.0, 1)}
    launches = {r["class"]: r["launches"] for r in out["classes"] if "launches" in r}
    assert launches == {K1F: 1, K1T: 1, xplane.POOL_FWD: 1, xplane.SIGMA_BWD: 1}
    assert out["kernel_launches"] == {"vdp_conv": 1, "vdp_conv_reduce": 1, "vmaxpool": 1,
                                      "vmaxpool_bwd": 0, "sigma_bwd": 1,
                                      "vdp_conv_dgrad": 1, "vdp_conv_dgrad_reduce": 0}
    assert out["unmatched_ms_per_step"] * 1e3 == pytest.approx(7.0)
    assert out["unmatched"] == [{"name": "at::native::vectorized_elementwise_kernel",
                                 "ms_per_step": pytest.approx(7e-3), "events": 1}]
    assert out["total_ms_per_step"] * 1e3 == pytest.approx(135.0)
    assert out["device_busy_ms_per_step"] * 1e3 == pytest.approx(135.0)
    # the backward's kernels reach conv1 through sequence number 5
    layers = {r["layer"]: round(r["ms_per_step"] * 1e3, 6) for r in out["layers_mxu"]}
    assert layers == {"conv1": 105.0}
    by = {(r["layer"], r["class"]) for r in out["layer_classes"]}
    assert ("(unscoped)", xplane.POOL_FWD) in by and ("conv1", xplane.SIGMA_BWD) in by
    # per step: the same trace read as two steps halves every time
    two = hlo_profile.join(xplane.load_trace(str(path)), 2)
    assert two["total_ms_per_step"] == pytest.approx(out["total_ms_per_step"] / 2)


def test_join_leaves_out_the_settling_call():
    """A settling call before the fixture's step (a forward op and its
    kernel, a backward op on autograd's thread inside the range's time, a
    kernel of its own, one whose record was lost) changes no number of the
    join."""
    rt = "cuda_runtime"
    settle = [
        _ev(hlo_profile.SETTLE, "user_annotation", -1000, 600),
        _ev("conv1", "user_annotation", -990, 100),
        _ev("VDPConv", "cpu_op", -980, 50, **{"Sequence number": 1, "Fwd thread id": 0}),
        _ev("cudaLaunchKernel", rt, -970, 5, correlation=50),
        _ev("cudaLaunchKernel", rt, -960, 5, correlation=51),
        _ev("VDPConvBackward", "cpu_op", -700, 100, tid=2,
            **{"Sequence number": 1, "Fwd thread id": 1}),
        _ev("cudaLaunchKernel", rt, -690, 2, tid=2, correlation=52),
        _ev("void vdp_conv_kernel_wgmma<64, true, true, true, true>(A)", "kernel",
            -950, 40, tid=7, pid=0, correlation=50),
        _ev("void vdp_conv_kernel<32, true, false, false>(A)", "kernel",
            -680, 20, tid=7, pid=0, correlation=52),
    ]
    plain = hlo_profile.join([xplane.Event(e) for e in _fixture_trace() if e["ph"] == "X"],
                             1, by_layer=True)
    settled = hlo_profile.join([xplane.Event(e) for e in settle + _fixture_trace()
                                if e["ph"] == "X"], 1, by_layer=True)
    assert settled == plain and plain["lost_launches"] == 0
    assert len(hlo_profile.drop_settle([xplane.Event(e) for e in settle])) == 0
    # the settling call's second launch lost its kernel's record
    assert hlo_profile.lost_launches([xplane.Event(e) for e in settle]) == 1


def test_join_of_a_real_cpu_profile_attributes_every_layer(tiny, tmp_path):
    """A traced tiny train step on the CPU (its host operators are the
    events): every conv layer of ``layer_names`` gets matrix time, forward
    and backward, nothing is left unjoined, and the classes sum to the
    total."""
    out = hlo_profile.run("hippocampus", 2, str(tmp_path), n_iters=1, by_layer=True,
                          device="cpu")
    layers = {r["layer"] for r in out["layers_mxu"]}
    assert {name for name, *_ in layer_names(tiny.model)} <= layers
    assert out["unmatched_ms_per_step"] == 0.0 and out["device_steps_ms_per_step"] is None
    assert sum(r["ms_per_step"] for r in out["classes"]) == pytest.approx(
        out["total_ms_per_step"])
    # every conv layer's backward reached its layer through the node's
    # sequence number: conv backward time is attributed to every layer
    bwd = {r["layer"] for r in out["layer_classes"] if r["class"] == xplane.CONV_BWD}
    assert {name for name, k, *_ in layer_names(tiny.model) if k == 3} <= bwd
    # on the CPU no kernel launches; the counters agree
    assert set(out["kernel_launches"].values()) == {0} == set(out["counted_launches"].values())
    assert out["lost_launches"] == 0 == out["settle_lost_launches"]
    assert get_act_dtype() == torch.float32 and out["act_dtype"] == "bfloat16"
    # the trace opens with the settling call, which the join leaves out
    events = xplane.load_trace(str(tmp_path / out["trace"]))
    forwards = [e for e in events if e.cat == "user_annotation" and e.name == "conv_input"]
    kept = [e for e in hlo_profile.drop_settle(events)
            if e.cat == "user_annotation" and e.name == "conv_input"]
    assert (len(forwards), len(kept)) == ((out["n_iters"] + 1) * out["k_steps"],
                                          out["n_iters"] * out["k_steps"])


@pytest.mark.parametrize("config,by_layer", [("hippocampus", True), ("unet3d", False)])
def test_cli_profile_writes_exact_join(tiny, tmp_path, capsys, config, by_layer):
    """``cli profile --device cpu`` prints the tables, with the unjoined row,
    and writes ``exact_join.json`` with the JAX twin's keys."""
    argv = ["profile", "--config", config, "--batch", "1", "--iters", "1",
            "--device", "cpu", "--out-dir", str(tmp_path)] + (["--by-layer"] if by_layer else [])
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "UNJOINED" in printed and "TOTAL" in printed
    with open(tmp_path / "exact_join.json") as f:
        out = json.load(f)
    assert JAX_KEYS <= set(out)
    assert ("layers_mxu" in out) == by_layer
    assert (out["model"], out["batch"], out["k_steps"], out["n_iters"]) == (config, 1, 2, 1)
    assert out["total_ms_per_step"] > 0 and out["classes"]


def test_profile_needs_a_card_unless_told_cpu(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["profile", "--iters", "1", "--out-dir", str(tmp_path)])


def test_enable_nan_debugging_raises_on_a_forward_nan():
    x = torch.tensor([-1.0, 4.0])
    profiling.enable_nan_debugging()
    try:
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
    finally:
        profiling.enable_nan_debugging(False)
    assert torch.isnan(torch.sqrt(x)).any()  # off again


def test_enable_nan_debugging_raises_on_a_backward_nan():
    """A forward without a NaN whose backward makes one (the gradient of
    |x|^0.5 at 0 is inf * 0)."""
    x = torch.zeros(3, requires_grad=True)
    profiling.enable_nan_debugging()
    try:
        y = (x.abs() ** 0.5).sum()
        assert not torch.isnan(y)
        with pytest.raises((FloatingPointError, RuntimeError), match="nan|NaN"):
            y.backward()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    z = torch.zeros(3, requires_grad=True)
    (z.abs() ** 0.5).sum().backward()
    assert torch.isnan(z.grad).all()


def test_enable_nan_debugging_catches_a_nan_inside_the_model():
    """A NaN image raises in the model's first op that makes one, not
    downstream at the loss."""
    from supernet_tpu_torch.models import forward, init_params

    params = init_params(torch.Generator().manual_seed(0), TINY.model, "cpu")
    x = torch.zeros(1, 32, 32, 1)
    x[0, 5, 5, 0] = float("nan")
    profiling.enable_nan_debugging()
    try:
        with pytest.raises(FloatingPointError):
            forward(params, x, TINY.model)
    finally:
        profiling.enable_nan_debugging(False)
    np.testing.assert_equal(torch.is_anomaly_enabled(), False)
