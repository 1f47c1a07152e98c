"""The port's host-side modules against the JAX package's, on the CPU:
``utils``, ``metrics``, ``reports``, ``data/{loaders,synthetic,shards,nifti}``
and ``native`` are the port's own copies (it imports nothing of
``supernet_tpu``), so the same random inputs go through both and must give
the same outputs, bit for bit. ``data/augment.py`` is rewritten for torch:
its random stream differs from ``jax.random``, so it is held to the
invariants of ``tests/test_augment.py`` and to the same distribution."""

import dataclasses
import filecmp
import inspect
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.data as jdata  # noqa: E402
import supernet_tpu.metrics as jmetrics  # noqa: E402
import supernet_tpu.native as jnative  # noqa: E402
import supernet_tpu.reports as jreports  # noqa: E402
import supernet_tpu.utils as jutils  # noqa: E402
from supernet_tpu.configs import HIPPOCAMPUS as JHIPPOCAMPUS  # noqa: E402
from supernet_tpu.data import augment as jaugment  # noqa: E402
from supernet_tpu.data import nifti as jnifti  # noqa: E402
from supernet_tpu_torch import configs, metrics, native, reports, train, utils  # noqa: E402
from supernet_tpu_torch import data as tdata  # noqa: E402
from supernet_tpu_torch.data import augment, nifti  # noqa: E402


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
JCFG = dataclasses.replace(JHIPPOCAMPUS.model, image_size=32, out_size=22,
                           base_kernels=4)


def _same(a, b):
    """Equal as nested tuples / dicts / arrays / floats, NaN equal to NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------- utils


def test_utils_equal_jax(capsys):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 30, 200)
    _same(utils.softplus_np(x), jutils.softplus_np(x))
    uncert = rng.uniform(0, 1, (5, 9, 9))
    for ds, hi in (("brats", 5), ("hippocampus", 3), ("lungs", 2)):
        pred = rng.integers(0, hi, (5, 9, 9))
        _same(utils.uncert_for_corr(uncert, pred, ds),
              jutils.uncert_for_corr(uncert, pred, ds))
    outs = []
    for mod in (utils, jutils):
        for p in (0, 0.3, 1.0, 1.7, -1.0, "x"):
            mod.update_progress(p)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Done" in outs[0]


# ----------------------------------------------------------------- metrics


def _masks(seed, empty=False):
    rng = np.random.default_rng(seed)
    t = (rng.uniform(0, 1, (6, 12, 12)) > 0.6).astype(np.float32)
    p = (rng.uniform(0, 1, (6, 12, 12)) > 0.5).astype(np.float32)
    if empty:  # both empty (0/0), truth empty, prediction empty
        t[0] = p[0] = 0
        t[1] = 0
        p[2] = 0
    return t, p


@pytest.mark.parametrize("fn", ["dice", "compute_H", "sensitivity", "precision",
                                "specificity", "rvd", "os_and_us",
                                "structure_metrics"])
@pytest.mark.parametrize("empty", [False, True])
def test_metrics_equal_jax(fn, empty):
    t, p = _masks(1, empty)
    _same(getattr(metrics, fn)(t, p), getattr(jmetrics, fn)(t, p))


def test_metric_helpers_equal_jax():
    for p, q in ((0.2, 0.5), (0.7, 0.1), (1.0, 0.0), (0.0, 0.0)):
        _same(metrics.c_score(p, q), jmetrics.c_score(p, q))
    rng = np.random.default_rng(2)
    y, yp = rng.integers(0, 5, (4, 8, 8)), rng.integers(0, 5, (4, 8, 8))
    for ds in ("hippocampus", "brats", "lungs"):
        assert metrics.dataset_structures(ds) == jmetrics.dataset_structures(ds)
        for s in metrics.dataset_structures(ds):
            _same(metrics.binarize(y, s, ds), jmetrics.binarize(y, s, ds))
    for name in ("mask_anterior", "mask_posterior", "mask_tumor", "mask_core", "mask_enh"):
        _same(tuple(getattr(metrics, name)(y, yp)), tuple(getattr(jmetrics, name)(y, yp)))
    with pytest.raises(KeyError, match="unknown structure"):
        metrics.binarize(y, "tumor", "hippocampus")
    sigma = rng.uniform(0, 1, (4, 8, 8, 5)).astype(np.float32)
    _same(metrics.uncertainty_at_prediction(sigma, yp),
          jmetrics.uncertainty_at_prediction(sigma, yp))
    x = [1.0, np.nan, 3.0]
    _same(metrics._nanmean(x), jmetrics._nanmean(x))
    _same(metrics._nanstd(x), jmetrics._nanstd(x))
    _same(metrics._nanstd([np.nan, 1.0]), jmetrics._nanstd([np.nan, 1.0]))


@pytest.mark.parametrize("empty", [False, True])
def test_dice_torch_matches_dice_jax_and_numpy(empty):
    t, p = _masks(3, empty)
    got = float(metrics.dice_torch(torch.from_numpy(t), torch.from_numpy(p)))
    np.testing.assert_allclose(got, float(jmetrics.dice_jax(t, p)), rtol=1e-6)
    np.testing.assert_allclose(got, metrics.dice(t, p)[0], rtol=1e-6)


# ----------------------------------------------------------------- reports


def _report_inputs(n=6, c=3, side=8, seed=4):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(c), (n, side, side)).astype(np.float32)
    sigma = rng.uniform(0, 1e-2, (n, side, side, c)).astype(np.float32)
    images = rng.uniform(0, 1, (n, side, side, 1)).astype(np.float32)
    labels = rng.integers(0, c, (n, side, side))
    return probs, sigma, images, labels


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("dataset,c", [("hippocampus", 3), ("brats", 5)])
def test_reports_equal_jax(tmp_path, dataset, c):
    """Text and pickle artifacts byte for byte; the same set of PNGs."""
    probs, sigma, images, labels = _report_inputs(c=c)
    for mod, sub in ((reports, "t"), (jreports, "j")):
        out = str(tmp_path / sub)
        got = mod.save_uncertainty_report(
            out, images, images + 0.01, probs, labels, sigma, masked=labels,
            images_n=2, dataset=dataset)
        _same(got, reports.save_uncertainty_report(
            str(tmp_path / "again"), images, None, probs, labels, sigma,
            images_n=0, adversarial=False, dataset=dataset))
        mod.write_hyperparameters(out, "Related_hyperparameters.txt",
                                  {"lr": 1e-4, "name": dataset, "n": 3})
        mod.save_history_pickle(out, {"train_loss": [1.0, 0.5]})
        mod.save_reference_training_curves(
            out, {"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.7],
                  "train_acc": [0.1, 0.2], "val_acc": [0.1, 0.3]},
            metrics.dataset_structures(dataset))
        mod.save_training_curves(out, {"train_loss": [1.0, 0.5]})
        path = mod.save_uncertainty_artifact(
            out, probs, sigma, images, labels,
            name=mod.uncertainty_artifact_name(0.1, "A"))
        _same(mod.load_uncertainty_artifact(path), [probs, sigma, images, labels])
        _same(mod.save_uncertainty(out, images_n=0, noise=0.1, where_noise="A",
                                   dataset=dataset), got)
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    assert _tree(t) == _tree(j) and len(_tree(t)) > 6
    for name in _tree(t):
        if not name.endswith(".png"):
            assert filecmp.cmp(os.path.join(t, name), os.path.join(j, name),
                               shallow=False), name


def test_report_helpers_equal_jax():
    for n_total, images_n, ds in ((403, 10, "hippocampus"), (57, 4, "brats"),
                                  (5, 10, "lungs")):
        _same(reports.sample_indices(n_total, images_n, ds),
              jreports.sample_indices(n_total, images_n, ds))
    assert reports.uncertainty_artifact_name(0.05, "P") == \
        jreports.uncertainty_artifact_name(0.05, "P")
    assert reports.uncertainty_artifact_name() == jreports.uncertainty_artifact_name()
    assert [n for n, f in inspect.getmembers(reports, inspect.isfunction)] == \
        [n for n, f in inspect.getmembers(jreports, inspect.isfunction)]


def test_uncertainty_accumulator_equal_jax(tmp_path):
    probs, sigma, images, labels = _report_inputs(n=9)
    for mod, sub in ((reports, "t"), (jreports, "j")):
        acc = mod.UncertaintyAccumulator(9, images_n=2, dataset="hippocampus",
                                         adversarial=False)
        for i in range(0, 9, 3):
            acc.update(images[i:i + 3], probs[i:i + 3], labels[i:i + 3], sigma[i:i + 3])
        assert acc.n_seen == 9 and acc.n_stashed == 2
        acc.finalize(str(tmp_path / sub))
    for name in _tree(str(tmp_path / "t")):
        if name.endswith(".txt"):
            assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False)
    assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))


# ----------------------------------------------------------------- loaders


def test_crop_and_expand_equal_jax():
    rng = np.random.default_rng(5)
    for shape, size in (((3, 32, 32), 22), ((2, 64, 64, 4), 54), ((2, 9, 9, 1), 4)):
        x = rng.normal(0, 1, shape)
        got = tdata.center_crop_np(x, size)
        _same(got, jdata.center_crop_np(x, size))
        from supernet_tpu.data.loaders import expand_to_shape as jexpand

        _same(tdata.expand_to_shape(got, shape[1], 0.5), jexpand(got, shape[1], 0.5))


@pytest.mark.parametrize("layout", ["nhw", "nchw", "onehot"])
def test_pickle_dataset_equal_jax(layout):
    rng = np.random.default_rng(6)
    n, c = 23, 1 if layout == "nhw" else 4
    x = rng.normal(0, 1, {"nhw": (n, 8, 8), "nchw": (n, 4, 8, 8),
                          "onehot": (n, 8, 8, 4)}[layout]).astype(np.float64)
    y = rng.integers(0, 3, (n, 8, 8))
    if layout == "onehot":
        y = np.eye(3)[y]
    t, j = tdata.PickleDataset(x, y, c), jdata.PickleDataset(x, y, c)
    assert len(t) == len(j) and t.steps_per_epoch(5) == j.steps_per_epoch(5)
    for kw in (dict(shuffle=True, seed=3, epoch=2), dict(drop_remainder=False), {}):
        _same(list(t.batches(5, **kw)), list(j.batches(5, **kw)))


def _write_brats_pickles(tmp_path, n_files=3):
    rng = np.random.default_rng(7)
    for i in range(n_files):
        x = rng.normal(0, 1, (4, 2, 8, 8)).astype(np.float32)  # NCHW
        y = rng.integers(0, 3, (4, 8, 8)).astype(np.uint8)
        with open(tmp_path / f"training_batch_{i}.pkl", "wb") as f:
            pickle.dump((x, y), f)
    return str(tmp_path / "training_batch_*.pkl")


def test_streaming_pickle_dataset_equal_jax(tmp_path):
    pattern = _write_brats_pickles(tmp_path)
    t = tdata.StreamingPickleDataset(pattern, 2, shuffle_buffer=5, seed=1)
    j = jdata.StreamingPickleDataset(pattern, 2, shuffle_buffer=5, seed=1)
    for kw in (dict(epoch=1), dict(shuffle=False, seed=9, drop_remainder=False)):
        _same(list(t.batches(3, **kw)), list(j.batches(3, **kw)))
    with pytest.raises(FileNotFoundError):
        tdata.StreamingPickleDataset(str(tmp_path / "none_*.pkl"))


def test_hippocampus_pickle_and_batch_iterator(tmp_path):
    rng = np.random.default_rng(8)
    blob = (rng.normal(0, 1, (6, 8, 8)), rng.integers(0, 3, (6, 8, 8)),
            rng.normal(0, 1, (4, 8, 8)), rng.integers(0, 3, (4, 8, 8)))
    path = str(tmp_path / "h.pkl")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    got = tdata.load_hippocampus_pickle(path)
    _same(got, jdata.load_hippocampus_pickle(path))
    assert len(got[2]) == 3  # the last test sample is dropped
    assert list(tdata.BatchIterator(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise ValueError("corrupt shard")

    it = tdata.BatchIterator(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


# --------------------------------------------------------------- synthetic


@pytest.mark.parametrize("name", ["hippocampus", "brats", "lungs"])
def test_synthetic_dataset_bit_equal_jax(name):
    import supernet_tpu.configs as jconfigs

    for seed in (0, 5):
        got = tdata.synthetic_dataset(configs.get_config(name).model, 5, seed=seed)
        want = jdata.synthetic_dataset(jconfigs.get_config(name).model, 5, seed=seed)
        _same(got, want)
        assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


def test_synthetic_volumes_bit_equal_jax():
    cfg = dataclasses.replace(CFG, image_size=12)
    jcfg = dataclasses.replace(JCFG, image_size=12)
    _same(tdata.synthetic_volumes(cfg, 2, seed=3), jdata.synthetic_volumes(jcfg, 2, seed=3))


# ------------------------------------------------------------------ shards


def _xy(n=37, h=8, c=2, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, h, h, c)).astype(np.float32),
            rng.integers(0, 3, (n, h, h)).astype(np.int32))


def test_io_cc_is_the_original_byte_for_byte():
    here = os.path.dirname(inspect.getsourcefile(native))
    there = os.path.dirname(inspect.getsourcefile(jnative))
    assert filecmp.cmp(os.path.join(here, "io.cc"), os.path.join(there, "io.cc"),
                       shallow=False)


def test_native_library_builds_outside_the_package():
    """The port compiles its library into build/torch_native/, not beside
    the source as the original does."""
    if not native.native_available():
        pytest.skip("no C++ compiler on this machine")
    so = native._library_path()
    assert os.path.isfile(so)
    assert os.path.basename(os.path.dirname(so)) == "torch_native"
    assert not [f for f in os.listdir(os.path.dirname(inspect.getsourcefile(native)))
                if f.endswith(".so")]


@pytest.mark.parametrize("onehot", [False, True])
def test_write_shards_equal_jax(tmp_path, onehot):
    x, y = _xy()
    if onehot:
        y = np.eye(3, dtype=np.int64)[y]
    t = tdata.write_shards(str(tmp_path / "t"), x, y, shard_size=10)
    j = jdata.write_shards(str(tmp_path / "j"), x, y, shard_size=10)
    assert [tuple(map(os.path.basename, p)) for p in t] == \
        [tuple(map(os.path.basename, p)) for p in j]
    for (tx, ty), (jx, jy) in zip(t, j):
        assert filecmp.cmp(tx, jx, shallow=False) and filecmp.cmp(ty, jy, shallow=False)
    assert tdata.shard_pairs(str(tmp_path / "t")) == t
    assert np.load(t[0][1]).shape == (10, 8, 8)  # one-hot labels become class maps


def test_convert_pickles_equal_jax(tmp_path):
    pattern = _write_brats_pickles(tmp_path)
    t = tdata.convert_pickles(pattern, str(tmp_path / "t"), in_channels=2, shard_size=3)
    j = jdata.convert_pickles(pattern, str(tmp_path / "j"), in_channels=2, shard_size=3)
    assert len(t) == len(j) == 6
    for (tx, ty), (jx, jy) in zip(t, j):
        assert filecmp.cmp(tx, jx, shallow=False) and filecmp.cmp(ty, jy, shallow=False)
    x, y = _xy(n=9, c=1)
    path = str(tmp_path / "h.pkl")
    with open(path, "wb") as f:
        pickle.dump((x[:5, ..., 0], y[:5], x[5:, ..., 0], y[5:]), f)
    for split, n in (("train", 5), ("test", 3)):
        pairs = tdata.convert_pickles(path, str(tmp_path / split), split=split)
        want = jdata.convert_pickles(path, str(tmp_path / ("j" + split)), split=split)
        assert filecmp.cmp(pairs[0][0], want[0][0], shallow=False)
        assert len(np.load(pairs[0][0])) == n


@pytest.mark.parametrize("shuffle", [False, True])
def test_shard_dataset_python_path_equal_jax(tmp_path, shuffle):
    x, y = _xy()
    tdata.write_shards(str(tmp_path), x, y, shard_size=10)
    t = tdata.ShardDataset(str(tmp_path), shuffle=shuffle, shuffle_buffer=7, seed=2,
                           use_native=False)
    j = jdata.ShardDataset(str(tmp_path), shuffle=shuffle, shuffle_buffer=7, seed=2,
                           use_native=False)
    assert len(t) == len(j) == 37 and t.x_shape == j.x_shape
    assert t.steps_per_epoch(5) == 7 and t.steps_per_epoch(5, False) == 8
    for kw in (dict(epoch=0), dict(epoch=3, drop_remainder=False)):
        _same(list(t.batches(5, **kw)), list(j.batches(5, **kw)))
    with pytest.raises(FileNotFoundError):
        tdata.ShardDataset(str(tmp_path / "empty"))


def test_native_loader_equal_jax(tmp_path):
    """The port's build of io.cc streams what the original's does: the same
    order without shuffling, the same sample set with it."""
    if not (native.native_available() and jnative.native_available()):
        pytest.skip("no C++ compiler on this machine")
    x, y = _xy()
    tdata.write_shards(str(tmp_path), x, y, shard_size=10)

    def batches(mod, shuffle, **kw):
        ds = mod.ShardDataset(str(tmp_path), shuffle=shuffle, seed=1, use_native=True)
        assert ds.use_native
        return list(ds.batches(5, **kw))

    got = batches(tdata, False, drop_remainder=False)
    _same(got, batches(jdata, False, drop_remainder=False))
    _same(np.concatenate([b[0] for b in got]), x)
    got = batches(tdata, True, epoch=2)
    want = batches(jdata, True, epoch=2)
    assert {b.tobytes() for xb, _ in got for b in xb} == \
        {b.tobytes() for xb, _ in want for b in xb}
    assert len(got) == 7 and got[0][0].dtype == np.float32 and got[0][1].dtype == np.int32


# ------------------------------------------------------------------- nifti


def _msd_task(root, n_vol=2, seed=10):
    rng = np.random.default_rng(seed)
    os.makedirs(root / "imagesTr")
    os.makedirs(root / "labelsTr")
    for i in range(n_vol):
        vol = rng.normal(100, 30, (20, 24, 6)).astype(np.float32)
        lab = np.zeros((20, 24, 6), np.uint8)
        lab[5:12, 6:15, 1:5] = 1 + (i % 2)
        jnifti.write_nifti(str(root / "imagesTr" / f"case_{i:03d}.nii.gz"), vol)
        jnifti.write_nifti(str(root / "labelsTr" / f"case_{i:03d}.nii.gz"), lab)


@pytest.mark.parametrize("dtype,gz", [(np.float32, False), (np.int16, True),
                                      (np.uint8, True), (np.float64, False)])
def test_nifti_io_equal_jax(tmp_path, dtype, gz):
    """Each package reads what the other wrote; both write the same bytes."""
    rng = np.random.default_rng(11)
    vol = (100 * rng.normal(0, 1, (5, 6, 7, 2))).astype(dtype)
    ext = ".nii.gz" if gz else ".nii"
    tp, jp = str(tmp_path / ("t" + ext)), str(tmp_path / ("j" + ext))
    nifti.write_nifti(tp, vol)
    jnifti.write_nifti(jp, vol)
    for reader in (nifti.read_nifti, jnifti.read_nifti):
        for path in (tp, jp):
            data, hdr = reader(path)
            np.testing.assert_array_equal(data, vol)
    _same(nifti.read_nifti(jp)[1], jnifti.read_nifti(jp)[1])
    if not gz:  # gzip stamps its header with the time
        assert filecmp.cmp(tp, jp, shallow=False)
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError):
        nifti.read_nifti(str(bad))


@pytest.mark.parametrize("image_size,keep_empty", [(32, False), (16, True), (16, False)])
def test_volume_to_slices_and_cube_equal_jax(image_size, keep_empty):
    rng = np.random.default_rng(12)
    for shape in ((20, 24, 6), (20, 24, 6, 4)):
        vol = rng.normal(50, 10, shape).astype(np.float32)
        lab = np.zeros(shape[:3], np.uint8)
        lab[4:9, 5:11, 2:4] = 2
        _same(nifti.volume_to_slices(vol, lab, image_size, keep_empty=keep_empty),
              jnifti.volume_to_slices(vol, lab, image_size, keep_empty=keep_empty))
        _same(nifti.volume_to_cube(vol, lab, 16), jnifti.volume_to_cube(vol, lab, 16))


def test_convert_nifti_dir_equal_jax(tmp_path):
    _msd_task(tmp_path / "task")
    t = nifti.convert_nifti_dir(str(tmp_path / "task"), str(tmp_path / "t"),
                                image_size=32, shard_size=4)
    j = jnifti.convert_nifti_dir(str(tmp_path / "task"), str(tmp_path / "j"),
                                 image_size=32, shard_size=4)
    assert len(t) == len(j) > 0
    for (tx, ty), (jx, jy) in zip(t, j):
        assert filecmp.cmp(tx, jx, shallow=False) and filecmp.cmp(ty, jy, shallow=False)
    ds = tdata.ShardDataset(str(tmp_path / "t"), use_native=False)
    xb, yb = next(ds.batches(2))
    assert xb.shape == (2, 32, 32, 1) and yb.shape == (2, 32, 32) and yb.max() > 0


# ----------------------------------------------------------------- augment


def _aug_xy(b=8, seed=0, h=32, hy=22, c=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(0, 1, (b, h, h, c)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, (b, hy, hy)).astype(np.int32)))


def test_rot90_matches_numpy():
    """The rotation selects equal np.rot90 for every count (the keys are
    driven until all four appear)."""
    cfg = configs.AugmentConfig(hflip=False, vflip=False, rot90=True)
    img = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (1, 6, 6, 2))
                           .astype(np.float32))
    seen = set()
    for key in range(40):
        bits, _ = augment.image_draws(key, 1)
        got, _ = augment.augment_batch(key, img, None, cfg)
        rk = int(bits[0, 0])
        np.testing.assert_array_equal(
            got[0].numpy(), np.rot90(img[0].numpy(), k=rk, axes=(0, 1)))
        seen.add(rk)
    assert seen == {0, 1, 2, 3}


def test_image_and_label_share_the_spatial_draw():
    _, y = _aug_xy()
    x = y[..., None].float()  # the image IS the label pattern
    xa, ya = augment.augment_batch(3, x, y, configs.AugmentConfig(rot90=True))
    np.testing.assert_array_equal(xa[..., 0].int().numpy(), ya.numpy())
    assert not torch.equal(ya, y)


def test_spatial_ops_commute_with_center_crop():
    from supernet_tpu_torch.ops import crop_center

    x, _ = _aug_xy(b=4)
    cfg = configs.AugmentConfig(rot90=True)
    full_then_crop = crop_center(augment.augment_batch(7, x, None, cfg)[0], 22, 22)
    crop_then_aug = augment.augment_batch(7, crop_center(x, 22, 22), None, cfg)[0]
    assert torch.equal(full_then_crop, crop_then_aug)


def test_intensity_and_noise_touch_image_only():
    x, y = _aug_xy()
    cfg = configs.AugmentConfig(hflip=False, vflip=False, rot90=False,
                                intensity_scale=0.2, intensity_shift=0.1, noise_std=0.05)
    xa, ya = augment.augment_batch(0, x, y, cfg)
    assert torch.equal(ya, y) and not torch.equal(xa, x)
    # without noise each image is an affine map of itself within the ranges
    cfg = dataclasses.replace(cfg, noise_std=0.0)
    xa, _ = augment.augment_batch(0, x, y, cfg)
    _, u = augment.image_draws(0, len(x))
    s = 0.8 + 0.4 * u[:, 0]
    d = 0.2 * u[:, 1] - 0.1
    assert torch.equal(xa, x * s.view(-1, 1, 1, 1) + d.view(-1, 1, 1, 1))
    assert (s >= 0.8).all() and (s <= 1.2).all() and (d.abs() <= 0.1).all()


def test_flattened_onehot_label_roundtrip():
    x, y = _aug_xy()
    y1h = train.one_hot_flatten(y, 3)
    cfg = configs.AugmentConfig(rot90=True)
    xa, ya = augment.augment_train_batch(5, x, y1h, 22, cfg, seed=0)
    xb, yb = augment.augment_train_batch(5, x, y, 22, cfg, seed=0)
    assert ya.shape == y1h.shape and torch.equal(xa, xb)
    np.testing.assert_array_equal(ya.reshape(8, 22, 22, 3).argmax(-1).numpy(), yb.numpy())
    # another step, another draw; another seed, another draw
    assert not torch.equal(augment.augment_train_batch(6, x, y, 22, cfg, seed=0)[0], xb)
    assert not torch.equal(augment.augment_train_batch(5, x, y, 22, cfg, seed=1)[0], xb)


def test_sharding_invariant_randomness():
    """The same global batch augments identically whole and as 4 shards
    (the draws are keyed by the global image index), noise apart."""
    x, y = _aug_xy()
    cfg = configs.AugmentConfig(rot90=True, intensity_scale=0.1, intensity_shift=0.05)
    xw, yw = augment.augment_batch(11, x, y, cfg)
    parts = [augment.augment_batch(11, x[i:i + 2], y[i:i + 2], cfg, index_offset=i)
             for i in range(0, 8, 2)]
    assert torch.equal(torch.cat([p[0] for p in parts]), xw)
    assert torch.equal(torch.cat([p[1] for p in parts]), yw)


def test_draws_have_the_jax_distribution():
    """Flip and rotation frequencies and the intensity range against the
    JAX module's, by distribution: 2000 images each."""
    n = 2000
    bits, u = augment.image_draws(123, n)
    jkeys = jaugment._image_keys(jax.random.PRNGKey(0), n, None)
    jbits = np.asarray(jax.vmap(
        lambda k: jax.random.randint(jax.random.split(k)[0], (3,), 0, 4))(jkeys))
    for col in range(3):
        for v in range(4):
            got = float((bits[:, col] == v).float().mean())
            want = float((jbits[:, col] == v).mean())
            assert abs(got - 0.25) < 0.04 and abs(want - 0.25) < 0.04
    assert abs(float(u.mean()) - 0.5) < 0.03 and 0 <= float(u.min()) and float(u.max()) < 1
    assert abs(float(u.var()) - 1 / 12) < 0.01
    # noise: the requested std, another field per step
    x = torch.zeros(4, 32, 32, 1)
    cfg = configs.AugmentConfig(hflip=False, vflip=False, noise_std=0.05)
    a = augment.augment_train_batch(0, x, torch.zeros(4, 22, 22, dtype=torch.int32), 22, cfg, 0)[0]
    b = augment.augment_train_batch(1, x, torch.zeros(4, 22, 22, dtype=torch.int32), 22, cfg, 0)[0]
    assert abs(float(a.std()) - 0.05) < 0.005 and not torch.equal(a, b)


def test_rot90_needs_square_frames():
    with pytest.raises(ValueError, match="square"):
        augment.augment_batch(0, torch.zeros(2, 6, 8, 1), None,
                              configs.AugmentConfig(rot90=True))


def test_train_step_augments_by_step_and_index():
    """The step applies ``maybe_augment`` keyed by ``state.step``: a step on
    a batch equals a step without augmentation on the batch augmented by
    hand, and ``maybe_augment`` without a config is the identity."""
    from supernet_tpu_torch.models import init_params

    aug = configs.AugmentConfig(rot90=True, intensity_scale=0.1)
    tc = dataclasses.replace(configs.HIPPOCAMPUS.train, augment=aug)
    tc0 = configs.HIPPOCAMPUS.train
    params = init_params(torch.Generator().manual_seed(0), CFG, "cpu")
    x, y = _aug_xy(b=4)
    assert train.maybe_augment(0, x, y, CFG, tc0) == (x, y)
    a, _ = train.create_train_state(params, tc, "cpu")
    b, _ = train.create_train_state(params, tc0, "cpu")
    a.step = b.step = 7
    xa, ya = train.maybe_augment(7, x, y, CFG, tc)
    assert not torch.equal(xa, x)
    a, ma = train.make_train_step(CFG, tc)(a, x.numpy(), y.numpy())
    b, mb = train.make_train_step(CFG, tc0)(b, xa, ya)
    assert float(ma.loss) == float(mb.loss) and a.step == b.step == 8
    for p, q in zip(train.leaves(a.params), train.leaves(b.params)):
        assert torch.equal(p, q)
    # make_multi_train_step augments each of its steps with that step's key
    c, _ = train.create_train_state(params, tc, "cpu")
    c.step = 7
    c, mc = train.make_multi_train_step(CFG, tc, 1)(c, x.numpy()[None], y.numpy()[None])
    assert float(mc.loss[0]) == float(ma.loss)
