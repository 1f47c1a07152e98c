"""The port's noise protocol (``supernet_tpu_torch/perturb.py``) on the CPU
against ``supernet_tpu.perturb``: the cases of ``tests/test_attacks_perturb.py``
from ``test_region_mask_hippocampus`` on.

``jax.random`` and ``torch.Generator`` streams differ, so the arithmetic
after the draw (region mask, crop-frame clip, SNR, salt-and-pepper's values)
is held equal to the JAX function for one injected draw (``NOISY_ATOL`` on
the images, ``SNR_RTOL`` on the SNR), and the draws are compared by
distribution.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu import perturb as jperturb  # noqa: E402
from supernet_tpu.configs import NoiseConfig as JNoiseConfig  # noqa: E402
from supernet_tpu_torch import perturb  # noqa: E402
from supernet_tpu_torch.configs import NoiseConfig  # noqa: E402

NOISY_ATOL = 1e-6
SNR_RTOL = 1e-5


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dataset,region", [
    ("hippocampus", "A"), ("hippocampus", "P"), ("hippocampus", "all"),
    ("brats", "O"), ("brats", "B"), ("brats", "all"), ("lungs", "O"), ("lungs", "A"),
])
def test_region_mask_matches_jax(dataset, region):
    y = np.random.default_rng(0).integers(0, 5, (2, 6, 6)).astype(np.int32)
    got = perturb.region_mask(_t(y), region, dataset)
    want = jperturb.region_mask(jnp.asarray(y), region, dataset)
    if want is None:
        assert got is None
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_region_mask_hippocampus():
    y = torch.tensor([[[0, 1], [2, 1]]])
    np.testing.assert_array_equal(
        perturb.region_mask(y, "A", "hippocampus").numpy(), [[[0, 1], [0, 1]]])
    np.testing.assert_array_equal(
        perturb.region_mask(y, "P", "hippocampus").numpy(), [[[0, 0], [1, 0]]])
    assert perturb.region_mask(y, "all", "hippocampus") is None


def test_region_mask_brats():
    y = torch.tensor([[[0, 1], [2, 4]]])
    np.testing.assert_array_equal(
        perturb.region_mask(y, "O", "brats").numpy(), [[[0, 1], [1, 1]]])
    np.testing.assert_array_equal(
        perturb.region_mask(y, "B", "brats").numpy(), [[[1, 0], [0, 0]]])


def test_gaussian_noise_region_selective():
    x = torch.ones((1, 4, 4, 1))
    y = torch.zeros((1, 4, 4), dtype=torch.int32)
    y[0, 1, 1] = 1
    nc = NoiseConfig(kind="gaussian", std=0.5, region="A")
    noisy, snr = perturb.apply_noise(_gen(), x, y, nc, "hippocampus")
    diff = (noisy - x).numpy()[0, :, :, 0]
    # only the anterior pixel may change (up to clipping)
    assert set(zip(*np.nonzero(diff != 0))).issubset({(1, 1)})
    assert np.isfinite(float(snr))


def test_clip_to_clean_range():
    x = _t(np.linspace(0, 1, 16, dtype=np.float32).reshape(1, 4, 4, 1))
    y = torch.zeros((1, 4, 4), dtype=torch.int32)
    nc = NoiseConfig(kind="gaussian", std=10.0, region="all")
    noisy, _ = perturb.apply_noise(_gen(), x, y, nc, "hippocampus")
    assert float(noisy.min()) >= 0.0 and float(noisy.max()) <= 1.0
    assert float(noisy.min()) == 0.0 and float(noisy.max()) == 1.0  # it did clip


def test_salt_and_pepper_additive_clip_semantics():
    """Reference semantics (Brats_functions.py:565-582 + Brats.py:1255-1275):
    the S&P array is ADDED to x and the result clipped to the clean batch
    range: salted pixels saturate at the batch max, peppered pixels add
    low_clip=0 (unchanged) on non-negative data."""
    x = _t(np.linspace(0.0, 1.0, 256, dtype=np.float32).reshape(1, 16, 16, 1))
    y = torch.zeros((1, 16, 16), dtype=torch.int32)
    nc = NoiseConfig(kind="salt_and_pepper", std=0.5, region="all")
    noisy, _ = perturb.apply_noise(_gen(3), x, y, nc, "brats")
    xn, nn = x.numpy(), noisy.numpy()
    changed = nn != xn
    assert changed.any()  # with p=0.5 on 256 pixels, salt flips occur
    np.testing.assert_allclose(nn[changed], 1.0)
    assert (nn >= xn - 1e-7).all()  # pepper never lowers non-negative data


def test_salt_and_pepper_signed_low_clip():
    """Signed input selects low_clip=-1 (Brats_functions.py:571-575)."""
    x = _t(np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(1, 8, 8, 1))
    delta = perturb.salt_and_pepper(_gen(), x, p=0.7, q=0.5)
    vals = set(np.unique(delta.numpy()).tolist())
    assert vals.issubset({-1.0, 0.0, 1.0})
    assert -1.0 in vals and 1.0 in vals


@pytest.mark.parametrize("signed", [False, True])
def test_salt_and_pepper_values_match_jax_for_its_draws(signed):
    """The JAX function's own boolean draws (recovered from its key) through
    the port's arithmetic give the JAX function's array."""
    lo = -1.0 if signed else 0.0
    x = np.linspace(lo, 1.0, 128, dtype=np.float32).reshape(2, 8, 8, 1)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jperturb.salt_and_pepper(key, jnp.asarray(x), 0.6, 0.4))
    k1, k2 = jax.random.split(key)
    flipped = np.asarray(jax.random.bernoulli(k1, 0.6, x.shape))
    salted = np.asarray(jax.random.bernoulli(k2, 0.4, x.shape))
    got = perturb.salt_and_pepper_values(_t(flipped), _t(salted), _t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


def test_snr_db():
    x = torch.ones((1, 2, 2, 1))
    noisy = x + 0.1
    # SNR = 10 log10(sum x^2 / sum (x - noisy)^2) = 10 log10(4 / 0.04) = 20
    assert float(perturb.snr_db(x, noisy)) == pytest.approx(20.0, abs=1e-3)
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (3, 9, 9, 2)).astype(np.float32)
    b = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
    np.testing.assert_allclose(float(perturb.snr_db(_t(a), _t(b))),
                               float(jperturb.snr_db(jnp.asarray(a), jnp.asarray(b))),
                               rtol=SNR_RTOL)
    # identical frames: the denominator's floor, not a division by zero
    np.testing.assert_allclose(float(perturb.snr_db(_t(a), _t(a))),
                               float(jperturb.snr_db(jnp.asarray(a), jnp.asarray(a))),
                               rtol=SNR_RTOL)


def test_speckle_scales_with_signal():
    x = torch.zeros((1, 4, 4, 1))
    y = torch.zeros((1, 4, 4), dtype=torch.int32)
    nc = NoiseConfig(kind="speckle", std=0.5, region="all")
    noisy, _ = perturb.apply_noise(_gen(), x, y, nc, "hippocampus")
    # speckle noise on zero signal is zero
    assert torch.equal(noisy, x)


def _crop_case():
    B, H, crop = 1, 6, 4
    x = np.full((B, H, H, 1), -3.0, np.float32)  # border below crop min
    x[0, 0, 0, 0] = 7.0  # and above crop max
    interior = np.linspace(0.0, 1.0, crop * crop, dtype=np.float32).reshape(crop, crop)
    x[0, 1:5, 1:5, 0] = interior
    return x, np.zeros((B, H, H), np.int32), interior, crop


def test_cropped_frame_clip_and_snr_semantics():
    """The reference clips noisy images to the min/max of the CENTER-CROPPED
    clean batch and computes SNR on the cropped frames
    (`Hippocampus.py:1270-1271,1298,1302-1307`). Pinned with a deterministic
    S&P (+1 everywhere) batch whose border values lie outside the crop
    range; the JAX function gives the same image and SNR."""
    x, y, interior, crop = _crop_case()
    # p=1, q=1: every pixel salted -> delta = +1 everywhere (deterministic)
    kw = dict(kind="salt_and_pepper", std=1.0, sp_ratio=1.0, region="all")
    noisy, snr = perturb.apply_noise(_gen(), _t(x), _t(y), NoiseConfig(**kw), "brats",
                                     crop_size=crop)
    nn = noisy.numpy()[0, :, :, 0]
    # clip range is the CROP frame's [0, 1], not the full frame's [-3, 7]
    expected = np.clip(x[0, :, :, 0] + 1.0, 0.0, 1.0)
    np.testing.assert_allclose(nn, expected, rtol=1e-6)
    noisy_c = expected[1:5, 1:5]
    exp_snr = 10.0 * np.log10(np.sum(interior**2) / np.sum((noisy_c - interior) ** 2))
    assert float(snr) == pytest.approx(float(exp_snr), abs=1e-4)
    jnoisy, jsnr = jperturb.apply_noise(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y),
                                        JNoiseConfig(**kw), "brats", crop_size=crop)
    np.testing.assert_allclose(noisy.numpy(), np.asarray(jnoisy), atol=NOISY_ATOL)
    # this case's SNR is 0 dB (5e-7 in one package, 0 in the other)
    np.testing.assert_allclose(float(snr), float(jsnr), rtol=SNR_RTOL, atol=1e-5)


def test_apply_noise_without_crop_matches_full_frame():
    """crop_size=0 (or == frame) keeps the full-frame behaviour."""
    x = _t(np.linspace(0, 1, 36, dtype=np.float32).reshape(1, 6, 6, 1))
    y = torch.zeros((1, 6, 6), dtype=torch.int32)
    nc = NoiseConfig(kind="gaussian", std=0.3, region="all")
    n0, s0 = perturb.apply_noise(_gen(1), x, y, nc, "hippocampus")
    n1, s1 = perturb.apply_noise(_gen(1), x, y, nc, "hippocampus", crop_size=6)
    assert torch.equal(n0, n1)
    assert float(s0) == pytest.approx(float(s1))


@pytest.mark.parametrize("crop", [0, 8])
@pytest.mark.parametrize("dataset,region", [("hippocampus", "A"), ("hippocampus", "all"),
                                            ("brats", "B")])
@pytest.mark.parametrize("kind", ["gaussian", "speckle", "salt_and_pepper"])
def test_apply_delta_matches_jax_for_an_injected_draw(monkeypatch, kind, dataset, region, crop):
    """One draw, made here with numpy, goes into the JAX function (its draw
    function replaced for the call) and into the port's ``apply_delta``: the
    same noisy image and the same SNR."""
    rng = np.random.default_rng(7)
    x = rng.normal(0.3, 1.0, (3, 12, 12, 2)).astype(np.float32)
    y = rng.integers(0, 3, (3, 12, 12)).astype(np.int32)
    if kind == "salt_and_pepper":
        delta = rng.choice([-1.0, 0.0, 1.0], x.shape).astype(np.float32)
    else:
        delta = (0.2 * rng.normal(0, 1, x.shape)).astype(np.float32)
        if kind == "speckle":
            delta = x * delta
    monkeypatch.setattr(jperturb, f"{kind}_noise" if kind != "salt_and_pepper" else kind,
                        lambda key, xx, *a: jnp.asarray(delta))
    kw = dict(kind=kind, std=0.2, region=region)
    jnoisy, jsnr = jperturb.apply_noise(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y),
                                        JNoiseConfig(**kw), dataset, crop_size=crop)
    noisy, snr = perturb.apply_delta(_t(x), _t(y), _t(delta), NoiseConfig(**kw), dataset,
                                     crop_size=crop)
    assert noisy.shape == x.shape and noisy.dtype == torch.float32
    np.testing.assert_allclose(noisy.numpy(), np.asarray(jnoisy), atol=NOISY_ATOL)
    np.testing.assert_allclose(float(snr), float(jsnr), rtol=SNR_RTOL)
    assert not np.array_equal(noisy.numpy(), x)


def test_draws_by_distribution():
    """gaussian: N(0, std); speckle: x * N(0, std); S&P: flip rate p, salt
    share q; each beside the JAX function's draw."""
    x = np.full((4, 64, 64, 1), 2.0, np.float32)
    key = jax.random.PRNGKey(0)
    for fn, jfn, scale in ((perturb.gaussian_noise, jperturb.gaussian_noise, 1.0),
                           (perturb.speckle_noise, jperturb.speckle_noise, 2.0)):
        for d in (fn(_gen(2), _t(x), 0.3).numpy(), np.asarray(jfn(key, jnp.asarray(x), 0.3))):
            assert d.shape == x.shape and d.dtype == np.float32
            assert abs(d.mean()) < 0.02 * scale
            np.testing.assert_allclose(d.std(), 0.3 * scale, rtol=0.03)
    for d in (perturb.salt_and_pepper(_gen(2), _t(x), 0.3, 0.25).numpy(),
              np.asarray(jperturb.salt_and_pepper(key, jnp.asarray(x), 0.3, 0.25))):
        # non-negative data: pepper adds 0, so only salt shows: p * q
        np.testing.assert_allclose((d == 1.0).mean(), 0.3 * 0.25, atol=0.01)
        assert set(np.unique(d)) <= {0.0, 1.0}
    signed = perturb.salt_and_pepper(_gen(2), _t(x - 3.0), 0.3, 0.25).numpy()
    np.testing.assert_allclose((signed != 0).mean(), 0.3, atol=0.01)
    np.testing.assert_allclose((signed == 1.0).sum() / (signed != 0).sum(), 0.25, atol=0.02)


def test_noise_generator_is_keyed_by_seed_and_batch():
    """The same (seed, batch index) gives the same noise whatever came
    before; another batch index or seed gives other noise. The generator is
    a CPU one, so a batch on the card gets these same draws."""
    x = torch.zeros((2, 8, 8, 1))
    a = perturb.gaussian_noise(perturb.noise_generator(3, 5), x, 1.0)
    b = perturb.gaussian_noise(perturb.noise_generator(3, 5), x, 1.0)
    assert torch.equal(a, b)
    assert perturb.noise_generator(3, 5).device.type == "cpu"
    for other in (perturb.noise_generator(3, 6), perturb.noise_generator(4, 5)):
        assert not torch.equal(a, perturb.gaussian_noise(other, x, 1.0))


def test_none_unknown_and_volumes():
    x = torch.ones((1, 4, 4, 1))
    y = torch.zeros((1, 4, 4), dtype=torch.int32)
    for nc in (NoiseConfig(), NoiseConfig(kind="gaussian", std=0.0)):
        noisy, snr = perturb.apply_noise(_gen(), x, y, nc)
        assert noisy is x and float(snr) == float("inf")
    with pytest.raises(ValueError, match="unknown noise kind"):
        perturb.apply_noise(_gen(), x, y, NoiseConfig(kind="poisson", std=0.1))
    vol = torch.ones((1, 4, 4, 4, 1))
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*'3-D family'"):
        perturb.apply_noise(_gen(), vol, torch.zeros((1, 4, 4, 4), dtype=torch.int32),
                            NoiseConfig(kind="gaussian", std=0.1), crop_size=2)
