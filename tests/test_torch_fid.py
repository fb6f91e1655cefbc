"""The port's FID == colddiff.eval.fid, and its resize == jax.image.resize.

  - ``ops.image.resize_bilinear`` against ``jax.image.resize(...,
    "bilinear")`` where it shrinks (JAX antialiases) and where it grows
    (JAX does not): fp32, atol 1e-6;
  - ``frechet_distance`` (the same scipy code: rtol 1e-12) and
    ``activation_statistics``, which drops the remainder (fp64 features:
    rtol 1e-12);
  - the fallback extractor's weights, derived again with JAX: exactly; its
    features: fp32, rtol 1e-5 (atol 1e-6 for features near 0);
  - the Inception pool3 graph against JAX's ``inception_pool3_features``
    under ``jax.enable_x64`` on ``synth_state_dict`` weights, fp64, B=2 at
    32 px in: rtol 1e-9;
  - the copied ``CONV_SPECS`` and ``synth_state_dict``: exactly;
  - the weights-free FID golden: JAX's ``calculate_fid_given_samples``
    against the port's on one fp64 ``synth_state_dict``, the port's
    through its checkpoint loader: rtol 1e-5.

Torch runs one thread in this file (a module fixture): the suite's test
processes share the machine's cores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.eval import fid as jfid
from colddiff.eval import torch_inception_ref
from colddiff_torch.eval import fid
from colddiff_torch.ops.image import resize_bilinear


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_inception_weights(monkeypatch, tmp_path):
    """Both packages look for weights in $COLDDIFF_INCEPTION_WEIGHTS and the
    working directory: neither holds any here."""
    monkeypatch.delenv("COLDDIFF_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("src,dst", [
    ((128, 128), (64, 64)), ((128, 128), (16, 16)), ((100, 100), (64, 64)),
    ((16, 16), (4, 4)), ((33, 20), (7, 5)),  # shrinks: antialiased
    ((64, 64), (299, 299)), ((32, 32), (299, 299)), ((16, 16), (64, 64)),
    ((8, 12), (16, 30)),  # grows: not antialiased
    ((64, 64), (64, 64)), ((64, 48), (64, 20)),  # one axis kept
])
@pytest.mark.parametrize("c", [1, 3])
def test_resize_matches_jax(src, dst, c):
    x = np.random.default_rng(0).uniform(-1, 1, (2, *src, c)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, c), method="bilinear")
    got = resize_bilinear(torch.from_numpy(x), dst)
    assert got.shape == (2, *dst, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_resize_refuses_shrink_and_grow_at_once():
    with pytest.raises(ValueError, match="shrinks one axis"):
        resize_bilinear(torch.zeros(1, 16, 16, 3), (8, 32))


def _spd(rng, d):
    a = rng.standard_normal((d, 2 * d))
    return a @ a.T / (2 * d)


@pytest.mark.parametrize("d", [2, 4, 32])
def test_frechet_distance_matches_jax(d):
    rng = np.random.default_rng(d)
    mu1, mu2 = rng.standard_normal(d), rng.standard_normal(d)
    s1, s2 = _spd(rng, d), _spd(rng, d)
    for args in ((mu1, s1, mu2, s2), (mu1, s1, mu1, s1)):
        np.testing.assert_allclose(fid.frechet_distance(*args), jfid.frechet_distance(*args),
                                   rtol=1e-12, atol=1e-12)


def test_frechet_distance_of_one_feature():
    """(m1 - m2)^2 + (s1 - s2)^2 for 1-d Gaussians; the JAX copy's
    ``sqrtm(..., disp=False)`` cannot unpack SciPy 1.17's 1x1 result."""
    got = fid.frechet_distance(np.array([1.0]), np.array([[4.0]]), np.array([3.0]),
                               np.array([[9.0]]))
    assert got == pytest.approx((1 - 3) ** 2 + (2 - 3) ** 2, rel=1e-12)


@pytest.mark.parametrize("n,batch_size", [(10, 4), (8, 4), (3, 4)])
def test_activation_statistics_drop_the_remainder(n, batch_size):
    """n // batch_size batches (the remainder dropped), one batch of all n
    when n < batch_size; the features here are fp64 channel means and
    squares."""
    x = np.random.default_rng(n).uniform(-1, 1, (n, 4, 4, 3))

    def tfeat(b):
        return torch.cat([b.mean(dim=(1, 2)), b.square().mean(dim=(1, 2))], dim=1)

    def jfeat(b):
        return jnp.concatenate([b.mean(axis=(1, 2)), (b ** 2).mean(axis=(1, 2))], axis=1)

    used = n if n < batch_size else n // batch_size * batch_size
    mu, sigma = fid.activation_statistics(x, tfeat, batch_size)
    feats = tfeat(torch.from_numpy(x[:used])).numpy()
    np.testing.assert_allclose(mu, feats.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(sigma, np.cov(feats, rowvar=False), rtol=1e-12)
    with jax.enable_x64(True):
        jmu, jsigma = jfid.activation_statistics(x, jfeat, batch_size)
    np.testing.assert_allclose(mu, jmu, rtol=1e-12)
    np.testing.assert_allclose(sigma, jsigma, rtol=1e-12, atol=1e-15)


def test_fallback_weights_are_jax_draws():
    k1, k2 = jax.random.split(jax.random.key(20220809))
    want = {"w1": np.asarray(jax.random.normal(k1, (7, 7, 3, 64)) * 0.1),
            "w2": np.asarray(jax.random.normal(k2, (3, 3, 64, 128)) * 0.1)}
    with np.load(fid.FALLBACK_WEIGHTS) as got:
        assert sorted(got.files) == ["w1", "w2"]
        for k, w in want.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], w)


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (3, 64, 64, 3), (2, 128, 128, 3),
                                   (2, 32, 32, 1), (2, 50, 50, 3)])
def test_fallback_features_match_jax(shape):
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    jf = jfid.fid_features_fn()
    tf = fid.fid_features_fn(device="cpu")
    assert (tf.is_inception, tf.name) == (jf.is_inception, jf.name) == (
        False, "fallback-random-projection")
    got = tf(torch.from_numpy(x))
    assert got.shape == (shape[0], 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jf(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)


def test_copied_inception_spec_and_weights():
    assert fid.CONV_SPECS == torch_inception_ref.CONV_SPECS
    for kw in ({}, {"seed": 3, "dtype": np.float32}):
        want, got = torch_inception_ref.synth_state_dict(**kw), fid.synth_state_dict(**kw)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _jax_params(sd):
    return {k: jnp.asarray(np.transpose(v, (2, 3, 1, 0)) if k.endswith(".conv.weight")
                           else v) for k, v in sd.items()}


def test_inception_pool3_matches_jax_fp64():
    sd = fid.synth_state_dict()
    x = np.random.default_rng(42).uniform(-1.0, 1.0, (2, 32, 32, 3))
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    got = fid.inception_pool3_features(p, torch.from_numpy(x))
    with jax.enable_x64(True):
        want = np.asarray(jfid.inception_pool3_features(_jax_params(sd), jnp.asarray(x)))
    assert got.shape == (2, 2048) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)


def test_fid_golden_matches_jax_fp64(tmp_path):
    """The FID number itself, weights-free (VERDICT.md:225-231): the port
    loads a saved fp64 ``synth_state_dict`` through its checkpoint loader,
    JAX runs the same weights through its pool3 graph (op by op: jitting
    the graph takes XLA ~20 s here); two sets of 3 images at 32 px and
    batch_size 2, so each side drops one image of each set."""
    sd = fid.synth_state_dict(seed=1)
    path = tmp_path / "pt_inception_synth.pth"
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    rng = np.random.default_rng(5)
    real = rng.uniform(-1, 1, (3, 32, 32, 3))
    fake = np.clip(real + 0.3 * rng.standard_normal(real.shape), -1, 1)
    feats = fid.fid_features_fn(str(path), device="cpu")
    assert (feats.is_inception, feats.name) == (True, "inception")
    got = fid.calculate_fid_given_samples([real, fake], batch_size=2, features=feats)
    with jax.enable_x64(True):
        p = _jax_params(sd)
        want = jfid.calculate_fid_given_samples(
            [real, fake], batch_size=2, features=lambda x: jfid.inception_pool3_features(p, x))
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_inception_features_take_grayscale_and_fp32(tmp_path):
    """A real checkpoint is fp32: the loader keeps the file's dtype, a
    one-channel batch is tiled to three, and the classifier keys are
    left out."""
    sd = fid.synth_state_dict(seed=2, dtype=np.float32)
    path = tmp_path / "synth32.pth"
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    feats = fid.inception_features_from_torch_checkpoint(path, device="cpu")
    gray = np.random.default_rng(3).uniform(-1, 1, (1, 24, 24, 1)).astype(np.float32)
    got = feats(torch.from_numpy(gray))
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    want = fid.inception_pool3_features(p, torch.from_numpy(np.repeat(gray, 3, axis=-1)))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_features_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid.fid_features_fn()
