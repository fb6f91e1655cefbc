"""The port's GMM == colddiff.eval.gmm, with JAX's draws replayed.

``fit_gmm`` takes JAX's ``choice(replace=False)`` init indices as
``init_idx`` and ``sample_gmm`` JAX's categorical components and normals as
``comp`` and ``z``, so both sides run the same EM and the same draws in
fp32: rtol 1e-5, atol 1e-6 (the frameworks' fp32 summation orders over a
few hundred points and up to 100 EM steps on well-separated clusters).
The port's own draws come from a ``torch.Generator``.

Torch runs one thread in this file (a module fixture): the suite's test
processes share the machine's cores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.eval import gmm as jgmm
from colddiff_torch.eval import gmm

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clusters(seed, d, k, n_each=100, spread=0.1):
    """k well-separated Gaussian clusters in d dimensions, fp32."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (k, d))
    x = np.concatenate([c + spread * rng.standard_normal((n_each, d)) for c in centers])
    return x[rng.permutation(len(x))].astype(np.float32)


def _as_torch(g: jgmm.GMM) -> gmm.GMM:
    return gmm.GMM(*(torch.from_numpy(np.array(f)) for f in g))


def _assert_gmm_close(got: gmm.GMM, want: jgmm.GMM):
    for name, g, w in zip(gmm.GMM._fields, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("d,k", [(2, 2), (3, 3), (1, 2)])
def test_log_prob_matches_jax(d, k):
    rng = np.random.default_rng(d * 10 + k)
    x = rng.standard_normal((50, d)).astype(np.float32)
    a = rng.standard_normal((k, d, d))
    want = jgmm.GMM(jnp.asarray(rng.dirichlet(np.ones(k)), jnp.float32),
                    jnp.asarray(rng.standard_normal((k, d)), jnp.float32),
                    jnp.asarray(a @ a.transpose(0, 2, 1) + np.eye(d), jnp.float32))
    got = gmm._log_prob(_as_torch(want), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgmm._log_prob(want, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("d,k,n_iters", [(2, 2, 50), (3, 3, 100), (1, 2, 20), (3, 1, 5)])
def test_fit_gmm_matches_jax_with_its_init(d, k, n_iters):
    x = _clusters(d, d, k)
    key = jax.random.key(d + k)
    want = jgmm.fit_gmm(jnp.asarray(x), k, key, n_iters=n_iters)
    idx = np.asarray(jax.random.choice(key, x.shape[0], (k,), replace=False))
    got = gmm.fit_gmm(torch.from_numpy(x), k, n_iters=n_iters, init_idx=torch.from_numpy(idx))
    _assert_gmm_close(got, want)


@pytest.mark.parametrize("d,k,num", [(2, 2, 300), (3, 3, 64), (4, 1, 10)])
def test_sample_gmm_matches_jax_with_its_draws(d, k, num):
    x = _clusters(7 + d, d, k)
    fitted = jgmm.fit_gmm(jnp.asarray(x), k, jax.random.key(0), n_iters=30)
    key = jax.random.key(11)
    want = jgmm.sample_gmm(fitted, key, num)
    k_rng, g_rng = jax.random.split(key)
    comp = jax.random.categorical(k_rng, jnp.log(fitted.weights), shape=(num,))
    z = jax.random.normal(g_rng, (num, d))
    got = gmm.sample_gmm(_as_torch(fitted), None, num, comp=torch.from_numpy(np.asarray(comp)),
                         z=torch.from_numpy(np.asarray(z)))
    assert got.shape == (num, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_generator_draws_recover_two_clusters():
    """The port's own draws (tests/test_eval.py's check): the fit finds
    both clusters, the samples sit on them, and one seed gives one result."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(np.concatenate([
        rng.standard_normal((200, 2)) * 0.1 + 2.0,
        rng.standard_normal((200, 2)) * 0.1 - 2.0]).astype(np.float32))
    fits = [gmm.fit_gmm(data, 2, torch.Generator().manual_seed(s), n_iters=50)
            for s in (0, 0)]
    for a, b in zip(*fits):
        assert torch.equal(a, b)
    np.testing.assert_allclose(np.sort(fits[0].means[:, 0].numpy()), [-2.0, 2.0], atol=0.2)
    draws = gmm.sample_gmm(fits[0], torch.Generator().manual_seed(1), 500)
    assert abs(draws[:, 0].abs().mean().item() - 2.0) < 0.3
    assert not torch.equal(draws, gmm.sample_gmm(fits[0], torch.Generator().manual_seed(2),
                                                 500))


def test_draws_need_a_generator():
    data = torch.from_numpy(_clusters(0, 2, 2))
    with pytest.raises(ValueError, match="torch.Generator"):
        gmm.fit_gmm(data, 2)
    fitted = gmm.fit_gmm(data, 2, init_idx=torch.tensor([0, 1]), n_iters=3)
    with pytest.raises(ValueError, match="torch.Generator"):
        gmm.sample_gmm(fitted, None, 4)
    with pytest.raises(ValueError, match="torch.Generator"):
        gmm.sample_gmm(fitted, None, 4, z=torch.zeros(4, 2))
