"""Full-covariance Gaussian mixture fitted by EM, in PyTorch.

Port of ``colddiff/eval/gmm.py``, which replaces the reference's
``pycave`` GPU GMM.  The blind generation routines of the eval harness fit
it to train-set channel means (or low-res degraded or clean images),
sample it, expand the draws to images and reverse-sample
(deblurring_diffusion_pytorch.py:1391-1512).

The EM statistics run in fp32 with TF32 refused on a CUDA tensor: the JAX
package pins ``Precision.HIGHEST`` on them (gmm.py:37,64-70).  Draws come
from a ``torch.Generator``; ``init_idx``, ``comp`` and ``z`` replace them,
so tests can replay JAX's threefry draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .metrics import _require_ieee_fp32

__all__ = ["GMM", "fit_gmm", "sample_gmm"]


class GMM(NamedTuple):
    weights: torch.Tensor  # [K]
    means: torch.Tensor  # [K, D]
    covs: torch.Tensor  # [K, D, D]


def _log_prob(gmm: GMM, x: torch.Tensor) -> torch.Tensor:
    """[N, K] log N(x | mu_k, Sigma_k) + log w_k."""
    d = x.shape[-1]
    chol = torch.linalg.cholesky(gmm.covs)  # [K, D, D]
    diff = x[:, None, :] - gmm.means[None]  # [N, K, D]
    eye = torch.eye(d, dtype=x.dtype, device=x.device).expand(chol.shape)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)  # [K, D, D]
    sol = torch.einsum("kde,nke->nkd", linv, diff)
    maha = sol.square().sum(dim=-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
    return -0.5 * (maha + logdet + d * math.log(2 * math.pi)) + torch.log(gmm.weights)[None]


def _draws_needed(generator: Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} draws: it needs a torch.Generator or the draws themselves")
    return generator


def fit_gmm(
    x: torch.Tensor,
    n_components: int,
    generator: Optional[torch.Generator] = None,
    n_iters: int = 100,
    reg: float = 1e-6,
    *,
    init_idx: Optional[torch.Tensor] = None,
) -> GMM:
    """EM fit on [N, D] data, from ``n_components`` distinct data points
    drawn from ``generator`` (no k-means++), or the rows ``init_idx``."""
    _require_ieee_fp32(x)
    n, d = x.shape
    if init_idx is None:
        gen = _draws_needed(generator, "fit_gmm's initialization")
        init_idx = torch.randperm(n, generator=gen, device=gen.device)[:n_components]
    means = x[init_idx.to(x.device)]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    # torch.cov is ddof 1, as jnp.cov
    covs = (torch.cov(x.T).reshape(d, d) + reg * eye).expand(n_components, d, d)
    weights = torch.full((n_components,), 1.0 / n_components, dtype=x.dtype,
                         device=x.device)
    gmm = GMM(weights, means, covs)
    for _ in range(n_iters):
        logp = _log_prob(gmm, x)  # [N, K]
        r = torch.exp(logp - torch.logsumexp(logp, dim=1, keepdim=True))  # responsibilities
        nk = r.sum(dim=0) + 1e-10  # [K]
        means = (r.T @ x) / nk[:, None]
        diff = x[:, None, :] - means[None]  # [N, K, D]
        covs = torch.einsum("nkd,nke->kde", r[:, :, None] * diff, diff) / nk[:, None, None]
        gmm = GMM(nk / n, means, covs + reg * eye)
    return gmm


def sample_gmm(gmm: GMM, generator: Optional[torch.Generator], num: int, *,
               comp: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw [num, D] samples: the components ``comp`` [num] by weight, then
    standard normals ``z`` [num, D], each from ``generator`` unless given."""
    _require_ieee_fp32(gmm.means)
    dev = gmm.means.device
    if comp is None:
        gen = _draws_needed(generator, "sample_gmm")
        comp = torch.multinomial(gmm.weights.to(gen.device), num, replacement=True,
                                 generator=gen)
    if z is None:
        gen = _draws_needed(generator, "sample_gmm")
        z = torch.randn((num, gmm.means.shape[-1]), generator=gen, dtype=gmm.means.dtype,
                        device=gen.device)
    comp, z = comp.to(dev), z.to(dev, gmm.means.dtype)
    chol = torch.linalg.cholesky(gmm.covs)  # [K, D, D]
    return gmm.means[comp] + torch.einsum("nde,ne->nd", chol[comp], z)
