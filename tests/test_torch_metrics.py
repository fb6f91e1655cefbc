"""The port's image metrics == colddiff.eval.metrics: SSIM, RMSE, PSNR on
NHWC batches, numpy-seeded, at 1e-6 in fp32, the metrics' own dtype (the
JAX SSIM window is fp32, so it takes no fp64 input): a separable 11-tap
filter and a mean over a few thousand values.  Their refusal of TF32 on the
card is in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.eval import metrics as jmetrics
from colddiff_torch.eval import metrics


def _pair(seed, shape, noise):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, shape)
    return a, np.clip(a + noise * rng.standard_normal(shape), -1.0, 1.0)


@pytest.mark.parametrize("shape,noise", [((2, 32, 32, 3), 0.05), ((3, 16, 20, 1), 0.5),
                                         ((1, 11, 11, 3), 0.0)])
def test_metrics_match_jax(shape, noise):
    a, b = (x.astype(np.float32) for x in _pair(1, shape, noise))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = {
        "ssim": jmetrics.ssim(ja, jb),
        "ssim_data_range_2": jmetrics.ssim(ja, jb, data_range=2.0),
        "ssim_per_image": jmetrics.ssim(ja, jb, size_average=False),
        "rmse": jmetrics.rmse(ja, jb),
        "psnr": jmetrics.psnr(ja, jb),
        "psnr_data_range_1": jmetrics.psnr(ja, jb, data_range=1.0),
    }
    got = {
        "ssim": metrics.ssim(ta, tb),
        "ssim_data_range_2": metrics.ssim(ta, tb, data_range=2.0),
        "ssim_per_image": metrics.ssim(ta, tb, size_average=False),
        "rmse": metrics.rmse(ta, tb),
        "psnr": metrics.psnr(ta, tb),
        "psnr_data_range_1": metrics.psnr(ta, tb, data_range=1.0),
    }
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.float32 and tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_identical_images():
    a = torch.from_numpy(_pair(2, (2, 16, 16, 3), 0.0)[0].astype(np.float32))
    assert metrics.ssim(a, a).item() == pytest.approx(1.0, abs=1e-6)
    assert metrics.rmse(a, a).item() == 0.0
    assert metrics.psnr(a, a).item() == pytest.approx(10 * np.log10(4 / 1e-12))


def test_tf32_flags_do_not_matter_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in _pair(3, (1, 12, 12, 3), 0.1))
    assert torch.isfinite(metrics.ssim(a, b))
