"""Evaluation: the eval surface of ``colddiff.eval``: the image metrics
(SSIM, RMSE, PSNR), FID with its Inception pool3 graph and the fallback
extractor, the EM Gaussian mixture, and the ``EvalHarness``."""

from .fid import (
    activation_statistics,
    calculate_fid_given_samples,
    fid_features_fn,
    frechet_distance,
    inception_features_from_torch_checkpoint,
)
from .gmm import GMM, fit_gmm, sample_gmm
from .harness import EvalHarness
from .metrics import psnr, rmse, ssim

__all__ = [
    "EvalHarness",
    "GMM",
    "activation_statistics",
    "calculate_fid_given_samples",
    "fid_features_fn",
    "fit_gmm",
    "frechet_distance",
    "inception_features_from_torch_checkpoint",
    "psnr",
    "rmse",
    "sample_gmm",
    "ssim",
]
