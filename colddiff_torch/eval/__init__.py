"""Evaluation: the image metrics of ``colddiff.eval`` (SSIM, RMSE, PSNR).
FID, the GMM and the eval harness are not ported yet (ROADMAP.md section 1,
item 11)."""

from .metrics import psnr, rmse, ssim

__all__ = ["psnr", "rmse", "ssim"]
