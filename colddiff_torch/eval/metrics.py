"""Quantitative image metrics: SSIM, RMSE, PSNR on NHWC batches.

Port of ``colddiff/eval/metrics.py``.  SSIM follows pytorch_msssim defaults
(Gaussian window 11, sigma 1.5, K1=0.01, K2=0.03, size_average=True), which
the reference harness calls as ``ssim(a, b, data_range=1)``
(deblurring_diffusion_pytorch.py:1679-1699).

The metrics run in true fp32.  SSIM's variances are the cancellation
E[x^2] - mu^2, which TF32's ten-bit mantissa corrupts (the JAX package pins
``precision=HIGHEST`` for the same reason), so on a CUDA tensor they raise
while ``torch.backends.cudnn.allow_tf32`` or
``torch.backends.cuda.matmul.allow_tf32`` is on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..schedules import gaussian_kernel_1d

__all__ = ["ssim", "rmse", "psnr"]


def _require_ieee_fp32(x: torch.Tensor) -> None:
    """Raise on a CUDA tensor unless convs and matmuls run in full fp32
    (cuDNN's convs default to TF32; the flags are global, so the caller
    sets them)."""
    if x.is_cuda and (torch.backends.cudnn.allow_tf32
                      or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the eval metrics need full fp32: set torch.backends.cudnn.allow_tf32 = "
            "False and torch.backends.cuda.matmul.allow_tf32 = False")


def _gauss_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode depthwise Gaussian filter of an NCHW batch."""
    c, k = x.shape[1], win.numel()
    y = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(y, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, win_size: int = 11,
         win_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity of NHWC batches: the mean of the SSIM map, or
    with ``size_average=False`` one value per image."""
    _require_ieee_fp32(a)
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    win = torch.from_numpy(gaussian_kernel_1d(win_size, win_sigma)).to(a.device, a.dtype)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _gauss_filter(a, win)
    mu_b = _gauss_filter(b, win)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = _gauss_filter(a * a, win) - mu_aa
    sig_b = _gauss_filter(b * b, win) - mu_bb
    sig_ab = _gauss_filter(a * b, win) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sig_a + sig_b + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(MSE), the reference's RMSE lines
    (deblurring_diffusion_pytorch.py:1678,1689,1698)."""
    _require_ieee_fp32(a)
    return (a - b).square().mean().sqrt()


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    _require_ieee_fp32(a)
    m = (a - b).square().mean()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(m, min=1e-12))
