"""Image-space utilities (port of the parts of ``colddiff/ops/image.py`` in use).

Color conversions follow the reference's snowification/diffusion/utils.py
(scikit-image D65 Lab port): images are NHWC in [-1, 1]; ``rgb2lab`` rescales
to [0, 1] inside and ``lab2rgb`` returns [-1, 1], as the JAX copies do.  The
3x3 color products are fp32 elementwise sums, so TF32 never touches them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_uint8", "rgb2lab", "lab2rgb"]

_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
_D65 = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)


def quantize_uint8(x: torch.Tensor) -> torch.Tensor:
    """8-bit quantization of a [-1, 1] image, reference ``discrete`` semantics.

    deblurring_diffusion_pytorch.py:954-958: scale to [0, 255], truncate toward
    zero (torch ``.int()``), rescale to [-1, 1].
    """
    y = (x + 1.0) * 0.5 * 255.0
    y = torch.trunc(y) / 255.0
    return y * 2.0 - 1.0


def _mat3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``x @ m.T`` over the last axis of 3, as fp32 products and sums."""
    m = torch.as_tensor(m, device=x.device)
    return (x[..., None, :] * m).sum(dim=-1)


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.04045, torch.pow((x + 0.055) / 1.055, 2.4), x / 12.92)


def _linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    threshold = 0.0031308
    # clamp before the fractional power to avoid nan grads at negative inputs
    safe = torch.clamp(x, min=threshold)
    return torch.where(x > threshold, 1.055 * torch.pow(safe, 1 / 2.4) - 0.055, 12.92 * x)


def rgb2lab(x: torch.Tensor) -> torch.Tensor:
    """NHWC RGB in [-1, 1] -> Lab (L in 0..100, a/b in -127..127).

    Parity target: snowification/diffusion/utils.py:113-164.
    """
    rgb = (x + 1.0) * 0.5
    xyz = _mat3(_srgb_to_linear(rgb), _RGB2XYZ)
    xyz_n = xyz / torch.as_tensor(_D65, device=x.device)
    threshold = 0.008856
    f = torch.where(
        xyz_n > threshold,
        torch.pow(torch.clamp(xyz_n, min=threshold), 1.0 / 3.0),
        7.787 * xyz_n + 4.0 / 29.0,
    )
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)


def lab2rgb(x: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """Lab -> NHWC RGB in [-1, 1] (snowification/diffusion/utils.py:168-222)."""
    L, a, b = x[..., 0], x[..., 1], x[..., 2]
    fy = (L + 16.0) / 116.0
    fx = a / 500.0 + fy
    fz = torch.clamp(fy - b / 200.0, min=0.0)
    f = torch.stack([fx, fy, fz], dim=-1)
    xyz = torch.where(f > 0.2068966, f**3, (f - 4.0 / 29.0) / 7.787)
    xyz = xyz * torch.as_tensor(_D65, device=x.device)
    rgb = _linear_to_srgb(_mat3(xyz, _XYZ2RGB))
    if clip:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    return 2.0 * rgb - 1.0
