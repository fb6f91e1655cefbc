"""Frechet Inception Distance on in-memory samples, as the reference computes it.

Port of ``colddiff/eval/fid.py``.  The reference's Fid/fid_score.py computes
FID on in-memory batches with the mseitzer pt_inception-2015-12-05 weights:
``calculate_fid_given_samples([real, fake])`` (fid_score.py:343-356), in
``n_iters = N // batch_size`` batches, the remainder dropped (:176).

The InceptionV3 pool3 graph runs over the torch checkpoint's state dict
(keys like ``Mixed_5b.branch1x1.conv.weight``), with the FID variants:
batch norms with eps 1e-3, ``count_include_pad=False`` 3x3 average pools,
the max pool of ``Mixed_7c``, and the input resized to 299 px.  It is NCHW
like the checkpoint, so its conv weights need no transpose.  It runs in the
weights' dtype; in fp32 on a CUDA tensor it refuses TF32, as the JAX graph
pins ``Precision.HIGHEST`` (TF32 would move the features ~1e-3).

Without a weights file (``pt_inception-2015-12-05-*.pth``: this repository
has none), :func:`fid_features_fn` falls back to the JAX package's
random-projection extractor.  Its two conv weights are JAX threefry draws
from ``jax.random.key(20220809)``, which no torch generator reproduces, so
they ship as ``fid_fallback_weights.npz`` beside this file (pinned to JAX
by tests/test_torch_fid.py).  Its numbers are a proxy, not Inception-FID:
the returned callable says so in ``.is_inception`` and ``.name``.

``CONV_SPECS`` and ``synth_state_dict`` are copies of
``colddiff/eval/torch_inception_ref.py``: random weights with the
checkpoint's layout, for tests and the GPU smoke run.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..operators.base import table_device
from ..ops.image import resize_bilinear
from .metrics import _require_ieee_fp32

__all__ = [
    "frechet_distance",
    "inception_pool3_features",
    "inception_features_from_torch_checkpoint",
    "fid_features_fn",
    "calculate_fid_given_samples",
    "activation_statistics",
    "CONV_SPECS",
    "synth_state_dict",
]

FALLBACK_WEIGHTS = Path(__file__).with_name("fid_fallback_weights.npz")


# --------------------------------------------------------------------- #
# Frechet distance (fid_score.py:198-252 semantics, scipy sqrtm on host)

def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # the JAX copy passes disp=False, which only drops a printed warning and
    # returns an error estimate beside the root; SciPy 1.16 deprecated it,
    # and 1.17 returns no estimate for a 1x1 matrix
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


# --------------------------------------------------------------------- #
# InceptionV3 pool3 graph (functions over the torch state dict, NCHW)

def _conv_bn(p, prefix, x, stride=1, padding=0):
    x = F.conv2d(x, p[prefix + ".conv.weight"], stride=stride, padding=padding)
    mean = p[prefix + ".bn.running_mean"][:, None, None]
    var = p[prefix + ".bn.running_var"][:, None, None]
    gamma = p[prefix + ".bn.weight"][:, None, None]
    beta = p[prefix + ".bn.bias"][:, None, None]
    # the JAX graph's order of operations
    return F.relu((x - mean) * torch.rsqrt(var + 1e-3) * gamma + beta)


def _avg_pool(x):
    """3x3 stride-1 average pool, padding 1, count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _inception_a(p, pre, x):
    b1 = _conv_bn(p, f"{pre}.branch1x1", x)
    b5 = _conv_bn(p, f"{pre}.branch5x5_1", x)
    b5 = _conv_bn(p, f"{pre}.branch5x5_2", b5, padding=2)
    b3 = _conv_bn(p, f"{pre}.branch3x3dbl_1", x)
    b3 = _conv_bn(p, f"{pre}.branch3x3dbl_2", b3, padding=1)
    b3 = _conv_bn(p, f"{pre}.branch3x3dbl_3", b3, padding=1)
    bp = _conv_bn(p, f"{pre}.branch_pool", _avg_pool(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, pre, x):
    b3 = _conv_bn(p, f"{pre}.branch3x3", x, stride=2)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_2", bd, padding=1)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


def _inception_c(p, pre, x):
    b1 = _conv_bn(p, f"{pre}.branch1x1", x)
    b7 = _conv_bn(p, f"{pre}.branch7x7_1", x)
    b7 = _conv_bn(p, f"{pre}.branch7x7_2", b7, padding=(0, 3))
    b7 = _conv_bn(p, f"{pre}.branch7x7_3", b7, padding=(3, 0))
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_1", x)
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_2", bd, padding=(3, 0))
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_3", bd, padding=(0, 3))
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_4", bd, padding=(3, 0))
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_5", bd, padding=(0, 3))
    bp = _conv_bn(p, f"{pre}.branch_pool", _avg_pool(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, pre, x):
    b3 = _conv_bn(p, f"{pre}.branch3x3_1", x)
    b3 = _conv_bn(p, f"{pre}.branch3x3_2", b3, stride=2)
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_1", x)
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


def _inception_e(p, pre, x, pool: str):
    b1 = _conv_bn(p, f"{pre}.branch1x1", x)
    b3 = _conv_bn(p, f"{pre}.branch3x3_1", x)
    b3 = torch.cat([_conv_bn(p, f"{pre}.branch3x3_2a", b3, padding=(0, 1)),
                    _conv_bn(p, f"{pre}.branch3x3_2b", b3, padding=(1, 0))], dim=1)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_2", bd, padding=1)
    bd = torch.cat([_conv_bn(p, f"{pre}.branch3x3dbl_3a", bd, padding=(0, 1)),
                    _conv_bn(p, f"{pre}.branch3x3dbl_3b", bd, padding=(1, 0))], dim=1)
    if pool == "max":
        # FIDInceptionE_2 (Fid/inception.py): max pool in the last block
        bp = F.max_pool2d(x, 3, stride=1, padding=1)
    else:
        bp = _avg_pool(x)
    bp = _conv_bn(p, f"{pre}.branch_pool", bp)
    return torch.cat([b1, b3, bd, bp], dim=1)


def inception_pool3_features(p: dict, x: torch.Tensor) -> torch.Tensor:
    """2048-d pool3 features [B, 2048] of an NHWC batch in [-1, 1].

    ``p`` maps the checkpoint's keys to tensors on ``x``'s device.  The
    input is bilinearly resized to 299 (fid_score.py resize_input
    semantics, as ``jax.image.resize``)."""
    _require_ieee_fp32(x)
    x = resize_bilinear(x, 299).permute(0, 3, 1, 2)
    x = _conv_bn(p, "Conv2d_1a_3x3", x, stride=2)
    x = _conv_bn(p, "Conv2d_2a_3x3", x)
    x = _conv_bn(p, "Conv2d_2b_3x3", x, padding=1)
    x = F.max_pool2d(x, 3, stride=2)
    x = _conv_bn(p, "Conv2d_3b_1x1", x)
    x = _conv_bn(p, "Conv2d_4a_3x3", x)
    x = F.max_pool2d(x, 3, stride=2)
    x = _inception_a(p, "Mixed_5b", x)
    x = _inception_a(p, "Mixed_5c", x)
    x = _inception_a(p, "Mixed_5d", x)
    x = _inception_b(p, "Mixed_6a", x)
    x = _inception_c(p, "Mixed_6b", x)
    x = _inception_c(p, "Mixed_6c", x)
    x = _inception_c(p, "Mixed_6d", x)
    x = _inception_c(p, "Mixed_6e", x)
    x = _inception_d(p, "Mixed_7a", x)
    x = _inception_e(p, "Mixed_7b", x, pool="avg")
    x = _inception_e(p, "Mixed_7c", x, pool="max")
    return x.mean(dim=(2, 3))  # adaptive avg pool -> [B, 2048]


def _to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Grayscale -> 3 channels, as the reference harness does before FID
    (deblurring_diffusion_pytorch.py:1612-1615 ``repeat``)."""
    return x.repeat(1, 1, 1, 3) if x.shape[-1] == 1 else x


def inception_features_from_torch_checkpoint(path: str | os.PathLike,
                                             device: torch.device | str = "cuda") -> Callable:
    """Load pt_inception weights onto ``device`` -> ``features(x)``, NHWC in
    [-1, 1] to [B, 2048] in the weights' dtype (fp32 for the real file)."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    device = table_device(device, "the Inception features")
    p = {k: torch.as_tensor(v).to(device) for k, v in sd.items()
         if k.endswith((".conv.weight", ".bn.weight", ".bn.bias", ".bn.running_mean",
                        ".bn.running_var"))}  # not fc.*: pool3 is before it
    dtype = p["Conv2d_1a_3x3.conv.weight"].dtype

    @torch.inference_mode()
    def features(x: torch.Tensor) -> torch.Tensor:
        return inception_pool3_features(p, _to_rgb(x.to(device, dtype)))

    features.is_inception = True
    features.name = "inception"
    return features


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero-pad NCHW ``x`` as XLA's ``"SAME"`` does: ``out = ceil(in /
    stride)`` and the odd pixel of the total after, not before (64 px in,
    k=7, stride 2: 2 before, 3 after; 32 px, k=3: 0 and 1).  torch's
    ``padding="same"`` refuses stride 2."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def fid_features_fn(weights_path: Optional[str] = None,
                    device: torch.device | str = "cuda") -> Callable:
    """Best-available feature extractor (see the module docstring): the
    Inception pool3 graph of the first weights file that exists among
    ``weights_path``, ``$COLDDIFF_INCEPTION_WEIGHTS`` and
    ``pt_inception-2015-12-05-6726825d.pth``, else the fallback."""
    candidates = [
        weights_path,
        os.environ.get("COLDDIFF_INCEPTION_WEIGHTS"),
        "pt_inception-2015-12-05-6726825d.pth",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return inception_features_from_torch_checkpoint(c, device)

    # deterministic fallback: random conv features + spatial mean
    device = table_device(device, "the fallback FID features")
    with np.load(FALLBACK_WEIGHTS) as w:  # HWIO, as JAX drew them
        w1, w2 = (torch.from_numpy(w[k]).permute(3, 2, 0, 1).contiguous().to(device)
                  for k in ("w1", "w2"))

    @torch.inference_mode()
    def features(x: torch.Tensor) -> torch.Tensor:
        x = _to_rgb(x.to(device, torch.float32))
        _require_ieee_fp32(x)
        x = resize_bilinear(x, 64).permute(0, 3, 1, 2)
        x = F.relu(F.conv2d(_same_pad(x, 7, 2), w1, stride=2))
        x = F.relu(F.conv2d(_same_pad(x, 3, 2), w2, stride=2))
        return x.mean(dim=(2, 3))

    features.is_inception = False
    features.name = "fallback-random-projection"
    return features


# --------------------------------------------------------------------- #

def activation_statistics(samples, features, batch_size: int = 64):
    """mu/sigma over features; drops the remainder like the reference
    (fid_score.py:176 ``n_iters = N // batch_size``)."""
    n = samples.shape[0]
    n_iters = max(n // batch_size, 1)
    feats = []
    for i in range(n_iters):
        chunk = torch.as_tensor(samples[i * batch_size : (i + 1) * batch_size])
        feats.append(features(chunk).cpu().numpy())
    acts = np.concatenate(feats)
    return acts.mean(axis=0), np.cov(acts, rowvar=False)


def calculate_fid_given_samples(samples, batch_size: int = 64, features=None,
                                device: torch.device | str = "cuda") -> float:
    """FID between samples[0] (real) and samples[1] (fake), NHWC in [-1, 1]
    (API parity: Fid/fid_score.py:343-356).  ``features`` defaults to
    :func:`fid_features_fn` on ``device``."""
    if features is None:
        features = fid_features_fn(device=device)
    mu1, s1 = activation_statistics(samples[0], features, batch_size)
    mu2, s2 = activation_statistics(samples[1], features, batch_size)
    return frechet_distance(mu1, s1, mu2, s2)


# --------------------------------------------------------------------- #
# Random weights with the pt_inception layout (copies of
# colddiff/eval/torch_inception_ref.py): prefix -> (in_ch, out_ch, (kh, kw)),
# the channel plan of torchvision's inception v3

CONV_SPECS = {}


def _add(pre, i, o, k):
    CONV_SPECS[pre] = (i, o, (k, k) if isinstance(k, int) else k)


_add("Conv2d_1a_3x3", 3, 32, 3)
_add("Conv2d_2a_3x3", 32, 32, 3)
_add("Conv2d_2b_3x3", 32, 64, 3)
_add("Conv2d_3b_1x1", 64, 80, 1)
_add("Conv2d_4a_3x3", 80, 192, 3)


def _spec_a(pre, cin, pool):
    _add(f"{pre}.branch1x1", cin, 64, 1)
    _add(f"{pre}.branch5x5_1", cin, 48, 1)
    _add(f"{pre}.branch5x5_2", 48, 64, 5)
    _add(f"{pre}.branch3x3dbl_1", cin, 64, 1)
    _add(f"{pre}.branch3x3dbl_2", 64, 96, 3)
    _add(f"{pre}.branch3x3dbl_3", 96, 96, 3)
    _add(f"{pre}.branch_pool", cin, pool, 1)


def _spec_b(pre, cin):
    _add(f"{pre}.branch3x3", cin, 384, 3)
    _add(f"{pre}.branch3x3dbl_1", cin, 64, 1)
    _add(f"{pre}.branch3x3dbl_2", 64, 96, 3)
    _add(f"{pre}.branch3x3dbl_3", 96, 96, 3)


def _spec_c(pre, c7):
    cin = 768
    _add(f"{pre}.branch1x1", cin, 192, 1)
    _add(f"{pre}.branch7x7_1", cin, c7, 1)
    _add(f"{pre}.branch7x7_2", c7, c7, (1, 7))
    _add(f"{pre}.branch7x7_3", c7, 192, (7, 1))
    _add(f"{pre}.branch7x7dbl_1", cin, c7, 1)
    _add(f"{pre}.branch7x7dbl_2", c7, c7, (7, 1))
    _add(f"{pre}.branch7x7dbl_3", c7, c7, (1, 7))
    _add(f"{pre}.branch7x7dbl_4", c7, c7, (7, 1))
    _add(f"{pre}.branch7x7dbl_5", c7, 192, (1, 7))
    _add(f"{pre}.branch_pool", cin, 192, 1)


def _spec_d(pre, cin):
    _add(f"{pre}.branch3x3_1", cin, 192, 1)
    _add(f"{pre}.branch3x3_2", 192, 320, 3)
    _add(f"{pre}.branch7x7x3_1", cin, 192, 1)
    _add(f"{pre}.branch7x7x3_2", 192, 192, (1, 7))
    _add(f"{pre}.branch7x7x3_3", 192, 192, (7, 1))
    _add(f"{pre}.branch7x7x3_4", 192, 192, 3)


def _spec_e(pre, cin):
    _add(f"{pre}.branch1x1", cin, 320, 1)
    _add(f"{pre}.branch3x3_1", cin, 384, 1)
    _add(f"{pre}.branch3x3_2a", 384, 384, (1, 3))
    _add(f"{pre}.branch3x3_2b", 384, 384, (3, 1))
    _add(f"{pre}.branch3x3dbl_1", cin, 448, 1)
    _add(f"{pre}.branch3x3dbl_2", 448, 384, 3)
    _add(f"{pre}.branch3x3dbl_3a", 384, 384, (1, 3))
    _add(f"{pre}.branch3x3dbl_3b", 384, 384, (3, 1))
    _add(f"{pre}.branch_pool", cin, 192, 1)


_spec_a("Mixed_5b", 192, 32)
_spec_a("Mixed_5c", 256, 64)
_spec_a("Mixed_5d", 288, 64)
_spec_b("Mixed_6a", 288)
_spec_c("Mixed_6b", 128)
_spec_c("Mixed_6c", 160)
_spec_c("Mixed_6d", 160)
_spec_c("Mixed_6e", 192)
_spec_d("Mixed_7a", 768)
_spec_e("Mixed_7b", 1280)
_spec_e("Mixed_7c", 2048)


def synth_state_dict(seed=0, dtype=np.float64):
    """Random weights with the pt_inception key layout, magnitude-controlled
    so activations stay O(1) through ~96 conv+bn layers."""
    rng = np.random.default_rng(seed)
    sd = {}
    for pre, (cin, cout, (kh, kw)) in CONV_SPECS.items():
        fan_in = cin * kh * kw
        sd[f"{pre}.conv.weight"] = (
            rng.standard_normal((cout, cin, kh, kw)) * np.sqrt(2.0 / fan_in)
        ).astype(dtype)
        sd[f"{pre}.bn.weight"] = rng.uniform(0.8, 1.2, (cout,)).astype(dtype)
        sd[f"{pre}.bn.bias"] = (rng.standard_normal((cout,)) * 0.1).astype(dtype)
        sd[f"{pre}.bn.running_mean"] = (
            rng.standard_normal((cout,)) * 0.1
        ).astype(dtype)
        sd[f"{pre}.bn.running_var"] = rng.uniform(0.8, 1.2, (cout,)).astype(dtype)
        sd[f"{pre}.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    # classifier keys present in the real checkpoint; must be ignored
    sd["fc.weight"] = rng.standard_normal((1008, 2048)).astype(dtype)
    sd["fc.bias"] = rng.standard_normal((1008,)).astype(dtype)
    return sd
