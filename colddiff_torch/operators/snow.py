"""Snowification degradation (ImageNet-C-style snow overlays).

Port of ``colddiff/operators/snow.py`` (reference: snowification/diffusion/
forward_process_impl.py:220-372).  Set-up is host numpy, seeded 123321
unless ``random_snow``: a Gaussian field -> ``clipped_zoom`` -> per-step
threshold (linspace start -> end) -> directional motion blur (a 1-D Gaussian
row kernel; vertical = along H) -> per-step layers ``snow`` and their
180-degree rotations ``snow_rot``.  The motion blur is a zero-padded 1-D
conv, so a per-step [S, S] matrix, applied to all T x L fields as two
batched einsums on the table device in true fp32.

The degrade is a pure function of the original image ``og``
(forward_process_impl.py:357-372): ``clip(brightness(og) + snow[i] +
snow_rot[i], 0, 1)``, so per-sample gathers from the [T, L, S, S] stacks
are exact.  The fields are the operator's tensors, so the Trainer's
checkpoint keeps them (the reference writes ``snow_base.npy``,
diffusion.py:177-193).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..ops.image import clipped_zoom, rgb_to_grayscale
from ..ops.linop import conv1d_matrix, require_ieee_fp32
from ..parallel.mesh import local_rows
from ..schedules import gaussian_kernel_1d
from .base import Degradation, bcast, table_device

__all__ = ["Snow", "SNOW_LEVELS", "snow_fields"]

# (c-tuple, thres_start, thres_end, mb_sigma_start, mb_sigma_end,
#  br_start, br_end) per snow_level (forward_process_impl.py:262-296)
SNOW_LEVELS = {
    1: ((0.1, 0.3, 3, 0.5, 5, 4, 0.8), 0.7, 0.3, 0.5, 5.0, 0.95, 0.7),
    2: ((0.55, 0.3, 2.5, 0.85, 11, 12, 0.55), 1.15, 0.7, 0.05, 12.0, 0.95, 0.55),
    3: ((0.55, 0.3, 2.5, 0.7, 11, 16, 0.4), 1.15, 0.7, 0.05, 16.0, 0.95, 0.4),
    4: ((0.55, 0.3, 2.5, 0.55, 11, 20, 0.3), 1.15, 0.55, 0.05, 20.0, 0.95, 0.3),
}

_FIXED_SEED = 123321


def snow_fields(snow_level: int, timesteps: int, image_size: int, *, random_snow: bool,
                single_snow: bool, batch_size: int, seed: Optional[int],
                snow_base: Optional[np.ndarray], device: torch.device):
    """(snow, snow_rot, br_coefs): the [T, L, S, S] layer stacks and the [T]
    brightness coefficients (forward_process_impl.py:257-355), with the JAX
    package's draws in its order; L is the batch under ``single_snow``, else 1."""
    c, th0, th1, mb0, mb1, br0, br1 = SNOW_LEVELS[snow_level]
    T, s = timesteps, image_size
    rng = np.random.RandomState(_FIXED_SEED if not random_snow else seed)
    if snow_base is not None:
        base = snow_base
    elif single_snow:
        cols = []
        for _ in range(batch_size):
            f = rng.normal(size=(s, s), loc=c[0], scale=c[1])[..., None]
            cols.append(clipped_zoom(f, c[2]))
        base = np.concatenate(cols, axis=2)  # [H, W, L=B]
    else:
        f = rng.normal(size=(s, s), loc=c[0], scale=c[1])[..., None]
        base = clipped_zoom(f, c[2])  # [H, W, 1]
    vertical = rng.uniform() > 0.5

    thresholds = np.linspace(th0, th1, T)
    mb_sigmas = np.linspace(mb0, mb1, T)
    br = np.linspace(br0, br1, T)
    fields = np.transpose(base, (2, 0, 1))[None]  # [1, L, H, W]
    fields = np.clip(np.where(fields < thresholds[:, None, None, None], 0.0, fields),
                     0.0, 1.0)  # [T, L, H, W]
    # per-step motion-blur matrices: a 1-D zero-padded 'same' conv
    mats = np.stack([conv1d_matrix(gaussian_kernel_1d(int(c[4]), sig), s, "zeros")
                     for sig in mb_sigmas]).astype(np.float32)  # [T, s, s]

    fx = torch.as_tensor(fields, dtype=torch.float32, device=device)
    m = torch.as_tensor(mats, device=device)
    require_ieee_fp32(fx)  # TF32 would corrupt the fields for the whole run
    h_blur = torch.einsum("tij,tlhj->tlhi", m, fx)  # along W
    v_blur = torch.einsum("tij,tljw->tliw", m, fx)  # along H
    if single_snow:
        # a fresh half-of-the-layers permutation per timestep takes the
        # vertical blur, from the operator's own seeded stream (the JAX
        # package's waiver, colddiff/operators/snow.py:129-143: upstream
        # draws it from torch's unseeded global generator)
        L = fields.shape[1]
        take_v = np.zeros((T, L), bool)
        for t_idx in range(T):
            take_v[t_idx, rng.permutation(L)[: L // 2]] = True
        snow = torch.where(torch.as_tensor(take_v, device=device)[:, :, None, None],
                           v_blur, h_blur)
    else:
        snow = v_blur if vertical else h_blur
    return (snow, torch.flip(snow, dims=(2, 3)),
            torch.as_tensor(br, dtype=torch.float32, device=device))


class Snow(Degradation):
    """``snow`` / ``snow_rot`` ([T, L, S, S] fp32) and ``br_coefs`` ([T])."""

    def __init__(self, *, timesteps: int, snow: torch.Tensor, snow_rot: torch.Tensor,
                 br_coefs: torch.Tensor, snow_level: int = 1, image_size: int = 32,
                 random_snow: bool = False, single_snow: bool = False,
                 fix_brightness: bool = False):
        super().__init__(timesteps)
        self.snow = snow
        self.snow_rot = snow_rot
        self.br_coefs = br_coefs
        self.snow_level = snow_level
        self.image_size = image_size
        self.random_snow = random_snow
        self.single_snow = single_snow
        self.fix_brightness = fix_brightness

    @classmethod
    def create(
        cls,
        *,
        image_size: int,
        timesteps: int,
        snow_level: int = 1,
        random_snow: bool = False,
        single_snow: bool = False,
        fix_brightness: bool = False,
        batch_size: int = 32,
        seed: Optional[int] = None,
        snow_base: Optional[np.ndarray] = None,
        device: torch.device | str = "cuda",
    ) -> "Snow":
        """Build the fields on ``device``: the card unless ``device="cpu"``.
        ``seed`` seeds a ``random_snow`` field (None: numpy's entropy)."""
        device = table_device(device, "Snow")
        snow, snow_rot, br_coefs = snow_fields(
            snow_level, timesteps, image_size, random_snow=random_snow,
            single_snow=single_snow, batch_size=batch_size, seed=seed, snow_base=snow_base,
            device=device)
        return cls(timesteps=timesteps, snow=snow, snow_rot=snow_rot, br_coefs=br_coefs,
                   snow_level=snow_level, image_size=image_size, random_snow=random_snow,
                   single_snow=single_snow, fix_brightness=fix_brightness)

    def reset(self, generator, batch_size):
        """New fields from a numpy seed drawn from ``generator``
        (``random_snow``; otherwise the operator itself)."""
        if not self.random_snow:
            return self
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                 device=generator.device if generator is not None else "cpu"))
        return self.reseed(seed, batch_size)

    def reseed(self, seed: int, batch_size: int) -> "Snow":
        """A copy with the random fields of numpy seed ``seed``."""
        new = copy.copy(self)
        new.snow, new.snow_rot, new.br_coefs = snow_fields(
            self.snow_level, self.timesteps, self.image_size, random_snow=True,
            single_snow=self.single_snow, batch_size=batch_size, seed=seed, snow_base=None,
            device=self.snow.device)
        return new

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        if og is None:
            og = x
        dev = self.snow.device
        n = self._levels(n, dev)
        idx = torch.clamp(n - 1, 0, self.timesteps - 1)
        # the fields are the global batch's; a process reads its rows' layers
        here = local_rows(x.shape[0])
        lidx = torch.arange(here.start, here.stop, device=dev) % self.snow.shape[1]
        sn = self.snow[idx, lidx][..., None]  # [B, H, W, 1]
        sn_rot = self.snow_rot[idx, lidx][..., None]
        og_r = (og + 1.0) * 0.5
        if self.fix_brightness:
            base = og_r
        else:
            gray = torch.maximum(og_r, rgb_to_grayscale(og_r) * 1.5 + 0.5)
            coef = bcast(self.br_coefs[idx], x.dim())
            base = coef * og_r + (1.0 - coef) * gray
        y = torch.clamp(base + sn + sn_rot, 0.0, 1.0) * 2.0 - 1.0
        return torch.where(bcast(n, x.dim()) == 0, x.to(y.dtype), y)
