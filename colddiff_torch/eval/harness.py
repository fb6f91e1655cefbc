"""Evaluation harness: the reference Trainer's ``--test_type`` surface.

Port of ``colddiff/eval/harness.py`` (SURVEY.md section 2.4):
  - ``test_from_data``: degrade a batch, run all_sample, dump per-step PNG
    grids + animated GIFs (deblurring_diffusion_pytorch.py:1238-1266;
    snowification diffusion.py:838-863).
  - ``fid_distance_decrease_from_manifold``: FID / RMSE / SSIM of degraded vs
    sampled vs direct-recon against originals (deblur :1567-1704).
  - ``sample_and_save_for_fid``: Family-B unconditional generation -> PNG tree
    for external FID (denoising_diffusion_pytorch.py:821-854).
  - GMM blind-generation samplers (deblur :1391-1512): fit a GMM to train-set
    channel means, expand samples to constant images, add symmetry-breaking
    noise, reverse-sample.
  - ``paper_showing_diffusion_images``-style trajectory strips (deblur
    :1269-1388) via PIL hconcat.

The harness runs on one device, ``"cuda"`` unless the caller asks for the
CPU; the model and the operator are moved there.  Every method that draws
takes a ``torch.Generator`` on that device (``generator``, JAX's ``rng``)
and draws from it in the order the JAX method splits its key; without one
it seeds its own with 0.  A Family-B endpoint, an operator's baked state
(``Fade.randomize``) and the GMM draws all come from it.  Images go in as
NHWC arrays or tensors in dataset space (rgb [-1, 1]) and come back as
numpy arrays or ``SampleResult`` tensors in dataset space.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..diffusion import ColdDiffusion
from ..operators.base import table_device
from ..ops.image import lab2rgb, resize_bilinear, rgb2lab
from ..parallel.mesh import batch_rows, gather_rows, replicate, shard_batch
from ..sampling import SampleResult, all_sample, prepare_start, sample
from ..tracing import prepare
from ..utils import apply_in_chunks, create_folder, save_gif, save_image_grid
from .fid import calculate_fid_given_samples, fid_features_fn
from .gmm import fit_gmm, sample_gmm
from .metrics import rmse, ssim

__all__ = ["EvalHarness"]


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class EvalHarness:
    def __init__(
        self,
        diffusion: ColdDiffusion,
        model: torch.nn.Module,
        results_folder: str = "./results_eval",
        fid_weights: Optional[str] = None,
        to_lab: bool = False,
        model_chunk: int = 16,
        endpoint_dataset=None,
        mesh=None,
        refresh_every: int = 1,
        bf16: bool = False,
        device: torch.device | str = "cuda",
    ):
        self.device = table_device(device, "EvalHarness")
        prepare(self.device)  # the span markers, loaded before any profiler window
        self.d = dataclasses.replace(diffusion, op=diffusion.op.to(self.device))
        # opt-in prediction caching (sampling.sample): K=1 (default) is the
        # exact reference algorithm; every metric dict stamps the value
        self.refresh_every = int(refresh_every)
        # bf16 eval compute (the JAX package's bench recipe): a bf16 copy of
        # the model, made once, and bf16 inputs at each call; outputs back to
        # fp32, so the reverse loop and every degrade stay fp32
        self.bf16 = bf16
        model = model.to(self.device).eval()
        # mesh-parallel eval (colddiff/eval/harness.py:62-76): the model is
        # replicated (rank 0's weights), each process samples its rows of a
        # batch the mesh divides and the rows are gathered back, so every
        # process holds the results and rank 0 alone writes files.  JAX
        # scales ``model_chunk`` with the mesh so each chip runs model_chunk
        # rows a call; here each process calls the model on its own rows, so
        # ``model_chunk`` stays the rows of one call on one process
        self.mesh = mesh
        self.rank, self.world = (0, 1) if mesh is None else (mesh.get_local_rank(),
                                                            mesh.size())
        if mesh is not None:
            replicate(model, mesh)
        self.model = copy.deepcopy(model).to(torch.bfloat16) if bf16 else model
        self.model_chunk = model_chunk
        # Family-B demixing: degradation endpoints come from a second dataset
        # (demixing_diffusion_pytorch.py:714-730); other ops synthesize their
        # own (noise / constant color) or need none (Family A)
        self.endpoint_dataset = endpoint_dataset
        self.results_folder = Path(results_folder)
        create_folder(self.results_folder)
        self._features = None
        self._fid_weights = fid_weights
        # Lab-space models: dataset rgb -> lab before the diffusion, outputs
        # lab -> rgb before saving/metrics (snowification diffusion.py:287-294,
        # :331-336; the reference FID harness feeds raw rgb into a lab-space
        # forward process -- diffusion.py:1043 -- which the JAX package treats
        # as a bug and converts instead)
        self.to_lab = to_lab

    def _apply(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.bf16:
            x = x.to(torch.bfloat16)
        return self.model(x, t).to(torch.float32)

    def denoise(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The model on a batch, in chunks of ``model_chunk`` (the JAX
        package's scheduling fix for B > 16, kept so both run the same
        per-call batch)."""
        if self.model_chunk and x.shape[0] > self.model_chunk:
            return apply_in_chunks(self._apply, self.model_chunk, x, t)
        return self._apply(x, t)

    @property
    def features(self):
        if self._features is None:
            self._features = fid_features_fn(self._fid_weights, self.device)
        return self._features

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    def _tensor(self, x) -> torch.Tensor:
        """An NHWC batch (array or tensor) as fp32 on the harness's device."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _stack(self, dataset, idxs) -> torch.Tensor:
        return self._tensor(np.stack([dataset[int(i)] for i in idxs]))

    def _sample(self, d: ColdDiffusion, img, t=None, **kw) -> SampleResult:
        return self._sharded(sample, d, img, t, **kw)

    def _all_sample(self, d: ColdDiffusion, img, t=None, **kw) -> SampleResult:
        return self._sharded(all_sample, d, img, t, **kw)

    def _sharded(self, fn, d: ColdDiffusion, img, t=None, *, x_end=None, **kw) -> SampleResult:
        """``fn`` (a sampler) on ``img``; under a mesh that divides the batch,
        each process runs its rows (and ``x_end``'s) inside ``batch_rows``, so
        the sampler's draws are the whole batch's, and the rows are gathered
        back.  A batch the mesh does not divide runs whole on every process,
        as the JAX harness leaves it unsharded (``_place``)."""
        kw["refresh_every"] = self.refresh_every
        if self.world == 1 or img.shape[0] % self.world:
            return fn(d, self.denoise, img, t, x_end=x_end, **kw)
        with batch_rows(self.rank, self.world):
            res = fn(d, self.denoise, shard_batch(img, self.mesh), t,
                     x_end=None if x_end is None else shard_batch(x_end, self.mesh), **kw)
        # the trajectories are [frames, B, ...]: their batch is dim 1
        return SampleResult(*(None if f is None else gather_rows(f, self.mesh, dim=int(i > 2))
                              for i, f in enumerate(res)))

    def _mesh_pad(self, x: torch.Tensor):
        """Pad the batch to a mesh multiple by repeating its last row; returns
        ``(padded, real rows)``, and callers slice the outputs back."""
        n = x.shape[0]
        pad = (-n) % self.world
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        return x, n

    def _write(self, save, *args, **kw) -> None:
        """A file of ``save``, written by rank 0 alone under a mesh."""
        if self.rank == 0:
            save(*args, **kw)

    # ------------------------------------------------------------------ #

    def _pre(self, og: torch.Tensor) -> torch.Tensor:
        """Dataset space (rgb [-1,1]) -> model space."""
        return rgb2lab(og) if self.to_lab else og

    def _post(self, imgs) -> np.ndarray:
        """Model space -> rgb [-1,1] (applied over any [..., H, W, 3]), on the host."""
        if self.to_lab:
            return _host(lab2rgb(torch.as_tensor(imgs)))
        return _host(imgs)

    def _post_result(self, res: SampleResult) -> SampleResult:
        """Convert every image field of a SampleResult to dataset space
        (lab2rgb under ``to_lab``; identity otherwise) so callers can save
        or measure any field without knowing the model's color space."""
        if not self.to_lab:
            return res
        return SampleResult(*(None if f is None else lab2rgb(f) for f in res))

    def _sample_x_end(self, generator, og):
        """Endpoint for Family-B ops: the operator's own synthesis when it
        has one, else images from ``endpoint_dataset`` (animorphosis)."""
        x_end = self.d.op.sample_x_end(generator, og)
        if x_end is None and getattr(self.d.op, "requires_x_end", False):
            if self.endpoint_dataset is None:
                raise ValueError(
                    "this degradation interpolates toward a second dataset; "
                    "construct EvalHarness(endpoint_dataset=...) "
                    "(CLI: --data_path_2)")
            n = og.shape[0]
            idx = torch.randint(0, len(self.endpoint_dataset), (n,), generator=generator,
                                device=generator.device)
            x_end = self._pre(self._stack(self.endpoint_dataset, idx.tolist()))
        return x_end

    def _degrade_start(self, og, generator):
        """(x_T, the endpoint, the operator with its drawn state) for a
        model-space batch: the endpoint is drawn first, then the baked state."""
        x_end = self._sample_x_end(generator, og)
        op = self.d.op
        if hasattr(op, "randomize"):
            op = op.randomize(generator, og.shape[0])
        start = prepare_start(dataclasses.replace(self.d, op=op), og, x_end=x_end)
        return start, x_end, op

    def test_from_data(self, batch, milestone: int = 0, generator=None, fps: int = 5):
        """Full trajectory dump for one batch (PNG grids + GIFs)."""
        gen = self._generator(generator)
        og = self._tensor(batch)
        start, x_end, op = self._degrade_start(self._pre(og), gen)
        res = self._all_sample(dataclasses.replace(self.d, op=op), start, x_end=x_end,
                               generator=gen)
        x0s = self._post(res.x0_trajectory)
        xts = self._post(res.xt_trajectory)
        root = self.results_folder
        self._write(save_image_grid, _host(og), root / f"og-{milestone}.png")
        for k in range(x0s.shape[0]):
            self._write(save_image_grid, x0s[k], root / f"x0-{milestone}-{k}.png")
            self._write(save_image_grid, xts[k], root / f"xt-{milestone}-{k}.png")
        self._write(save_gif, list(x0s), root / f"x0-{milestone}.gif", fps=fps, titles=True)
        self._write(save_gif, list(xts), root / f"xt-{milestone}.gif", fps=fps, titles=True)
        return res

    def test_with_mixup(self, batch1, batch2, milestone: str = "mixup", generator=None):
        """Sample from an average of two batches (snow diffusion.py:865-881)."""
        og = (self._tensor(batch1) + self._tensor(batch2)) / 2.0
        return self.test_from_data(og, milestone=milestone, generator=generator)

    def test_from_random(self, batch, milestone: str = "random", generator=None):
        """Sample from a 0.9-scaled batch (snow diffusion.py:884-895)."""
        return self.test_from_data(self._tensor(batch) * 0.9, milestone=milestone,
                                   generator=generator)

    def controlled_direct_reconstruct(self, batch, extra: str = "0", generator=None):
        """Fixed-seed single-pass reconstruction grids
        (defading_diffusion_gaussian.py:922-943)."""
        gen = self._generator(generator)
        og = self._tensor(batch)
        start, x_end, op = self._degrade_start(self._pre(og), gen)
        res = self._sample(dataclasses.replace(self.d, op=op), start, x_end=x_end,
                           generator=gen)
        root = self.results_folder
        for name, imgs in [("og", _host(og)), ("xt", self._post(res.xt)),
                           ("direct_recons", self._post(res.direct_recons)),
                           ("recon", self._post(res.img))]:
            self._write(save_image_grid, imgs, root / f"sample-{name}-{extra}.png")
        return res

    def save_training_data(self, dataset, num: int = 64):
        """Dump training images as PNGs (deblur :1712-1722)."""
        out = self.results_folder / "training_data"
        create_folder(out)
        from PIL import Image

        for i in range(min(num, len(dataset))):
            arr = ((np.asarray(dataset[i]) + 1) * 127.5).astype(np.uint8)
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            self._write(Image.fromarray(arr).save, out / f"{i}.png")
        return out

    def opt(self, batch, t: Optional[int] = None, generator=None):
        """Pure forward degradation, no model (deblur ``opt``, :595-607).

        Input and output are dataset-space rgb; the degradation itself runs
        in model space (lab under ``to_lab``), like every other method."""
        gen = self._generator(generator)
        og = self._pre(self._tensor(batch))
        steps = t if t is not None else self.d.num_timesteps
        x_end = self._sample_x_end(gen, og)
        state = self.d.op.sample_rng_state(gen, og.shape[0])
        return self._post(prepare_start(self.d, og, steps, x_end=x_end, rng=state))

    # ------------------------------------------------------------------ #

    def fid_distance_decrease_from_manifold(
        self, dataset, start: int = 0, end: int = 1000, batch_size: int = 32,
        generator=None,
    ) -> dict:
        """The paper's Table harness: prints and returns the 3x3 metric grid.

        Images wider than 256px are nearest-downscaled to 64 before the
        metrics, as the snowification harness does
        (snowification/diffusion/diffusion.py:1050-1054)."""
        gen = self._generator(generator)
        idx = range(start, min(end, len(dataset)))
        originals, degradeds, sampleds, directs = [], [], [], []
        buf = []
        for i in idx:
            buf.append(dataset[i])
            if len(buf) == batch_size:
                self._manifold_batch(np.stack(buf), gen, originals, degradeds,
                                     sampleds, directs)
                buf = []
        if buf:
            self._manifold_batch(np.stack(buf), gen, originals, degradeds,
                                 sampleds, directs)
        og = np.concatenate(originals)
        bl = np.concatenate(degradeds)
        sm = np.concatenate(sampleds)
        dr = np.concatenate(directs)

        # loud extractor identity: fallback numbers must never be mistaken
        # for real Inception-FID, so they get ``proxy_fid_*`` keys
        extractor = self.features.name
        fid_key = "fid" if self.features.is_inception else "proxy_fid"
        # stamp the active prediction-caching factor: metrics produced by an
        # accelerated (refresh_every > 1) run must never be mistaken for the
        # exact reference algorithm's
        out = {"extractor": extractor, "refresh_every": self.refresh_every,
               "bf16": self.bf16}
        # the reference unnormalizes to [0,1] before RMSE/SSIM
        # (deblurring_diffusion_pytorch.py:1619-1623, :1679-1699); FID takes
        # the [-1,1] convention directly (the extractor owns normalization)
        og01 = self._tensor((og + 1.0) * 0.5)
        for name, other in [("degraded", bl), ("sampled", sm), ("direct", dr)]:
            out[f"{fid_key}_{name}"] = calculate_fid_given_samples(
                [og, other], features=self.features
            )
            other01 = self._tensor((other + 1.0) * 0.5)
            out[f"rmse_{name}"] = float(rmse(og01, other01))
            out[f"ssim_{name}"] = float(ssim(og01, other01, data_range=1.0))
        out[f"{fid_key}_improvement"] = (
            out[f"{fid_key}_degraded"] - out[f"{fid_key}_sampled"]
        )
        for k, v in out.items():
            if self.rank == 0:
                print(f"{k}: {v:.5f}" if isinstance(v, float) else f"{k}: {v}")
        return out

    def _manifold_batch(self, batch, generator, originals, degradeds, sampleds, directs):
        # a batch the mesh does not divide is padded (colddiff/eval/harness.py:350)
        og, n = self._mesh_pad(self._pre(self._tensor(batch)))
        start, x_end, op = self._degrade_start(og, generator)
        res = self._sample(dataclasses.replace(self.d, op=op), start, x_end=x_end,
                           generator=generator)
        rows = [np.asarray(batch, np.float32), self._post(res.xt[:n]), self._post(res.img[:n]),
                self._post(res.direct_recons[:n])]
        if rows[0].shape[1] > 256:
            # torch F.interpolate(size=64) default mode='nearest'
            # (snowification diffusion.py:1050-1054): src = floor(i * scale)
            h = rows[0].shape[1]
            idx = np.minimum((np.arange(64) * (h / 64)).astype(int), h - 1)
            rows = [r[:, idx][:, :, idx] for r in rows]
        for acc, r in zip((originals, degradeds, sampleds, directs), rows):
            acc.append(r)

    # ------------------------------------------------------------------ #

    def sample_and_save_for_fid(
        self, num: int = 6400, batch_size: int = 128, generator=None, image_size=None,
        out_name: str = "fid_out", endpoint_dataset=None,
    ) -> Path:
        """Family-B unconditional generation -> PNG tree.

        ``endpoint_dataset``: demixing samples from dataset-2 images instead
        of noise (demixing_diffusion_pytorch.py:806-836).
        """
        gen = self._generator(generator)
        s = image_size or self.d.image_size
        out = self.results_folder / out_name
        create_folder(out)
        count = 0
        ep_idx = 0
        while count < num:
            if endpoint_dataset is not None:
                idxs = [(ep_idx + i) % len(endpoint_dataset) for i in range(batch_size)]
                ep_idx += batch_size
                noise = self._pre(self._stack(endpoint_dataset, idxs))
            else:
                # unit-normal noise is a dataset-space (rgb [-1,1]-scale)
                # distribution; route it through _pre so a lab-space model
                # starts from the same distribution as the endpoint-dataset
                # branch rather than raw N(0,1) in lab coordinates
                noise = self._pre(torch.randn((batch_size, s, s, self.d.channels),
                                              generator=gen, device=self.device))
            imgs = self._post(self._sample(self.d, noise, x_end=noise, generator=gen).img)
            for i in range(imgs.shape[0]):
                if count >= num:
                    break
                self._save_png(imgs[i], out / f"{count}.png")
                count += 1
        return out

    # ------------------------------------------------------------------ #

    def gmm_mean_samples(
        self, dataset, clusters: int = 1, num: int = 64, noise_level: float = 0.0,
        generator=None, max_fit: int = 5000,
    ):
        """Blind generation via GMM over train-set channel means
        (sample_as_a_mean_blur_torch_gmm[_ablation], deblur :1391-1512)."""
        gen = self._generator(generator)
        n_fit = min(len(dataset), max_fit)
        # per-image channel means in MODEL space (lab means != rgb means
        # converted, so _pre comes before the reduction), batched in chunks
        means = torch.cat([
            self._pre(self._stack(dataset, range(lo, min(lo + 256, n_fit)))).mean(dim=(1, 2))
            for lo in range(0, n_fit, 256)
        ])
        gmm = fit_gmm(means, clusters, gen)
        draws = sample_gmm(gmm, gen, num)  # [num, C]
        s = self.d.image_size
        img = draws[:, None, None, :].expand(num, s, s, draws.shape[-1])
        # gen_sample preamble (deblur :465-482): degrade the start image
        # through the chain (identity for constant images under normalized
        # blur, incl. the discrete collapse), then add symmetry-breaking noise
        img = prepare_start(self.d, img)
        if noise_level > 0:
            img = img + noise_level * torch.randn(img.shape, generator=gen,
                                                  device=self.device)
        return self._post_result(self._sample(self.d, img, generator=gen))

    # ------------------------------------------------------------------ #

    def gmm_blur_samples(
        self, dataset, clusters: int = 10, num: int = 64, sample_at: int = None,
        gmm_res: int = 16, noise_level: float = 0.0, generator=None, max_fit: int = 2000,
    ):
        """Blind generation via GMM over *degraded low-res images* at level
        ``sample_at`` (sample_as_a_blur_torch_gmm, deblur :1514-1564):
        degrade train images to sample_at, downsample, flatten, fit GMM,
        sample, upsample, continue the degradation chain sample_at -> T
        (sample_from_blur with start=sample_at, :1551), reverse from T."""
        gen = self._generator(generator)
        T = self.d.num_timesteps
        sample_at = sample_at if sample_at is not None else T
        s = self.d.image_size
        n_fit = min(len(dataset), max_fit)
        imgs = self._pre(self._stack(dataset, range(n_fit)))
        lvl = torch.full((n_fit,), sample_at, dtype=torch.long, device=self.device)
        degraded = self.d.op.degrade(imgs, lvl)
        c = degraded.shape[-1]
        low = resize_bilinear(degraded, gmm_res).reshape(n_fit, -1)
        gmm = fit_gmm(low, clusters, gen)
        draws = sample_gmm(gmm, gen, num).reshape(num, gmm_res, gmm_res, c)
        start = resize_bilinear(draws, s)
        if noise_level > 0:
            start = start + noise_level * torch.randn(start.shape, generator=gen,
                                                      device=self.device)
        xt = self.d.op.degrade_range(start, sample_at, T)
        return self._post_result(self._sample(self.d, xt, generator=gen))

    # ------------------------------------------------------------------ #
    # Family-B vector-GMM blind generation + data-as-x_T sampling

    def _fit_vector_gmm(self, dataset, siz, clusters, generator, max_fit):
        """Fit a GMM to bilinear-downsized flattened *clean* dataset images
        (the shared preamble of sample_as_a_vector_gmm*,
        denoising_diffusion_pytorch.py:1091-1117)."""
        n_fit = min(len(dataset), max_fit)
        imgs = self._pre(self._stack(dataset, range(n_fit)))
        c = imgs.shape[-1]
        low = resize_bilinear(imgs, siz).reshape(n_fit, -1)
        return fit_gmm(low, clusters, generator), c

    def _vector_gmm_starts(self, gmm, generator, num, siz, c):
        """GMM draws -> [num, image_size, image_size, c] bilinear-upsized x_T
        (denoising_diffusion_pytorch.py:1119-1125)."""
        draws = sample_gmm(gmm, generator, num).reshape(num, siz, siz, c)
        return resize_bilinear(draws, self.d.image_size)

    def gmm_vector_samples(self, dataset, siz: int = 64, clusters: int = 10,
                           num: int = 100, generator=None, max_fit: int = 2000,
                           save: bool = True, traj_stride: int = 1):
        """Blind generation via GMM over downsized clean train images
        (sample_as_a_vector_gmm, denoising_diffusion_pytorch.py:1091-1158;
        demixing :1080, defading-generation :1148): the upsized GMM draw is
        x_T and the endpoint is estimated per reverse step (the reference's
        Family-B all_sample always calls get_x2_bar_from_xt, :495 -- matched
        here by x_end=None).  Saves the og grid + x0/xt trajectory GIFs."""
        gen = self._generator(generator)
        gmm, c = self._fit_vector_gmm(dataset, siz, clusters, gen, max_fit)
        start = self._vector_gmm_starts(gmm, gen, num, siz, c)
        res = self._post_result(self._all_sample(self.d, start, generator=gen,
                                                 traj_stride=traj_stride))
        if save:
            tag = f"{siz}-{clusters}-vec"
            self._write(save_image_grid, self._post(start), self.results_folder / f"og-{tag}.png")
            x0s = [_host(f) for f in res.x0_trajectory]
            xts = [_host(f) for f in res.xt_trajectory]
            self._write(save_gif, x0s + [_host(res.img)],
                     self.results_folder / f"Gif-{tag}-x0.gif", titles=True)
            self._write(save_gif, xts + [_host(res.img)],
                     self.results_folder / f"Gif-{tag}-xt.gif", titles=True)
        return res

    def gmm_vector_samples_and_save(self, dataset, siz: int = 64,
                                    clusters: int = 10, n_sample: int = 1000,
                                    batch_size: int = 100, generator=None,
                                    max_fit: int = 2000, out_dir=None) -> Path:
        """PNG-dump variant for external FID: fit once, then draw/reverse in
        batches and save each final reconstruction as sample-x0-<cnt>.png
        (sample_as_a_vector_gmm_and_save, denoising_diffusion_pytorch.py:
        1161-1213; the pycave-backed sample_as_a_vector_pytorch_gmm_and_save
        :1215-1286 differs only in GMM backend -- one EM serves both).
        Output dir mirrors the reference's ``<results>_<siz>_<clusters>/``."""
        gen = self._generator(generator)
        gmm, c = self._fit_vector_gmm(dataset, siz, clusters, gen, max_fit)
        out = Path(out_dir) if out_dir is not None else (
            self.results_folder.with_name(f"{self.results_folder.name}_{siz}_{clusters}")
        )
        create_folder(out)
        cnt = 0
        while cnt < n_sample:
            start = self._vector_gmm_starts(gmm, gen, batch_size, siz, c)
            imgs = self._post(self._sample(self.d, start, generator=gen).img)
            for i in range(imgs.shape[0]):
                if cnt >= n_sample:
                    break
                self._save_png(imgs[i], out / f"sample-x0-{cnt}.png")
                cnt += 1
        return out

    def gmm_from_blur_samples_and_save(self, dataset, start: int = 0,
                                       end: Optional[int] = 1000,
                                       siz: int = 64, clusters: int = 10,
                                       n_sample: int = 1000,
                                       batch_size: int = 100,
                                       sample_at: Optional[int] = None,
                                       generator=None, out_dir=None) -> Path:
        """Fit a GMM at the half-degraded level and reverse-sample from it
        (sample_as_a_vector_from_blur_pytorch_gmm_and_save,
        denoising_diffusion_pytorch.py:1288-1360).  The reference method is
        dead as written -- it calls ``opt`` and ``all_sample_from_blur``,
        neither of which exists on the hot GaussianDiffusion -- so this
        implements its stated intent, as the JAX package does: degrade the
        dataset to ``sample_at = T // 2``, bilinear-downsize + flatten + fit
        a GMM there, then treat upsized GMM draws as x_{sample_at} and
        reverse the remaining steps (endpoint estimated per step, like the
        reference's Family-B all_sample).  Works for Family A too (degrade
        needs no endpoint there).  Saves ``sample-x0-<cnt>.png`` finals and
        ``sample-<cnt>.png`` GMM starts in the reference's mirrored
        ``<results>_{siz}_{clusters}_{sample_at}`` trees."""
        gen = self._generator(generator)
        T = self.d.num_timesteps
        sample_at = T // 2 if sample_at is None else int(sample_at)
        s = self.d.image_size
        last = len(dataset) - 1 if end is None else min(end, len(dataset) - 1)
        idxs = list(range(start + 1, last + 1))
        lows = []
        c = None
        for lo in range(0, len(idxs), 256):
            chunk = self._pre(self._stack(dataset, idxs[lo:lo + 256]))
            x_end = self._sample_x_end(gen, chunk)
            lvl = torch.full((chunk.shape[0],), sample_at, dtype=torch.long,
                             device=self.device)
            deg = self.d.op.degrade(chunk, lvl, x_end=x_end, og=chunk)
            c = deg.shape[-1]
            lows.append(resize_bilinear(deg, siz).reshape(deg.shape[0], -1))
        gmm = fit_gmm(torch.cat(lows), clusters, gen)
        base = Path(out_dir) if out_dir is not None else self.results_folder
        out = base.with_name(f"{base.name}_{siz}_{clusters}_{sample_at}")
        out_gmm = base.with_name(f"{base.name}_gmm_{siz}_{clusters}_{sample_at}")
        create_folder(out)
        create_folder(out_gmm)
        cnt = 0
        while cnt < n_sample:
            draws = sample_gmm(gmm, gen, batch_size).reshape(batch_size, siz, siz, c)
            xt = resize_bilinear(draws, s)
            imgs = self._post(self._sample(self.d, xt, sample_at, generator=gen).img)
            starts = self._post(xt)
            for i in range(imgs.shape[0]):
                if cnt >= n_sample:
                    break
                self._save_png(imgs[i], out / f"sample-x0-{cnt}.png")
                self._save_png(starts[i], out_gmm / f"sample-{cnt}.png")
                cnt += 1
        return out

    def sample_from_data_save(self, dataset, start: int = 0,
                              end: Optional[int] = 1000, batch_size: int = 32,
                              generator=None, out_dir=None) -> Path:
        """Reverse-sample clean dataset images treated directly as x_T and
        dump the final reconstructions as individual PNGs
        (sample_from_data_save, denoising_diffusion_pytorch.py:1362-1395;
        demixing :1351, defading-generation :1419).  Keeps the reference's
        slice semantics: images with start < idx <= end.  A ragged last
        batch runs as it is (the JAX package pads it to its compiled shape;
        the rows are independent)."""
        gen = self._generator(generator)
        last = len(dataset) - 1 if end is None else min(end, len(dataset) - 1)
        idxs = list(range(start + 1, last + 1))
        out = Path(out_dir) if out_dir is not None else (
            self.results_folder / "sample_from_data")
        create_folder(out)
        cnt = 0
        for lo in range(0, len(idxs), batch_size):
            batch = self._pre(self._stack(dataset, idxs[lo:lo + batch_size]))
            imgs = self._post(self._sample(self.d, batch, generator=gen).img)
            for img in imgs:
                self._save_png(img, out / f"sample-x0-{cnt}.png")
                cnt += 1
        return out

    def test_from_data_save_results(self, dataset, num: Optional[int] = None,
                                    batch_size: int = 32, generator=None) -> Path:
        """Per-image PNG trees of original / degraded / direct-recon / final
        reconstruction over the eval set (test_from_data_save_results,
        defading_diffusion_gaussian.py:1146-1244; --test_type
        test_save_images).  Folders mirror the reference's
        ``<results>_{orig,blur,d_deblur,deblur}``."""
        gen = self._generator(generator)
        n = min(num or len(dataset), len(dataset))
        dirs = {}
        for tag in ("orig", "blur", "d_deblur", "deblur"):
            d = self.results_folder.with_name(f"{self.results_folder.name}_{tag}")
            create_folder(d)
            dirs[tag] = d
        cnt = 0
        for lo in range(0, n, batch_size):
            og = self._stack(dataset, range(lo, min(lo + batch_size, n)))
            start, x_end, op = self._degrade_start(self._pre(og), gen)
            res = self._sample(dataclasses.replace(self.d, op=op), start, x_end=x_end,
                               generator=gen)
            rows = {
                "orig": _host(og),
                "blur": self._post(res.xt),
                "d_deblur": self._post(res.direct_recons),
                "deblur": self._post(res.img),
            }
            for i in range(og.shape[0]):
                for tag, imgs in rows.items():
                    self._save_png(imgs[i], dirs[tag] / f"{cnt}.png")
                cnt += 1
        return self.results_folder

    def _forward_frames(self, og_m, generator):
        """The model-space forward trajectory [og, D(og, 1), ..., D(og, T)]
        and the endpoint it was drawn toward."""
        b = og_m.shape[0]
        x_end = self._sample_x_end(generator, og_m)
        fwd_m = [og_m] + [
            self.d.op.degrade(og_m, torch.full((b,), n, dtype=torch.long,
                                               device=self.device),
                              x_end=x_end, og=og_m)
            for n in range(1, self.d.num_timesteps + 1)
        ]
        return fwd_m, x_end

    def forward_and_backward(self, batch, generator=None, prefix: str = "fb"):
        """Forward degradation frames + reverse frames for figure strips
        (denoising_diffusion_pytorch.py:437-478; deblur :691-861)."""
        gen = self._generator(generator)
        fwd_m, x_end = self._forward_frames(self._pre(self._tensor(batch)), gen)
        res = self._post_result(self._all_sample(self.d, fwd_m[-1], x_end=x_end,
                                                 generator=gen))
        fwd = [self._post(f) for f in fwd_m]
        bwd = [_host(f) for f in res.xt_trajectory] + [_host(res.img)]
        self._write(save_gif, fwd, self.results_folder / f"{prefix}-forward.gif")
        self._write(save_gif, bwd, self.results_folder / f"{prefix}-backward.gif")
        return fwd, bwd

    def paper_cover_page(self, batch, n_frames: int = 8, generator=None,
                         name: str = "cover_page.png"):
        """Multi-image trajectory grid: rows = samples, columns = reverse steps
        (paper_showing_diffusion_images_cover_page, deblur :1269-1330)."""
        og = self._tensor(batch)
        res = self._run_all_sample(og, self._generator(generator))
        frames = np.concatenate(
            [_host(res.xt_trajectory), _host(res.img)[None]], axis=0
        )  # [T+1, B, H, W, C]
        T1 = frames.shape[0]
        pick = np.linspace(0, T1 - 1, min(n_frames, T1)).astype(int)
        page = np.concatenate(
            [np.concatenate([frames[k, b] for k in pick], axis=1) for b in range(og.shape[0])],
            axis=0)
        return self._save_png(page, self.results_folder / name)

    # ------------------------------------------------------------------ #
    # named paper-figure generators (reference --test_type surface)

    def _run_all_sample(self, og, generator, s_times=None, routine=None):
        """``og`` is dataset-space rgb; the result's fields are converted
        back to dataset space (to_lab-safe for every figure generator)."""
        d = self.d if routine is None else dataclasses.replace(self.d,
                                                              sampling_routine=routine)
        start, x_end, op = self._degrade_start(self._pre(og), generator)
        return self._post_result(self._all_sample(dataclasses.replace(d, op=op), start,
                                                  s_times, x_end=x_end,
                                                  generator=generator))

    @staticmethod
    def _panel(imgs, pad: int = 10, color: float = -1.0) -> np.ndarray:
        """hconcat [H,W,C] images with a uniform border (cv2.copyMakeBorder +
        hconcat in the reference; color -1 = black, +1 = white)."""
        out = []
        for im in imgs:
            im = _host(im)
            if im.shape[-1] == 1:
                im = np.repeat(im, 3, axis=-1)
            out.append(np.pad(im, ((pad, pad), (pad, pad), (0, 0)),
                              constant_values=color))
        return np.concatenate(out, axis=1)

    def _save_png(self, img, path):
        from PIL import Image

        img = ((np.clip(_host(img), -1, 1) + 1) * 127.5).astype(np.uint8)
        if img.shape[-1] == 1:
            img = img[..., 0]
        self._write(Image.fromarray(img).save, path)
        return path

    def paper_invert_section_images(self, batch, s_times=None, generator=None):
        """Per-sample [degraded | direct recon | sampled recon | original]
        panels with 10px black borders
        (denoising_diffusion_pytorch.py:910-956)."""
        og = self._tensor(batch)
        res = self._run_all_sample(og, self._generator(generator), s_times)
        root = self.results_folder
        paths = []
        for cnt in range(max(og.shape[0] // 3, 1)):
            parts = {
                "blurry_image": res.xt_trajectory[0][cnt],
                "direct_recons": res.x0_trajectory[0][cnt],
                "sampling_recons": res.x0_trajectory[-1][cnt],
                "original": og[cnt],
            }
            for name, im in parts.items():
                self._save_png(im, root / f"{name}_{cnt}.png")
            paths.append(self._save_png(self._panel(list(parts.values()), color=-1.0),
                                        root / f"all_{cnt}.png"))
        return paths

    def paper_showing_diffusion_images(self, batch, s_times=None, generator=None,
                                       to_show=(0, 2, 4, 8, 16, 32, 64, 80,
                                                88, 92, 96, 98, 99)):
        """Per-sample reverse-trajectory strips at fixed step indices + the
        final reconstruction (denoising_diffusion_pytorch.py:957-996)."""
        og = self._tensor(batch)
        res = self._run_all_sample(og, self._generator(generator), s_times)
        xts = _host(res.xt_trajectory)
        x0_last = _host(res.x0_trajectory[-1])
        pick = [j for j in to_show if j < xts.shape[0]]
        return [self._save_png(self._panel([xts[j, cnt] for j in pick] + [x0_last[cnt]],
                                           pad=0),
                               self.results_folder / f"all_{cnt}.png")
                for cnt in range(og.shape[0])]

    def paper_showing_diffusion_images_diff(
        self, batch, s_times=None, generator=None,
        to_show=(0, 1, 2, 4, 8, 10, 12, 16, 17, 18, 19, 20),
    ):
        """Algorithm-1 vs Algorithm-2 trajectory strips for sample 0
        (denoising_diffusion_pytorch.py:997-1049 all_sample_both_sample)."""
        gen = self._generator(generator)
        og = self._tensor(batch)
        paths = []
        for alg, routine in (("alg2", "x0_step_down"), ("alg1", "default")):
            res = self._run_all_sample(og, gen, s_times, routine=routine)
            xts = _host(res.xt_trajectory)
            frames = [xts[j, 0] for j in to_show if j < xts.shape[0]]
            frames.append(res.x0_trajectory[-1][0])
            paths.append(self._save_png(self._panel(frames, pad=0),
                                        self.results_folder / f"all_{alg}_0.png"))
        return paths

    def paper_showing_sampling_diff_images(self, batch, s_times=None, generator=None):
        """Per-sample [original | alg1 final | alg2 final] white-bordered
        panels (denoising_diffusion_pytorch.py:1051-1090)."""
        gen = self._generator(generator)
        og = self._tensor(batch)
        res2 = self._run_all_sample(og, gen, s_times, routine="x0_step_down")
        res1 = self._run_all_sample(og, gen, s_times, routine="default")
        root = self.results_folder
        paths = []
        for cnt in range(og.shape[0]):
            x1, x2 = res1.x0_trajectory[-1][cnt], res2.x0_trajectory[-1][cnt]
            self._save_png(x1, root / f"x0_alg1_{cnt}.png")
            self._save_png(x2, root / f"x0_alg2_{cnt}.png")
            self._save_png(og[cnt], root / f"og_img_{cnt}.png")
            paths.append(self._save_png(self._panel([og[cnt], x1, x2], color=1.0),
                                        root / f"all_{cnt}.png"))
        return paths

    def paper_cover_page_both_sampling(self, batch, n_frames: int = 8,
                                       generator=None):
        """Forward strip + one reverse strip per sampling algorithm
        (deblur paper_showing_diffusion_images_cover_page_both_sampling,
        :1269-1337 via forward_and_backward_2)."""
        gen = self._generator(generator)
        og_m = self._pre(self._tensor(batch))
        T = self.d.num_timesteps
        fwd_m, x_end = self._forward_frames(og_m, gen)
        fwd = [self._post(f) for f in fwd_m]
        pick = np.linspace(0, T, min(n_frames, T + 1)).astype(int)
        paths = []
        for alg, routine in (("1", "default"), ("2", "x0_step_down")):
            d = dataclasses.replace(self.d, sampling_routine=routine)
            res = self._post_result(self._all_sample(d, fwd_m[-1], x_end=x_end,
                                                     generator=gen))
            bwd = [_host(f) for f in res.xt_trajectory] + [_host(res.img)]
            for k in range(og_m.shape[0]):
                frames = [fwd[j][k] for j in pick] + [bwd[j][k] for j in pick[1:]]
                paths.append(self._save_png(self._panel(frames, pad=0),
                                            self.results_folder / f"all_{alg}_{k}.png"))
        return paths

    def sample_from_blur(self, img, start: int = 0, generator=None,
                         prefix: str = "from_blur"):
        """Continue the degradation chain from level ``start`` to T on an
        already-degraded input, then reverse-sample
        (GaussianDiffusion.sample_from_blur, deblur :863-925; Trainer wiring
        sample_as_a_blur_torch_gmm :1551)."""
        gen = self._generator(generator)
        img = self._tensor(img)
        xt = self.d.op.degrade_range(self._pre(img), start, self.d.num_timesteps)
        res = self._post_result(self._sample(self.d, xt, generator=gen))
        root = self.results_folder
        self._write(save_image_grid, _host(img), root / f"sample-og-{prefix}.png")
        self._write(save_image_grid, _host(res.xt), root / f"sample-xt-{prefix}.png")
        self._write(save_image_grid, _host(res.direct_recons),
                    root / f"sample-direct_recons-{prefix}.png")
        self._write(save_image_grid, _host(res.img), root / f"sample-recon-{prefix}.png")
        return res

    def paper_trajectory_strip(self, batch, n_frames: int = 8, generator=None,
                               name: str = "trajectory_strip.png"):
        """Horizontal forward+reverse trajectory strip (paper figures)."""
        og = self._tensor(batch)[:1]
        res = self._run_all_sample(og, self._generator(generator))
        frames = _host(res.xt_trajectory)[:, 0]  # [T, H, W, C]
        T = frames.shape[0]
        pick = np.linspace(0, T - 1, min(n_frames, T)).astype(int)
        strip = np.concatenate([frames[i] for i in pick], axis=1)
        return self._save_png(strip, self.results_folder / name)
