"""Trainer: the single-device training loop with EMA, checkpoints and
periodic sample grids.

Port of the main path of ``colddiff/train.py`` (``Trainer``, :49-575), with
the reference ``Trainer``'s interface (deblurring_diffusion_pytorch.py:
1057-1235): Adam(lr=2e-5), gradient accumulation x2, an EMA shadow updated
every 10 steps after a 2000-step warmup (reset to the params before that),
and a checkpoint plus sample grids every ``save_and_sample_every`` steps.

As in the JAX Trainer:
  - the step's gradient is the mean of the ``accum`` microbatch gradients,
    and its reported loss the mean of the microbatch losses;
  - ``bf16=True`` casts the parameters and the input to bf16 at each
    forward and keeps fp32 master weights, Adam moments and EMA (the JAX
    recipe, not per-op autocast);
  - the denoiser's output is cast to fp32, so the loss is fp32;
  - each microbatch takes its Family-B endpoint from ``second_dataset``
    (``mix``: a second loader, seeded ``seed + 1``) or draws it
    (``op.sample_x_end``), then draws its t, its operator state
    (``op.sample_rng_state``: fade's crops) and a noise routine's noise
    (``Final_small_noise``, ``Final_random_mean[_and_actual]``), all from
    one ``torch.Generator`` seeded by ``seed``;
  - a model with dropout (``UnetResNet``) draws its masks in training from
    a generator of its own, seeded from ``seed``, so the draws above do
    not move with the model; every model call of one microbatch's loss
    draws the same masks, as JAX applies the model with one dropout key
    per microbatch (colddiff/train.py:277-286).  EMA sampling runs the
    model in ``eval()`` with no generator: no dropout;
  - only operators with ``random_snow`` are reset at each step
    (colddiff/train.py:468-478), from a generator of their own seeded by the
    step, so a fade operator's baked crops never change in training.

Checkpoints are ``torch.save`` blobs ``{step, model, ema, opt, generator,
dropout_generator, op}`` (``results_folder/model.pt``); ``model`` and
``ema`` have the reference's state-dict names, and ``op`` holds the
operator's tensors (a random snow field), as the JAX checkpoint holds the
operator.

Not ported yet: multi-process training and parameter sharding (ROADMAP.md
section 1, item 12), the restart supervisor (item 13), and ``remat``,
``to_lab``, ``profile_dir`` and ``debug_nans`` (item 6).  Passing any of
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .data.datasets import DataLoader
from .diffusion import ColdDiffusion
from .models.convert import load_reference_checkpoint
from .ops.linop import require_ieee_fp32
from .sampling import prepare_start, sample
from .utils import bf16_params, create_folder, cycle, ema_update, save_image_grid

__all__ = ["Trainer"]

# JAX Trainer arguments not ported yet -> the ROADMAP.md item that ports them
_UNPORTED = {
    "param_sharding": "section 1, item 12 (parallelism)",
    "fsdp_min_size": "section 1, item 12 (parallelism)",
    "mesh": "section 1, item 12 (parallelism)",
    "restart_every_steps": "section 1, item 13 (restart supervisor)",
    "restart_rss_gb": "section 1, item 13 (restart supervisor)",
    "remat": "section 1, item 6 (Trainer)",
    "to_lab": "section 1, item 6 (Trainer)",
    "profile_dir": "section 1, item 6 (Trainer)",
    "profile_steps": "section 1, item 6 (Trainer)",
    "debug_nans": "section 1, item 6 (Trainer)",
}


class Trainer:
    def __init__(
        self,
        diffusion: ColdDiffusion,
        model: torch.nn.Module,
        dataset,
        *,
        second_dataset=None,  # mix: the endpoint images (demixing Trainer)
        train_batch_size: int = 32,
        train_lr: float = 2e-5,
        train_num_steps: int = 700000,
        gradient_accumulate_every: int = 2,
        ema_decay: float = 0.995,
        step_start_ema: int = 2000,
        update_ema_every: int = 10,
        save_and_sample_every: int = 1000,
        save_with_milestone_every: int = 0,  # 0 = only the rolling 'model.pt'
        results_folder: str = "./results",
        load_path: Optional[str] = None,
        load_torch_path: Optional[str] = None,
        auto_resume: bool = False,
        bf16: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        device: torch.device | str = "cuda",
        **unported,
    ):
        for name in unported:
            if name not in _UNPORTED:
                raise TypeError(f"Trainer got an unexpected keyword argument '{name}'")
            raise NotImplementedError(
                f"Trainer argument '{name}' is not ported to colddiff_torch yet; "
                f"see ROADMAP.md {_UNPORTED[name]}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer on a CUDA device, but no CUDA device is "
                                   "available; pass device='cpu' to train on the CPU")
            # the degrade matmuls need full fp32; the flag is global, so the
            # caller sets it (ops/linop.py)
            require_ieee_fp32(torch.empty(0, device=self.device))
        if load_path is not None and load_torch_path is not None:
            raise ValueError("pass load_path or load_torch_path, not both")

        self.diffusion = dataclasses.replace(diffusion, op=diffusion.op.to(self.device))
        self.model = model.to(self.device)
        self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        self.batch_size = train_batch_size
        self.train_num_steps = train_num_steps
        self.accum = gradient_accumulate_every
        self.ema_decay = ema_decay
        self.step_start_ema = step_start_ema
        self.update_ema_every = update_ema_every
        self.save_and_sample_every = save_and_sample_every
        self.save_with_milestone_every = save_with_milestone_every
        self.results_folder = Path(results_folder)
        create_folder(self.results_folder)
        self.metrics_path = self.results_folder / "metrics.jsonl"
        self.bf16 = bf16
        self.opt = torch.optim.Adam(self.model.parameters(), lr=train_lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            (1009 << 32) + seed)
        self.dl = cycle(DataLoader(dataset, train_batch_size,
                                   num_workers=num_workers, seed=seed))
        self.dl2 = (cycle(DataLoader(second_dataset, train_batch_size,
                                     num_workers=num_workers, seed=seed + 1))
                    if second_dataset is not None else None)
        # snapshot() draws its grid images (and endpoints) from loaders of
        # its own, so the training stream is the same whether or not
        # snapshots run
        self._snap_dataset = dataset
        self._snap_dataset2 = second_dataset
        self._snap_workers = num_workers
        self._snap_seed = seed
        self._snap_dl = self._snap_dl2 = None
        self._snap_bs = 0
        self.step = 0

        if auto_resume and (self.results_folder / "model.pt").exists():
            # resume from this run's own rolling checkpoint, over both the
            # warm start and the migration path (colddiff/train.py:200-209)
            load_path = str(self.results_folder / "model.pt")
            load_torch_path = None
        if load_path is not None:
            self.load(load_path)
        elif load_torch_path is not None:
            # migration from a reference PyTorch Trainer checkpoint
            # ({step, model, ema}, deblurring_diffusion_pytorch.py:1140-1149);
            # Adam restarts at zero, as the reference's resume does
            blob = torch.load(load_torch_path, map_location="cpu")
            self.model.load_state_dict(load_reference_checkpoint(blob, use_ema=False))
            self.ema_model.load_state_dict(load_reference_checkpoint(blob, use_ema=True))
            self.step = int(blob.get("step", 0))

    # ------------------------------------------------------------------ #

    def _denoise_fn(self, model: torch.nn.Module,
                    generator: Optional[torch.Generator] = None):
        """``denoise(x, t)`` of ``model``, returning fp32 (colddiff/train.py:
        245-263).  With ``generator``, the model draws its dropout masks from
        it, each call from the generator's state at this call, so all calls
        draw the same masks, as all JAX applies with one dropout key do."""
        kwargs = {} if generator is None else {"generator": generator}
        state = None if generator is None else generator.get_state()

        def replay():
            if state is not None:
                generator.set_state(state)

        if self.bf16:
            params = bf16_params(model.named_parameters())

            def fn(x, t):
                replay()
                out = torch.func.functional_call(model, params,
                                                 (x.to(torch.bfloat16), t), kwargs)
                return out.to(torch.float32)
        else:
            dtype = next(model.parameters()).dtype

            def fn(x, t):
                replay()
                return model(x.to(dtype), t, **kwargs).to(torch.float32)
        return fn

    def _next_superbatch(self, dl=None) -> torch.Tensor:
        """[accum, B, H, W, C] float32 on the device, from ``dl`` (the
        training loader by default)."""
        dl = self.dl if dl is None else dl
        xs = torch.from_numpy(np.stack([next(dl) for _ in range(self.accum)]))
        if self.device.type == "cuda":
            return xs.pin_memory().to(self.device, non_blocking=True)
        return xs.to(self.device)

    def _maybe_reset_op(self) -> None:
        """Redraw the state of operators with ``random_snow`` before each step
        (colddiff/train.py:468-478), from a generator seeded by the step
        alone, as JAX folds the step into ``key(997)``; the training
        generator's stream is left as it is."""
        op = self.diffusion.op
        if getattr(op, "random_snow", False):
            gen = torch.Generator(device=self.device).manual_seed((997 << 32) + self.step)
            self.diffusion = dataclasses.replace(self.diffusion,
                                                 op=op.reset(gen, self.batch_size))

    def train_step(self, batch: torch.Tensor, t: Optional[torch.Tensor] = None,
                   x_end: Optional[torch.Tensor] = None, rng=None) -> torch.Tensor:
        """One optimizer step over the ``[accum, B, ...]`` microbatches of
        ``batch``; returns the mean microbatch loss (a 0-d device tensor).

        ``t`` ([accum, B] levels), ``x_end`` ([accum, B, H, W, C]) and
        ``rng`` (per microbatch, an operator state of
        ``op.sample_rng_state``) replace the generator's draws; the tests
        use them to replay the JAX Trainer's draws."""
        self._maybe_reset_op()
        op = self.diffusion.op
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(self.accum):
            x = batch[i]
            x_end_i = (op.sample_x_end(self.generator, x) if x_end is None
                       else x_end[i])
            fn = self._denoise_fn(self.model, self.dropout_generator)
            loss = self.diffusion.loss(fn, x, self.generator,
                                       t=None if t is None else t[i], x_end=x_end_i,
                                       rng=None if rng is None else rng[i])
            loss.backward()  # sums into .grad, as the JAX scan sums grads
            loss_sum += loss.detach()
        params = [p for p in self.model.parameters() if p.grad is not None]
        torch._foreach_div_([p.grad for p in params], self.accum)
        self.opt.step()

        # EMA: every `update_ema_every` steps; reset to the params during
        # warmup (colddiff/train.py:308-318)
        self.step += 1
        if self.step % self.update_ema_every == 0:
            ema, new = list(self.ema_model.parameters()), list(self.model.parameters())
            if self.step < self.step_start_ema:
                with torch.no_grad():
                    torch._foreach_copy_(ema, new)
            else:
                ema_update(ema, new, self.ema_decay)
        return loss_sum / self.accum

    def train(self, log_every: int = 100) -> str:
        """Run to ``train_num_steps``; returns "done"."""
        t0 = time.time()
        while self.step < self.train_num_steps:
            batch = self._next_superbatch()
            x_end = None if self.dl2 is None else self._next_superbatch(self.dl2)
            loss = self.train_step(batch, x_end=x_end)
            if self.step % log_every == 0:
                loss_v = float(loss)
                dt = time.time() - t0
                ips = log_every * self.accum * self.batch_size / dt
                print(f"step {self.step}: loss {loss_v:.5f} ({ips:.1f} img/s)", flush=True)
                with open(self.metrics_path, "a") as f:
                    f.write(json.dumps({"step": self.step, "loss": loss_v,
                                        "images_per_sec": round(ips, 2)}) + "\n")
                t0 = time.time()
            if self.step % self.save_and_sample_every == 0:
                # the checkpoint first: the T-step sampler is the likelier
                # place for a long run to fail
                self.save()
                self.snapshot(self.step // self.save_and_sample_every)
                if (self.save_with_milestone_every
                        and self.step % self.save_with_milestone_every == 0):
                    self.save(self.results_folder / f"model_{self.step}.pt")
        self.save()
        return "done"

    def _snapshot_batch(self, n: int):
        """(grid images, endpoint images or None) from loaders with their own
        seeds (colddiff/train.py:358-391), never more than a dataset holds;
        one batch size for both, since the endpoints pair with the images."""
        bs = min(max(n, self.batch_size), len(self._snap_dataset))
        if self._snap_dataset2 is not None:
            bs = min(bs, len(self._snap_dataset2))
        if self._snap_dl is None or self._snap_bs < bs:
            self._snap_bs = bs
            self._snap_dl = cycle(DataLoader(
                self._snap_dataset, bs, num_workers=self._snap_workers,
                seed=self._snap_seed + 7919))
            if self._snap_dataset2 is not None:
                self._snap_dl2 = cycle(DataLoader(
                    self._snap_dataset2, bs, num_workers=self._snap_workers,
                    seed=self._snap_seed + 7920))
        og = next(self._snap_dl)[:n]
        return og, None if self._snap_dl2 is None else next(self._snap_dl2)[:n]

    def snapshot(self, milestone: int, batch_size: Optional[int] = None) -> None:
        """EMA sample grids ``og``, ``xt``, ``direct_recons`` and ``sample``
        (reference Trainer.train(), deblurring_diffusion_pytorch.py:1206-1228)."""
        n = batch_size or min(self.batch_size, 36)
        og_np, end_np = self._snapshot_batch(n)
        og = torch.from_numpy(og_np).to(self.device)
        self.ema_model.eval()
        d = self.diffusion
        gen = torch.Generator(device=self.device).manual_seed(self.step)
        with torch.inference_mode():
            # mix's endpoints come from the second dataset; an operator that
            # owns its endpoint draws it (train.py:326-336)
            x_end = (d.op.sample_x_end(gen, og) if end_np is None
                     else torch.from_numpy(end_np).to(self.device))
            res = sample(d, self._denoise_fn(self.ema_model),
                         prepare_start(d, og, x_end=x_end), x_end=x_end, generator=gen)
        for name, imgs in [("og", og_np), ("xt", res.xt),
                           ("direct_recons", res.direct_recons), ("sample", res.img)]:
            if torch.is_tensor(imgs):
                imgs = imgs.float().cpu().numpy()
            save_image_grid(imgs, self.results_folder / f"{name}-{milestone}.png")

    # ------------------------------------------------------------------ #

    def state(self) -> dict:
        """The checkpoint blob ``{step, model, ema, opt, generator,
        dropout_generator, op}``."""
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema_model.state_dict(), "opt": self.opt.state_dict(),
                "generator": self.generator.get_state(),
                "dropout_generator": self.dropout_generator.get_state(),
                "op": self.diffusion.op.state()}

    def load_state(self, blob: dict) -> None:
        """Restore a blob of :meth:`state`, of
        ``models.convert.train_state_from_flax`` (no generators, no
        operator) or of a checkpoint older than the operator's or the
        dropout generator's entry (no ``op``, no ``dropout_generator``).

        Adam's moments and step counts come from the blob, its
        hyperparameters stay this Trainer's, as in the JAX Trainer, whose
        checkpoint holds the optimizer state and not its configuration."""
        self.model.load_state_dict(blob["model"])
        self.ema_model.load_state_dict(blob["ema"])
        own = [{k: v for k, v in g.items() if k != "params"} for g in self.opt.param_groups]
        self.opt.load_state_dict(blob["opt"])
        for group, hyper in zip(self.opt.param_groups, own):
            group.update(hyper)
        for key in ("generator", "dropout_generator"):
            if key in blob:
                getattr(self, key).set_state(blob[key].cpu())
        if "op" in blob:
            self.diffusion = dataclasses.replace(
                self.diffusion, op=self.diffusion.op.with_state(blob["op"], self.device))
        self.step = int(blob["step"])

    def save(self, path: Optional[str | os.PathLike] = None) -> None:
        path = Path(path or (self.results_folder / "model.pt"))
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(self.state(), tmp)
        os.replace(tmp, path)  # a crash mid-save leaves the last checkpoint whole

    def load(self, path: str | os.PathLike) -> None:
        self.load_state(torch.load(path, map_location="cpu"))
