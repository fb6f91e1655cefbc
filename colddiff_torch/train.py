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

Switches, as in the JAX Trainer:
  - ``remat``: the denoiser call of each training loss runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``), so its
    activations are recomputed in the backward pass.  The dropout
    generator's replay sits inside the checkpointed call, so the recompute
    draws the masks of the forward.  The recompute runs every layer again,
    the block-front kernels too: a training call launches each front twice;
  - ``to_lab``: batches go to Lab (``rgb2lab``) before the loss, and the
    sample grids back through ``lab2rgb`` (snowification diffusion.py:
    613-625);
  - ``profile_dir``/``profile_steps``: a ``torch.profiler`` trace of the
    steps from ``profile_steps[0]`` to ``profile_steps[1]``, written as a
    Chrome trace under ``profile_dir`` (JAX's ``jax.profiler`` window), the
    port's spans (``colddiff_torch.tracing``) named in it;
  - ``debug_nans``: a non-finite batch or microbatch loss raises
    ``FloatingPointError`` (JAX's ``jax_debug_nans``).  The check waits for
    the card, so it runs only with the switch on;
  - ``restart_every_steps``/``restart_rss_gb``: ``train()`` checkpoints and
    returns "restart" every N steps, or when the host RSS passes the limit
    (the CLI's supervisor respawns a worker that resumes).  A resumed
    Trainer also continues its loaders' streams from the checkpoint's step,
    so a run cut into workers takes the batches of an unbroken one (the JAX
    Trainer starts its loaders anew).

Multi-process training (colddiff/train.py:133-150, after
``colddiff_torch.parallel.init_multihost``; ``mesh`` defaults to one over
the process group): ``train_batch_size`` is global and divides over the
processes, each process's loaders read its stripe of the dataset at
``batch // processes`` rows, and every draw of a step above (t, the
endpoint, the operator state, the noise, the dropout masks) is made for the
global batch from the generators every process holds alike, each keeping
its rows (``parallel.batch_rows``), so an n-process step equals the
1-process step on the joined batch.  The gradient is averaged over the
processes once an optimizer step, after the ``accum`` microbatches, in flat
buckets; the reported loss is the mean over the processes.
``param_sharding="fsdp"`` shards the model, the EMA and Adam's moments
with ``fully_shard`` at ``parallel.fsdp_sharding``'s placements
(``fsdp_min_size``), its ``MixedPrecisionPolicy`` gathering bf16 weights
under ``bf16``; its gradients too are reduced once a step, at the last
microbatch's backward (``set_requires_gradient_sync``), so they sum in the
replicated path's order; the EMA updates the local shards.  Sample grids
come from rank 0 after every process gathers the EMA; ``save()`` gathers
the whole state and rank 0 writes it, with the reference's names, so a
checkpoint of any run loads into any other; logs and ``metrics.jsonl``
come from rank 0, and the RSS restart trigger stays single-process.  Without a process group
no collective runs.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from .data.datasets import DataLoader
from .diffusion import ColdDiffusion
from .models.convert import load_reference_checkpoint
from .ops.image import lab2rgb, rgb2lab
from .ops.linop import require_ieee_fp32
from .parallel.mesh import (all_reduce_mean, batch_rows, full_state_dict, is_sharded, make_mesh,
                            put_like, shard_like, shard_state)
from .sampling import prepare_start, sample
from .tracing import label, prepare, span
from .utils import bf16_params, create_folder, cycle, ema_update, save_image_grid

__all__ = ["Trainer"]


def _local(tensors) -> list:
    """The local shards of sharded tensors, the others as they are."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


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
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (10, 20),
        debug_nans: bool = False,
        remat: bool = False,
        restart_every_steps: int = 0,
        restart_rss_gb: float = 0.0,
        to_lab: bool = False,
        param_sharding: str = "replicated",
        fsdp_min_size: int = 2 ** 14,
        mesh=None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer on a CUDA device, but no CUDA device is "
                                   "available; pass device='cpu' to train on the CPU")
            # the degrade matmuls need full fp32; the flag is global, so the
            # caller sets it (ops/linop.py)
            require_ieee_fp32(torch.empty(0, device=self.device))
            prepare(self.device)  # the span markers, loaded before any profiler window
        if load_path is not None and load_torch_path is not None:
            raise ValueError("pass load_path or load_torch_path, not both")
        if param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"unknown param_sharding mode: {param_sharding!r}")
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(self.device.type)
        if mesh is None and param_sharding == "fsdp":
            raise ValueError("param_sharding='fsdp' shards over a process group: call "
                             "colddiff_torch.parallel.init_multihost first (a group of "
                             "one process will do)")
        self.mesh = mesh
        self.rank, self.world = (0, 1) if mesh is None else (mesh.get_local_rank(), mesh.size())
        if train_batch_size % self.world:
            raise ValueError(f"train_batch_size={train_batch_size} must divide over "
                             f"{self.world} processes")

        self.diffusion = dataclasses.replace(diffusion, op=diffusion.op.to(self.device))
        self.model = model.to(self.device)
        self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        # the unsharded module that rank 0 loads the gathered EMA into to sample
        self._template = (copy.deepcopy(self.model).cpu() if param_sharding == "fsdp"
                          else None)
        if mesh is not None:
            policy = None
            if bf16 and param_sharding == "fsdp":
                from torch.distributed.fsdp import MixedPrecisionPolicy

                policy = MixedPrecisionPolicy(param_dtype=torch.bfloat16,
                                              reduce_dtype=torch.float32)
            shard_state(self.model, mesh, param_sharding, min_size=fsdp_min_size,
                        mp_policy=policy)
            shard_state(self.ema_model, mesh, param_sharding, min_size=fsdp_min_size)
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
        self.remat = remat
        self.to_lab = to_lab
        self.debug_nans = debug_nans
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler = None
        self.restart_every_steps = restart_every_steps
        self.restart_rss_gb = restart_rss_gb
        if restart_rss_gb:
            base = self._host_rss_gb()
            if base and restart_rss_gb <= base + 1.0:
                print(f"WARNING: --restart_rss_gb {restart_rss_gb} is at or "
                      f"below the process baseline RSS ({base:.1f} GB); "
                      "every step would trigger a respawn -- raise the "
                      "threshold well above baseline", flush=True)
        # Adam's foreach kernels refuse a group that mixes sharded and whole
        # parameters (torch 2.11), so a sharded model steps tensor by tensor
        self.opt = torch.optim.Adam(self.model.parameters(), lr=train_lr,
                                    betas=(0.9, 0.999), eps=1e-8,
                                    foreach=False if is_sharded(self.model) else None)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            (1009 << 32) + seed)
        self._dataset, self._dataset2 = dataset, second_dataset
        self._num_workers, self._seed = num_workers, seed
        self._start_loaders(0)
        # snapshot() draws its grid images (and endpoints) from loaders of
        # its own, so the training stream is the same whether or not
        # snapshots run
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
            put_like(load_reference_checkpoint(blob, use_ema=False), self.model)
            put_like(load_reference_checkpoint(blob, use_ema=True), self.ema_model)
            self.step = int(blob.get("step", 0))

    # ------------------------------------------------------------------ #

    def _start_loaders(self, skip: int) -> None:
        """The training loaders (and ``second_dataset``'s), continuing their
        seeded streams after ``skip`` batches."""
        stripe = dict(process_index=self.rank, process_count=self.world, skip=skip)
        local = self.batch_size // self.world
        self.dl = cycle(DataLoader(self._dataset, local, num_workers=self._num_workers,
                                   seed=self._seed, **stripe))
        self.dl2 = (cycle(DataLoader(self._dataset2, local, num_workers=self._num_workers,
                                     seed=self._seed + 1, **stripe))
                    if self._dataset2 is not None else None)

    def _rows(self):
        """Draws of batch-shaped tensors inside are the global batch's, each
        process keeping its rows; nothing changes on one process."""
        if self.world == 1:
            return contextlib.nullcontext()
        return batch_rows(self.rank, self.world)

    def _denoise_fn(self, model: torch.nn.Module,
                    generator: Optional[torch.Generator] = None, remat: bool = False):
        """``denoise(x, t)`` of ``model``, returning fp32 (colddiff/train.py:
        245-267).  With ``generator``, the model draws its dropout masks from
        it, each call from the generator's state at this call, so all calls
        draw the same masks, as all JAX applies with one dropout key do.
        With ``remat``, each call runs under ``torch.utils.checkpoint``; the
        generator's replay is part of the checkpointed call, so its
        recompute draws the same masks.  The masks are the global batch's
        rows (``_rows``), set inside the call too, since a recompute may run
        on the autograd engine's own thread."""
        kwargs = {} if generator is None else {"generator": generator}
        state = None if generator is None else generator.get_state()
        rows = self._rows if generator is not None else contextlib.nullcontext

        def replay():
            if state is not None:
                generator.set_state(state)

        if self.bf16:
            # fully_shard's MixedPrecisionPolicy casts the sharded parameters
            # as it gathers them; the others are cast here
            params = bf16_params((n, p) for n, p in model.named_parameters()
                                 if not isinstance(p, DTensor))

            def fn(x, t):
                with rows():
                    replay()
                    out = torch.func.functional_call(model, params,
                                                     (x.to(torch.bfloat16), t), kwargs)
                return out.to(torch.float32)
        else:
            dtype = next(model.parameters()).dtype

            def fn(x, t):
                with rows():
                    replay()
                    return model(x.to(dtype), t, **kwargs).to(torch.float32)
        if remat:
            return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                                     use_reentrant=False)
        return fn

    def _to_model_space(self, x: torch.Tensor) -> torch.Tensor:
        """Dataset images (rgb [-1, 1]) as the model sees them: Lab with
        ``to_lab`` (colddiff/train.py:338-345)."""
        return rgb2lab(x) if self.to_lab else x

    def _next_superbatch(self, dl=None) -> torch.Tensor:
        """[accum, B, H, W, C] float32 on the device, from ``dl`` (the
        training loader by default)."""
        dl = self.dl if dl is None else dl
        with span("train.loader"):
            # stacked straight into pinned host memory: one host copy
            first = torch.from_numpy(next(dl))
            xs = torch.empty((self.accum, *first.shape), dtype=first.dtype,
                             pin_memory=self.device.type == "cuda")
            xs[0] = first
            for i in range(1, self.accum):
                xs[i] = torch.from_numpy(next(dl))
            return self._to_model_space(xs.to(self.device, non_blocking=True))

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
        use them to replay the JAX Trainer's draws.  Over several processes,
        ``batch`` and these are this process's rows of the global step's."""
        self._maybe_reset_op()
        op = self.diffusion.op
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        if self.debug_nans and not torch.isfinite(batch).all():
            raise FloatingPointError("debug_nans: the batch holds a non-finite value")
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        fsdp = is_sharded(self.model)
        for i in range(self.accum):
            x = batch[i]
            if fsdp:  # reduce-scatter the microbatches' sum once, as the whole grads
                self.model.set_requires_gradient_sync(i == self.accum - 1)
            with span("train.forward"):
                fn = self._denoise_fn(self.model, self.dropout_generator, remat=self.remat)
                with self._rows():
                    x_end_i = (op.sample_x_end(self.generator, x) if x_end is None
                               else x_end[i])
                    loss = self.diffusion.loss(fn, x, self.generator,
                                               t=None if t is None else t[i], x_end=x_end_i,
                                               rng=None if rng is None else rng[i])
            if self.debug_nans and not torch.isfinite(loss):
                raise FloatingPointError(
                    f"debug_nans: microbatch {i} of step {self.step + 1} has loss {loss.item()}")
            with span("train.backward"):
                loss.backward()  # sums into .grad, as the JAX scan sums grads
            loss_sum += loss.detach()
        with span("train.optimizer"):
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            whole = [g for g in grads if not isinstance(g, DTensor)]
            sharded = [g for g in grads if isinstance(g, DTensor)]
            torch._foreach_div_(whole, self.accum)
            if sharded:  # fully_shard averaged these over the processes at the last backward
                torch._foreach_div_(sharded, self.accum)
            loss = loss_sum / self.accum
            if self.world > 1:
                all_reduce_mean([*whole, loss], self.mesh)
            self.opt.step()

            # EMA: every `update_ema_every` steps; reset to the params during
            # warmup (colddiff/train.py:308-318); on the local shards when sharded
            self.step += 1
            if self.step % self.update_ema_every == 0:
                ema, new = _local(self.ema_model.parameters()), _local(self.model.parameters())
                if self.step < self.step_start_ema:
                    with torch.no_grad():
                        torch._foreach_copy_(ema, new)
                else:
                    ema_update(ema, new, self.ema_decay)
        return loss

    @staticmethod
    def _host_rss_gb() -> float:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        return int(line.split()[1]) / 1024 / 1024
        except OSError:
            pass
        return 0.0

    def _should_restart(self) -> bool:
        if self.restart_every_steps and self.step % self.restart_every_steps == 0:
            return True
        # RSS is one process's: processes deciding apart would leave the
        # others waiting in the next collective (colddiff/train.py:408-414)
        return bool(self.restart_rss_gb and self.world == 1
                    and self._host_rss_gb() > self.restart_rss_gb)

    def _start_profiler(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()
        label(True)  # the port's spans appear in the exported trace

    def _stop_profiler(self) -> None:
        """Stop the trace and write it as ``trace_steps_<start>_<stop>.json``
        under ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        label(False)
        self._profiler.stop()
        create_folder(self.profile_dir)
        start, stop = self.profile_steps
        self._profiler.export_chrome_trace(
            str(Path(self.profile_dir) / f"trace_steps_{start}_{stop}.json"))
        self._profiler = None

    def train(self, log_every: int = 100) -> str:
        """Run to ``train_num_steps``.  Returns "done", or "restart" when a
        ``restart_every_steps``/``restart_rss_gb`` boundary came first (the
        checkpoint is saved; a Trainer with ``auto_resume`` continues)."""
        t0 = time.time()
        while self.step < self.train_num_steps:
            if self.profile_dir and self.rank == 0 and self.step == self.profile_steps[0]:
                self._start_profiler()
            batch = self._next_superbatch()
            x_end = None if self.dl2 is None else self._next_superbatch(self.dl2)
            loss = self.train_step(batch, x_end=x_end)
            if self._profiler is not None and self.step == self.profile_steps[1]:
                self._stop_profiler()
            if self.step % log_every == 0:
                loss_v = float(loss)
                dt = time.time() - t0
                ips = log_every * self.accum * self.batch_size / dt
                if self.rank == 0:
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
            if self.step < self.train_num_steps and self._should_restart():
                self.save()
                if self.rank == 0:
                    print(f"step {self.step}: restart boundary -- checkpoint saved, "
                          "handing back to supervisor", flush=True)
                return "restart"
        self.save()
        return "done"

    def _snapshot_batch(self, n: int):
        """(grid images, endpoint images or None) from loaders with their own
        seeds (colddiff/train.py:358-391), never more than a dataset holds;
        one batch size for both, since the endpoints pair with the images."""
        bs = min(max(n, self.batch_size), len(self._dataset))
        if self._dataset2 is not None:
            bs = min(bs, len(self._dataset2))
        if self._snap_dl is None or self._snap_bs < bs:
            self._snap_bs = bs
            self._snap_dl = cycle(DataLoader(
                self._dataset, bs, num_workers=self._num_workers, seed=self._seed + 7919))
            if self._dataset2 is not None:
                self._snap_dl2 = cycle(DataLoader(
                    self._dataset2, bs, num_workers=self._num_workers,
                    seed=self._seed + 7920))
        og = next(self._snap_dl)[:n]
        return og, None if self._snap_dl2 is None else next(self._snap_dl2)[:n]

    def snapshot(self, milestone: int, batch_size: Optional[int] = None) -> None:
        """EMA sample grids ``og``, ``xt``, ``direct_recons`` and ``sample``
        (reference Trainer.train(), deblurring_diffusion_pytorch.py:1206-1228).
        Over several processes, rank 0 alone samples and writes them, after
        every process takes part in gathering a sharded EMA
        (colddiff/train.py:480-500)."""
        ema = self.ema_model
        if is_sharded(ema):
            state = full_state_dict(ema)
            if self.rank == 0:
                ema = copy.deepcopy(self._template).to(self.device)
                ema.load_state_dict(state)
        if self.rank != 0:
            return
        n = batch_size or min(self.batch_size, 36)
        og_np, end_np = self._snapshot_batch(n)
        og = self._to_model_space(torch.from_numpy(og_np).to(self.device))
        ema.eval()
        d = self.diffusion
        gen = torch.Generator(device=self.device).manual_seed(self.step)
        with torch.inference_mode():
            # mix's endpoints come from the second dataset; an operator that
            # owns its endpoint draws it (train.py:326-336)
            x_end = (d.op.sample_x_end(gen, og) if end_np is None
                     else self._to_model_space(torch.from_numpy(end_np).to(self.device)))
            res = sample(d, self._denoise_fn(ema),
                         prepare_start(d, og, x_end=x_end), x_end=x_end, generator=gen)
            # Lab grids go back to rgb before saving (colddiff/train.py:512-525)
            grids = [lab2rgb(r) if self.to_lab else r
                     for r in (res.xt, res.direct_recons, res.img)]
        for name, imgs in zip(("og", "xt", "direct_recons", "sample"), (og_np, *grids)):
            if torch.is_tensor(imgs):
                imgs = imgs.float().cpu().numpy()
            save_image_grid(imgs, self.results_folder / f"{name}-{milestone}.png")

    # ------------------------------------------------------------------ #

    def state(self) -> dict:
        """The checkpoint blob ``{step, model, ema, opt, generator,
        dropout_generator, op}``, whole: a sharded run's gather, which every
        process enters, in the 1-process layout."""
        return {"step": self.step, "model": full_state_dict(self.model),
                "ema": full_state_dict(self.ema_model), "opt": self._opt_state(),
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
        checkpoint holds the optimizer state and not its configuration.
        Every process loads the whole blob; a sharded model keeps its
        shards."""
        put_like(blob["model"], self.model)
        put_like(blob["ema"], self.ema_model)
        own = [{k: v for k, v in g.items() if k != "params"} for g in self.opt.param_groups]
        self._load_opt_state(blob["opt"])
        for group, hyper in zip(self.opt.param_groups, own):
            group.update(hyper)
        for key in ("generator", "dropout_generator"):
            if key in blob:
                getattr(self, key).set_state(blob[key].cpu())
        if "op" in blob:
            self.diffusion = dataclasses.replace(
                self.diffusion, op=self.diffusion.op.with_state(blob["op"], self.device))
        self.step = int(blob["step"])
        # the loaders continue from this step: each step drew accum batches
        self._start_loaders(self.step * self.accum)

    def _opt_state(self) -> dict:
        """Adam's state dict, its moments gathered whole when sharded."""
        osd = self.opt.state_dict()
        return full_state_dict(osd) if is_sharded(self.model) else osd

    def _load_opt_state(self, osd: dict) -> None:
        """Load a whole Adam state dict; each process keeps the shards of the
        sharded parameters' moments."""
        if is_sharded(self.model):
            params = list(self.model.parameters())
            osd = dict(osd, state={i: {k: shard_like(v, params[i]) if k != "step" else v
                                       for k, v in st.items()}
                                   for i, st in osd["state"].items()})
        self.opt.load_state_dict(osd)

    def save(self, path: Optional[str | os.PathLike] = None) -> None:
        """Write the checkpoint; every process enters (a sharded state is
        gathered), rank 0 writes, and the others wait for the file."""
        path = Path(path or (self.results_folder / "model.pt"))
        blob = self.state()
        if self.rank == 0:
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            torch.save(blob, tmp)
            os.replace(tmp, path)  # a crash mid-save leaves the last checkpoint whole
        if self.world > 1:
            dist.barrier(group=self.mesh.get_group())

    def load(self, path: str | os.PathLike) -> None:
        self.load_state(torch.load(path, map_location="cpu"))
