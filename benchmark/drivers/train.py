"""Driver of the ``train`` traffic kind: a closed loop of optimizer steps
through the port's ``Trainer``, as ``Trainer.train()``'s loop body runs
them (``_next_superbatch`` then ``train_step``), without its logging,
checkpoints and sample grids.

Set-up builds one Trainer from the seed and drives its first
``checked_steps`` steps through the window's own call and feed; those
steps are what the reference follows.  Each step takes its levels from the
benchmark (``train_step(batch, t=...)``), so the reference gets the same.

Readings (each in ``limits/<cell>.json`` is held to its limit there):

- ``grad_diff``: the first step's gradient as Adam got it (its first
  moment after one step over 1 - beta1) against the reference's, leaf by
  leaf: |program - reference| over the larger of the reference's norm of
  that leaf and of the median leaf, at the median leaf
  (``grad_diff_worst``: at the worst);
- ``grad_gap``: the same of the gap between the two norms, at the worst
  leaf (``grad_gap_median``: the median leaf; ``grad_worst_leaf``: its
  name);
- ``change_gap``: the gap between the norms of the parameters' change
  over the checked steps, the same, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (a leaf with no
  gradient moves by round-off alone under Adam);
- ``loss_gap``: the largest |program - reference| / reference over the
  checked steps' losses;
- ``ema_gap``: the largest |EMA - the reference's rule| after the checked
  steps (the initial weights) and at the first EMA step after the window
  (the rule applied to the EMA before that step and the parameters after);
- ``feed_faults``: checked rows that are no image of the pool, or repeat.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import common
from ..reference import diffusion as ref_diffusion
from ..reference import models as ref_models
from ..reference import precision
from ..trace import Recorder, traced

MAX_LEVEL_DRAWS = 4096  # optimizer steps a run can take before its levels repeat
REFERENCE_ROWS = 16  # images a reference forward and backward holds at once
FAULTS = ("state_unchanged", "half_batch")


class PoolDataset:
    """The benchmark's clean images as the Trainer's dataset."""

    def __init__(self, images: np.ndarray):
        self.images = images

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.images[i]


def _seeds(seed: int) -> dict:
    """Independent streams of one seed: weights, pool, levels."""
    return {"weights": seed, "pool": seed + (1 << 40), "levels": seed + (2 << 40)}


def inputs(cell: dict, seed: int, device) -> dict:
    """The benchmark's inputs: weights, the pool of clean images and each
    step's levels, all from ``seed``."""
    config, traffic = cell["config"], cell["traffic"]
    seeds = _seeds(seed)
    with torch.device("meta"):
        shapes = ref_models.build(config)
    pool = common.make_pool(seeds["pool"], traffic["pool_images"], config["image_size"],
                            config["channels"], device)
    gen = torch.Generator(device=device).manual_seed(seeds["levels"])
    levels = torch.randint(0, config["degradation"]["time_steps"],
                           (MAX_LEVEL_DRAWS, traffic["accum"], traffic["batch"]),
                           generator=gen, device=device)
    return {"weights": common.make_weights(shapes, seeds["weights"], device),
            "pool": pool, "levels": levels}


@torch.no_grad()
def _leaf_norms(tensors) -> list[float]:
    return [float(n) for n in torch._foreach_norm(list(tensors))]


class Program:
    """The port's Trainer, set up from the seed, its checked steps run."""

    def __init__(self, cell: dict, seed: int, device):
        from colddiff_torch.train import Trainer

        config, traffic, train = cell["config"], cell["traffic"], cell["config"]["train"]
        self.device = torch.device(device)
        self.cell, self.seed = cell, seed
        self.inputs = inputs(cell, seed, self.device)
        weights = self.inputs["weights"]
        self.trainer = Trainer(
            common.port_diffusion(config, self.device),
            common.port_model(config, weights, self.device),
            PoolDataset(self.inputs["pool"].cpu().numpy()),
            train_batch_size=traffic["batch"], gradient_accumulate_every=traffic["accum"],
            train_lr=train["lr"], ema_decay=train["ema_decay"],
            update_ema_every=train["update_ema_every"], step_start_ema=train["step_start_ema"],
            save_and_sample_every=10 ** 9, results_folder=str(common.scratch_dir("train")),
            bf16=config["precision"]["unet"] == "bfloat16",
            num_workers=traffic["loader_workers"], seed=seed, device=self.device)
        self.names = [n for n, _ in self.trainer.model.named_parameters()]
        self.rec = Recorder(self.device)
        losses, self.batches = [], []
        for k in range(traffic["checked_steps"]):
            batch = self.trainer._next_superbatch()
            self.batches.append(batch)
            losses.append(self._step(batch))
            if k == 0:
                state = self.trainer.opt.state
                beta1 = self.trainer.opt.param_groups[0]["betas"][0]
                # a leaf the optimizer holds no moment of got no gradient
                grads = [state[p]["exp_avg"] / (1 - beta1) if p in state else torch.zeros_like(p)
                         for p in self.trainer.model.parameters()]
        start = [weights[n] for n in self.names]
        with torch.no_grad():
            change = _leaf_norms(torch._foreach_sub(list(self.trainer.model.parameters()), start))
            ema_gap = max(float(d.abs().max()) for d in
                          torch._foreach_sub(list(self.trainer.ema_model.parameters()), start))
        self.outputs = {"losses": [float(v) for v in losses], "grads": grads,
                        "grad_norms": _leaf_norms(grads), "change_norms": change,
                        "ema_gap": ema_gap}
        del self.inputs["weights"]

    def _step(self, batch):
        levels = self.inputs["levels"][self.trainer.step % MAX_LEVEL_DRAWS]
        return self.trainer.train_step(batch, t=levels)

    def _steps(self, n: int) -> list:
        losses = []
        for _ in range(n):
            with self.rec.span("loader"):
                batch = self.trainer._next_superbatch()
            with self.rec.span("train_step"):
                losses.append(self._step(batch))
        return losses

    def window(self, seconds: float, trace: bool) -> dict:
        """Optimizer steps until the first that ends at or after
        ``seconds``; with ``trace``, the first ``trace_steps`` of them under
        the profiler."""
        traffic = self.cell["traffic"]
        per_step = traffic["batch"] * traffic["accum"]
        losses, stretch = [], None
        t0 = time.perf_counter()
        if trace:
            n = traffic["trace_steps"]

            def run():
                losses.extend(self._steps(n))
                return {"steps": n, "forward_calls": n * traffic["accum"],
                        "forward_batch": traffic["batch"]}

            stretch = traced(run, self.rec)
        while not losses or time.perf_counter() - t0 < seconds:
            losses.extend(self._steps(1))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"seconds": elapsed, "attempted": len(losses), "failed": failed,
                "rates": {"train_images_per_s": len(losses) * per_step / elapsed},
                "stretch": stretch}

    def finish(self) -> dict:
        """Step on to the next EMA step and hold the EMA to the reference's
        rule there, then free the program's state; returns what the
        reference is to judge."""
        tr = self.trainer
        while (tr.step + 1) % tr.update_ema_every:
            self._steps(1)
        shadow = [e.detach().clone() for e in tr.ema_model.parameters()]
        self._steps(1)
        params = [p.detach() for p in tr.model.parameters()]
        ref_diffusion.ema(shadow, params, tr.step, tr.ema_decay, tr.update_ema_every,
                          tr.step_start_ema)
        with torch.no_grad():
            after = max(float(d.abs().max()) for d in torch._foreach_sub(
                list(tr.ema_model.parameters()), shadow))
        out = dict(self.outputs, ema_gap=max(self.outputs["ema_gap"], after),
                   batches=self.batches, names=self.names)
        tr.dl = tr.dl2 = None
        del self.trainer, self.batches, shadow, params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def control(cell: dict, seed: int, device, unet: str = "fp8", degrade: str = "tf32") -> dict:
    """The reference in the program's place, its UNet operands rounded to
    ``unet`` and its degrade operands to ``degrade``: the checked steps on
    pool rows of the seed, read as the program's are."""
    traffic = cell["traffic"]
    device = torch.device(device)
    inp = inputs(cell, seed, device)
    n = traffic["checked_steps"] * traffic["accum"] * traffic["batch"]
    rows = torch.randperm(len(inp["pool"]), device=device,
                          generator=torch.Generator(device=device).manual_seed(seed))[:n]
    batches = list(inp["pool"][rows].view(traffic["checked_steps"], traffic["accum"],
                                          traffic["batch"], *inp["pool"].shape[1:]))
    casts = getattr(precision, unet), getattr(precision, degrade)
    run = _reference_steps(cell, inp, batches, device, casts)
    return dict(run, ema_gap=0.0, batches=batches)


def _reference_steps(cell, inp, batches, device, casts=(ref_models.identity,) * 2) -> dict:
    config, traffic = cell["config"], cell["traffic"]
    model = ref_models.build(config).to(device)
    model.load_state_dict(inp["weights"])
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    cum = ref_diffusion.blur_matrices(config["degradation"], config["image_size"], device)
    adam = ref_diffusion.Adam(params, config["train"]["lr"])
    losses = []
    for k, batch in enumerate(batches):
        model.zero_grad(set_to_none=True)
        loss = sum(ref_diffusion.final_l1_loss(model, cum, batch[i], inp["levels"][k][i],
                                               REFERENCE_ROWS, *casts)
                   for i in range(traffic["accum"]))
        losses.append(loss / traffic["accum"])
        grads = [p.grad / traffic["accum"] for p in params]
        if k == 0:
            first = [g.clone() for g in grads]
        adam.step(grads)
    change = _leaf_norms(torch._foreach_sub([p.detach() for p in params], start))
    return {"losses": losses, "grads": first, "grad_norms": _leaf_norms(first),
            "change_norms": change, "names": names}


def _leaf_gaps(prog: list[float], ref: list[float], keep=None) -> dict[int, float]:
    """Each kept leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median kept leaf."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    floor = float(np.median([ref[i] for i in idx]))
    return {i: abs(prog[i] - ref[i]) / max(ref[i], floor) for i in idx}


def _feed_faults(pool: torch.Tensor, batches: list) -> int:
    """Checked rows that are no image of the pool, or that repeat one.  An
    image's key is an integer hash of its bits, exact in any order of sums."""
    flat = pool.reshape(len(pool), -1)
    coef = torch.arange(1, flat.shape[1] + 1, device=pool.device, dtype=torch.int64) * 2654435761

    def keys(x):
        return (x.contiguous().view(torch.int32).to(torch.int64) * coef).sum(dim=1).tolist()

    where = {k: i for i, k in enumerate(keys(flat))}
    rows = torch.cat([b.reshape(-1, flat.shape[1]) for b in batches])
    found = [where.get(k) for k in keys(rows)]
    faults = sum(i is None or not torch.equal(flat[i], row) for i, row in zip(found, rows))
    return faults + len(found) - len(set(found))


def compare(cell: dict, seed: int, outputs: dict, device) -> dict:
    """The reference's checked steps on the same rows and levels, and the
    readings of ``outputs`` against them."""
    device = torch.device(device)
    inp = inputs(cell, seed, device)
    run = _reference_steps(cell, inp, outputs["batches"], device)
    if outputs["names"] != run["names"]:
        raise RuntimeError("the program's parameters are not the reference's, by name")
    ref_grad = run["grad_norms"]
    median_grad = float(np.median(ref_grad))
    moved = [g >= 1e-3 * median_grad for g in ref_grad]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(outputs["losses"], run["losses"]))
    grad = _leaf_gaps(outputs["grad_norms"], ref_grad)
    change = _leaf_gaps(outputs["change_norms"], run["change_norms"], moved)
    worst_grad, worst_change = max(grad, key=grad.get), max(change, key=change.get)
    with torch.no_grad():
        diff = _leaf_norms(torch._foreach_sub(outputs["grads"], run["grads"]))
    floor = float(np.median(ref_grad))
    grad_diff = [d / max(r, floor) for d, r in zip(diff, ref_grad)]
    return {"grad_diff": float(np.median(grad_diff)), "grad_diff_worst": max(grad_diff),
            "loss_gap": loss_gap,
            "grad_gap": grad[worst_grad], "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap": change[worst_change],
            "change_gap_median": float(np.median(list(change.values()))),
            "grad_worst_leaf": run["names"][worst_grad],
            "change_worst_leaf": run["names"][worst_change],
            "ema_gap": outputs["ema_gap"],
            "feed_faults": _feed_faults(inp["pool"], outputs["batches"]),
            "losses": outputs["losses"], "reference_losses": run["losses"]}


def plant(fault):
    """A context in which the program runs with ``fault`` planted (None:
    none): its optimizer step returns the state unchanged, or its loss
    leaves out half of each microbatch and takes the mean over the rest."""
    import contextlib
    from unittest import mock

    from colddiff_torch.diffusion import ColdDiffusion

    if fault is None:
        return contextlib.nullcontext()
    if fault == "state_unchanged":
        return mock.patch("torch.optim.Adam.step", lambda self, closure=None: None)
    if fault == "half_batch":
        loss = ColdDiffusion.loss

        def half(self, fn, x, generator, *, t=None, **kw):
            h = x.shape[0] // 2
            return loss(self, fn, x[:h], generator, t=None if t is None else t[:h], **kw)

        return mock.patch.object(ColdDiffusion, "loss", half)
    raise ValueError(f"the train driver plants {FAULTS}, not {fault!r}")
