"""Data-parallel and row-sharded dry runs over N processes, checked against one process.

    python -m colddiff_torch.scripts.dryrun_multichip --n N --device {cuda,cpu} [--flagship]
        [--space S [--workflow NAME ...]]

The torch twin of ``__graft_entry__.dryrun_multichip`` (``:28-180``).  It
starts N processes joined by
``parallel.init_multihost`` (gloo on the CPU or when they share a card,
NCCL when each has one), and each runs the real Trainer path:

  1. one replicated data-parallel ``Trainer`` step (accum 2): each process
     takes its stripe of the dataset from its own loader, and the joined
     global batch comes back for the check;
  2. one sampling run of the EMA model: each process samples its rows of a
     seeded batch inside ``batch_rows``, and the rows are gathered;
  3. ``EvalHarness(mesh=).fid_distance_decrease_from_manifold`` (batches
     the mesh does not divide are padded);
  4. one step with ``param_sharding="fsdp"``, ``fsdp_min_size=1``: a finite
     loss.

Then this process runs 1-3 without a process group, from the same weights
and on the joined batch, and holds the N-process results against them.
The tiny configuration (blur Constant T=4 kernel 3, 16 px, UnetConvNext
dim 8 (1, 2), fp32, 2 images a process) uses the JAX dry run's
tolerances: loss rtol 1e-5 / atol 1e-6, params rtol 1e-4 / atol 1e-5,
samples 2e-5, and the metrics rtol 1e-4 / atol 1e-5 of
tests/test_parallel.py.  ``--flagship`` runs the flagship's training and
sampling path instead (blur Exponential_reflect T=200 kernel 15 std 0.01,
128 px, UnetConvNext dim 64 (1, 2, 4, 8), bf16 on fp32 masters, B=16 x
accum 2, a T=200 sample of 16, the manifold harness over 64 images at
batch 32 with ``model_chunk`` 16); a process's bf16 convolutions run on
fewer rows than the 1-process run's, so there the loss is held at rtol
1e-3 and the step's gradient (all parameters' together) and the samples at
a relative L2 of 2e-2, the bf16 train-step tolerance of the port's tests
(the updates are reported: Adam's first step flips the update of a
gradient near zero on a rounding).  Each process counts its
front-kernel launches in 1-2.

With ``--space S`` the run is the spatial block instead (the twin of
``__graft_entry__.py:157-180``): the processes form
``make_mesh_2d(N // S, S)``, and each, inside ``parallel.image_rows``,
  (a) runs the front of every block of the UNet on its rows of seeded
      inputs (``shard_images``), fp32 and bf16, against the whole-image
      front in the same process (the same kernel on the card): within 1e-4
      and 2e-2, and whether bitwise equal; the halo'd block exchanges 3 rows
      each way, never the row axis, unless it is thinner than 3 rows;
  (b) runs an fp32 forward of the UNet on its block of a seeded batch,
      counting the collectives it makes;
  (c) runs prepare_start + sample (``x0_step_down``, bf16 UNet compute for
      ``--flagship``) on its block, counting its front launches and timing
      it.
The gathered (``gather_images``) forward and samples are held against
this process's whole-image run: the tiny configuration (one image a data
index) at 2e-5, ``--flagship`` (two, the latency case of fewer images than
processes) at a relative L2 of 1e-3 for the fp32 forward and 2e-2, the
port's bf16 tolerance, for the samples.

``--workflow NAME ...`` (with ``--space``; default ``blur``, the block
above) runs the reference's other workflows row-sharded instead, on a
``(1, S)`` mesh, at chip_smoke.py's phases 11-21 settings with
``--flagship`` (the tiny run: 16 px, the tiny UNets): ``fade``,
``resolution``, ``decolor``, ``decolor_lab``, ``fade_generation``,
``noise``, ``mix``, ``snow``, ``fade_naive``, ``fade_random`` and
``resnet`` (CIFAR-10 deblurring with the ResNet UNet).  Each holds against
one process: the degrade at T in fp32 (relative to max |y|, 1e-5), its
random draws (endpoints, crops, snow fields) equal, and for each routine
(b) the fp32 forward at the start, with the collectives it made by kind,
and (c) prepare_start + sample from level min(T, 8) (the ResNet's from T),
timed, with its front launches, at (b) and (c)'s tolerances.  ``loss``
holds the UNet's fp32 ``ColdDiffusion.loss`` (t given, cuDNN
deterministic) against one process at rtol 1e-5 and its gradients, summed
over the space axis, at a relative L2 of 1e-3.  The last line is the
result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import socket
import sys
import tempfile
import time
from collections import Counter
from typing import Optional
from unittest import mock

import torch

__all__ = ["Config", "TINY", "FLAGSHIP", "Workflow", "WORKFLOWS", "WORKFLOW_NAMES",
           "process_checks", "check", "front_shapes", "spatial_fronts", "spatial_checks",
           "check_spatial", "workflow_checks", "check_workflows", "run", "main"]

@dataclasses.dataclass(frozen=True)
class Config:
    size: int
    timesteps: int
    blur: dict
    unet: dict
    batch: int  # a process's rows of a training microbatch and of the sample
    bf16: bool
    eval_images: int
    eval_batch: int
    eval_seed: int
    loss_rtol: float
    loss_atol: float
    params_rtol: float  # tiny: allclose on the params; flagship: rel L2 of the gradient
    params_atol: float
    samples_tol: float  # tiny: allclose; flagship: rel L2
    space_batch: int  # the spatial block's images a data-axis index
    forward_tol: float  # the spatial block's fp32 forward; tiny: allclose; flagship: rel L2


TINY = Config(size=16, timesteps=4,
              blur=dict(blur_routine="Constant", kernel_size=3, kernel_std=1.0),
              unet=dict(dim=8, dim_mults=(1, 2)), batch=2, bf16=False,
              eval_images=6, eval_batch=3, eval_seed=1, loss_rtol=1e-5, loss_atol=1e-6,
              params_rtol=1e-4, params_atol=1e-5, samples_tol=2e-5, space_batch=1,
              forward_tol=2e-5)
FLAGSHIP = Config(size=128, timesteps=200,
                  blur=dict(blur_routine="Exponential_reflect", kernel_size=15,
                            kernel_std=0.01),
                  unet=dict(dim=64, dim_mults=(1, 2, 4, 8)), batch=8, bf16=True,
                  eval_images=64, eval_batch=32, eval_seed=15, loss_rtol=1e-3,
                  loss_atol=0.0, params_rtol=2e-2, params_atol=0.0, samples_tol=2e-2,
                  space_batch=2, forward_tol=1e-3)
FRONT_FP32_ATOL = 1e-4  # the halo'd front against the whole-image front (chip_smoke.py's)
FRONT_BF16_ATOL = 2e-2
ACCUM = 2
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-5
METRICS = ("rmse_degraded", "rmse_sampled", "rmse_direct", "ssim_degraded", "ssim_sampled",
           "ssim_direct", "proxy_fid_degraded", "proxy_fid_sampled", "proxy_fid_direct")


def _diffusion(cfg: Config, device):
    from ..diffusion import ColdDiffusion
    from ..operators import get_operator

    op = get_operator("blur", image_size=cfg.size, timesteps=cfg.timesteps, device=device,
                      **cfg.blur)
    return ColdDiffusion(op=op, image_size=cfg.size, sampling_routine="x0_step_down")


def _model(cfg: Config, weights: Optional[str]):
    from ..models import UnetConvNext

    torch.manual_seed(0)
    model = UnetConvNext(channels=3, **cfg.unet)
    if weights is not None:
        model.load_state_dict(torch.load(weights, map_location="cpu"))
    return model


def _trainer(cfg: Config, device, weights, folder, world: int, **kw):
    from ..data import SyntheticDataset
    from ..train import Trainer

    return Trainer(_diffusion(cfg, device), _model(cfg, weights),
                   SyntheticDataset(cfg.size, 3, length=4 * cfg.batch * world),
                   train_batch_size=cfg.batch * world, gradient_accumulate_every=ACCUM,
                   train_num_steps=1, save_and_sample_every=10**9, results_folder=folder,
                   num_workers=1, bf16=cfg.bf16, device=device, **kw)


def _start_batch(cfg: Config, n: int, device) -> torch.Tensor:
    """The seeded images the sampling run starts from."""
    gen = torch.Generator().manual_seed(7)
    return (torch.rand(n, cfg.size, cfg.size, 3, generator=gen) * 2 - 1).to(device)


def _sample(tr, cfg: Config, og: torch.Tensor) -> torch.Tensor:
    from ..sampling import prepare_start, sample

    d = tr.diffusion
    return sample(d, tr._denoise_fn(tr.ema_model), prepare_start(d, og)).img


def _manifold(cfg: Config, tr, device, folder, mesh=None) -> dict:
    from ..data import SyntheticDataset
    from ..eval import EvalHarness

    h = EvalHarness(tr.diffusion, copy.deepcopy(tr.ema_model), results_folder=folder,
                    bf16=cfg.bf16, model_chunk=16, mesh=mesh, device=device)
    ds = SyntheticDataset(cfg.size, 3, length=cfg.eval_images, seed=cfg.eval_seed)
    return h.fid_distance_decrease_from_manifold(ds, end=cfg.eval_images,
                                                 batch_size=cfg.eval_batch)


def process_checks(cfg: Config, mesh, weights: Optional[str], folder: str) -> dict:
    """Steps 1-4 of the module docstring on this process of ``mesh``'s group;
    returns what :func:`check` needs (the same on every process but the
    launch counts, which are gathered)."""
    import torch.distributed as dist

    from ..ops.convnext_front import convnext_front
    from ..parallel import batch_rows, gather_rows, local_device, shard_batch

    rank, n = mesh.get_local_rank(), mesh.size()
    dev = local_device(mesh.device_type, rank)
    convnext_front.launches = 0
    tr = _trainer(cfg, dev, weights, folder, n, mesh=mesh)
    before = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    local = tr._next_superbatch()
    loss = tr.train_step(local).item()
    og = _start_batch(cfg, cfg.batch * n, dev)
    with batch_rows(rank, n), torch.inference_mode():
        samples = _sample(tr, cfg, shard_batch(og, mesh))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = gather_rows(torch.tensor([convnext_front.launches], device=dev), mesh)
    result = dict(loss=loss, before=before,
                  params={k: v.detach().cpu() for k, v in tr.model.state_dict().items()},
                  grads=[p.grad.detach().cpu() for p in tr.model.parameters()],
                  batch=gather_rows(local, mesh, dim=1).cpu(),
                  samples=gather_rows(samples, mesh).cpu(), launches=launches.tolist(),
                  n=n, device=dev.type, backend=dist.get_backend(mesh.get_group()))
    result["metrics"] = _manifold(cfg, tr, dev, folder, mesh)
    del tr
    tr = _trainer(cfg, dev, weights, folder, n, mesh=mesh, param_sharding="fsdp",
                  fsdp_min_size=1)
    result["fsdp_loss"] = tr.train_step(tr._next_superbatch()).item()
    return result


def front_shapes(model, size: int, device) -> list:
    """(C, H, W, norm, has_cond) of each block front of ``model``'s forward
    at ``size`` px, in call order (forward pre-hooks on a B=1 forward)."""
    from ..models.layers import ConvNextBlock

    shapes = []

    def hook(block, args):
        x, t = args if len(args) == 2 else (args[0], None)
        shapes.append((x.shape[1], x.shape[2], x.shape[3], block.norm,
                       block.mlp is not None and t is not None))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, ConvNextBlock)]
    try:
        with torch.inference_mode():
            model(torch.zeros(1, size, size, 3, device=device),
                  torch.zeros(1, dtype=torch.long, device=device))
    finally:
        for h in handles:
            h.remove()
    return shapes


def _front_args(gen, b: int, c: int, h: int, w: int, has_cond: bool, device) -> list:
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    return [randn(b, c, h, w).contiguous(memory_format=torch.channels_last),
            randn(c, 1, 7, 7, scale=0.05), randn(c, scale=0.1),
            randn(b, c) if has_cond else None,
            (torch.rand(c, generator=gen) + 0.5).to(device), randn(c, scale=0.1)]


def _per_process(value: float, device) -> list:
    """``value`` of every process of the world, in rank order, on every process."""
    import torch.distributed as dist

    v = torch.zeros(dist.get_world_size(), dtype=torch.float64, device=device)
    v[dist.get_rank()] = value
    dist.all_reduce(v)
    return v.tolist()


def spatial_fronts(shapes, batch: int, mesh, device) -> list:
    """(a) of the module docstring at ``shapes`` (of :func:`front_shapes`):
    per front, the worst fp32 and bf16 errors over the processes, whether
    every process's block was bitwise the whole-image front's, and what
    the block exchanged (the shapes of the slabs this process sent)."""
    import torch.distributed as dist

    from ..ops.convnext_front import convnext_front
    from ..parallel import image_rows, spatial

    space = mesh["space"]
    gen = torch.Generator().manual_seed(11)
    rows = []
    for c, h, w, norm, has_cond in shapes:
        args = _front_args(gen, batch, c, h, w, has_cond, device)
        errs, bitwise = [], []
        for dt in (torch.float32, torch.bfloat16):
            a = [None if t is None else t.to(dt) for t in args]
            a[0] = a[0].contiguous(memory_format=torch.channels_last)
            want = convnext_front(*a, norm=norm)
            hb = h // space.size()
            block = a[0][:, :, space.get_local_rank() * hb:(space.get_local_rank() + 1) * hb]
            spatial.collectives.clear()
            with image_rows(mesh), torch.inference_mode():
                got = convnext_front(block, *a[1:], norm=norm)
            exchanged = sorted(spatial.collectives)
            mine = want[:, :, space.get_local_rank() * hb:(space.get_local_rank() + 1) * hb]
            errs.append((got.float() - mine.float()).abs().max().item())
            bitwise.append(float(torch.equal(got, mine)))
        worst = torch.tensor(errs + [-b for b in bitwise], dtype=torch.float64, device=device)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        rows.append(dict(shape=[batch, h, w, c], norm=norm, cond=has_cond,
                         max_abs_err_fp32=worst[0].item(), max_abs_err_bf16=worst[1].item(),
                         bitwise_fp32=worst[2].item() == -1.0,
                         bitwise_bf16=worst[3].item() == -1.0,
                         exchanged=[[kind, list(shape)] for kind, shape in exchanged]))
    return rows


def _bf16_denoise(model):
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    return lambda x, t: model16(x.to(torch.bfloat16), t).to(torch.float32)


def _timed_sample(cfg: Config, d, model, og) -> tuple:
    """prepare_start + sample from ``og`` with ``model`` (bf16 compute when
    ``cfg.bf16``); returns (the samples, wall seconds, front launches)."""
    from ..ops.convnext_front import convnext_front
    from ..sampling import prepare_start, sample

    denoise = _bf16_denoise(model) if cfg.bf16 else model
    sync = torch.cuda.synchronize if og.is_cuda else (lambda: None)
    with torch.inference_mode():
        sample(d, denoise, prepare_start(d, og), t=1)  # warm-up
        sync()
        convnext_front.launches = 0
        t0 = time.perf_counter()
        out = sample(d, denoise, prepare_start(d, og)).img
        sync()
    return out, time.perf_counter() - t0, convnext_front.launches


def _forward_inputs(cfg: Config, n: int, device) -> tuple:
    gen = torch.Generator().manual_seed(13)
    x = (torch.randn(n, cfg.size, cfg.size, 3, generator=gen)).to(device)
    return x, torch.randint(0, cfg.timesteps, (n,), generator=gen).to(device)


def spatial_checks(cfg: Config, mesh, weights: Optional[str]) -> dict:
    """(a)-(c) of the module docstring on this process of a
    ``make_mesh_2d`` mesh; returns what :func:`check_spatial` needs (the
    same on every process)."""
    import torch.distributed as dist

    from ..parallel import (gather_images, image_rows, local_device, shard_batch,
                            shard_images, spatial)

    data, space = mesh["data"], mesh["space"]
    dev = local_device(mesh.device_type, dist.get_rank())
    n = cfg.space_batch * data.size()
    model = _model(cfg, weights).to(dev).eval()
    shapes = front_shapes(model, cfg.size, dev)
    res = dict(n=dist.get_world_size(), mesh=[data.size(), space.size()], device=dev.type,
               backend=dist.get_backend(space.get_group()), fronts_per_forward=len(shapes),
               fronts=spatial_fronts(shapes, cfg.space_batch, mesh, dev))
    x, t = _forward_inputs(cfg, n, dev)
    spatial.collectives.clear()
    with image_rows(mesh), torch.inference_mode():
        out = model(shard_images(x, mesh), shard_batch(t, data))
    by_kind = Counter()
    for (kind, _), count in spatial.collectives.items():
        by_kind[kind] += count
    res["collectives_per_forward"] = sum(by_kind.values())
    res["collectives_by_kind"] = dict(by_kind)
    res["forward"] = gather_images(out, mesh).cpu()
    d = _diffusion(cfg, dev)
    with image_rows(mesh):
        samples, seconds, launches = _timed_sample(cfg, d, model,
                                                   shard_images(_start_batch(cfg, n, dev), mesh))
    res["samples"] = gather_images(samples, mesh).cpu()
    res["seconds"] = _per_process(seconds, dev)
    res["launches"] = [int(v) for v in _per_process(launches, dev)]
    return res


def check_spatial(got: dict, cfg: Config, dev: torch.device, weights: Optional[str]) -> dict:
    """Run (b) and (c) of the module docstring on one process on the whole
    images, and hold ``got`` (rank 0's :func:`spatial_checks`) against them
    and (a) to its bounds; returns the summary (raises if a check does not
    hold)."""
    flagship = cfg == FLAGSHIP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(cfg, weights).to(dev).eval()
    n = cfg.space_batch * got["mesh"][0]
    x, t = _forward_inputs(cfg, n, dev)
    with torch.inference_mode():
        forward = model(x, t).cpu()
    samples, seconds, launches = _timed_sample(cfg, _diffusion(cfg, dev), model,
                                               _start_batch(cfg, n, dev))
    samples = samples.cpu()
    res = {k: got[k] for k in ("n", "mesh", "device", "backend", "fronts", "fronts_per_forward",
                               "collectives_per_forward", "collectives_by_kind", "seconds",
                               "launches")}
    res.update(config="flagship" if flagship else "tiny", batch=n, seconds_1=seconds,
               launches_1=launches, forward_rel_l2=_rel_l2(got["forward"], forward),
               samples_rel_l2=_rel_l2(got["samples"], samples),
               forward_max_err=(got["forward"] - forward).abs().max().item(),
               samples_max_err=(got["samples"] - samples).abs().max().item())
    bad = [f for f in got["fronts"] if not (f["max_abs_err_fp32"] <= FRONT_FP32_ATOL
                                            and f["max_abs_err_bf16"] <= FRONT_BF16_ATOL)]
    if bad:
        raise AssertionError(f"halo'd fronts against the whole image: {bad}")
    for f in got["fronts"]:  # 3 rows each way, or the whole rows of a thin block
        h = f["shape"][1] // got["mesh"][1]
        want = set() if got["mesh"][1] == 1 else {("halo", 6)} if h >= 3 else {("rows", h)}
        if {(kind, shape[2]) for kind, shape in f["exchanged"]} != want:
            raise AssertionError(f"front {f['shape']} exchanged {f['exchanged']}")
    # the plain version runs on CPU tensors and counts no launch
    per_process = got["fronts_per_forward"] * cfg.timesteps if dev.type == "cuda" else 0
    if got["launches"] != [per_process] * got["n"] or launches != per_process:
        raise AssertionError(f"front launches per process {got['launches']}, one process "
                             f"{launches}; expected {per_process}")
    if flagship:
        if not (res["forward_rel_l2"] <= cfg.forward_tol
                and res["samples_rel_l2"] <= cfg.samples_tol):
            raise AssertionError(f"forward rel L2 {res['forward_rel_l2']}, samples rel L2 "
                                 f"{res['samples_rel_l2']}")
    else:
        torch.testing.assert_close(got["forward"], forward, rtol=cfg.forward_tol,
                                   atol=cfg.forward_tol)
        torch.testing.assert_close(got["samples"], samples, rtol=cfg.samples_tol,
                                   atol=cfg.samples_tol)
    return res


@dataclasses.dataclass(frozen=True)
class Workflow:
    """One of the reference's workflows (chip_smoke.py phases 11-21) under
    row sharding: the operator ``op`` built with ``cfg`` (and the image
    size where it takes one), its sampling ``routines`` and
    ``recon_noise`` settings, its image ``size`` at full width, where its
    endpoint comes from (``"drawn"``: ``op.sample_x_end``; ``"second"``: a
    second seeded image set; None), and whether it runs the ResNet UNet
    (whose bf16 run samples in fp32 too)."""

    op: str
    cfg: dict
    routines: tuple = ("x0_step_down",)
    size: int = 128
    end: Optional[str] = None
    recon_noise: tuple = (0.0,)
    resnet: bool = False


WORKFLOWS = {
    "fade": Workflow("fade", dict(timesteps=100, fade_routine="Incremental", kernel_std=0.2)),
    "resolution": Workflow("resolution", dict(timesteps=4,
                                              resolution_routine="Incremental_factor_2")),
    "decolor": Workflow("decolor", dict(timesteps=20, decolor_routine="Linear",
                                        decolor_total_remove=True)),
    "decolor_lab": Workflow("decolor", dict(timesteps=20, decolor_routine="Linear",
                                            decolor_total_remove=True, to_lab=True)),
    "fade_generation": Workflow("fade_generation", dict(timesteps=750, reverse=True,
                                                        kernel_std=0.05),
                                ("x0_step_down", "ddim"), end="drawn"),
    "noise": Workflow("noise", dict(timesteps=200), ("ddim", "x0_step_down"), end="drawn"),
    "mix": Workflow("mix", dict(timesteps=200), end="second"),
    "snow": Workflow("snow", dict(timesteps=200, snow_level=4, random_snow=True,
                                  fix_brightness=True, seed=0), recon_noise=(0.0, 0.01)),
    "fade_naive": Workflow("fade_naive", dict(timesteps=50, fade_routine="Spiral_2"),
                           ("x0_step_down_spiral_2_fix", "x0_step_down_spiral_2_rand"), 32,
                           end="drawn"),
    "fade_random": Workflow("fade", dict(timesteps=50, fade_routine="Random_Incremental",
                                         kernel_std=0.1, initial_mask=1), size=32),
    "resnet": Workflow("blur", dict(timesteps=50, blur_routine="Special_6_routine",
                                    kernel_size=11), size=32, resnet=True),
}
# "blur" is the flagship's spatial block above; "loss" the flagship's loss
# and its gradients
WORKFLOW_NAMES = ("blur", *WORKFLOWS, "loss")
SAMPLE_DEPTH = 8  # a workflow's sample starts at level min(T, 8); the ResNet's at T
DEGRADE_REL = 1e-5  # a row-sharded degrade against one process, relative to max |y|
RESNET_TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                   resolution=16)
LOSS_RTOL = 1e-5  # the flagship loss (fp32) against one process
GRAD_REL_L2 = 1e-3  # its group-summed gradients against one process's


def _workflow_size(wf: Workflow, cfg: Config) -> int:
    return wf.size if cfg == FLAGSHIP else cfg.size


def _workflow_model(wf: Workflow, cfg: Config, weights: Optional[str]):
    """The workflow's UNet: the dry run's UnetConvNext, or the CIFAR-10
    ResNet of ``get_model`` (the tiny run: a 16 px one), from seed 0."""
    if not wf.resnet:
        return _model(cfg, weights)
    from ..models import UnetResNet, get_model

    torch.manual_seed(0)
    if cfg == FLAGSHIP:
        return get_model("UnetResNet", dataset="cifar10")
    return UnetResNet(**RESNET_TINY)


def _workflow_diffusion(wf: Workflow, cfg: Config, device, routine: str,
                        recon_noise_std: float, batch: int):
    from ..diffusion import ColdDiffusion
    from ..operators import get_operator

    size = _workflow_size(wf, cfg)
    kw = dict(wf.cfg)
    if wf.op not in ("decolor", "noise", "mix"):
        kw["image_size"] = size
    if wf.op == "snow":
        kw["batch_size"] = batch
    op = get_operator(wf.op, **kw, device=device)
    if wf.op == "fade" and op.random:
        # the crops baked for the run: the whole batch's, the same on every process
        op = op.randomize(torch.Generator(device=device).manual_seed(17), batch)
    return ColdDiffusion(op=op, image_size=size, sampling_routine=routine,
                         recon_noise_std=recon_noise_std)


def _workflow_images(wf: Workflow, cfg: Config, n: int, device) -> tuple:
    """The clean batch (Lab for ``decolor_lab``) and the endpoint of a
    ``second``-set workflow, whole, from seeds."""
    from ..data import SyntheticDataset
    from ..ops.image import rgb2lab

    size = _workflow_size(wf, cfg)
    gen = torch.Generator().manual_seed(19)
    img = (torch.rand(n, size, size, 3, generator=gen) * 2 - 1).to(device)
    if wf.cfg.get("to_lab"):
        img = rgb2lab(img)
    second = None
    if wf.end == "second":
        data = SyntheticDataset(size, 3, length=n, seed=11)
        second = torch.stack([torch.from_numpy(data[i]) for i in range(n)]).to(device)
    return img, second


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _kinds(counts: Counter) -> dict:
    by_kind = Counter()
    for (kind, _), count in counts.items():
        by_kind[kind] += count
    return dict(by_kind)


def _workflow_run(name: str, cfg: Config, model, dev, n: int, place=None) -> dict:
    """One workflow on this process: whole images (``place`` None) or,
    inside ``image_rows``, this process's blocks (``place`` gives
    ``(shard, gather)``): the degrade at T in fp32, the random draws, and
    for each routine the fp32 forward at the start (with its collectives),
    then a bf16 (for the flagship; for its ResNet fp32 too) prepare_start
    + sample from level ``min(T, SAMPLE_DEPTH)`` (T for the
    ResNet), timed, with its front launches.  On whole images of more than
    one, the ResNet's samples are also run with its GroupNorms on the plain
    chain, whole (``split_whole``) and an image at a time (``split``): how
    far the rounding of another batch shape moves them.  (The GroupNorm
    kernel and the convs give an image the same bits at any batch on the
    card, so the kernel's own samples would not show bf16's rounding; the
    plain chain keeps the measure apart from the kernel under test.)"""
    from ..ops import group_norm
    from ..ops.convnext_front import convnext_front
    from ..parallel import spatial
    from ..sampling import prepare_start, sample

    wf = WORKFLOWS[name]
    shard, whole = place or ((lambda a: a), (lambda a: a))
    img, second = _workflow_images(wf, cfg, n, dev)
    og = shard(img)
    d = _workflow_diffusion(wf, cfg, dev, wf.routines[0], 0.0, n)
    op, steps = d.op, d.num_timesteps
    gen = torch.Generator(device=dev).manual_seed(23)
    res = dict(name=name, T=steps, size=_workflow_size(wf, cfg), rows=[], draws={})
    x_end = None
    if wf.end == "drawn":
        x_end = op.sample_x_end(gen, og)
        res["draws"]["x_end"] = whole(x_end).cpu()
    elif wf.end == "second":
        x_end = shard(second)
    if wf.op == "fade" and op.random:
        res["draws"]["offsets"] = op.offsets.cpu()
    if wf.op == "snow":
        fresh = op.reset(torch.Generator(device=dev).manual_seed(29), n)
        res["draws"]["fields"] = [_digest(fresh.snow), _digest(fresh.snow_rot)]
    with torch.inference_mode():
        res["degrade"] = whole(op.degrade(og, torch.full((og.shape[0],), steps, device=dev),
                                          x_end=x_end, og=og)).cpu()
    depth = steps if wf.resnet else min(steps, SAMPLE_DEPTH)
    denoisers = {"fp32": model}
    if cfg.bf16:
        denoisers = {"bf16": _bf16_denoise(model), **(denoisers if wf.resnet else {})}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def run(d, denoise, og, x_end):
        return sample(d, denoise, prepare_start(d, og, depth, x_end=x_end), depth, x_end=x_end,
                      generator=torch.Generator(device=dev).manual_seed(37)).img

    for routine in wf.routines:
        for recon in wf.recon_noise:
            d = _workflow_diffusion(wf, cfg, dev, routine, recon, n)
            with torch.inference_mode():
                start = prepare_start(d, og, depth, x_end=x_end)
                spatial.collectives.clear()
                level = torch.full((og.shape[0],), depth - 1, dtype=torch.long, device=dev)
                forward = whole(model(start, level)).cpu()
                kinds = _kinds(spatial.collectives)
            for dtype, denoise in denoisers.items():
                row = dict(routine=routine, recon_noise_std=recon, depth=depth, dtype=dtype,
                           forward=forward, collectives_by_kind=kinds)
                with torch.inference_mode():
                    sample(d, denoise, start, 1, x_end=x_end,
                           generator=torch.Generator(device=dev).manual_seed(31))  # warm-up
                    sync()
                    convnext_front.launches = 0
                    t0 = time.perf_counter()
                    out = run(d, denoise, og, x_end)
                    sync()
                    row["seconds"] = time.perf_counter() - t0
                    row["launches"] = convnext_front.launches
                    if place is None and n > 1 and wf.resnet:
                        with mock.patch.object(group_norm, "group_norm_swish",
                                               group_norm.group_norm_swish_plain):
                            row["split"] = torch.cat([run(d, denoise, og[i:i + 1], None if x_end
                                                          is None else x_end[i:i + 1])
                                                      for i in range(n)]).cpu()
                            row["split_whole"] = run(d, denoise, og, x_end).cpu()
                row["samples"] = whole(out).cpu()
                res["rows"].append(row)
    return res


def _loss_run(cfg: Config, dev, weights: Optional[str], n: int, place=None) -> dict:
    """The dry run's UnetConvNext in fp32 through ``ColdDiffusion.loss``
    (Final, l1, the blur of the configuration) with t given, cuDNN held to
    its deterministic algorithms: the loss and its gradients (flat; inside
    ``image_rows`` summed over the space axis, ``place`` giving ``(shard,
    space group)``)."""
    import torch.distributed as dist

    from ..parallel import spatial

    shard, group = place or ((lambda a: a), None)
    model = _model(cfg, weights).to(dev)
    gen = torch.Generator().manual_seed(41)
    x = (torch.rand(n, cfg.size, cfg.size, 3, generator=gen) * 2 - 1).to(dev)
    t = torch.randint(0, cfg.timesteps, (n,), generator=gen).to(dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        spatial.collectives.clear()
        loss = _diffusion(cfg, dev).loss(model, shard(x), None, t=t)
        loss.backward()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    if group is not None:
        dist.all_reduce(grads, group=group)
    return dict(loss=loss.item(), grads=grads.cpu(),
                collectives_by_kind=_kinds(spatial.collectives))


def workflow_checks(cfg: Config, mesh, weights: Optional[str], names) -> dict:
    """The row-sharded side of each workflow in ``names`` (of
    :data:`WORKFLOWS`, and ``"loss"``) on this process of a ``(1, S)``
    ``make_mesh_2d`` mesh, at ``cfg.space_batch`` images; returns what
    :func:`check_workflows` needs (gathered, the same on every process,
    with each process's seconds and front launches)."""
    import torch.distributed as dist

    from ..parallel import gather_images, image_rows, local_device, shard_images

    data, space = mesh["data"], mesh["space"]
    if data.size() != 1:
        raise ValueError("the workflows run on a (1, S) mesh: one data index")
    dev = local_device(mesh.device_type, dist.get_rank())
    n = cfg.space_batch
    place = (lambda a: shard_images(a, mesh), lambda a: gather_images(a, mesh))
    out = dict(n=dist.get_world_size(), mesh=[data.size(), space.size()], device=dev.type,
               backend=dist.get_backend(space.get_group()), workflows={})
    models = {}
    for name in names:
        if name == "loss":
            with image_rows(mesh):
                out["loss"] = _loss_run(cfg, dev, weights, n,
                                        (place[0], space.get_group()))
            continue
        wf = WORKFLOWS[name]
        if wf.resnet not in models:
            models[wf.resnet] = _workflow_model(wf, cfg, weights).to(dev).eval()
        with image_rows(mesh):
            res = _workflow_run(name, cfg, models[wf.resnet], dev, n, place)
        for row in res["rows"]:
            row["seconds"] = _per_process(row["seconds"], dev)
            row["launches"] = [int(v) for v in _per_process(row["launches"], dev)]
        out["workflows"][name] = res
    return out


def check_workflows(got: dict, cfg: Config, dev: torch.device, weights: Optional[str],
                    names) -> dict:
    """Run each workflow of ``names`` on one process on the whole images and
    hold ``got`` (rank 0's :func:`workflow_checks`) against it: the degrade
    at T (relative to max |y|, <= 1e-5), the fp32 forward (tiny: allclose
    2e-5; flagship and the ResNet: rel L2 <= 1e-3) and the samples (tiny:
    2e-5; flagship and the ResNet: rel L2 <= 1e-3 in fp32, and in bf16 <=
    2e-2, for the ResNet's T=50 sample or twice its ``split`` one where
    more: bf16 rounding alone, one process's same images run an image at a
    time with the GroupNorms on the plain chain, moves it by ~4e-2), the
    draws equal, the front launches (17 a forward of
    the UnetConvNext, 0 of the ResNet, on the card); the loss (rtol 1e-5)
    and its group-summed gradients (rel L2 <= 1e-3).  Returns the summary
    (raises if a check does not hold)."""
    flagship = cfg == FLAGSHIP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = cfg.space_batch
    summary = {k: got[k] for k in ("n", "mesh", "device", "backend")}
    summary["workflows"] = {}
    models = {}
    bad = []
    for name in names:
        if name == "loss":
            one = _loss_run(cfg, dev, weights, n)
            mine = got["loss"]
            row = dict(loss=mine["loss"], loss_1=one["loss"],
                       grad_rel_l2=_rel_l2(mine["grads"], one["grads"]),
                       collectives_by_kind=mine["collectives_by_kind"])
            if not (math.isclose(mine["loss"], one["loss"], rel_tol=LOSS_RTOL)
                    and row["grad_rel_l2"] <= GRAD_REL_L2):
                bad.append(f"loss: {row}")
            summary["loss"] = row
            continue
        wf = WORKFLOWS[name]
        if wf.resnet not in models:
            models[wf.resnet] = _workflow_model(wf, cfg, weights).to(dev).eval()
        one = _workflow_run(name, cfg, models[wf.resnet], dev, n)
        mine = got["workflows"][name]
        deg = ((mine["degrade"] - one["degrade"]).abs().max()
               / one["degrade"].abs().max()).item()
        draws = {k: (torch.equal(v, one["draws"][k]) if torch.is_tensor(v)
                     else v == one["draws"][k]) for k, v in mine["draws"].items()}
        wsum = dict(T=one["T"], size=one["size"], degrade_rel_err=deg, draws_equal=draws,
                    rows=[])
        if not (deg <= DEGRADE_REL and all(draws.values())):
            bad.append(f"{name}: degrade rel err {deg}, draws equal {draws}")
        fronts = 0 if wf.resnet or dev.type != "cuda" else 17
        for r, r1 in zip(mine["rows"], one["rows"]):
            row = dict(routine=r["routine"], recon_noise_std=r["recon_noise_std"],
                       depth=r["depth"], dtype=r["dtype"], seconds=r["seconds"],
                       seconds_1=r1["seconds"],
                       launches=r["launches"], launches_1=r1["launches"],
                       collectives_by_kind=r["collectives_by_kind"],
                       forward_rel_l2=_rel_l2(r["forward"], r1["forward"]),
                       samples_rel_l2=_rel_l2(r["samples"], r1["samples"]),
                       forward_max_err=(r["forward"] - r1["forward"]).abs().max().item(),
                       samples_max_err=(r["samples"] - r1["samples"]).abs().max().item())
            if "split" in r1:
                row["split_rel_l2"] = _rel_l2(r1["split"], r1["split_whole"])
            if flagship or wf.resnet:
                # the tiny ResNet too: its GroupNorms see the blurred start
                # nearly flat, a variance near their eps that scales the
                # statistics' fp32 rounding up (relative L2 ~6e-5 on the CPU)
                row["samples_bound"] = (FLAGSHIP.forward_tol if r["dtype"] == "fp32" else max(
                    FLAGSHIP.samples_tol, 2 * row.get("split_rel_l2", 0.0)))
                ok = (row["forward_rel_l2"] <= FLAGSHIP.forward_tol
                      and row["samples_rel_l2"] <= row["samples_bound"])
            else:
                ok = (torch.allclose(r["forward"], r1["forward"], rtol=cfg.forward_tol,
                                     atol=cfg.forward_tol)
                      and torch.allclose(r["samples"], r1["samples"], rtol=cfg.samples_tol,
                                         atol=cfg.samples_tol))
            want = fronts * r["depth"]
            if not (ok and r["launches"] == [want] * got["n"] and r1["launches"] == want):
                bad.append(f"{name} {row}: expected {want} front launches a process")
            if not all(torch.isfinite(t).all() for t in (r["samples"], r["forward"])):
                bad.append(f"{name} {r['routine']}: not finite")
            wsum["rows"].append(row)
        summary["workflows"][name] = wsum
    if bad:
        raise AssertionError("workflows under row sharding: " + "; ".join(bad)
                             + "\nsummary: " + json.dumps(summary, default=float))
    return summary


def _process(rank: int, n: int, port: int, device: str, flagship: bool,
             weights: Optional[str], out: str, space: Optional[int],
             workflows=("blur",)) -> None:
    """One process of the run; rank 0 saves what the check needs to ``out``."""
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    if device == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist

    from ..parallel import init_multihost, make_mesh, make_mesh_2d

    dev = init_multihost(f"localhost:{port}", n, rank, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FLAGSHIP if flagship else TINY
    if space:
        mesh = make_mesh_2d(n // space, space, dev.type)
        result = spatial_checks(cfg, mesh, weights) if "blur" in workflows else {}
        others = [w for w in workflows if w != "blur"]
        if others:
            result["workflow_checks"] = workflow_checks(cfg, mesh, weights, others)
    else:
        with tempfile.TemporaryDirectory() as folder:
            result = process_checks(cfg, make_mesh(dev.type), weights, folder)
    if rank == 0:
        torch.save(result, out)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double())).item()


def run(n: int, device: str = "cuda", flagship: bool = False,
        weights: Optional[str] = None, timeout: float = 600.0,
        space: Optional[int] = None, workflows=("blur",)) -> dict:
    """The dry run; returns its result (raises if a process fails or a check
    does not hold).  ``weights``: a state dict file the model starts from
    (default: torch's init under seed 0).  ``space``: the spatial block on
    ``make_mesh_2d(n // space, space)`` instead, for each of ``workflows``
    (:data:`WORKFLOW_NAMES`; "blur" is the flagship's block, the others run
    on a ``(1, space)`` mesh)."""
    import torch.multiprocessing as mp

    from ..parallel import local_device

    if space is not None and (space < 1 or n % space):
        raise ValueError(f"--space {space} does not divide --n {n}")
    workflows = tuple(workflows)
    unknown = set(workflows) - set(WORKFLOW_NAMES)
    if unknown or not workflows or (workflows != ("blur",) and not space):
        raise ValueError(f"workflows {workflows}: each one of {WORKFLOW_NAMES}, "
                         "and other than blur only with --space")
    dev = local_device(device, 0)
    cfg = FLAGSHIP if flagship else TINY
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as folder:
        out = os.path.join(folder, "rank0.pt")
        port = _free_port()
        procs = [ctx.Process(target=_process,
                             args=(r, n, port, dev.type, flagship, weights, out, space,
                                   workflows))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            raise RuntimeError(f"dryrun_multichip: process exit codes {codes}")
        if space:
            got = torch.load(out)
            res = check_spatial(got, cfg, dev, weights) if "blur" in workflows else {}
            if "workflow_checks" in got:
                res["workflow_checks"] = check_workflows(
                    got["workflow_checks"], cfg, dev, weights,
                    [w for w in workflows if w != "blur"])
            return res
        return check(torch.load(out), cfg, dev, weights, folder)


def check(got: dict, cfg: Config, dev: torch.device, weights: Optional[str],
          folder: str) -> dict:
    """Run the step, the sampling run and the harness of
    :func:`process_checks` on one process, without a group, on the joined
    batch, and hold ``got`` (rank 0's result) against them; returns the
    summary (raises if a check does not hold)."""
    n, flagship = got["n"], cfg == FLAGSHIP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = _trainer(cfg, dev, weights, folder, n)
    loss = tr.train_step(got["batch"].to(dev)).item()
    with torch.inference_mode():
        samples = _sample(tr, cfg, _start_batch(cfg, cfg.batch * n, dev)).cpu()
    metrics = _manifold(cfg, tr, dev, folder)
    params = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    grads = [p.grad.detach().cpu() for p in tr.model.parameters()]
    res = dict(n=n, device=got["device"], backend=got["backend"],
               config="flagship" if flagship else "tiny", loss=got["loss"], loss_1=loss,
               launches=got["launches"], fsdp_loss=got["fsdp_loss"],
               metrics=got["metrics"], metrics_1=metrics)
    if not math.isclose(got["loss"], loss, rel_tol=cfg.loss_rtol, abs_tol=cfg.loss_atol):
        raise AssertionError(f"loss: {n} processes {got['loss']}, one {loss}")
    if flagship:
        # Adam's first step moves a parameter by about lr * sign(g), so a
        # gradient near zero flips its update on a rounding: the gradients
        # are held, the updates reported
        res["grad_rel_l2"] = _rel_l2(torch.cat([g.flatten() for g in got["grads"]]),
                                     torch.cat([g.flatten() for g in grads]))
        res["update_rel_l2"] = _rel_l2(
            torch.cat([(got["params"][k] - got["before"][k]).flatten() for k in params]),
            torch.cat([(params[k] - got["before"][k]).flatten() for k in params]))
        res["samples_rel_l2"] = _rel_l2(got["samples"], samples)
        if not (res["grad_rel_l2"] <= cfg.params_rtol
                and res["samples_rel_l2"] <= cfg.samples_tol):
            raise AssertionError(f"gradients rel L2 {res['grad_rel_l2']}, samples rel L2 "
                                 f"{res['samples_rel_l2']}")
    else:
        for k, v in params.items():
            torch.testing.assert_close(got["params"][k], v, rtol=cfg.params_rtol,
                                       atol=cfg.params_atol, msg=lambda m: f"{k}: {m}")
        torch.testing.assert_close(got["samples"], samples, rtol=cfg.samples_tol,
                                   atol=cfg.samples_tol)
        res["samples_max_err"] = (got["samples"] - samples).abs().max().item()
    for k in METRICS:
        if not math.isclose(got["metrics"][k], metrics[k], rel_tol=METRIC_RTOL,
                            abs_tol=METRIC_ATOL):
            raise AssertionError(f"{k}: {n} processes {got['metrics'][k]}, one {metrics[k]}")
    if not math.isfinite(got["fsdp_loss"]):
        raise AssertionError(f"non-finite fsdp loss: {got['fsdp_loss']}")
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m colddiff_torch.scripts.dryrun_multichip")
    p.add_argument("--n", type=int, default=2, help="processes")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--flagship", action="store_true",
                   help="the flagship's training and sampling path instead of the tiny one")
    p.add_argument("--weights", default=None, help="a state dict file to start from")
    p.add_argument("--space", type=int, default=None,
                   help="the spatial block on a (n / space, space) mesh instead")
    p.add_argument("--workflow", nargs="+", default=["blur"], choices=WORKFLOW_NAMES,
                   metavar="NAME", help="with --space: the workflows to run row-sharded "
                   f"(default blur, the flagship's block): {', '.join(WORKFLOW_NAMES)}")
    args = p.parse_args(argv)
    res = run(args.n, args.device, args.flagship, args.weights, space=args.space,
              workflows=args.workflow)
    for name, w in res.get("workflow_checks", {}).get("workflows", {}).items():
        for r in w["rows"]:
            print(f"dryrun_multichip({args.n}, space {args.space}, {name} {r['routine']}"
                  f"{' recon_noise_std %g' % r['recon_noise_std'] if r['recon_noise_std'] else ''}"
                  f", T={w['T']} {w['size']}px): ok; degrade rel err "
                  f"{w['degrade_rel_err']:.3e}, draws equal {w['draws_equal']}; forward rel L2 "
                  f"{r['forward_rel_l2']:.3e} {r['collectives_by_kind']}; {r['dtype']} sample "
                  f"from level {r['depth']} rel L2 {r['samples_rel_l2']:.3e}; front launches "
                  f"per process {r['launches']}; s per process {r['seconds']} vs one process "
                  f"{r['seconds_1']:.3f}", flush=True)
    if "loss" in res.get("workflow_checks", {}):
        r = res["workflow_checks"]["loss"]
        print(f"dryrun_multichip({args.n}, space {args.space}, loss): ok; loss {r['loss']:.7f} "
              f"vs one process {r['loss_1']:.7f}; group-summed gradients rel L2 "
              f"{r['grad_rel_l2']:.3e}; {r['collectives_by_kind']}", flush=True)
    if args.space and "blur" not in args.workflow:
        print(json.dumps(res, default=float), file=sys.stderr)
        return res
    if args.space:
        print(f"dryrun_multichip({args.n}, space {args.space}, {res['device']}, "
              f"{res['backend']}, {res['config']}): ok, mesh {res['mesh']}; fronts on row "
              f"blocks == the whole image (worst fp32 "
              f"{max(f['max_abs_err_fp32'] for f in res['fronts']):.3e}, bf16 "
              f"{max(f['max_abs_err_bf16'] for f in res['fronts']):.3e}); forward rel L2 "
              f"{res['forward_rel_l2']:.3e}, samples rel L2 {res['samples_rel_l2']:.3e} "
              f"against one process; front launches per process {res['launches']}; "
              f"{res['collectives_per_forward']} collectives a forward "
              f"{res['collectives_by_kind']}; sample s {res['seconds']} vs one process "
              f"{res['seconds_1']:.3f}", flush=True)
        print(json.dumps(res, default=float), file=sys.stderr)
        return res
    print(f"dryrun_multichip({args.n}, {res['device']}, {res['backend']}, {res['config']}): "
          f"ok, loss={res['loss']:.6f} == {res['loss_1']:.6f} on one process; params, "
          f"samples and manifold metrics equal; front launches per process "
          f"{res['launches']}; fsdp loss={res['fsdp_loss']:.6f}", flush=True)
    print(json.dumps({k: v for k, v in res.items() if k not in ("metrics_1",)}, default=float),
          file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
