"""Data-parallel and row-sharded dry runs over N processes, checked against one process.

    python -m colddiff_torch.scripts.dryrun_multichip --n N --device {cuda,cpu} [--flagship]
        [--space S]

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
port's bf16 tolerance, for the samples.  The last line is the result.
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

import torch

__all__ = ["Config", "TINY", "FLAGSHIP", "process_checks", "check", "front_shapes",
           "spatial_fronts", "spatial_checks", "check_spatial", "run", "main"]

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


def _process(rank: int, n: int, port: int, device: str, flagship: bool,
             weights: Optional[str], out: str, space: Optional[int]) -> None:
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
        result = spatial_checks(cfg, make_mesh_2d(n // space, space, dev.type), weights)
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
        space: Optional[int] = None) -> dict:
    """The dry run; returns its result (raises if a process fails or a check
    does not hold).  ``weights``: a state dict file the model starts from
    (default: torch's init under seed 0).  ``space``: the spatial block on
    ``make_mesh_2d(n // space, space)`` instead."""
    import torch.multiprocessing as mp

    from ..parallel import local_device

    if space is not None and (space < 1 or n % space):
        raise ValueError(f"--space {space} does not divide --n {n}")
    dev = local_device(device, 0)
    cfg = FLAGSHIP if flagship else TINY
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as folder:
        out = os.path.join(folder, "rank0.pt")
        port = _free_port()
        procs = [ctx.Process(target=_process,
                             args=(r, n, port, dev.type, flagship, weights, out, space))
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
            return check_spatial(torch.load(out), cfg, dev, weights)
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
    args = p.parse_args(argv)
    res = run(args.n, args.device, args.flagship, args.weights, space=args.space)
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
