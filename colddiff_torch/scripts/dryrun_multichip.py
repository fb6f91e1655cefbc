"""Data-parallel dry run over N processes, checked against one process.

    python -m colddiff_torch.scripts.dryrun_multichip --n N --device {cuda,cpu} [--flagship]

The torch twin of ``__graft_entry__.dryrun_multichip`` (``:28-155``; its
spatial block is ROADMAP.md item 12b).  It starts N processes joined by
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
front-kernel launches in 1-2.  The last line is the result.
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
from typing import Optional

import torch

__all__ = ["Config", "TINY", "FLAGSHIP", "process_checks", "check", "run", "main"]

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


TINY = Config(size=16, timesteps=4,
              blur=dict(blur_routine="Constant", kernel_size=3, kernel_std=1.0),
              unet=dict(dim=8, dim_mults=(1, 2)), batch=2, bf16=False,
              eval_images=6, eval_batch=3, eval_seed=1, loss_rtol=1e-5, loss_atol=1e-6,
              params_rtol=1e-4, params_atol=1e-5, samples_tol=2e-5)
FLAGSHIP = Config(size=128, timesteps=200,
                  blur=dict(blur_routine="Exponential_reflect", kernel_size=15,
                            kernel_std=0.01),
                  unet=dict(dim=64, dim_mults=(1, 2, 4, 8)), batch=8, bf16=True,
                  eval_images=64, eval_batch=32, eval_seed=15, loss_rtol=1e-3,
                  loss_atol=0.0, params_rtol=2e-2, params_atol=0.0, samples_tol=2e-2)
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


def _process(rank: int, n: int, port: int, device: str, flagship: bool,
             weights: Optional[str], out: str) -> None:
    """One process of the run; rank 0 saves what the check needs to ``out``."""
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    if device == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist

    from ..parallel import init_multihost, make_mesh

    dev = init_multihost(f"localhost:{port}", n, rank, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as folder:
        result = process_checks(FLAGSHIP if flagship else TINY, make_mesh(dev.type), weights,
                                folder)
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
        weights: Optional[str] = None, timeout: float = 600.0) -> dict:
    """The dry run; returns its result (raises if a process fails or a check
    does not hold).  ``weights``: a state dict file the model starts from
    (default: torch's init under seed 0)."""
    import torch.multiprocessing as mp

    from ..parallel import local_device

    dev = local_device(device, 0)
    cfg = FLAGSHIP if flagship else TINY
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as folder:
        out = os.path.join(folder, "rank0.pt")
        port = _free_port()
        procs = [ctx.Process(target=_process,
                             args=(r, n, port, dev.type, flagship, weights, out))
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
    args = p.parse_args(argv)
    res = run(args.n, args.device, args.flagship, args.weights)
    print(f"dryrun_multichip({args.n}, {res['device']}, {res['backend']}, {res['config']}): "
          f"ok, loss={res['loss']:.6f} == {res['loss_1']:.6f} on one process; params, "
          f"samples and manifold metrics equal; front launches per process "
          f"{res['launches']}; fsdp loss={res['fsdp_loss']:.6f}", flush=True)
    print(json.dumps({k: v for k, v in res.items() if k not in ("metrics_1",)}, default=float),
          file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
