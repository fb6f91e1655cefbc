"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path -- CelebA-128 deblurring served by reverse
sampling: blur ``Exponential_reflect`` T=200 kernel 15 std 0.01 at 128 px,
``x0_step_down``, the flagship ``UnetConvNext(dim=64, (1,2,4,8))`` with
random seeded weights, bf16 UNet compute and fp32 degrade math, B=16 -- and
checks it, in phases:

  1. environment: card name and power limit, torch/CUDA/nvcc versions, TF32 off;
  2. build: the CUDA kernels compile from colddiff_torch/csrc (timed);
  3. kernel vs plain PyTorch at every block front of the flagship forward
     at B=16, fp32 and bf16 (C < 32 through the small-C kernel, C >= 32
     through the tile kernel); each front's kernel device time over a run
     of launches, its single-call time, the plain version's and the
     library depthwise conv's times, its launches per forward and per train
     step, and its bound (bytes or operations) with the share reached; and
     the sums of device, library and bound times over the C >= 32 fronts;
  4. UNet parity: the fp32 flagship forward on the GPU vs on the CPU;
  5. oracle sampler: x0_step_down with a perfect denoiser gives back the
     clean batch (Algorithm-2 telescoping; checks the fp32 degrade);
  6. the main path: prepare_start + sample, timed, with the kernels' launch
     counts checked (17 fronts a forward, the stem through the small-C
     kernel);
  7. train-step parity: one fp32 optimizer step of a small UNet on the GPU
     vs on the CPU (loss, gradients, front launches);
  8. the training main path: ``Trainer.train()`` at full width (B=16,
     accum 2, bf16 compute on fp32 masters, Adam, EMA), 10 timed optimizer
     steps with the kernels' launch counts checked, one step with a
     checkpoint and the EMA sample grids, then a bitwise checkpoint round
     trip;
  9. the four Mosaic probe kernels of scripts/bisect_mosaic.py, through
     their entry point, against their plain versions, with device times
     over a run, bounds and, where one exists, a library call's time; and
     the launch floor, an empty ``torch.cuda._sleep(0)`` timed the same way;
 10. the wide-C front (C > 1024), the tile kernel's cluster form: against
     its plain version at (16,16,16,1280), (16,16,16,2048), (2,8,8,4096)
     and (2,8,8,8192) (a cluster of 8), fp32 and bf16, each row with its
     cluster configuration, timed as in phase 3, and checked to allocate
     nothing but its output; a ``UnetConvNext(dim=80)`` fp32 forward at
     128 px on the GPU vs on the CPU (its ups.0.0 front has 1280 channels),
     with the launch counts;
 11-15. the reference's other published workflows (docs/USAGE.md:62-84),
     each with the flagship UNet (random seeded weights, bf16 compute, fp32
     degrade math, B=16): prepare_start + sample timed (images/s, peak
     memory) with the front launch counts checked (17 a forward, the stem
     through the small-C kernel), after an oracle check of the operator on
     the card (a perfect denoiser gives back the clean batch) and its
     degrade against its CPU run:
     11. conditional fade, CelebA-128: ``fade`` Incremental, kernel_std 0.2,
         T=100, x0_step_down;
     12. super-resolution, 128 px: ``resolution`` Incremental_factor_2, T=4;
     13. colorization, 128 px: ``decolor`` Linear, total remove, T=20, with
         ``to_lab`` off and on;
     14. fade generation, 128 px: ``fade_generation`` reverse, kernel_std
         0.05, T=750, endpoints from ``sample_x_end``; sampled with
         x0_step_down (a fixed endpoint) and with ddim, then 3
         ``Trainer.train()`` steps (accum 2) whose last takes the snapshot;
     15. Random_Incremental fade, CIFAR-10 32 px: kernel_std 0.1,
         initial_mask 1, T=50; 5 ``Trainer.train()`` steps with crops drawn
         per loss, the baked crop offsets checked unchanged, then a sample
         that keeps them;
 16. ``all_sample`` on the flagship blur path (T=200, 128 px, B=16,
     traj_stride 10): frame 0 of x0_trajectory is direct_recons, the last
     xt_trajectory frame sampled on for the last 10 steps gives the final
     image; peak memory.

Device times come from CUDA events around a run of launches that a spin
kernel holds back until the host has queued them all, so the card runs
them back to back: the events time the card, not the Python and ctypes
path of each call (that path is the single-call ``call_ms``).  The L2 stays
as the run leaves it; a row says whether its working set fits the 50 MB
L2 ("warm") or not.  Bounds count each input byte read once and each
output byte written once at 3.35 TB/s, and each tap as one fp32 FMA
(2 flops) at 67 TFLOP/s: the H100 SXM's published peaks.

Any failure raises and the script exits non-zero; without a CUDA device it
exits non-zero at once.  The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from colddiff_torch.data import SyntheticDataset
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext
from colddiff_torch.models.layers import ConvNextBlock
from colddiff_torch.operators import get_operator
from colddiff_torch.ops import _build
from colddiff_torch.ops import bisect_mosaic as probe_ops
from colddiff_torch.ops.convnext_front import (SMALL_C, TILE_MAX_CHANNELS, cluster_config,
                                              convnext_front, convnext_front_plain)
from colddiff_torch.ops.image import rgb2lab
from colddiff_torch.sampling import all_sample, prepare_start, sample
from colddiff_torch.scripts import bisect_mosaic as probe_script
from colddiff_torch.train import Trainer

SEED = 0
BATCH = 16
IMG = 128
T = 200
FLAGSHIP = dict(dim=64, dim_mults=(1, 2, 4, 8), channels=3)
FRONT_FP32_ATOL = 1e-4  # summation order over 49 taps and C channels only
FRONT_BF16_TOL = 2e-2  # one bf16 rounding of an LN output of magnitude <= ~4
UNET_REL_L2 = 1e-3
ORACLE_ATOL = 1e-4
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL_L2 = 1e-3  # cuDNN vs oneDNN summation orders, as in phase 4
TRAIN_STEPS = 10
ACCUM = 2
PROBE_ATOL = 1e-5  # masked_norm: fp32 summation order of its mean
# (B, H, W, C); clusters of 5, 8, 8 and 8 blocks
WIDE_SHAPES = ((16, 16, 16, 1280), (16, 16, 16, 2048), (2, 8, 8, 4096), (2, 8, 8, 8192))
WIDE_DIM = 80  # UnetConvNext(dim=80): a 16 * 80 = 1280-channel front at ups.0.0
DEGRADE_REL = 1e-5  # an operator's degrade on the card vs the CPU, relative to max |y|
TRAJ_STRIDE = 10
RUN = 50  # launches per device-time run of a kernel or a library call
PLAIN_RUN = 20  # calls per run of a plain version (~12 launches each)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50e6


def log(*parts) -> None:
    print(*parts, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def seeded_unet(seed: int, device, **cfg) -> UnetConvNext:
    """UnetConvNext with weights drawn from a seeded torch.Generator:
    uniform(+-1/sqrt(fan_in)) weights and biases, LayerNorm g=1, b=0."""
    model = UnetConvNext(**cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".g"):
                p.fill_(1.0)
            elif name.endswith(".b"):
                p.zero_()
            else:
                owner = model.get_submodule(name.rsplit(".", 1)[0])
                fan_in = owner.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                p.uniform_(-bound, bound, generator=gen)
    return model.to(device).eval()


def record_fronts(model: UnetConvNext, x: torch.Tensor, t: torch.Tensor):
    """Run ``model(x, t)`` and record each block front it runs:
    (block name, C, H, W, norm, has_cond) in call order."""
    shapes = []

    def hook(name, block, args):
        h, tt = args if len(args) == 2 else (args[0], None)
        has_cond = block.mlp is not None and tt is not None
        shapes.append((name, h.shape[1], h.shape[2], h.shape[3], block.norm, has_cond))

    handles = [m.register_forward_pre_hook(functools.partial(hook, name))
               for name, m in model.named_modules() if isinstance(m, ConvNextBlock)]
    try:
        with torch.inference_mode():
            out = model(x, t)
    finally:
        for h in handles:
            h.remove()
    return out, shapes


def front_args(gen, b, c, h, w, has_cond, device):
    """Random front inputs: x [B,C,H,W] channels_last, w [C,1,7,7], ..."""
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    x = randn(b, c, h, w).contiguous(memory_format=torch.channels_last)
    wk = randn(c, 1, 7, 7, scale=0.05)
    bias = randn(c, scale=0.1)
    cond = randn(b, c) if has_cond else None
    gamma = torch.rand(c, generator=gen, device=device) + 0.5
    beta = randn(c, scale=0.1)
    return x, wk, bias, cond, gamma, beta


def cuda_median_ms(fn, warmup: int = 5, iters: int = 30) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def device_ms(fn, n: int = RUN):
    """Device ms per call over a run of ``n`` calls of ``fn`` that the card
    runs back to back.  A spin kernel, longer than twice the host's time to
    queue the run, holds the stream while the host queues it; the run counts
    as back to back when the start event has not fired by the time the last
    call is queued.  Returns (ms, back_to_back)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_cycles_per_ms() * (2 * host_ms + 1)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    back_to_back = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / n, back_to_back


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def front_bound(b, h, w, c, has_cond, norm, esize):
    """The front's bound: x read and out written once, the weights, bias,
    cond and LayerNorm parameters read once; 49 FMAs per output."""
    outputs = b * h * w * c
    nbytes = esize * (2 * outputs + 49 * c + c + (b * c if has_cond else 0)
                      + (2 * c if norm else 0))
    return bound(nbytes, 2 * 49 * outputs)


def timed_row(row, key, fn, n: int = RUN) -> None:
    """``row[key]`` = device ms per call of ``fn``; flags a host-paced run."""
    row[key], back_to_back = device_ms(fn, n)
    if not back_to_back:
        row.setdefault("host_paced", []).append(key)


def check_front(args, norm: bool, what: str):
    """The kernel against the plain version on ``args`` in fp32, and on
    their bf16 roundings against the plain version in fp32; returns the
    bf16 arguments and both max errors."""
    got = convnext_front(*args, norm=norm)
    want = convnext_front_plain(*args, norm=norm)
    err32 = (got - want).abs().max().item()
    if not err32 <= FRONT_FP32_ATOL:
        raise AssertionError(f"fp32 front {what}: max err {err32}")
    a16 = [None if a is None else a.to(torch.bfloat16) for a in args]
    a16[0] = a16[0].contiguous(memory_format=torch.channels_last)
    got16 = convnext_front(*a16, norm=norm).float()
    want16 = convnext_front_plain(*[None if a is None else a.float() for a in a16], norm=norm)
    excess = ((got16 - want16).abs() - FRONT_BF16_TOL * want16.abs()).max().item()
    if not excess <= FRONT_BF16_TOL:
        raise AssertionError(f"bf16 front {what}: |err| - rtol*|want| = {excess}")
    return a16, err32, (got16 - want16).abs().max().item()


def time_front(row, args, a16, batch, h, w, c, norm, has_cond) -> None:
    """Phase 3's timings of one front into ``row``, fp32 and bf16."""
    for tag, a in (("fp32", args), ("bf16", a16)):
        bound_ms, row["bound_by_" + tag] = front_bound(
            batch, h, w, c, has_cond, norm, a[0].element_size())
        row[f"bound_us_{tag}"] = 1e3 * bound_ms
        row[f"l2_{tag}"] = ("warm" if 2 * a[0].numel() * a[0].element_size() <= L2_BYTES
                            else "exceeds")
        timed_row(row, f"ms_{tag}", lambda: convnext_front(*a, norm=norm))
        row[f"bound_share_{tag}"] = bound_ms / row[f"ms_{tag}"]
        row[f"call_ms_{tag}"] = cuda_median_ms(lambda: convnext_front(*a, norm=norm))
        timed_row(row, f"plain_ms_{tag}",
                  lambda: convnext_front_plain(*a, norm=norm), PLAIN_RUN)
        timed_row(row, f"library_ms_{tag}",
                  lambda: F.conv2d(a[0], a[1], a[2], padding=3, groups=c))


def kernel_label(c: int) -> str:
    return "small_c" if c < SMALL_C else "tile" if c <= TILE_MAX_CHANNELS else "wide_c"


def cluster_label(cl: dict) -> str:
    """One line for a ``cluster_config`` dict."""
    return (f"k={cl['k']} S={cl['slab']} tile {cl['tile'][0]}x{cl['tile'][1]} "
            f"R={cl['run']} CK={cl['chunk']}")


def check_fronts(shapes, batch: int, device, timed: bool):
    """Phase 3: kernel vs plain at every block front, fp32 and bf16; with
    ``timed``, each front's device, call, plain and library times and its
    bound (see the module docstring)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    per_forward = Counter(s[1:] for s in shapes)
    rows, worst32, worst16 = [], 0.0, 0.0
    for front, c, h, w, norm, has_cond in shapes:
        args = front_args(gen, batch, c, h, w, has_cond, device)
        # bf16: the kernel on bf16 tensors vs the plain version in fp32 on
        # the same bf16-rounded inputs and weights
        a16, err32, err16 = check_front(args, norm, f"C={c} {h}x{w}")
        worst32, worst16 = max(worst32, err32), max(worst16, err16)
        n = per_forward[(c, h, w, norm, has_cond)]
        row = dict(front=front, shape=[batch, h, w, c], norm=norm, cond=has_cond,
                   kernel=kernel_label(c), launches_per_forward=n,
                   launches_per_train_step=n * ACCUM, max_abs_err_fp32=err32,
                   max_abs_err_bf16=err16)
        if timed:
            time_front(row, args, a16, batch, h, w, c, norm, has_cond)
        rows.append(row)
        log("  front", json.dumps(row))
    return rows, worst32, worst16


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def oracle_sample(device, batch: int, size: int, timesteps: int) -> float:
    """Phase 5: max |sample(prepare_start(clean)) - clean| with denoise = clean."""
    op = get_operator("blur", image_size=size, timesteps=timesteps,
                      blur_routine="Exponential_reflect", kernel_size=15,
                      kernel_std=0.01, device=device)
    d = ColdDiffusion(op=op, image_size=size, sampling_routine="x0_step_down")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    clean = torch.rand(batch, size, size, 3, generator=gen, device=device) * 2 - 1
    res = sample(d, lambda x, t: clean, prepare_start(d, clean))
    return (res.img - clean).abs().max().item()


def main_path(model: UnetConvNext, device, batch: int, size: int, timesteps: int):
    """Phase 6: prepare_start + sample (x0_step_down), bf16 UNet, fp32 degrade."""
    op = get_operator("blur", image_size=size, timesteps=timesteps,
                      blur_routine="Exponential_reflect", kernel_size=15,
                      kernel_std=0.01, device=device)
    d = ColdDiffusion(op=op, image_size=size, sampling_routine="x0_step_down")
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    img = torch.rand(batch, size, size, 3, generator=gen, device=device) * 2 - 1
    denoise = bf16_denoise(model)
    # warm-up: two reverse steps (first-call cuDNN and allocator set-up)
    sample(d, denoise, prepare_start(d, img), t=2)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    out = sample(d, denoise, prepare_start(d, img)).img
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return out, seconds, convnext_front.launches, convnext_front.small_c_launches


def blur_diffusion(size: int, timesteps: int, device) -> ColdDiffusion:
    op = get_operator("blur", image_size=size, timesteps=timesteps,
                      blur_routine="Exponential_reflect", kernel_size=15,
                      kernel_std=0.01, device=device)
    return ColdDiffusion(op=op, image_size=size, sampling_routine="x0_step_down")


def train_step_parity(device, folder: str):
    """Phase 7: one fp32 optimizer step (B=2, accum 2, given t) of a small
    UNet on the GPU and on the CPU, from the same weights and batch.
    Returns (loss rel err, worst grad rel L2, front launches, small-C
    launches, fronts, small-C fronts)."""
    cfg, size, steps = dict(dim=16, dim_mults=(1, 2)), 32, 20
    _, fronts = record_fronts(seeded_unet(SEED, "cpu", **cfg),
                              torch.zeros(1, size, size, 3), torch.tensor([1]))
    t = torch.tensor([[0, 7], [13, 19]])
    runs = {}
    for dev in (device, torch.device("cpu")):
        tr = Trainer(blur_diffusion(size, steps, dev), seeded_unet(SEED, dev, **cfg),
                     SyntheticDataset(size, 3, length=8), train_batch_size=2,
                     gradient_accumulate_every=ACCUM, results_folder=f"{folder}/{dev.type}",
                     num_workers=1, seed=SEED, device=dev)
        before = convnext_front.launches, convnext_front.small_c_launches
        loss = tr.train_step(tr._next_superbatch(), t=t.to(dev)).item()
        runs[dev.type] = (loss, [p.grad.detach().cpu() for p in tr.model.parameters()],
                          convnext_front.launches - before[0],
                          convnext_front.small_c_launches - before[1])
    (loss_g, grads_g, launches, small), (loss_c, grads_c, _, _) = runs["cuda"], runs["cpu"]
    worst = max(rel_l2(g, c) for g, c in zip(grads_g, grads_c))
    return (abs(loss_g - loss_c) / abs(loss_c), worst, launches, small, len(fronts),
            sum(f[1] < SMALL_C for f in fronts))


def train_main_path(device, folder: str):
    """Phase 8: the Trainer at full width, bf16 compute on fp32 masters,
    driven through ``Trainer.train(log_every=1)``: one warm-up step, then
    TRAIN_STEPS timed steps (step 10 takes the EMA branch), then one step
    whose checkpoint and EMA sample grids run (``save_and_sample_every``),
    then a checkpoint round trip into a fresh Trainer.  Each step's loss and
    time are read from the Trainer's own ``metrics.jsonl`` (the loader's
    wait included).  Returns (losses, step seconds, front launches, small-C
    launches, peak bytes, seconds of the snapshot step, whether the round
    trip is bitwise)."""
    d = blur_diffusion(IMG, T, device)
    last = TRAIN_STEPS + 2
    kw = dict(train_batch_size=BATCH, gradient_accumulate_every=ACCUM, train_lr=2e-5,
              ema_decay=0.995, step_start_ema=2000, update_ema_every=10,
              save_and_sample_every=last, results_folder=folder, bf16=True,
              num_workers=8, seed=SEED, device=device)
    ds = SyntheticDataset(IMG, 3, length=64)
    tr = Trainer(d, seeded_unet(SEED, device, **FLAGSHIP), ds, train_num_steps=1, **kw)
    tr.train(log_every=1)  # warm-up: cuDNN and allocator set-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    tr.train_num_steps = 1 + TRAIN_STEPS
    tr.train(log_every=1)
    launches, small = convnext_front.launches, convnext_front.small_c_launches
    peak = torch.cuda.max_memory_allocated(device)

    tr.train_num_steps = last
    t0 = time.perf_counter()
    tr.train(log_every=1)  # save, then snapshot(1): sampling with the EMA model
    snap_s = time.perf_counter() - t0
    for name in ("og", "xt", "direct_recons", "sample"):
        if not (tr.results_folder / f"{name}-1.png").is_file():
            raise AssertionError(f"snapshot wrote no {name}-1.png")
    lines = [json.loads(x) for x in tr.metrics_path.read_text().splitlines()]
    if [x["step"] for x in lines] != list(range(1, last + 1)):
        raise AssertionError(f"metrics.jsonl steps {[x['step'] for x in lines]}")
    timed = lines[1:1 + TRAIN_STEPS]
    losses = [x["loss"] for x in timed]
    step_s = [BATCH * ACCUM / x["images_per_sec"] for x in timed]

    fresh = Trainer(d, seeded_unet(SEED + 1, device, **FLAGSHIP), ds,
                    load_path=f"{folder}/model.pt", **kw)
    a, b = tr.state(), fresh.state()
    bitwise = (a["step"] == b["step"] == last
               and all(torch.equal(a[k][n], b[k][n]) for k in ("model", "ema") for n in a[k])
               and torch.equal(a["generator"], b["generator"])
               and all(torch.equal(v, b["opt"]["state"][i][name])
                       for i, st in a["opt"]["state"].items() for name, v in st.items()))
    return losses, step_s, launches, small, peak, snap_s, bitwise


def call_allocation(fn) -> tuple:
    """(the peak bytes one call of ``fn`` allocates, the bytes it leaves
    allocated, its output's bytes)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base, torch.cuda.memory_allocated() - base,
            out.untyped_storage().nbytes())


def wide_c_fronts(device, cpu_unet_input):
    """Phase 10: the cluster form against its plain version at every
    WIDE_SHAPES entry (cond and LayerNorm, as ups.0.0), each with its
    cluster configuration, a phase-3 row of times and a check that one
    call allocates its output alone (no workspace); then the dim=80 UNet
    on the GPU vs the CPU.  Returns (rows, worst fp32 error, worst bf16
    error, rel L2, launches, small-C launches, wide-C launches)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    rows, worst32, worst16 = [], 0.0, 0.0
    for b, h, w, c in WIDE_SHAPES:
        args = front_args(gen, b, c, h, w, True, device)
        a16, err32, err16 = check_front(args, True, f"C={c} {h}x{w} B={b}")
        worst32, worst16 = max(worst32, err32), max(worst16, err16)
        row = dict(front="wide_c", shape=[b, h, w, c], norm=True, cond=True,
                   kernel=kernel_label(c), max_abs_err_fp32=err32, max_abs_err_bf16=err16)
        for tag, a in (("fp32", args), ("bf16", a16)):
            row["cluster_" + tag] = cluster_config(c, a[0].dtype)
            peak, kept, out_bytes = call_allocation(lambda: convnext_front(*a))
            if not peak == kept == out_bytes:
                raise AssertionError(f"wide-C front {row['shape']} {tag}: a call allocated "
                                     f"{peak} bytes at its peak and kept {kept}; its "
                                     f"output has {out_bytes}")
            row["alloc_bytes_" + tag] = peak
        time_front(row, args, a16, b, h, w, c, True, True)
        rows.append(row)
        log("  front", json.dumps(row))
        del args, a16
    cfg = dict(FLAGSHIP, dim=WIDE_DIM)
    x, t = cpu_unet_input
    want, shapes = record_fronts(seeded_unet(SEED, "cpu", **cfg), x, t)
    if sum(f[1] > TILE_MAX_CHANNELS for f in shapes) != 1:
        raise AssertionError(f"dim={WIDE_DIM} fronts: {shapes}")
    model = seeded_unet(SEED, device, **cfg)
    zero_launches()
    with torch.inference_mode():
        got = model(x.to(device), t.to(device))
    torch.cuda.synchronize(device)
    counts = launch_counts()
    return rows, worst32, worst16, rel_l2(got, want), *counts


def reset_peak(device) -> int:
    """Free what earlier phases left (their Trainers' cycles), reset the
    peak-memory count and return the bytes still allocated."""
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def zero_launches() -> None:
    convnext_front.launches = convnext_front.small_c_launches = 0
    convnext_front.wide_c_launches = 0


def launch_counts():
    """(all front launches, small-C, wide-C) since ``zero_launches``."""
    return (convnext_front.launches, convnext_front.small_c_launches,
            convnext_front.wide_c_launches)


def bf16_denoise(model):
    def denoise(x, t):
        return model(x.to(torch.bfloat16), t).to(torch.float32)
    return denoise


def check_operator(d: ColdDiffusion, size: int, device, x_end_fn=None, lab=False):
    """The operator of ``d`` on the card: its degrade at 9 or more levels
    from 0 to T against its CPU copy (relative to max |y|), and the oracle -- with a
    perfect denoiser, prepare_start + sample gives back the clean batch
    (Algorithm 2 telescopes; Family B with its true endpoint).  Returns
    (degrade rel err, oracle max err)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    clean = torch.rand(4, size, size, 3, generator=gen, device=device) * 2 - 1
    if lab:
        clean = rgb2lab(clean)
    x_end = None if x_end_fn is None else x_end_fn(gen, clean)
    op, cpu = d.op, d.op.to("cpu")
    worst = 0.0
    for level in sorted(set(range(0, op.timesteps + 1, max(1, op.timesteps // 8)))
                        | {op.timesteps}):
        n = torch.full((4,), level, device=device)
        kw = {} if x_end is None else {"x_end": x_end}
        got = op.degrade(clean, n, **kw)
        want = cpu.degrade(clean.cpu(), n.cpu(), **{k: v.cpu() for k, v in kw.items()})
        worst = max(worst, ((got.cpu() - want).abs().max() / want.abs().max()).item())
    if not worst <= DEGRADE_REL:
        raise AssertionError(f"{type(op).__name__} degrade cuda vs cpu: rel err {worst}")
    res = sample(dataclasses.replace(d, sampling_routine="x0_step_down"),
                 lambda x, t: clean, prepare_start(d, clean, x_end=x_end), x_end=x_end)
    err = ((res.img - clean).abs().max() / clean.abs().max()).item()
    if not err <= ORACLE_ATOL:
        raise AssertionError(f"{type(op).__name__} oracle sampler: rel err {err}")
    return worst, err


def sample_path(d: ColdDiffusion, model, device, batch: int, size: int, *, x_end_fn=None,
                lab=False):
    """prepare_start + sample with the bf16 UNet, timed from a clean batch;
    checks the output and the launch counts (17 fronts and one small-C
    front a forward).  Returns a dict of the run's numbers."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    img = torch.rand(batch, size, size, 3, generator=gen, device=device) * 2 - 1
    if lab:
        img = rgb2lab(img)
    x_end = None if x_end_fn is None else x_end_fn(gen, img)
    denoise = bf16_denoise(model)
    sample(d, denoise, prepare_start(d, img, 2, x_end=x_end), t=2, x_end=x_end)  # warm-up
    base = reset_peak(device)
    zero_launches()
    t0 = time.perf_counter()
    out = sample(d, denoise, prepare_start(d, img, x_end=x_end), x_end=x_end).img
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches, small, wide = launch_counts()
    steps = d.num_timesteps
    if not (out.shape == img.shape and torch.isfinite(out).all().item()):
        raise AssertionError(f"{type(d.op).__name__} sample: {out.shape}, not finite/shaped")
    if (launches, small, wide) != (17 * steps, steps, 0):
        raise AssertionError(f"{type(d.op).__name__} sample launched {launches} fronts, "
                             f"{small} small-C, {wide} wide-C; expected {17 * steps}, "
                             f"{steps}, 0")
    return dict(op=type(d.op).__name__, routine=d.sampling_routine, T=steps, batch=batch,
                size=size, seconds=seconds, images_per_s=batch / seconds,
                peak_bytes=torch.cuda.max_memory_allocated(device), base_bytes=base,
                launches=launches, small_c_launches=small)


def workflows(model, device, card: str):
    """Phases 11-14 (sampling): returns the result rows."""
    def op(name, size, **cfg):
        return get_operator(name, image_size=size, **cfg, device=device)

    def x_end_fn(d):
        return lambda gen, x: d.op.sample_x_end(gen, x)

    fade = ColdDiffusion(op=op("fade", IMG, timesteps=100, fade_routine="Incremental",
                               kernel_std=0.2), image_size=IMG,
                         sampling_routine="x0_step_down")
    sr = ColdDiffusion(op=op("resolution", IMG, timesteps=4,
                             resolution_routine="Incremental_factor_2"),
                       image_size=IMG, sampling_routine="x0_step_down")
    decolor = {lab: ColdDiffusion(op=get_operator(
        "decolor", timesteps=20, decolor_routine="Linear", decolor_total_remove=True,
        to_lab=lab, device=device), image_size=IMG, sampling_routine="x0_step_down")
        for lab in (False, True)}
    gen_op = op("fade_generation", IMG, timesteps=750, reverse=True, kernel_std=0.05)
    fgen = {r: ColdDiffusion(op=gen_op, image_size=IMG, sampling_routine=r)
            for r in ("x0_step_down", "ddim")}
    runs = [("11", fade, {}), ("12", sr, {}), ("13", decolor[False], {}),
            ("13", decolor[True], dict(lab=True)),
            ("14", fgen["x0_step_down"], dict(x_end_fn=x_end_fn(fgen["x0_step_down"]))),
            ("14", fgen["ddim"], dict(x_end_fn=x_end_fn(fgen["ddim"])))]
    rows = []
    for phase, d, kw in runs:
        deg, oracle = check_operator(d, IMG, device, **kw)
        row = sample_path(d, model, device, BATCH, IMG, **kw)
        row.update(phase=phase, to_lab=bool(kw.get("lab")), degrade_rel_err=deg,
                   oracle_rel_err=oracle)
        log(f"[{phase}] {row['op']} {row['routine']} T={row['T']} B={BATCH} {IMG}px"
            f"{' to_lab' if row['to_lab'] else ''}: {row['seconds']:.3f} s, "
            f"{row['images_per_s']:.3f} images/s, peak memory {row['peak_bytes']} bytes "
            f"({row['peak_bytes'] / 2**30:.2f} GiB; {row['base_bytes']} allocated before "
            f"the run), front launches {row['launches']}, of "
            f"them small-C {row['small_c_launches']}; degrade cuda vs cpu rel err "
            f"{deg:.3e}, oracle rel err {oracle:.3e}; card: {card}")
        rows.append(row)
    return rows


def train_workflow(d: ColdDiffusion, device, folder: str, size: int, steps: int,
                   snapshot: bool):
    """``Trainer.train()`` at full width (B=16, accum 2, bf16) for one
    warm-up step and ``steps`` more, the last with the checkpoint and the EMA
    sample grids when ``snapshot``; checks the losses and the launch counts
    (17 fronts a microbatch forward, plus 17 a reverse step of the
    snapshot).  Returns (trainer, train images/s from metrics.jsonl, peak
    bytes, front launches)."""
    kw = dict(train_batch_size=BATCH, gradient_accumulate_every=ACCUM, bf16=True,
              save_and_sample_every=(1 + steps) if snapshot else 10**9,
              results_folder=folder, num_workers=8, seed=SEED, device=device)
    tr = Trainer(d, seeded_unet(SEED, device, **FLAGSHIP), SyntheticDataset(size, 3, length=64),
                 train_num_steps=1, **kw)
    tr.train(log_every=1)
    reset_peak(device)
    zero_launches()
    tr.train_num_steps = 1 + steps
    tr.train(log_every=1)
    launches, small, _ = launch_counts()
    want = 17 * ACCUM * steps + (17 * d.num_timesteps if snapshot else 0)
    if launches != want or small * 17 != want:
        raise AssertionError(f"{type(d.op).__name__} training launched {launches} fronts "
                             f"({small} small-C), expected {want}")
    lines = [json.loads(x) for x in tr.metrics_path.read_text().splitlines()]
    losses = [x["loss"] for x in lines]
    if len(lines) != 1 + steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training metrics {lines}")
    if snapshot and not (tr.results_folder / "sample-1.png").is_file():
        raise AssertionError("snapshot wrote no sample-1.png")
    timed = lines[1:1 + steps - (1 if snapshot else 0)] or lines[1:]
    ips = float(np.median([x["images_per_sec"] for x in timed]))
    return tr, ips, torch.cuda.max_memory_allocated(device), launches


def random_fade_path(device, folder: str, card: str):
    """Phase 15: Random_Incremental fade at 32 px (CIFAR-10): 5 training
    steps that draw their crops per loss while the baked offsets stay as
    they were, then a sample that keeps the baked offsets."""
    op = get_operator("fade", image_size=32, timesteps=50, fade_routine="Random_Incremental",
                      kernel_std=0.1, initial_mask=1, device=device)
    op = op.randomize(torch.Generator(device=device).manual_seed(SEED + 7), BATCH)
    d = ColdDiffusion(op=op, image_size=32, sampling_routine="x0_step_down")
    deg, oracle = check_operator(d, 32, device)
    draws = []
    counted = op.to(device)  # a copy whose crop draws are counted
    counted.sample_rng_state = lambda generator, b: (draws.append(b),
                                                     op.sample_rng_state(generator, b))[1]
    tr, ips, peak, launches = train_workflow(dataclasses.replace(d, op=counted), device,
                                             folder, 32, 5, snapshot=False)
    tr_op = tr.diffusion.op
    if len(draws) != 6 * ACCUM or not torch.equal(tr_op.offsets.cpu(), op.offsets.cpu()):
        raise AssertionError(f"Random_Incremental training: {len(draws)} crop draws, "
                             f"offsets kept: {torch.equal(tr_op.offsets.cpu(), op.offsets.cpu())}")
    before = tr_op.offsets.clone()
    row = sample_path(tr.diffusion, seeded_unet(SEED, device, **FLAGSHIP).to(torch.bfloat16),
                      device, BATCH, 32)
    if not torch.equal(tr.diffusion.op.offsets, before):
        raise AssertionError("sampling changed the baked crop offsets")
    row.update(phase="15", train_images_per_s=ips, train_peak_bytes=peak,
               train_launches=launches, crop_draws=len(draws), degrade_rel_err=deg,
               oracle_rel_err=oracle)
    log(f"[15] Random_Incremental fade 32px T=50 B={BATCH}: 5 Trainer.train() steps, "
        f"{ips:.3f} train images/s (median), peak {peak} bytes, front launches {launches}, "
        f"{len(draws)} crop draws (warm-up included), baked offsets unchanged; sample "
        f"{row['images_per_s']:.3f} images/s, peak {row['peak_bytes']} bytes, offsets "
        f"unchanged; degrade rel err {deg:.3e}, oracle rel err {oracle:.3e}; card: {card}")
    return row


def trajectories(model, device, card: str):
    """Phase 16: all_sample on the flagship blur path, traj_stride 10."""
    d = blur_diffusion(IMG, T, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    img = torch.rand(BATCH, IMG, IMG, 3, generator=gen, device=device) * 2 - 1
    denoise = bf16_denoise(model)
    start = prepare_start(d, img)
    base = reset_peak(device)
    zero_launches()
    t0 = time.perf_counter()
    res = all_sample(d, denoise, start, traj_stride=TRAJ_STRIDE)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches, small, _ = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    frames = T // TRAJ_STRIDE
    if (res.x0_trajectory.shape != (frames, BATCH, IMG, IMG, 3)
            or res.xt_trajectory.shape != res.x0_trajectory.shape):
        raise AssertionError(f"trajectories {res.x0_trajectory.shape}")
    if not torch.equal(res.x0_trajectory[0], res.direct_recons):
        raise AssertionError("x0_trajectory[0] is not direct_recons")
    if not torch.equal(res.xt_trajectory[0], start):
        raise AssertionError("xt_trajectory[0] is not the start")
    tail = sample(d, denoise, res.xt_trajectory[-1], t=TRAJ_STRIDE).img
    tail_err = (tail - res.img).abs().max().item()
    if not tail_err <= ORACLE_ATOL:
        raise AssertionError(f"the last xt frame does not feed the last steps: {tail_err}")
    if launches != 17 * T or small != T:
        raise AssertionError(f"all_sample launched {launches} fronts, {small} small-C")
    traj_bytes = res.x0_trajectory.nbytes + res.xt_trajectory.nbytes
    log(f"[16] all_sample blur T={T} B={BATCH} {IMG}px traj_stride {TRAJ_STRIDE}: "
        f"{seconds:.3f} s, {BATCH / seconds:.3f} images/s, peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB; {base} allocated before the run), trajectories "
        f"{traj_bytes} bytes; frame 0 == "
        f"direct_recons; last xt frame + {TRAJ_STRIDE} steps vs img max err {tail_err:.3e}; "
        f"front launches {launches}; card: {card}")
    return dict(phase="16", seconds=seconds, images_per_s=BATCH / seconds, peak_bytes=peak,
                base_bytes=base, trajectory_bytes=traj_bytes, tail_err=tail_err)


def probe_kernels(device):
    """Phase 9: the probe entry point's four kernels against their plain
    versions, each with its device time over a run, its single-call time,
    its bound (input and output bytes once; adds and subtracts as flops)
    and, where one PyTorch call computes the same function, that call's
    time; returns one row per probe."""
    wrappers = (probe_ops.probe_roll, probe_ops.probe_roll_slice,
                probe_ops.probe_masked_norm, probe_ops.probe_dyn_sublane)
    for w in wrappers:
        w.launches = 0
    outs = probe_script.probes(device)
    torch.cuda.synchronize(device)
    launches = [w.launches for w in wrappers]
    a = probe_script.inputs(device)
    width = a["x"].shape[-1]
    shift = width - probe_script.ROLL
    ones = torch.ones(1, 1, probe_ops.WINDOW, 1, device=device)
    # roll_slice rolls left by ROLL and keeps SPLIT lanes of it: they never
    # wrap (SPLIT + ROLL <= width), so the probe is one fixed gather
    if probe_script.SPLIT + probe_script.ROLL > width:
        raise AssertionError("roll_slice wraps: it is not one fixed gather")
    gather = torch.cat([torch.arange(probe_script.ROLL, probe_script.SPLIT + probe_script.ROLL),
                        torch.arange(probe_script.SPLIT, width)]).to(device)
    if not torch.equal(a["x"].index_select(-1, gather),
                       probe_ops.roll_slice_plain(a["x"], shift, probe_script.SPLIT)):
        raise AssertionError("roll_slice is not the gather index_select takes")
    # (kernel, plain, library call or None, tolerance, input, flops, replaces)
    calls = [
        (lambda: probe_ops.probe_roll(a["x"], shift),
         lambda: probe_ops.roll_plain(a["x"], shift),
         lambda: torch.roll(a["x"], shift, -1), 0.0, a["x"], 0,
         "scripts/bisect_mosaic.py:37"),
        (lambda: probe_ops.probe_roll_slice(a["x"], shift, probe_script.SPLIT),
         lambda: probe_ops.roll_slice_plain(a["x"], shift, probe_script.SPLIT),
         lambda: a["x"].index_select(-1, gather), 0.0, a["x"], 0,
         "scripts/bisect_mosaic.py:42"),
        # no library call: x minus its mean over each group of 64 lanes takes
        # two PyTorch calls (the mean, then the subtraction)
        (lambda: probe_ops.probe_masked_norm(a["xn"]),
         lambda: probe_ops.masked_norm_plain(a["xn"]), None, PROBE_ATOL, a["xn"],
         2 * a["xn"].numel(), "scripts/bisect_mosaic.py:49"),
        # dyn_sublane adds rows r .. r+6 in the plain version's order
        (lambda: probe_ops.probe_dyn_sublane(a["xd"]),
         lambda: probe_ops.dyn_sublane_plain(a["xd"]),
         lambda: F.conv2d(a["xd"][:, None], ones), 0.0, a["xd"],
         (probe_ops.WINDOW - 1) * outs[3][1].numel(), "scripts/bisect_mosaic.py:64"),
    ]
    # (shift, split) of the kernels with a float4 path, for quad_path
    quad_args = {"roll_whole_row": (shift, width), "dyn_sublane": (0, 0),
                 "roll_then_slice": (shift, probe_script.SPLIT)}
    rows = []
    for w, (name, got), n, (kernel, plain, library, tol, x, flops, replaces) in zip(
            wrappers, outs, launches, calls):
        err = (got - plain()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"probe {name}: max err {err} > {tol}")
        bound_ms, bound_by = bound(x.nbytes + got.nbytes, flops)
        row = dict(name=w.__name__, probe=name, launches=n, max_abs_err=err,
                   bound_ms=bound_ms, bound_us=1e3 * bound_ms, bound_by=bound_by,
                   library_ms=None, replaces=replaces, sum=float(got.sum()))
        if name in quad_args:
            row["float4_path"] = probe_ops.quad_path(x.data_ptr(), got.data_ptr(),
                                                     x.shape[-1], *quad_args[name])
        timed_row(row, "ms", kernel)
        row["bound_share"] = bound_ms / row["ms"]
        row["call_ms"] = cuda_median_ms(kernel)
        timed_row(row, "plain_ms", plain)
        if library is not None:
            timed_row(row, "library_ms", library)
        rows.append(row)
        log("  probe", json.dumps(rows[-1]))
    # the launch floor: an empty kernel, timed the same way
    floor = {}
    timed_row(floor, "ms", lambda: torch.cuda._sleep(0))
    return rows, floor


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    # 1. environment
    card = gpu_name_and_power()
    log("[1] nvidia-smi:", card)
    log("[1] torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("[1] nvcc:", nvcc)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[1] allow_tf32 matmul", torch.backends.cuda.matmul.allow_tf32,
        "cudnn", torch.backends.cudnn.allow_tf32)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    log(f"[2] kernels built/loaded in {time.perf_counter() - t0:.2f} s:", lib_path.name)
    build_log = lib_path.with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("[2] ptxas:", line.strip())

    # front shapes of the flagship forward, from a CPU fp32 run at B=1;
    # the same run is phase 4's reference
    model32_cpu = seeded_unet(SEED, "cpu", **FLAGSHIP)
    gen = torch.Generator().manual_seed(SEED + 3)
    x1 = torch.rand(1, IMG, IMG, 3, generator=gen) * 2 - 1
    t1 = torch.tensor([T // 2])
    want_cpu, shapes = record_fronts(model32_cpu, x1, t1)
    log(f"[3] {len(shapes)} block fronts per forward:", shapes)

    # 3. kernel vs plain
    rows, err32, err16 = check_fronts(shapes, BATCH, dev, timed=True)
    torch.cuda.synchronize(dev)
    log(f"[3] kernel == plain at {len(rows)} fronts: fp32 max err {err32:.3e} "
        f"(<= {FRONT_FP32_ATOL}), bf16 max err {err16:.3e}")
    for r in rows:
        log(f"[3] {r['front']} {r['shape']} {r['kernel']} x{r['launches_per_forward']}: "
            + "; ".join(f"{tag} {r['ms_' + tag] * 1e3:.3f} us (call {r['call_ms_' + tag]:.4f} "
                        f"ms) vs library {r['library_ms_' + tag] * 1e3:.3f} us, plain "
                        f"{r['plain_ms_' + tag] * 1e3:.3f} us, bound "
                        f"{r['bound_us_' + tag]:.3f} us ({r['bound_by_' + tag]}, "
                        f"{100 * r['bound_share_' + tag]:.2f}%, L2 {r['l2_' + tag]})"
                        for tag in ("fp32", "bf16"))
            + (f"; host-paced runs: {r['host_paced']}" if "host_paced" in r else ""))
    tile = [r for r in rows if r["kernel"] == "tile"]
    for tag in ("fp32", "bf16"):
        log(f"[3] the {len(tile)} C >= {SMALL_C} fronts of one forward, {tag}, summed: "
            f"kernel {1e3 * sum(r['ms_' + tag] for r in tile):.3f} us, library "
            f"{1e3 * sum(r['library_ms_' + tag] for r in tile):.3f} us, bound "
            f"{sum(r['bound_us_' + tag] for r in tile):.3f} us")
    log(f"[3] card: {card}")

    # 4. UNet parity, fp32, GPU vs CPU
    model32 = seeded_unet(SEED, dev, **FLAGSHIP)
    zero_launches()
    with torch.inference_mode():
        got = model32(x1.to(dev), t1.to(dev))
    torch.cuda.synchronize(dev)
    fwd_launches, fwd_small = convnext_front.launches, convnext_front.small_c_launches
    rel = rel_l2(got, want_cpu)
    # cuDNN and oneDNN sum the 3x3 convs, the attention products and the
    # LayerNorm statistics in other orders; fp32 rounding differences of
    # ~1e-6 per layer compound through ~70 layers of random weights
    if not (rel <= UNET_REL_L2 and fwd_launches == len(shapes) == 17 and fwd_small == 1):
        raise AssertionError(f"UNet parity: rel L2 {rel}, launches {fwd_launches}, "
                             f"small-C launches {fwd_small}")
    log(f"[4] UNet fp32 cuda vs cpu rel L2 {rel:.3e} (<= {UNET_REL_L2}); "
        f"front launches per forward {fwd_launches}, of them small-C {fwd_small}")
    del model32, model32_cpu

    # 5. oracle sampler
    oracle_err = oracle_sample(dev, BATCH, IMG, T)
    if not oracle_err <= ORACLE_ATOL:
        raise AssertionError(f"oracle sampler max err {oracle_err}")
    log(f"[5] oracle x0_step_down T={T} {IMG}px B={BATCH}: max err {oracle_err:.3e}")

    # 6. main path
    model16 = seeded_unet(SEED, dev, **FLAGSHIP).to(torch.bfloat16)
    out, seconds, launches, small_launches = main_path(model16, dev, BATCH, IMG, T)
    if not (out.shape == (BATCH, IMG, IMG, 3) and out.dtype == torch.float32
            and torch.isfinite(out).all().item()):
        raise AssertionError(f"main path output {out.shape} {out.dtype} not finite/shaped")
    if launches != 17 * T or small_launches != T:
        raise AssertionError(f"main path launched the front kernels {launches} times, "
                             f"expected {17 * T}, the small-C kernel {small_launches} "
                             f"times, expected {T}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[6] main path B={BATCH} T={T} {IMG}px bf16: {seconds:.3f} s, "
        f"{BATCH / seconds:.3f} images/s, peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB), front launches {launches}, of them small-C "
        f"{small_launches}; card: {card}")

    del model16
    with tempfile.TemporaryDirectory() as folder:
        # 7. train-step parity, fp32, GPU vs CPU
        loss_err, grad_err, step_launches, step_small, nfronts, nsmall = \
            train_step_parity(dev, folder + "/p7")
        if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_REL_L2
                and step_launches == nfronts * ACCUM and step_small == nsmall * ACCUM):
            raise AssertionError(f"train-step parity: loss rel err {loss_err}, grad rel "
                                 f"L2 {grad_err}, launches {step_launches} != "
                                 f"{nfronts} x {ACCUM} or small-C {step_small} != "
                                 f"{nsmall} x {ACCUM}")
        log(f"[7] train step fp32 cuda vs cpu: loss rel err {loss_err:.3e} "
            f"(<= {TRAIN_LOSS_RTOL}), worst grad rel L2 {grad_err:.3e} "
            f"(<= {TRAIN_GRAD_REL_L2}), front launches {step_launches} = "
            f"{nfronts} fronts x {ACCUM}, of them small-C {step_small} = {nsmall} x {ACCUM}")

        # 8. the training main path
        losses, step_s, train_launches, train_small, train_peak, snap_s, bitwise = \
            train_main_path(dev, folder + "/p8")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses not finite: {losses}")
    if train_launches != 17 * ACCUM * TRAIN_STEPS or train_small != ACCUM * TRAIN_STEPS:
        raise AssertionError(f"training launched the front kernels {train_launches} "
                             f"times, expected {17 * ACCUM * TRAIN_STEPS}, the small-C "
                             f"kernel {train_small} times, expected {ACCUM * TRAIN_STEPS}")
    if not bitwise:
        raise AssertionError("checkpoint round trip is not bitwise equal")
    images = BATCH * ACCUM
    step_ms = 1e3 * sum(step_s) / len(step_s)
    log(f"[8] losses {losses}")
    log(f"[8] Trainer.train() B={BATCH} x accum {ACCUM} {IMG}px bf16, {TRAIN_STEPS} "
        f"steps, loader included: {step_ms:.3f} ms per optimizer step (median "
        f"{1e3 * float(np.median(step_s)):.3f}), {images / (step_ms / 1e3):.3f} train "
        f"images/s; peak memory {train_peak} bytes ({train_peak / 2**30:.2f} GiB); front "
        f"launches {train_launches}, of them small-C {train_small}; the step with save + EMA snapshot (T={T}) "
        f"{snap_s:.3f} s; checkpoint round trip bitwise; card: {card}")

    # 9. probes
    probes, floor = probe_kernels(dev)
    log("[9] probes: " + ", ".join(f"{r['name']} max err {r['max_abs_err']:.3e} "
                                    f"{r['ms'] * 1e3:.3f} us vs plain "
                                    f"{r['plain_ms'] * 1e3:.3f} us, bound "
                                    f"{r['bound_us']:.3f} us" for r in probes)
        + f"; launch floor (torch.cuda._sleep(0)) {floor['ms'] * 1e3:.3f} us"
        + (" (host-paced)" if "host_paced" in floor else "") + f"; card: {card}")

    # 10. the wide-C front
    wide_rows, wide32, wide16, wide_rel, wide_all, wide_small, wide_launches = \
        wide_c_fronts(dev, (x1, t1))
    if not (wide_rel <= UNET_REL_L2 and (wide_all, wide_small, wide_launches) == (17, 1, 1)):
        raise AssertionError(f"dim={WIDE_DIM} UNet: rel L2 {wide_rel}, launches "
                             f"{(wide_all, wide_small, wide_launches)}, expected (17, 1, 1)")
    w0 = wide_rows[0]
    log(f"[10] cluster form == plain at {[r['shape'] for r in wide_rows]}: fp32 max err "
        f"{wide32:.3e} (<= {FRONT_FP32_ATOL}), bf16 max err {wide16:.3e}; each call "
        f"allocated its output alone")
    for r in wide_rows:
        log(f"[10] {r['shape']}: "
            + "; ".join(f"{tag} ({cluster_label(r['cluster_' + tag])}) "
                        f"{r['ms_' + tag] * 1e3:.3f} us (call {r['call_ms_' + tag]:.4f} "
                        f"ms) vs library {r['library_ms_' + tag] * 1e3:.3f} us, plain "
                        f"{r['plain_ms_' + tag] * 1e3:.3f} us, bound "
                        f"{r['bound_us_' + tag]:.3f} us ({r['bound_by_' + tag]}, "
                        f"{100 * r['bound_share_' + tag]:.2f}%)" for tag in ("fp32", "bf16"))
            + (f"; host-paced runs: {r['host_paced']}" if "host_paced" in r else ""))
    log(f"[10] UnetConvNext(dim={WIDE_DIM}) fp32 cuda vs cpu rel L2 {wide_rel:.3e} (<= "
        f"{UNET_REL_L2}), front launches {wide_all}, small-C {wide_small}, wide-C "
        f"{wide_launches}; card: {card}")

    # 11-14. the other workflows' sampling paths; 14-15 their training
    model16 = seeded_unet(SEED, dev, **FLAGSHIP).to(torch.bfloat16)
    flows = workflows(model16, dev, card)
    with tempfile.TemporaryDirectory() as folder:
        fgen_row = next(r for r in flows if r["op"] == "FadeGeneration")
        d = ColdDiffusion(op=get_operator("fade_generation", image_size=IMG, timesteps=750,
                                          reverse=True, kernel_std=0.05, device=dev),
                          image_size=IMG, sampling_routine="x0_step_down")
        # the Trainer itself is not kept: later phases measure peak memory
        ips, peak, fg_launches = train_workflow(d, dev, folder + "/p14", IMG, 3,
                                                snapshot=True)[1:]
        fgen_row.update(train_images_per_s=ips, train_peak_bytes=peak,
                        train_launches=fg_launches)
        log(f"[14] fade_generation Trainer.train() B={BATCH} x accum {ACCUM} {IMG}px bf16, "
            f"3 steps (the last with save + EMA snapshot, T=750): {ips:.3f} train images/s "
            f"(median of the 2 steps without the snapshot), peak memory {peak} bytes "
            f"({peak / 2**30:.2f} GiB), front launches {fg_launches}; card: {card}")
        flows.append(random_fade_path(dev, folder + "/p15", card))
    # 16. all_sample
    flows.append(trajectories(model16, dev, card))
    del model16
    log("[11-16] " + json.dumps(flows))

    def front_entry(name, kernel, row, launched, train_launched, max_abs_err):
        """The kernels-line entry of one front kernel at ``row``'s shape, bf16
        (the main path's dtype); max_abs_err is fp32, over its fronts."""
        return {
            "name": name, "kernel": kernel, "route": "cuda",
            "source": "colddiff_torch/csrc/convnext_front.cu",
            "replaces": "colddiff/ops/pallas/convnext_front.py:129",
            "launches": launched, "train_launches": train_launched,
            "max_abs_err": max_abs_err,
            "shape": row["shape"], "dtype": "bfloat16", "ms": row["ms_bf16"],
            "plain_ms": row["plain_ms_bf16"], "library_ms": row["library_ms_bf16"],
            "bound_ms": row["bound_us_bf16"] / 1e3, "bound_us": row["bound_us_bf16"],
            "bound_by": row["bound_by_bf16"],
        }

    stem = next(r for r in rows if r["kernel"] == "small_c")
    level0 = next(r for r in rows if r["shape"][1:] == [IMG, IMG, 64] and r["cond"])
    kernels = [
        front_entry("convnext_front_small_c", "convnext_front_small_c_kernel", stem,
                    small_launches, train_small,
                    max(r["max_abs_err_fp32"] for r in rows if r["kernel"] == "small_c")),
        front_entry("convnext_front", "convnext_front_tile_kernel", level0,
                    launches - small_launches, train_launches - train_small,
                    max(r["max_abs_err_fp32"] for r in rows if r["kernel"] == "tile")),
        # launches: the dim=80 forward of phase 10, the path that has a C > 1024 front
        front_entry("convnext_front_wide_c",
                    "convnext_front_tile_kernel, cluster form (TileCfg SPLIT: k blocks a "
                    "tile, LayerNorm sums through distributed shared memory), "
                    + cluster_label(w0["cluster_bf16"]), w0, wide_launches, None, wide32),
    ] + [{
        "name": r["name"], "route": "cuda",
        "source": "colddiff_torch/csrc/bisect_mosaic.cu", "replaces": r["replaces"],
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_us": r["bound_us"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "float4_path": r.get("float4_path"),
    } for r in probes]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
