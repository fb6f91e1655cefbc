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
     image; peak memory;
 17-20. the last four workflows (docs/USAGE.md:44-84), as 11-15:
     17. hot-noise generation, 128 px: ``noise`` T=200 from N(0, I), with
         ddim and with x0_step_down (a fixed endpoint);
     18. animorphosis, 128 px: ``mix`` T=200, endpoints from a second
         synthetic image set made from a seed; x0_step_down with a fixed
         endpoint, then 3 ``Trainer.train()`` steps with ``second_dataset``
         whose last takes the checkpoint and the snapshot;
     19. desnowification, CelebA-128: ``snow`` level 4, T=200, random_snow,
         fix_brightness; x0_step_down, then again with recon_noise_std
         0.01 (the degrade's input is the noisy reconstruction, its ``og``
         the clean one); 3 ``Trainer.train()`` steps, each resetting the
         fields, and the host time of one reset; the degrade with
         fix_brightness off checked too;
     20. spiral inpainting, 32 px: ``fade_naive`` Spiral_2 at the CLI's
         T=50, with x0_step_down_spiral_2_fix and _rand.
 21. CIFAR-10 deblurring with the ResNet UNet at full width,
     ``get_model("UnetResNet", dataset="cifar10")`` (35.7M parameters,
     dropout 0.1), blur Special_6_routine T=50 at 32 px: the fp32 forward
     on the card vs the CPU; bf16 prepare_start + sample at B=32 (images/s,
     peak memory); ``Trainer.train()`` B=32 x accum 2, bf16, dropout from
     the Trainer's dropout generator (train images/s, ms a step, peak
     memory); one state and one dropout seed give one loss, another seed
     another; the checkpoint round trip and ``load_torch_path`` of a
     reference-named blob; ssim / rmse / psnr of the samples on the card vs
     the CPU.  The ResNet launches no front kernel (checked);
 22. the other training routines, each through ``Trainer.train()`` and a
     sampling run: ``Final_small_noise``, ``Final_random_mean``,
     ``Final_random_mean_and_actual`` and ``Gradient_norm`` on
     super-resolution (T=4, 128 px) with the flagship UNet (17 fronts a
     forward checked), ``Step`` and ``Step_Gradient`` on random snow
     (level 3, T=200, fix_brightness, 32 px) with the ResNet;
 23. ``sample_multi_step`` on phase 21's configuration, per-sample t_start
     and t_end: an oracle denoiser ends each sample at the clean batch
     degraded to its t_end, and the fp32 ResNet's run on the card matches
     its CPU run.
 24. the eval surface on the flagship path (``EvalHarness``, bf16 compute,
     ``model_chunk`` 16): ``fid_distance_decrease_from_manifold`` over 64
     synthetic 128 px images at batch_size 32 with the fallback extractor,
     timed (images/s, peak memory), its front launches checked (17 a
     forward, the stem through the small-C kernel, two chunks a step), its
     first batch's samples checked equal to a direct prepare_start +
     sample, and its metric dict held against RMSE, SSIM and the proxy FID
     recomputed on the CPU from the card's images; ``gmm_mean_samples``
     (num 16) with its fronts counted; the Inception pool3 graph on
     ``synth_state_dict`` weights on the card vs the CPU at B=8 and its
     card time per image at B=64; ``fit_gmm`` on the card vs the CPU from
     one init.
 25. the command line on the flagship path, over 64 seeded 160x160 PNGs
     read by the CLI's ``folder`` dataset: ``python -m
     colddiff_torch.cli.main train`` (blur Exponential_reflect T=200 kernel
     15 std 0.01, 128 px, dim 64, B=16 x accum 2, bf16) as a subprocess,
     20 steps under its restart supervisor with ``--restart_every_steps
     10`` (exactly one respawn; ``model.pt`` at step 20 and its four
     sample grids); then, in this process, ``main(["test", ...,
     "--test_type", "test_fid_distance_decrease_from_manifold",
     "--test_end", "32"])`` from that checkpoint, with its front launches
     checked (17 a forward, T=200 a batch of 16) and ``refresh_every`` 1
     stamped; one flagship ``Trainer`` step with ``remat`` and one
     without, from one state and one batch and t (equal losses, equal
     updates within the bf16 train-step tolerance, the recompute's second
     forward counted in the launches, the peak memory of each); one CLI
     ``train`` step of ``decolor --to_lab`` with its snapshot, and
     ``rgb2lab``/``lab2rgb`` on the card vs the CPU; a ``Trainer``
     profiler window (steps 1-3) whose trace names the tile kernel.
 26. parallelism (``colddiff_torch.parallel``): (a) phase 8's ``Trainer``
     at full width, 3 timed steps after a warm-up with no process group,
     then under ``init_multihost`` (a group of one process, NCCL)
     replicated and with ``param_sharding="fsdp"``, then once more without
     a group after its end, each from one state and one batch stream, its
     losses and updates held against the run without a group within the
     bf16 train-step tolerance (train images/s, peak memory, 17 front
     launches a forward), and the FSDP run's ``model.pt`` loaded bitwise
     into a ``Trainer`` of one process; (b) ``python -m
     colddiff_torch.scripts.dryrun_multichip --n 2 --flagship`` as a call:
     two processes sharing the card over gloo with CUDA tensors, one
     replicated step (8 images a process x accum 2) and a T=200 sample of
     16 held against one process, each process's front launches counted,
     and one FSDP step; (c) in the same group, the manifold harness with
     ``mesh=`` over 64 images, its metrics equal to phase 24's dict.
 27. row (spatial) sharding: ``dryrun_multichip.run(2, flagship=True,
     space=2)``, two processes sharing the card over gloo on a (1, 2)
     ``make_mesh_2d`` mesh, each holding 64 of the 128 rows of every
     image inside ``parallel.image_rows``: (a) the flagship's 17 block
     fronts (B=2) on row halves through the front kernel, which runs on the
     block extended by 3 rows of its neighbour, against the whole-image
     kernel, fp32 (<= 1e-4) and bf16 (<= 2e-2), with whether each is
     bitwise equal; (b) an fp32 forward at B=2, gathered, against one
     process (rel L2 <= 1e-3), with the collectives a forward makes; (c) a
     bf16 prepare_start + sample (T=200, B=2: fewer images than processes'
     row blocks, the latency case) against one process (rel L2 <= 2e-2),
     3,400 front launches on each process, and each process's wall seconds
     beside one process's; (d) in this process, a group of one (NCCL) on a
     (1, 1) mesh: the fp32 forward and the bf16 T=200 sample inside
     ``image_rows`` bitwise equal to the run without a group (cuDNN held
     to its deterministic algorithms: its fp32 transposed conv is not
     bitwise repeatable from call to call otherwise).
 28. row sharding on every other workflow: ``dryrun_multichip.run(2,
     flagship=True, space=2, workflows=...)``, two processes sharing the
     card over gloo on a (1, 2) mesh, B=2: (a) each of phases 11-20's
     workflows at its published size with the flagship UNet (fade T=100,
     resolution Incremental_factor_2 T=4, decolor T=20 with ``to_lab`` off
     and on, fade_generation T=750 x0_step_down and ddim, noise ddim and
     x0_step_down, mix, snow level 4 random_snow with and without
     recon_noise_std 0.01, all at 128 px; Random_Incremental fade and
     fade_naive Spiral_2 fix and rand at 32 px): the degrade at T in fp32,
     gathered, against one process (relative to max |y|, <= 1e-5), the
     random draws (endpoints, crops, snow fields) equal to one process's,
     an fp32 forward (rel L2 <= 1e-3, the collectives by kind) and a bf16
     prepare_start + sample from level min(T, 8) (rel L2 <= 2e-2) against
     one process, 17 front launches a forward on each process; (b) phase
     21's CIFAR-10 ResNet (blur Special_6_routine T=50, 32 px): the fp32
     forward (rel L2 <= 1e-3; halos, sums and row gathers), an fp32 T=50
     sample of 2 (<= 1e-3) and a bf16 one (<= 2e-2, or twice the rel L2
     between one process's run of the 2 images as one batch and one at a
     time where that is more: bf16 rounding alone moves this sample ~4e-2)
     against one process, no front launch; (c) the
     flagship's fp32 loss (phase 8's configuration, t given, cuDNN
     deterministic) against one process (rtol 1e-5) and its gradients
     summed over the two processes (rel L2 <= 1e-3).  Each row's wall
     seconds a process beside one process's.
 29. the loaders' native helper (``colddiff_torch/data/native.py``, host
     C++ built with g++ on the card's host): a fresh build timed; the
     batches of the native path against its numpy path
     (``COLDDIFF_NO_NATIVE``), at most float32's eps apart (one ulp of
     1.0; the elements that differ counted): B=16 ``aug1`` crops of 160 px
     PNGs at 128 px through ``ImageFolderDataset`` and B=32 CIFAR-10 pad-4
     crops through ``ArrayDataset``; each path's median host ms a batch
     over rounds that run the two in turns (the folder batch with and
     without the PNG decode and resize); and phase
     25's in-process ``test`` checked to have cropped through the native
     helper.
 30. the record workflows (``colddiff_torch/scripts/``: the twins of the
     JAX package's five record scripts), each through its ``main`` at full
     width (``UnetConvNext(64, (1, 2, 4, 8))``, 64 or 128 px, full T) but
     short, writing under a temporary folder: ``train_loss_parity`` (20
     steps fp32 and bf16 at 128 px), ``refresh_quality`` (16 images on
     the fp32 run's checkpoint, K = 1/2/4/8 fp32 and 1/4/8 bf16),
     ``family_b_generation`` (20 steps, 32 images from noise by
     x0_step_down and ddim), ``family_b_refresh_quality`` (32 images on
     that checkpoint) and ``gmm_generation`` (20 bf16 steps, 32 GMM
     images at noise 0.0 and 0.002); each checked for its front launches
     (17 a forward, the stem through the small-C kernel), finite losses
     that fall over the 20 steps, every key of the JAX record it twins
     (``docs/examples/*.json``), and ``docs/examples/`` left byte for byte
     as it was; then a Family-B run of 10 steps resumed to 20 against an
     unbroken 20-step run, bitwise, under cuDNN's deterministic mode (set
     for that check alone and restored).
 31. the initialisation: the flagship and ``get_model("UnetResNet",
     dataset="cifar10")`` built through the CLI's ``build`` with ``--seed``,
     each held to the JAX package's rule (``layers.init_as_flax``): the
     pooled std of w * sqrt(fan_in) within 1 +- 0.01, no |w| * sqrt(fan_in)
     past lecun_normal's cut 2 / 0.8796, zero biases, norms at one and zero,
     and a second build bitwise equal; the flagship's initial fp32
     ``ColdDiffusion.loss`` on one synthetic batch of 16 (beside the JAX
     record's first-10 mean) and its output std.

 32. the GroupNorm-swish kernel (``colddiff_torch/csrc/group_norm_swish.cu``,
     which replaces no TPU kernel): at each (C, H, swish) of the CIFAR-10
     ResNet's 51 calls a forward, at B=256 in bf16, against the plain
     version (within two bf16 ulps, at most 1% of elements not bitwise
     equal, two runs bitwise equal), its form, and its device time beside
     its bound, the plain chain's and one ``F.group_norm`` call's, summed
     over the forward; the streaming form at (256, 64 px) and (128, 128 px)
     in bf16 and fp32; and the ResNet's bf16 ``Trainer.train_step`` at
     B=128 with the plain chain (the path before the kernel) and with the
     kernel, a Trainer a turn (plain, kernel, kernel, plain).

 33. the GroupNorm-swish kernel with a per-image [B, C] affine (ADM's
     AdaGN, ``models/unet_adm.py``) at (8, 256, 256 px), ADM's widest
     256 px shape at B=8, in bf16: against the plain version, two runs
     bitwise equal, each image bitwise equal to a [C] call with its own
     gamma and beta, one launch a call, its form, and its device time beside
     its bound and the [C] call's.

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
kernels, after phases 27 and 28's launch counts; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from colddiff_torch.data import ArrayDataset, ImageFolderDataset, SyntheticDataset
from colddiff_torch.data import native
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.eval import EvalHarness, fit_gmm, metrics
from colddiff_torch.eval import fid as fid_mod
from colddiff_torch.models import UnetConvNext, get_model
from colddiff_torch.models.convert import load_reference_checkpoint
from colddiff_torch.cli import main as cli_main
from colddiff_torch.models import layers
from colddiff_torch.models.layers import ChannelLayerNorm, ConvNextBlock
from colddiff_torch.operators import get_operator
from colddiff_torch.ops import _build
from colddiff_torch.ops import bisect_mosaic as probe_ops
from colddiff_torch.ops import group_norm as gn_ops
from colddiff_torch.ops.convnext_front import (SMALL_C, TILE_MAX_CHANNELS, cluster_config,
                                              convnext_front, convnext_front_plain)
from colddiff_torch.ops.image import lab2rgb, rgb2lab
from colddiff_torch import parallel
from colddiff_torch.sampling import all_sample, prepare_start, sample, sample_multi_step
from colddiff_torch.scripts import bisect_mosaic as probe_script
from colddiff_torch.scripts import dryrun_multichip
from colddiff_torch.train import Trainer

SEED = 0
BATCH = 16
SNOW_RECON_NOISE = 0.01  # phase 19: enough to make the degrade's input differ from og
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
CIFAR = 32  # phases 21-23: CIFAR-10 with the ResNet UNet of get_model
RESNET_BATCH = 32
RESNET_NORMS = 51  # its GroupNorm-swish calls a forward, each one kernel launch on the card
CIFAR_T = 50  # blur Special_6_routine (BASELINE.md:24)
ROUTINE_STEPS = 2  # phase 22: Trainer.train() steps a routine, after one warm-up
MULTI_STEP_CPU_BATCH = 4  # phase 23: the fp32 model run on the card vs the CPU
EVAL_IMAGES = 64  # phase 24: the manifold harness's images, in batches of 32
EVAL_BATCH = 32
EVAL_CHUNK = 16  # the harness's model_chunk: two forwards a reverse step
EVAL_GMM_NUM = 16
FID_RTOL = 1e-3  # a proxy FID from the card's features vs the CPU's (atol 1e-4)
INCEPTION_REL_L2 = 1e-3  # ~96 fp32 conv layers, cuDNN vs oneDNN summation orders
INCEPTION_CHECK_B, INCEPTION_TIME_B = 8, 64
GMM_REL = 1e-4  # fit_gmm's fields on the card vs the CPU, relative to each field's max
METRIC_REL = 1e-5  # ssim / rmse / psnr on the card vs the CPU
DEGRADE_REL = 1e-5  # an operator's degrade on the card vs the CPU, relative to max |y|
TRAJ_STRIDE = 10
CLI_IMAGES, CLI_SIDE = 64, 160  # phase 25: the PNGs of the CLI's folder dataset
CLI_STEPS, CLI_RESTART = 20, 10  # supervised train steps, a worker's steps
CLI_TEST_END = 32  # the manifold test's images, in batches of BATCH
CLI_LAB_T = 20  # the to_lab decolor step (phase 13's T)
PROFILE_STEPS = (1, 3)
REMAT_UPDATE_REL_L2 = 2e-2  # the bf16 train-step tolerance of the port's tests
PAR_STEPS = 3  # phase 26: timed Trainer steps a placement, after one warm-up
PAR_LOSS_RTOL = 1e-3  # a step's loss against the one without a process group
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-5  # a mesh harness's metrics (tests/test_parallel.py)
SPACE = 2  # phase 27: processes on the space axis, sharing the card
NATIVE_FOLDER_B, NATIVE_CIFAR_B = 16, 32  # phase 29: a batch of each loader
NATIVE_REPS = 20  # timed rounds of both paths in turns; each path's median is kept
NATIVE_MAX_DIFF = float(np.finfo(np.float32).eps)  # v * (2/255) - 1 vs v / 255 * 2 - 1
LAB_REL = 1e-5  # rgb2lab / lab2rgb on the card vs the CPU, relative to max |y|
REC_STEPS, REC_RESUME_AT = 20, 10  # phase 30: a twin's train steps; the resume's cut
REC_N_GEN, REC_REFRESH_IMAGES = 32, 16  # images a generation twin makes; a sweep's
REC_FALL = 5  # the losses averaged at each end of a parity run
# phase 31: lecun_normal's cut of w * sqrt(fan_in), and the band of the pooled
# std of w * sqrt(fan_in) (1 by the rule; over >= 35M weights its sampling
# error is ~1e-4, and torch's default rule gives 1/sqrt(3) = 0.577)
INIT_BOUND = 2.0 / 0.87962566103423978
INIT_STD_TOL = 0.01
JAX_FIRST10_LOSS = 0.65449  # docs/examples/train_bf16_parity.json, fp32 first-10 mean
REC_JAX = {"train_loss_parity": "train_bf16_parity.json",
           "refresh_quality": "refresh_quality.json",
           "family_b_generation": "family_b_generation.json",
           "family_b_refresh_quality": "family_b_refresh_quality.json",
           "gmm_generation": "gmm_generation.json"}
# phase 32: the GroupNorm-swish kernel at the sample cell's batch, the
# streaming form's shapes (C, H) at 64 and 128 px at GN_STREAM_BATCH, and
# the ResNet's bf16 train step at GN_TRAIN_BATCH on both paths
GN_BATCH, GN_STREAM_BATCH, GN_TRAIN_BATCH = 256, 16, 128
GN_STREAM_SHAPES = ((256, 64), (128, 128))
GN_TRAIN_STEPS = 20  # timed steps a turn, after 3 warm-up steps
ADA_GN_SHAPE = (8, 256, 256)  # phase 33: (B, C, H) of ADM's 256 px AdaGN calls in its train cell
GN_FP32_TOL = 1e-5  # the statistics' summation order only
GN_BF16_TOL = 2.0 ** -6  # a normalized value on the other bf16 neighbour, carried
GN_BF16_MISMATCH = 0.01  # through the rounded product and sum; rarely
REPO = Path(__file__).resolve().parent
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


def seeded_weights(model: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """``model`` with weights drawn from a seeded torch.Generator:
    uniform(+-1/sqrt(fan_in)) weights and biases, norm scales 1 and offsets
    0 (ConvNeXt LayerNorm g, b; ResNet GroupNorm weight, bias); in eval()."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, (ChannelLayerNorm, torch.nn.GroupNorm)):
                p.fill_(1.0 if name.endswith((".g", ".weight")) else 0.0)
            else:
                bound = 1.0 / math.sqrt(owner.weight[0].numel())
                p.uniform_(-bound, bound, generator=gen)
    return model.to(device).eval()


def seeded_unet(seed: int, device, **cfg) -> UnetConvNext:
    return seeded_weights(UnetConvNext(**cfg), seed, device)


def seeded_resnet(seed: int, device) -> torch.nn.Module:
    """The CIFAR-10 ResNet UNet of ``get_model`` (ch 128, (1,2,2,2), 2 res
    blocks, attention at 16 px, dropout 0.1, 32 px), seeded weights."""
    return seeded_weights(get_model("UnetResNet", dataset="cifar10"), seed, device)


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
               and all(torch.equal(v, b["op"][name]) for name, v in a["op"].items())
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
    gn_ops.group_norm_swish.launches = 0


def norm_launches() -> int:
    """GroupNorm-swish kernel launches since ``zero_launches``."""
    return gn_ops.group_norm_swish.launches


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
                lab=False, fronts: int = 17, keep=None):
    """prepare_start + sample with the bf16 UNet, timed from a clean batch;
    checks the output and the launch counts (``fronts`` fronts a forward,
    one of them small-C: 17 for UnetConvNext, 0 for UnetResNet, whose
    forward launches RESNET_NORMS GroupNorm-swish kernels instead).  A routine
    that draws (recon_noise_std, the spiral endpoint redrawn each step)
    draws from a seeded generator.  Returns a dict of the run's numbers;
    ``keep``, a dict, also receives the clean batch and the samples."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    img = torch.rand(batch, size, size, 3, generator=gen, device=device) * 2 - 1
    if lab:
        img = rgb2lab(img)
    x_end = None if x_end_fn is None else x_end_fn(gen, img)
    denoise = bf16_denoise(model)
    sample(d, denoise, prepare_start(d, img, 2, x_end=x_end), t=2, x_end=x_end,
           generator=gen)  # warm-up
    base = reset_peak(device)
    zero_launches()
    t0 = time.perf_counter()
    out = sample(d, denoise, prepare_start(d, img, x_end=x_end), x_end=x_end,
                 generator=gen).img
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches, small, wide = launch_counts()
    norms = norm_launches()
    if keep is not None:
        keep.update(img=img, out=out)
    steps = d.num_timesteps
    if not (out.shape == img.shape and torch.isfinite(out).all().item()):
        raise AssertionError(f"{type(d.op).__name__} sample: {out.shape}, not finite/shaped")
    small_want, norms_want = (steps, 0) if fronts else (0, RESNET_NORMS * steps)
    if (launches, small, wide, norms) != (fronts * steps, small_want, 0, norms_want):
        raise AssertionError(f"{type(d.op).__name__} sample launched {launches} fronts, "
                             f"{small} small-C, {wide} wide-C, {norms} GroupNorms; expected "
                             f"{fronts * steps}, {small_want}, 0, {norms_want}")
    return dict(op=type(d.op).__name__, routine=d.sampling_routine, T=steps, batch=batch,
                size=size, seconds=seconds, images_per_s=batch / seconds,
                peak_bytes=torch.cuda.max_memory_allocated(device), base_bytes=base,
                launches=launches, small_c_launches=small, norm_launches=norms)


def log_sample_row(row, card: str, what: str = "") -> None:
    """One line for a ``sample_path`` row with its checks."""
    log(f"[{row['phase']}] {row['op']} {row['routine']} T={row['T']} B={row['batch']} "
        f"{row['size']}px{what}: {row['seconds']:.3f} s, "
        f"{row['images_per_s']:.3f} images/s, peak memory {row['peak_bytes']} bytes "
        f"({row['peak_bytes'] / 2**30:.2f} GiB; {row['base_bytes']} allocated before "
        f"the run), front launches {row['launches']}, of "
        f"them small-C {row['small_c_launches']}, GroupNorm launches "
        f"{row['norm_launches']}; degrade cuda vs cpu rel err "
        f"{row['degrade_rel_err']:.3e}, oracle rel err {row['oracle_rel_err']:.3e}; "
        f"card: {card}")


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
        log_sample_row(row, card, " to_lab" if row["to_lab"] else "")
        rows.append(row)
    return rows


def train_workflow(d: ColdDiffusion, device, folder: str, size: int, steps: int,
                   snapshot: bool, second_dataset=None, model=None, batch: int = BATCH,
                   fronts: int = 17):
    """``Trainer.train()`` at full width (B=16 unless ``batch``, accum 2,
    bf16) of ``model`` (the flagship UNet unless given) for one warm-up step
    and ``steps`` more, the last with the checkpoint and the EMA sample
    grids when ``snapshot``, with mix's endpoint images when
    ``second_dataset`` is given; checks the losses and the launch counts
    (``fronts`` a forward: 17 for UnetConvNext, 0 for UnetResNet, whose
    forward launches RESNET_NORMS GroupNorm-swish kernels instead and whose
    backward recomputes them in plain PyTorch; one forward a microbatch,
    two under Final_random_mean_and_actual, plus one a reverse step of the
    snapshot).  Returns (trainer, train images/s from metrics.jsonl, peak
    bytes, front launches, GroupNorm-swish launches)."""
    kw = dict(train_batch_size=batch, gradient_accumulate_every=ACCUM, bf16=True,
              save_and_sample_every=(1 + steps) if snapshot else 10**9,
              results_folder=folder, num_workers=8, seed=SEED, device=device,
              second_dataset=second_dataset)
    model = seeded_unet(SEED, device, **FLAGSHIP) if model is None else model
    tr = Trainer(d, model, SyntheticDataset(size, 3, length=64), train_num_steps=1, **kw)
    tr.train(log_every=1)
    reset_peak(device)
    zero_launches()
    tr.train_num_steps = 1 + steps
    tr.train(log_every=1)
    launches, small, _ = launch_counts()
    norms = norm_launches()
    per_loss = 2 if d.train_routine == "Final_random_mean_and_actual" else 1
    forwards = per_loss * ACCUM * steps + (d.num_timesteps if snapshot else 0)
    want, norms_want = fronts * forwards, 0 if fronts else RESNET_NORMS * forwards
    if launches != want or small * fronts != want or norms != norms_want:
        raise AssertionError(f"{type(d.op).__name__} training launched {launches} fronts "
                             f"({small} small-C) and {norms} GroupNorms, expected {want} "
                             f"and {norms_want}")
    lines = [json.loads(x) for x in tr.metrics_path.read_text().splitlines()]
    losses = [x["loss"] for x in lines]
    if len(lines) != 1 + steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training metrics {lines}")
    if snapshot and not (tr.results_folder / "sample-1.png").is_file():
        raise AssertionError("snapshot wrote no sample-1.png")
    timed = lines[1:1 + steps - (1 if snapshot else 0)] or lines[1:]
    ips = float(np.median([x["images_per_sec"] for x in timed]))
    return tr, ips, torch.cuda.max_memory_allocated(device), launches, norms


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
    tr, ips, peak, launches, _ = train_workflow(dataclasses.replace(d, op=counted), device,
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


def last_workflows(model, device, folder: str, card: str):
    """Phases 17-20: hot noise, animorphosis (with its training through
    ``second_dataset``), desnowification (with og live and its training)
    and spiral inpainting; returns the result rows."""
    def op(name, **cfg):
        return get_operator(name, **cfg, device=device)

    def drawn(d):
        return lambda gen, x: d.op.sample_x_end(gen, x)

    # mix's endpoints: a second synthetic image set, made from a seed
    second = SyntheticDataset(IMG, 3, length=64, seed=SEED + 11)

    def from_second(gen, x):
        return torch.from_numpy(np.stack([second[i] for i in range(x.shape[0])])).to(x.device)

    noise_op = op("noise", timesteps=T)
    mix = ColdDiffusion(op=op("mix", timesteps=T), image_size=IMG,
                        sampling_routine="x0_step_down")
    snow = ColdDiffusion(op=op("snow", image_size=IMG, timesteps=T, snow_level=4,
                               random_snow=True, fix_brightness=True, seed=SEED),
                         image_size=IMG, sampling_routine="x0_step_down")
    spiral_op = op("fade_naive", image_size=32, timesteps=50, fade_routine="Spiral_2")
    runs = [("17", ColdDiffusion(op=noise_op, image_size=IMG, sampling_routine=r), IMG, True)
            for r in ("ddim", "x0_step_down")]
    runs += [("18", mix, IMG, None), ("19", snow, IMG, False),
             ("19", dataclasses.replace(snow, recon_noise_std=SNOW_RECON_NOISE), IMG, False)]
    runs += [("20", ColdDiffusion(op=spiral_op, image_size=32, sampling_routine=r), 32, True)
             for r in ("x0_step_down_spiral_2_fix", "x0_step_down_spiral_2_rand")]
    rows = []
    for phase, d, size, own_end in runs:
        x_end_fn = from_second if own_end is None else drawn(d) if own_end else None
        # the oracle runs x0_step_down without recon noise
        check = dataclasses.replace(d, recon_noise_std=0.0)
        deg, oracle = check_operator(check, size, device, x_end_fn=x_end_fn)
        row = sample_path(d, model, device, BATCH, size, x_end_fn=x_end_fn)
        row.update(phase=phase, recon_noise_std=d.recon_noise_std, degrade_rel_err=deg,
                   oracle_rel_err=oracle)
        log_sample_row(row, card, f" recon_noise_std {d.recon_noise_std}"
                       if d.recon_noise_std else "")
        rows.append(row)

    # 19: the blend from og's brightness (fix_brightness off), on the card vs the CPU
    bright = snow.op.to(device)
    bright.fix_brightness = False
    deg_bright = check_operator(dataclasses.replace(snow, op=bright), IMG, device)[0]

    # 18 and 19: Trainer.train(); mix with its endpoint dataset and a snapshot
    mix_row = next(r for r in rows if r["op"] == "Animorphosis")
    ips, peak, launches = train_workflow(mix, device, folder + "/p18", IMG, 3, snapshot=True,
                                         second_dataset=second)[1:4]
    mix_row.update(train_images_per_s=ips, train_peak_bytes=peak, train_launches=launches)
    log(f"[18] mix Trainer.train() with second_dataset B={BATCH} x accum {ACCUM} {IMG}px "
        f"bf16, 3 steps (the last with save + EMA snapshot, T={T}): {ips:.3f} train "
        f"images/s (median of the 2 steps without the snapshot), peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB), front launches {launches}; card: {card}")
    tr, ips, peak, launches, _ = train_workflow(snow, device, folder + "/p19", IMG, 3,
                                                snapshot=False)
    if torch.equal(tr.diffusion.op.snow, snow.op.snow):
        raise AssertionError("random snow: the Trainer's steps did not reset the fields")
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tr.diffusion.op.reset(gen, BATCH)
    torch.cuda.synchronize(device)
    reset_ms = 1e3 * (time.perf_counter() - t0)
    del tr
    snow_row = next(r for r in rows if r["op"] == "Snow" and not r["recon_noise_std"])
    snow_row.update(train_images_per_s=ips, train_peak_bytes=peak, train_launches=launches,
                    reset_host_ms=reset_ms, degrade_rel_err_brightness=deg_bright)
    log(f"[19] snow Trainer.train() B={BATCH} x accum {ACCUM} {IMG}px bf16, 3 steps, "
        f"random_snow (fields reset every step): {ips:.3f} train images/s (median), peak "
        f"memory {peak} bytes ({peak / 2**30:.2f} GiB), front launches {launches}; one "
        f"reset {reset_ms:.3f} ms on the host (fields [{T}, 1, {IMG}, {IMG}] x 2); degrade "
        f"with fix_brightness off cuda vs cpu rel err {deg_bright:.3e}; card: {card}")
    return rows


def cifar_blur(device) -> ColdDiffusion:
    """CIFAR-10 deblurring (BASELINE.md:24): blur Special_6_routine T=50,
    kernel 11, sigma i/100 + 0.35, x0_step_down."""
    op = get_operator("blur", image_size=CIFAR, timesteps=CIFAR_T,
                      blur_routine="Special_6_routine", kernel_size=11, device=device)
    return ColdDiffusion(op=op, image_size=CIFAR, sampling_routine="x0_step_down")


def resnet_cifar(device, folder: str, card: str):
    """Phase 21: CIFAR-10 deblurring with the ResNet UNet at full width:
    (a) the fp32 forward on the card vs the CPU; (b) bf16 prepare_start +
    sample at B=32; (c) Trainer.train() for one warm-up step and 2 timed
    ones, B=32 x accum 2, bf16, dropout live; (d) two train_steps from one
    state and one dropout seed give one loss, another seed another; (e) the
    checkpoint round trip, and load_torch_path of a reference-named blob;
    (e2) ssim, rmse and psnr of the samples on the card vs the CPU.  No
    front kernel launches here (the JAX twin reaches no Pallas kernel);
    RESNET_NORMS GroupNorm-swish launches a forward, counted in (a)-(c).
    Returns the phase's row."""
    t_phase = time.perf_counter()
    # (a)
    gen = torch.Generator().manual_seed(SEED + 13)
    x = torch.rand(4, CIFAR, CIFAR, 3, generator=gen) * 2 - 1
    t = torch.tensor([0, 12, 31, CIFAR_T - 1])
    model_cpu, model = seeded_resnet(SEED, "cpu"), seeded_resnet(SEED, device)
    with torch.inference_mode():
        want = model_cpu(x, t)
        zero_launches()
        got = model(x.to(device), t.to(device))
        torch.cuda.synchronize(device)
    del model_cpu
    rel = rel_l2(got, want)
    params = sum(p.numel() for p in model.parameters())
    if not (rel <= UNET_REL_L2 and launch_counts() == (0, 0, 0)
            and norm_launches() == RESNET_NORMS):
        raise AssertionError(f"ResNet UNet fp32 cuda vs cpu: rel L2 {rel}, front launches "
                             f"{launch_counts()}, GroupNorm launches {norm_launches()}")
    log(f"[21a] UnetResNet CIFAR-10 ({params} parameters) fp32 cuda vs cpu rel L2 "
        f"{rel:.3e} (<= {UNET_REL_L2}), front launches 0, GroupNorm launches "
        f"{RESNET_NORMS}")
    # (b)
    d = cifar_blur(device)
    deg, oracle = check_operator(d, CIFAR, device)
    keep = {}
    row = sample_path(d, model.to(torch.bfloat16), device, RESNET_BATCH, CIFAR, fronts=0,
                      keep=keep)
    del model
    row.update(phase="21", params=params, fp32_rel_l2=rel, degrade_rel_err=deg,
               oracle_rel_err=oracle)
    log_sample_row(row, card, " UnetResNet")
    # (c)
    tr, ips, peak, launches, norms = train_workflow(
        d, device, folder + "/train", CIFAR, 2, snapshot=False,
        model=seeded_resnet(SEED, device), batch=RESNET_BATCH, fronts=0)
    step_ms = 1e3 * RESNET_BATCH * ACCUM / ips
    log(f"[21c] UnetResNet Trainer.train() B={RESNET_BATCH} x accum {ACCUM} {CIFAR}px bf16, "
        f"dropout 0.1 from the Trainer's dropout generator: {ips:.3f} train images/s "
        f"(median of 2 steps), {step_ms:.3f} ms per optimizer step, peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB), front launches {launches}, GroupNorm launches {norms}; "
        f"card: {card}")
    # (d)
    blob = copy.deepcopy(tr.state())
    batch = tr._next_superbatch()
    losses = []
    torch.backends.cudnn.deterministic = True
    try:
        for dseed in (1, 1, 2):
            tr.load_state(copy.deepcopy(blob))  # Adam steps its moments in place
            tr.dropout_generator.manual_seed(dseed)
            losses.append(tr.train_step(batch).item())
    finally:
        torch.backends.cudnn.deterministic = False
    if not losses[0] == losses[1] != losses[2]:
        raise AssertionError(f"dropout seeds 1, 1, 2 gave losses {losses}")
    log(f"[21d] train_step from one state: dropout seed 1 twice -> {losses[0]!r}, "
        f"{losses[1]!r}; seed 2 -> {losses[2]!r}")
    # (e)
    tr.save()
    kw = dict(train_batch_size=RESNET_BATCH, gradient_accumulate_every=ACCUM, bf16=True,
              num_workers=1, seed=SEED, device=device)
    ds = SyntheticDataset(CIFAR, 3, length=64)
    fresh = Trainer(d, seeded_resnet(SEED + 1, device), ds, results_folder=folder + "/fresh",
                    load_path=f"{folder}/train/model.pt", **kw)
    a, b = tr.state(), fresh.state()
    bitwise = (a["step"] == b["step"]
               and all(torch.equal(a[k][n], b[k][n]) for k in ("model", "ema") for n in a[k])
               and all(torch.equal(a[k], b[k]) for k in ("generator", "dropout_generator"))
               and all(torch.equal(v, b["opt"]["state"][i][name])
                       for i, st in a["opt"]["state"].items() for name, v in st.items()))
    ref = seeded_resnet(SEED + 2, "cpu").state_dict()
    torch.save({"step": 9, "model": {f"module.denoise_fn.{k}": v for k, v in ref.items()},
                "ema": {f"module.denoise_fn.{k}": v * 0.5 for k, v in ref.items()}},
               f"{folder}/ref.pt")
    migrated = Trainer(d, seeded_resnet(SEED + 3, device), ds, results_folder=folder + "/ref",
                       load_torch_path=f"{folder}/ref.pt", **kw)
    loaded = (migrated.step == 9
              and set(load_reference_checkpoint(f"{folder}/ref.pt")) == set(ref)
              and all(torch.equal(migrated.model.state_dict()[k].cpu(), v)
                      and torch.equal(migrated.ema_model.state_dict()[k].cpu(), v * 0.5)
                      for k, v in ref.items()))
    if not (bitwise and loaded):
        raise AssertionError(f"ResNet checkpoint round trip bitwise {bitwise}, reference "
                             f"blob loaded {loaded}")
    log("[21e] checkpoint round trip bitwise (model, ema, Adam, both generators); "
        "load_torch_path of a reference-named ResNet blob exact")
    del tr, fresh, migrated
    # (e2)
    scores = {}
    for fn in (metrics.ssim, metrics.rmse, metrics.psnr):
        on_card = fn(keep["out"], keep["img"]).item()
        on_cpu = fn(keep["out"].cpu(), keep["img"].cpu()).item()
        err = abs(on_card - on_cpu) / abs(on_cpu)
        if not (math.isfinite(on_card) and err <= METRIC_REL):
            raise AssertionError(f"{fn.__name__}: card {on_card}, cpu {on_cpu}")
        scores[fn.__name__] = (on_card, err)
    log("[21e2] samples vs clean batch: " + ", ".join(
        f"{k} {v:.6f} (card vs cpu rel err {e:.3e})" for k, (v, e) in scores.items()))
    seconds = time.perf_counter() - t_phase
    row.update(train_images_per_s=ips, train_step_ms=step_ms, train_peak_bytes=peak,
               train_launches=launches, train_norm_launches=norms, dropout_losses=losses,
               metrics={k: v for k, (v, _) in scores.items()}, phase_seconds=seconds)
    log(f"[21] phase seconds {seconds:.2f}")
    return row


def routine_workflows(device, folder: str, card: str):
    """Phase 22: the training routines of item 10 through Trainer.train()
    (one warm-up step, ROUTINE_STEPS timed) and one sampling run each:
    Final_small_noise, Final_random_mean, Final_random_mean_and_actual and
    Gradient_norm on super-resolution (Incremental_factor_2, T=4, 128 px)
    with the flagship UNet, as resolution_diffusion_pytorch trains them;
    Step and Step_Gradient on random snow (level 3, T=200, fix_brightness,
    32 px; BASELINE.md:31) with the ResNet UNet, as snowification trains
    them.  Returns the rows."""
    t_phase = time.perf_counter()
    sr = get_operator("resolution", image_size=IMG, timesteps=4,
                      resolution_routine="Incremental_factor_2", device=device)
    snow = get_operator("snow", image_size=CIFAR, timesteps=T, snow_level=3, random_snow=True,
                        fix_brightness=True, seed=SEED, device=device)
    runs = [(r, sr, IMG, 17) for r in ("Final_small_noise", "Final_random_mean",
                                      "Final_random_mean_and_actual", "Gradient_norm")]
    runs += [(r, snow, CIFAR, 0) for r in ("Step", "Step_Gradient")]
    models16 = {17: seeded_unet(SEED, device, **FLAGSHIP).to(torch.bfloat16),
                0: seeded_resnet(SEED, device).to(torch.bfloat16)}
    rows = []
    for routine, op, size, fronts in runs:
        t0 = time.perf_counter()
        d = ColdDiffusion(op=op, image_size=size, train_routine=routine,
                          sampling_routine="x0_step_down")
        model = None if fronts else seeded_resnet(SEED, device)
        ips, peak, launches, norms = train_workflow(d, device, f"{folder}/{routine}", size,
                                                    ROUTINE_STEPS, snapshot=False,
                                                    model=model, fronts=fronts)[1:]
        row = sample_path(d, models16[fronts], device, BATCH, size, fronts=fronts)
        row.update(phase="22", train_routine=routine,
                   model="UnetConvNext" if fronts else "UnetResNet", train_images_per_s=ips,
                   train_peak_bytes=peak, train_launches=launches, train_norm_launches=norms,
                   seconds_total=time.perf_counter() - t0)
        log(f"[22] {routine} {row['op']} T={row['T']} {size}px {row['model']} B={BATCH}: "
            f"Trainer.train() x accum {ACCUM} bf16 {ips:.3f} train images/s (median of "
            f"{ROUTINE_STEPS}), peak {peak} bytes, front launches {launches}, GroupNorm "
            f"launches {norms}; sample {row['images_per_s']:.3f} images/s, peak "
            f"{row['peak_bytes']} bytes, front launches {row['launches']}, of them small-C "
            f"{row['small_c_launches']}, GroupNorm launches {row['norm_launches']}; "
            f"{row['seconds_total']:.2f} s; card: {card}")
        rows.append(row)
    log(f"[22] phase seconds {time.perf_counter() - t_phase:.2f}")
    return rows


def multi_step_path(device, card: str):
    """Phase 23: sample_multi_step on phase 21's configuration, per-sample
    t_start in [1, 50] and t_end in [0, t_start) from a seeded generator.
    Each sample starts at the clean batch degraded to its t_start; the
    oracle denoiser must end it at the clean batch degraded to its t_end
    (the clean image at 0); then the fp32 ResNet's run on the card against
    its CPU run.  Returns the phase's row."""
    t_phase = time.perf_counter()
    d = cifar_blur(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    clean = torch.rand(RESNET_BATCH, CIFAR, CIFAR, 3, generator=gen, device=device) * 2 - 1
    t_start = torch.randint(1, CIFAR_T + 1, (RESNET_BATCH,), generator=gen, device=device)
    t_end = (torch.rand(RESNET_BATCH, generator=gen, device=device) * t_start).long()
    t_end[0] = 0
    start = d.op.degrade(clean, t_start)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = sample_multi_step(d, lambda x, t: clean, start, t_start, t_end)
    torch.cuda.synchronize(device)
    oracle_s = time.perf_counter() - t0
    want = d.op.degrade(clean, t_end)
    err = (out - want).abs().max().item()
    if not (err <= ORACLE_ATOL and torch.equal(want[t_end == 0], clean[t_end == 0])):
        raise AssertionError(f"sample_multi_step oracle: max err {err}")
    n = MULTI_STEP_CPU_BATCH
    outs, secs = [], []  # the card's run, then the CPU's
    for dev in (device, torch.device("cpu")):
        model = seeded_resnet(SEED, dev)
        dd = dataclasses.replace(d, op=d.op.to(dev))
        zero_launches()
        t0 = time.perf_counter()
        outs.append(sample_multi_step(dd, lambda x, t: model(x, t), start[:n].to(dev),
                                      t_start[:n].to(dev), t_end[:n].to(dev)).cpu())
        secs.append(time.perf_counter() - t0)
        if dev == device:
            norms = norm_launches()
    rel = rel_l2(*outs)
    iters = int((t_start[:n] - t_end[:n]).max())
    if not (rel <= UNET_REL_L2 and norms == RESNET_NORMS * iters):
        raise AssertionError(f"sample_multi_step fp32 cuda vs cpu: rel L2 {rel}, GroupNorm "
                             f"launches {norms} in {iters} iterations")
    seconds = time.perf_counter() - t_phase
    log(f"[23] sample_multi_step blur Special_6 T={CIFAR_T} {CIFAR}px B={RESNET_BATCH}, "
        f"t_start {t_start.tolist()}, t_end {t_end.tolist()}: oracle max err {err:.3e} "
        f"(<= {ORACLE_ATOL}) in {oracle_s:.3f} s; fp32 UnetResNet B={n} ({iters} "
        f"iterations, {norms} GroupNorm launches) cuda vs cpu rel L2 {rel:.3e} (<= "
        f"{UNET_REL_L2}), cuda "
        f"{secs[0]:.3f} s, cpu {secs[1]:.3f} s; phase seconds {seconds:.2f}; card: {card}")
    return dict(phase="23", oracle_max_err=err, rel_l2=rel, iterations=iters,
                norm_launches=norms,
                oracle_seconds=oracle_s, cuda_seconds=secs[0], phase_seconds=seconds)


def eval_path(device, card: str):
    """Phase 24: the eval surface on the flagship configuration.  Returns
    the phase's row."""
    t_phase = time.perf_counter()
    d = blur_diffusion(IMG, T, device)
    ds = SyntheticDataset(IMG, 3, length=EVAL_IMAGES, seed=SEED + 15)
    row = dict(phase="24")
    with tempfile.TemporaryDirectory() as folder:
        h = EvalHarness(d, seeded_unet(SEED, device, **FLAGSHIP), results_folder=folder,
                        bf16=True, model_chunk=EVAL_CHUNK, device=device)
        kept = []  # each batch and the four rows the harness keeps of it
        run_batch = h._manifold_batch

        def keep(batch, gen, *rows):
            run_batch(batch, gen, *rows)
            kept.append((batch, [r[-1] for r in rows]))

        h._manifold_batch = keep
        sample(h.d, h.denoise, prepare_start(h.d, h._tensor(ds[0][None])), t=2)  # warm-up
        base = reset_peak(device)
        zero_launches()
        t0 = time.perf_counter()
        scores = h.fid_distance_decrease_from_manifold(ds, end=EVAL_IMAGES,
                                                       batch_size=EVAL_BATCH)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        forwards = T * math.ceil(EVAL_BATCH / EVAL_CHUNK) * (EVAL_IMAGES // EVAL_BATCH)
        if launches != (17 * forwards, forwards, 0):
            raise AssertionError(f"manifold harness launched {launches} (all, small-C, "
                                 f"wide-C) fronts; expected {(17 * forwards, forwards, 0)}")
        row.update(manifold_seconds=seconds, manifold_images_per_s=EVAL_IMAGES / seconds,
                   manifold_peak_bytes=torch.cuda.max_memory_allocated(device),
                   base_bytes=base, manifold_launches=launches[0],
                   manifold_small_c_launches=launches[1], scores=scores)

        # its first batch's samples == a direct prepare_start + sample
        batch, rows = kept[0]
        direct = sample(h.d, h.denoise, prepare_start(h.d, h._tensor(batch)))
        for name, got, want in (("xt", rows[1], direct.xt), ("img", rows[2], direct.img),
                                ("direct_recons", rows[3], direct.direct_recons)):
            if not np.array_equal(got, want.cpu().numpy()):
                raise AssertionError(f"manifold harness {name} != direct sample: max err "
                                     f"{np.abs(got - want.cpu().numpy()).max()}")

        # the metric dict against its CPU recomputation from the card's images
        og, *others = (np.concatenate([k[1][i] for k in kept]) for i in range(4))
        feats = fid_mod.fid_features_fn(device="cpu")
        og01 = torch.from_numpy((og + 1.0) * 0.5)
        worst = {"fid": 0.0, "metric": 0.0}
        for name, other in zip(("degraded", "sampled", "direct"), others):
            other01 = torch.from_numpy((other + 1.0) * 0.5)
            want = {f"proxy_fid_{name}": fid_mod.calculate_fid_given_samples(
                        [og, other], features=feats),
                    f"rmse_{name}": metrics.rmse(og01, other01).item(),
                    f"ssim_{name}": metrics.ssim(og01, other01, data_range=1.0).item()}
            for k, w in want.items():
                kind, rtol, atol = (("fid", FID_RTOL, 1e-4) if k.startswith("proxy_fid")
                                    else ("metric", METRIC_REL, 0.0))
                err = abs(scores[k] - w)
                worst[kind] = max(worst[kind], err / abs(w))
                if not (err <= rtol * abs(w) + atol and math.isfinite(scores[k])):
                    raise AssertionError(f"manifold harness {k}: card {scores[k]}, cpu {w}")
        row.update(fid_rel_err=worst["fid"], metric_rel_err=worst["metric"])

        # gmm_mean_samples, fronts counted
        gen = torch.Generator(device=device).manual_seed(SEED + 16)
        zero_launches()
        t0 = time.perf_counter()
        res = h.gmm_mean_samples(ds, clusters=1, num=EVAL_GMM_NUM, noise_level=0.002,
                                 generator=gen)
        torch.cuda.synchronize(device)
        gmm_s = time.perf_counter() - t0
        launches = launch_counts()
        if not (res.img.shape == (EVAL_GMM_NUM, IMG, IMG, 3)
                and torch.isfinite(res.img).all().item()):
            raise AssertionError(f"gmm_mean_samples: {res.img.shape}, not finite/shaped")
        if launches != (17 * T, T, 0):
            raise AssertionError(f"gmm_mean_samples launched {launches} fronts; expected "
                                 f"{(17 * T, T, 0)}")
        row.update(gmm_mean_seconds=gmm_s, gmm_mean_images_per_s=EVAL_GMM_NUM / gmm_s,
                   gmm_mean_launches=launches[0])
        del h, res

        # the Inception pool3 graph on synthetic weights, card vs CPU
        path = f"{folder}/pt_inception_synth.pth"
        torch.save({k: torch.as_tensor(v)
                    for k, v in fid_mod.synth_state_dict(dtype=np.float32).items()}, path)
        inc = {dev: fid_mod.inception_features_from_torch_checkpoint(path, dev)
               for dev in (device, "cpu")}
    x = torch.rand(INCEPTION_TIME_B, IMG, IMG, 3, generator=gen, device=device) * 2 - 1
    small = x[:INCEPTION_CHECK_B]
    inc_rel = rel_l2(inc[device](small), inc["cpu"](small.cpu()))
    if not inc_rel <= INCEPTION_REL_L2:
        raise AssertionError(f"Inception pool3 cuda vs cpu: rel L2 {inc_rel}")
    inc_ms = cuda_median_ms(lambda: inc[device](x), warmup=2, iters=5)
    with FlopCounterMode(display=False) as flops:
        inc[device](x)
    inc_bound_ms = bound(0.0, flops.get_total_flops())[0]
    row.update(inception_rel_l2=inc_rel, inception_ms=inc_ms,
               inception_us_per_image=1e3 * inc_ms / INCEPTION_TIME_B,
               inception_flops=flops.get_total_flops(), inception_bound_ms=inc_bound_ms)

    # fit_gmm, card vs CPU from one init: 4 clusters of 2,000 points in 16-d
    centers = torch.rand(4, 16, generator=gen, device=device) * 6 - 3
    pts = (centers.repeat_interleave(500, 0)
           + 0.2 * torch.randn(2000, 16, generator=gen, device=device))
    init = torch.randperm(2000, generator=gen, device=device)[:4]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fitted = fit_gmm(pts, 4, init_idx=init)
    torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    want = fit_gmm(pts.cpu(), 4, init_idx=init.cpu())
    gmm_rel = max(((g.cpu() - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(fitted, want))
    if not gmm_rel <= GMM_REL:
        raise AssertionError(f"fit_gmm cuda vs cpu: rel err {gmm_rel}")
    seconds = time.perf_counter() - t_phase
    row.update(gmm_fit_rel_err=gmm_rel, gmm_fit_seconds=fit_s, phase_seconds=seconds)
    log(f"[24] EvalHarness blur Exponential_reflect T={T} {IMG}px bf16, model_chunk "
        f"{EVAL_CHUNK}: fid_distance_decrease_from_manifold {EVAL_IMAGES} images at "
        f"batch_size {EVAL_BATCH} in {row['manifold_seconds']:.3f} s, "
        f"{row['manifold_images_per_s']:.3f} images/s, peak memory "
        f"{row['manifold_peak_bytes']} bytes ({row['manifold_peak_bytes'] / 2**30:.2f} GiB; "
        f"{base} allocated before), front launches {row['manifold_launches']}, of them "
        f"small-C {row['manifold_small_c_launches']}; samples == direct sample; card vs "
        f"cpu: proxy FID rel err {worst['fid']:.3e} (<= {FID_RTOL}), rmse/ssim rel err "
        f"{worst['metric']:.3e} (<= {METRIC_REL}); gmm_mean_samples num {EVAL_GMM_NUM} "
        f"{gmm_s:.3f} s ({row['gmm_mean_launches']} front launches); Inception pool3 "
        f"(synthetic weights) B={INCEPTION_CHECK_B} cuda vs cpu rel L2 {inc_rel:.3e} (<= "
        f"{INCEPTION_REL_L2}), B={INCEPTION_TIME_B} {inc_ms:.3f} ms, "
        f"{row['inception_us_per_image']:.1f} us/image, {flops.get_total_flops() / 1e9:.1f} "
        f"GFLOP (FlopCounterMode) so a bound of {inc_bound_ms:.3f} ms at fp32 peak "
        f"({100 * inc_bound_ms / inc_ms:.1f}%); fit_gmm (2000 x 16, K=4, 100 "
        f"iterations) cuda vs cpu rel err {gmm_rel:.3e} (<= {GMM_REL}) in {fit_s:.3f} s; "
        f"phase seconds {seconds:.2f}; card: {card}")
    return row


def write_pngs(folder: Path, n: int, side: int, seed: int) -> None:
    """``n`` seeded ``side`` x ``side`` RGB PNGs: smooth fields with noise."""
    from PIL import Image

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    for i in range(n):
        f = rng.random((3, 3))
        img = (np.sin(2 * np.pi * (f[:, 0, None, None] * xx + f[:, 1, None, None] * yy
                                   + f[:, 2, None, None])) * 0.4 + 0.5
               + 0.1 * rng.standard_normal((3, side, side)))
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)).save(
            folder / f"{i:03d}.png")


def remat_pair(device, folder: str):
    """One flagship Trainer step without and with ``remat`` from one state
    (seeded weights), one batch and one t.  Returns per run (loss, update
    of each parameter, front launches, small-C launches, peak bytes above
    the state's)."""
    d = blur_diffusion(IMG, T, device)
    ds = SyntheticDataset(IMG, 3, length=64, seed=SEED + 25)
    gen = torch.Generator(device=device).manual_seed(SEED + 25)
    t = torch.randint(0, T, (ACCUM, BATCH), generator=gen, device=device)
    runs = []
    for remat in (False, True):
        tr = Trainer(d, seeded_unet(SEED, device, **FLAGSHIP), ds, train_batch_size=BATCH,
                     gradient_accumulate_every=ACCUM, results_folder=f"{folder}/{remat}",
                     bf16=True, num_workers=4, seed=SEED, remat=remat, device=device)
        before = [p.detach().clone() for p in tr.model.parameters()]
        batch = tr._next_superbatch()
        base = reset_peak(device)
        zero_launches()
        loss = tr.train_step(batch, t=t)
        torch.cuda.synchronize(device)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated(device) - base
        update = [p.detach() - b for p, b in zip(tr.model.parameters(), before)]
        runs.append((loss.item(), update, launches[0], launches[1], peak))
        del tr, before, batch
    return runs


def cli_path(device, card: str):
    """Phase 25: the CLI on the flagship path.  Returns the phase's row."""
    t_phase = time.perf_counter()
    row = dict(phase="25")
    torch.cuda.empty_cache()  # the train workers are processes of their own
    with tempfile.TemporaryDirectory() as tmp:
        data, results = Path(tmp) / "png", Path(tmp) / "results"
        write_pngs(data, CLI_IMAGES, CLI_SIDE, SEED + 25)
        flags = ["--dataset", "folder", "--data_path", str(data), "--image_size", str(IMG),
                 "--time_steps", str(T), "--blur_routine", "Exponential_reflect",
                 "--blur_size", "15", "--blur_std", "0.01", "--dim", "64",
                 "--batch_size", str(BATCH), "--bf16", "--save_folder", str(results)]

        # 1. train through the entry point, under the restart supervisor
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        env.pop("COLDDIFF_RESTART_WORKER", None)
        cmd = [sys.executable, "-m", "colddiff_torch.cli.main", "train", *flags,
               "--grad_accum", str(ACCUM), "--train_steps", str(CLI_STEPS),
               "--save_and_sample_every", str(CLI_STEPS),
               "--restart_every_steps", str(CLI_RESTART)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=900)
        train_s = time.perf_counter() - t0
        respawns = r.stdout.count("hit restart boundary; respawning")
        if r.returncode != 0 or respawns != CLI_STEPS // CLI_RESTART - 1:
            raise AssertionError(f"CLI train: exit {r.returncode}, {respawns} respawns; "
                                 f"stdout {r.stdout[-2000:]}\nstderr {r.stderr[-4000:]}")
        blob = torch.load(results / "model.pt", map_location="cpu")
        if blob["step"] != CLI_STEPS or not all(torch.isfinite(v).all()
                                                for v in blob["model"].values()):
            raise AssertionError(f"CLI train: checkpoint at step {blob['step']}, "
                                 f"expected {CLI_STEPS}, or not finite")
        for name in ("og", "xt", "direct_recons", "sample"):
            if not (results / f"{name}-1.png").is_file():
                raise AssertionError(f"CLI train wrote no {name}-1.png at step {CLI_STEPS}")
        # a worker's fixed cost: the same command for 0 steps, no supervisor
        # (interpreter, imports, CUDA set-up, the model's build, one checkpoint)
        t0 = time.perf_counter()
        r0 = subprocess.run([*cmd[:-2], "--train_steps", "0", "--save_folder",
                             str(Path(tmp) / "zero")], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
        zero_s = time.perf_counter() - t0
        if r0.returncode != 0:
            raise AssertionError(f"CLI train --train_steps 0: exit {r0.returncode}; "
                                 f"stderr {r0.stderr[-4000:]}")
        images = CLI_STEPS * ACCUM * BATCH
        row.update(train_seconds=train_s, train_workers=respawns + 1,
                   train_wall_images_per_s=images / train_s, zero_step_worker_seconds=zero_s)
        log(f"[25] CLI train (subprocess, supervisor + {respawns + 1} workers, "
            f"--restart_every_steps {CLI_RESTART}) {CLI_STEPS} steps B={BATCH} x accum "
            f"{ACCUM} {IMG}px bf16 with the step-{CLI_STEPS} checkpoint and T={T} snapshot: "
            f"{train_s:.3f} s wall, {images / train_s:.3f} train images/s over the wall "
            f"(process starts, kernel library loads and the snapshot included); one "
            f"worker of 0 steps (start-up and a checkpoint) {zero_s:.3f} s; card: {card}")

        # 2. test in this process, from the checkpoint; the harness call
        # timed apart from the CLI's loading around it
        harness_s = []
        manifold = EvalHarness.fid_distance_decrease_from_manifold

        def timed_manifold(self, *a, **kw):
            t1 = time.perf_counter()
            out = manifold(self, *a, **kw)
            harness_s.append(time.perf_counter() - t1)
            return out

        base = reset_peak(device)
        zero_launches()
        crops0 = native.calls["crop_flip_normalize"]
        t0 = time.perf_counter()
        EvalHarness.fid_distance_decrease_from_manifold = timed_manifold
        try:
            cli_main.main(["test", *flags, "--test_type",
                           "test_fid_distance_decrease_from_manifold", "--test_end",
                           str(CLI_TEST_END), "--load_path", str(results / "model.pt")])
        finally:
            EvalHarness.fid_distance_decrease_from_manifold = manifold
        torch.cuda.synchronize(device)
        test_s = time.perf_counter() - t0
        row.update(test_native_crops=native.calls["crop_flip_normalize"] - crops0)
        launches = launch_counts()
        forwards = T * (CLI_TEST_END // BATCH)  # model_chunk 16: one forward a step
        if launches != (17 * forwards, forwards, 0):
            raise AssertionError(f"CLI test launched {launches} (all, small-C, wide-C) "
                                 f"fronts; expected {(17 * forwards, forwards, 0)}")
        scores = json.loads((results / "manifold_metrics.json").read_text())
        if not (scores["refresh_every"] == 1 and scores["bf16"] is True
                and all(math.isfinite(v) for v in scores.values() if isinstance(v, float))):
            raise AssertionError(f"CLI test metrics: {scores}")
        peak = torch.cuda.max_memory_allocated(device)
        row.update(test_seconds=test_s, test_images_per_s=CLI_TEST_END / test_s,
                   test_harness_seconds=harness_s[0], test_peak_bytes=peak,
                   test_base_bytes=base, test_launches=launches[0],
                   test_small_c_launches=launches[1], scores=scores)
        log(f"[25] CLI test test_fid_distance_decrease_from_manifold --test_end "
            f"{CLI_TEST_END} (in process; Trainer load + harness build included): "
            f"{test_s:.3f} s, {CLI_TEST_END / test_s:.3f} images/s, of it the harness "
            f"call {harness_s[0]:.3f} s ({CLI_TEST_END / harness_s[0]:.3f} images/s); "
            f"peak memory {peak} "
            f"bytes ({peak / 2**30:.2f} GiB; {base} allocated before), front launches "
            f"{launches[0]}, of them small-C {launches[1]}; refresh_every "
            f"{scores['refresh_every']}; card: {card}")

        # 3. remat against the step without it
        (loss0, up0, l0, s0, peak0), (loss1, up1, l1, s1, peak1) = remat_pair(
            device, f"{tmp}/remat")
        bitwise = all(torch.equal(a, b) for a, b in zip(up0, up1))
        num = math.sqrt(sum((a.double() - b.double()).square().sum().item()
                            for a, b in zip(up0, up1)))
        den = math.sqrt(sum(a.double().square().sum().item() for a in up0))
        if not (loss0 == loss1 and num <= REMAT_UPDATE_REL_L2 * den
                and (l0, s0) == (17 * ACCUM, ACCUM) and (l1, s1) == (2 * l0, 2 * s0)):
            raise AssertionError(f"remat: losses {loss0} {loss1}, update rel L2 {num / den}, "
                                 f"launches {(l0, s0)} and {(l1, s1)}")
        row.update(remat_loss=loss1, remat_update_rel_l2=num / den, remat_bitwise=bitwise,
                   plain_peak_bytes=peak0, remat_peak_bytes=peak1,
                   plain_launches=l0, remat_launches=l1)
        log(f"[25] remat: one flagship step B={BATCH} x accum {ACCUM} bf16, losses equal "
            f"({loss1}), updates rel L2 {num / den:.3e} (<= {REMAT_UPDATE_REL_L2}; bitwise "
            f"{bitwise}); peak memory above the state {peak1} bytes ({peak1 / 2**30:.2f} "
            f"GiB) with remat vs {peak0} ({peak0 / 2**30:.2f} GiB) without; front launches "
            f"{l1} (small-C {s1}) vs {l0} (small-C {s0}); card: {card}")
        del up0, up1

        # 4. to_lab: one CLI train step of decolor in Lab, and the conversions
        lab_dir = Path(tmp) / "lab"
        t0 = time.perf_counter()
        cli_main.main(["train", "--degradation", "decolor", "--decolor_routine", "Linear",
                       "--decolor_total_remove", "--to_lab", "--dataset", "folder",
                       "--data_path", str(data), "--image_size", str(IMG),
                       "--time_steps", str(CLI_LAB_T), "--dim", "64",
                       "--batch_size", str(BATCH), "--bf16", "--train_steps", "1",
                       "--save_and_sample_every", "1", "--save_folder", str(lab_dir)])
        lab_s = time.perf_counter() - t0
        blob = torch.load(lab_dir / "model.pt", map_location="cpu")
        if blob["step"] != 1 or not (lab_dir / "sample-1.png").is_file():
            raise AssertionError("CLI to_lab train: no step-1 checkpoint or sample grid")
        x = torch.rand(BATCH, IMG, IMG, 3, generator=torch.Generator().manual_seed(SEED + 26))
        x = x * 2 - 1
        lab_cpu = rgb2lab(x)
        lab_err = ((rgb2lab(x.to(device)).cpu() - lab_cpu).abs().max()
                   / lab_cpu.abs().max()).item()
        back_cpu = lab2rgb(lab_cpu)
        back_err = ((lab2rgb(lab_cpu.to(device)).cpu() - back_cpu).abs().max()
                    / back_cpu.abs().max()).item()
        if not (lab_err <= LAB_REL and back_err <= LAB_REL):
            raise AssertionError(f"rgb2lab / lab2rgb cuda vs cpu: rel err {lab_err}, "
                                 f"{back_err}")
        row.update(to_lab_seconds=lab_s, rgb2lab_rel_err=lab_err, lab2rgb_rel_err=back_err)
        log(f"[25] CLI train decolor Linear --to_lab T={CLI_LAB_T} {IMG}px, 1 step with "
            f"its snapshot (in process): {lab_s:.3f} s; rgb2lab cuda vs cpu rel err "
            f"{lab_err:.3e}, lab2rgb {back_err:.3e} (<= {LAB_REL}); card: {card}")

        # 5. the profiler window of the Trainer
        prof_dir = Path(tmp) / "prof"
        reset_peak(device)
        tr = Trainer(blur_diffusion(IMG, T, device), seeded_unet(SEED, device, **FLAGSHIP),
                     SyntheticDataset(IMG, 3, length=64), train_batch_size=BATCH,
                     gradient_accumulate_every=ACCUM, train_num_steps=PROFILE_STEPS[1],
                     save_and_sample_every=10**9, results_folder=f"{tmp}/p25", bf16=True,
                     num_workers=4, seed=SEED, profile_dir=str(prof_dir),
                     profile_steps=PROFILE_STEPS, device=device)
        tr.train(log_every=1)
        del tr
        traces = sorted(prof_dir.glob("*.json"))
        text = traces[0].read_text() if len(traces) == 1 else ""
        tile_events = text.count("convnext_front_tile_kernel")
        if not tile_events:
            raise AssertionError(f"profiler: traces {traces} name no convnext_front_tile_kernel")
        row.update(trace_bytes=len(text), trace_tile_kernel_mentions=tile_events)
        log(f"[25] profiler steps {PROFILE_STEPS}: {traces[0].name} {len(text)} bytes, "
            f"convnext_front_tile_kernel named {tile_events} times")
    seconds = time.perf_counter() - t_phase
    row.update(phase_seconds=seconds)
    log(f"[25] phase seconds {seconds:.2f}; card: {card}")
    return row


def rel_l2_all(a, b) -> float:
    """Relative L2 of the tensors of ``a`` against those of ``b``, all together."""
    num = math.sqrt(sum((x.double() - y.double()).square().sum().item() for x, y in zip(a, b)))
    return num / math.sqrt(sum(y.double().square().sum().item() for y in b))


def parallel_steps(tr, device):
    """One warm-up step and PAR_STEPS timed ones of ``tr`` from its loader;
    returns (losses, the update over all steps, step seconds, front
    launches, small-C launches, peak bytes)."""
    before = [p.detach().clone() for p in parallel.full_state_dict(tr.model).values()]
    losses = [tr.train_step(tr._next_superbatch()).item()]
    reset_peak(device)
    zero_launches()
    seconds = []
    for _ in range(PAR_STEPS):
        t0 = time.perf_counter()
        losses.append(tr.train_step(tr._next_superbatch()).item())
        seconds.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    after = parallel.full_state_dict(tr.model).values()
    update = [a.detach() - b for a, b in zip(after, before)]
    return losses, update, seconds, launches[0], launches[1], peak


def parallel_path(device, card: str, eval_scores: dict):
    """Phase 26, as the module docstring says.  Returns the phase's row."""
    t_phase = time.perf_counter()
    row = dict(phase="26")
    d = blur_diffusion(IMG, T, device)
    ds = SyntheticDataset(IMG, 3, length=64, seed=SEED + 26)
    kw = dict(train_batch_size=BATCH, gradient_accumulate_every=ACCUM, bf16=True,
              num_workers=8, seed=SEED, save_and_sample_every=10**9, device=device)
    images = BATCH * ACCUM
    with tempfile.TemporaryDirectory() as folder:
        def no_group(name):
            return parallel_steps(Trainer(d, seeded_unet(SEED, device, **FLAGSHIP), ds,
                                          results_folder=f"{folder}/{name}", **kw), device)

        runs = {"none": no_group("none")}
        parallel.init_multihost(device=device)
        backend = torch.distributed.get_backend()
        for mode in ("replicated", "fsdp"):
            tr = Trainer(d, seeded_unet(SEED, device, **FLAGSHIP), ds,
                         results_folder=f"{folder}/{mode}", param_sharding=mode, **kw)
            runs[mode] = parallel_steps(tr, device)
            if mode == "fsdp":
                tr.save()
                saved = tr.state()
            del tr
        torch.distributed.destroy_process_group()
        # the FSDP checkpoint in a Trainer of one process without a group
        one = Trainer(d, seeded_unet(SEED + 1, device, **FLAGSHIP), ds,
                      results_folder=f"{folder}/one", load_path=f"{folder}/fsdp/model.pt",
                      **kw)
        got = one.state()
        bitwise = (got["step"] == saved["step"] == 1 + PAR_STEPS
                   and all(torch.equal(got[k][n].cpu(), v.cpu())
                           for k in ("model", "ema") for n, v in saved[k].items())
                   and all(torch.equal(got["opt"]["state"][i][n].cpu(), v.cpu())
                           for i, st in saved["opt"]["state"].items() for n, v in st.items()))
        del one, got, saved
        # the run without a group again: what the group's presence cost the host
        runs["none_after"] = no_group("none_after")
    if backend != "nccl" or not bitwise:
        raise AssertionError(f"phase 26 (a): backend {backend}, FSDP checkpoint into one "
                             f"process bitwise {bitwise}")
    ref_losses, ref_update = runs["none"][:2]
    labels = {"none": "without a process group",
              "replicated": f"replicated under init_multihost, world 1, {backend}",
              "fsdp": f"fsdp under init_multihost, world 1, {backend}",
              "none_after": "without a process group again, after the group's end"}
    for mode, label in labels.items():
        losses, update, seconds, launches, small, peak = runs[mode]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        upd = rel_l2_all(update, ref_update)
        if not (all(math.isfinite(x) for x in losses) and loss_err <= PAR_LOSS_RTOL
                and upd <= REMAT_UPDATE_REL_L2
                and (launches, small) == (17 * ACCUM * PAR_STEPS, ACCUM * PAR_STEPS)):
            raise AssertionError(f"phase 26 (a) {mode}: losses {losses} vs {ref_losses}, "
                                 f"update rel L2 {upd}, launches {(launches, small)}")
        row[mode] = dict(losses=losses, loss_rel_err=loss_err, update_rel_l2=upd,
                         bitwise=loss_err == 0.0 and upd == 0.0,
                         step_ms=1e3 * float(np.median(seconds)),
                         train_images_per_s=images / float(np.median(seconds)),
                         peak_bytes=peak, launches=launches, small_c_launches=small)
        log(f"[26] (a) Trainer {label}: "
            f"B={BATCH} x accum {ACCUM} {IMG}px bf16, {PAR_STEPS} steps after a warm-up, "
            f"median {row[mode]['step_ms']:.3f} ms a step, "
            f"{row[mode]['train_images_per_s']:.3f} train images/s, peak memory {peak} bytes "
            f"({peak / 2**30:.2f} GiB); losses {losses}, rel err {loss_err:.3e} (<= "
            f"{PAR_LOSS_RTOL}), updates rel L2 {upd:.3e} (<= {REMAT_UPDATE_REL_L2}; bitwise "
            f"{row[mode]['bitwise']}); front launches {launches} = 17 x {ACCUM} x "
            f"{PAR_STEPS}, small-C {small}; card: {card}")
    log(f"[26] (a) FSDP checkpoint (model.pt of the world-1 {backend} run) loaded into a "
        f"Trainer of one process without a group: model, EMA and Adam's state bitwise")
    row["fsdp_checkpoint_bitwise"] = bitwise

    # (b), (c): two processes sharing the card over gloo
    with tempfile.TemporaryDirectory() as folder:
        weights = f"{folder}/flagship.pt"
        torch.save(seeded_unet(SEED, "cpu", **FLAGSHIP).state_dict(), weights)
        t0 = time.perf_counter()
        res = dryrun_multichip.run(2, "cuda", flagship=True, weights=weights)
        dry_s = time.perf_counter() - t0
    per_rank = 17 * (ACCUM + T)  # the step's two microbatches and the T=200 sample
    if res["backend"] != "gloo" or res["launches"] != [per_rank] * 2:
        raise AssertionError(f"phase 26 (b): backend {res['backend']}, front launches per "
                             f"process {res['launches']}, expected {[per_rank] * 2}")
    worst = 0.0
    for k in dryrun_multichip.METRICS:
        err = abs(res["metrics"][k] - eval_scores[k])
        worst = max(worst, err / abs(eval_scores[k]))
        if not err <= METRIC_ATOL + METRIC_RTOL * abs(eval_scores[k]):
            raise AssertionError(f"phase 26 (c) {k}: mesh {res['metrics'][k]}, phase 24 "
                                 f"{eval_scores[k]}")
    row.update(dryrun=res, dryrun_seconds=dry_s, mesh_vs_phase24_rel_err=worst)
    log(f"[26] (b) dryrun_multichip --n 2 --flagship on one card ({res['backend']}, CUDA "
        f"tensors): one replicated step B={BATCH} ({dryrun_multichip.FLAGSHIP.batch} a "
        f"process) x accum {ACCUM}, loss {res['loss']} vs {res['loss_1']} on one process, "
        f"gradient rel L2 {res['grad_rel_l2']:.3e} (<= "
        f"{dryrun_multichip.FLAGSHIP.params_rtol}), updates rel L2 "
        f"{res['update_rel_l2']:.3e}, T={T} sample of {BATCH} rel L2 "
        f"{res['samples_rel_l2']:.3e} (<= {dryrun_multichip.FLAGSHIP.samples_tol}); front "
        f"launches per process {res['launches']} = 17 x ({ACCUM} + {T}); FSDP step (gloo, "
        f"CUDA tensors) loss {res['fsdp_loss']}; {dry_s:.2f} s with the processes' start-up")
    log(f"[26] (c) EvalHarness(mesh=) over the two processes ({res['backend']}, CUDA "
        f"tensors), "
        f"fid_distance_decrease_from_manifold 64 images at batch 32: metrics == phase 24's "
        f"single-device dict, worst rel err {worst:.3e} (<= {METRIC_RTOL} + {METRIC_ATOL}); "
        f"card: {card}")
    row["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[26] phase seconds {row['phase_seconds']:.2f} (backends: {backend} in (a), "
        f"{res['backend']} in (b) and (c))")
    return row


def spatial_path(device, card: str) -> dict:
    """Phase 27, as the module docstring says.  Returns the phase's row."""
    t_phase = time.perf_counter()
    cfg = dryrun_multichip.FLAGSHIP
    with tempfile.TemporaryDirectory() as folder:
        weights = f"{folder}/flagship.pt"
        torch.save(seeded_unet(SEED, "cpu", **FLAGSHIP).state_dict(), weights)
        t0 = time.perf_counter()
        res = dryrun_multichip.run(SPACE, "cuda", flagship=True, weights=weights, space=SPACE)
        dry_s = time.perf_counter() - t0
    per_process = 17 * T
    if not (res["backend"] == "gloo" and res["mesh"] == [1, SPACE] and len(res["fronts"]) == 17
            and res["launches"] == [per_process] * SPACE
            and res["launches_1"] == per_process):
        raise AssertionError(f"phase 27: backend {res['backend']}, mesh {res['mesh']}, "
                             f"{len(res['fronts'])} fronts, front launches per process "
                             f"{res['launches']} (one process {res['launches_1']}), "
                             f"expected {[per_process] * SPACE}")
    row = dict(phase="27", dryrun=res, dryrun_seconds=dry_s)
    for f in res["fronts"]:
        log(f"[27] (a) front {f['shape']} norm={f['norm']} cond={f['cond']} on {SPACE} row "
            f"blocks vs the whole image, both through the kernel: fp32 max err "
            f"{f['max_abs_err_fp32']:.3e} (bitwise {f['bitwise_fp32']}), bf16 "
            f"{f['max_abs_err_bf16']:.3e} (bitwise {f['bitwise_bf16']}); exchanged "
            f"{f['exchanged']}")
    log(f"[27] (b) fp32 forward B={cfg.space_batch} {IMG}px on a (1, {SPACE}) mesh, gathered: "
        f"rel L2 {res['forward_rel_l2']:.3e} (<= {cfg.forward_tol}) against one process; "
        f"{res['collectives_per_forward']} collectives a forward "
        f"{res['collectives_by_kind']}")
    log(f"[27] (c) bf16 prepare_start + sample T={T} B={cfg.space_batch} {IMG}px row-sharded "
        f"over {SPACE} processes ({res['backend']}, CUDA tensors, one card): rel L2 "
        f"{res['samples_rel_l2']:.3e} (<= {cfg.samples_tol}) against one process; front "
        f"launches per process {res['launches']} = 17 x {T}; wall s per process "
        f"{res['seconds']} vs one process {res['seconds_1']:.3f}; {dry_s:.2f} s with the "
        f"processes' start-up; card: {card}")

    # (d) a group of one on a (1, 1) mesh against no group, with cuDNN held
    # to its deterministic algorithms: its fp32 transposed conv (Upsample)
    # is not bitwise repeatable from call to call otherwise (PERF.md)
    parallel.init_multihost(device=device)
    backend = torch.distributed.get_backend()
    torch.backends.cudnn.deterministic = True
    try:
        mesh = parallel.make_mesh_2d(1, 1, "cuda")
        model = seeded_unet(SEED, device, **FLAGSHIP)
        gen = torch.Generator().manual_seed(SEED + 27)
        x = torch.randn(cfg.space_batch, IMG, IMG, 3, generator=gen).to(device)
        t = torch.randint(0, T, (cfg.space_batch,), generator=gen).to(device)
        img = (torch.rand(cfg.space_batch, IMG, IMG, 3, generator=gen) * 2 - 1).to(device)
        d = blur_diffusion(IMG, T, device)
        denoise = bf16_denoise(copy.deepcopy(model).to(torch.bfloat16))
        with torch.inference_mode():
            plain = [model(x, t), sample(d, denoise, prepare_start(d, img)).img]
            with parallel.image_rows(mesh):
                grouped = [parallel.gather_images(model(parallel.shard_images(x, mesh), t), mesh),
                           parallel.gather_images(sample(d, denoise, prepare_start(
                               d, parallel.shard_images(img, mesh))).img, mesh)]
        bitwise = [torch.equal(a, b) for a, b in zip(plain, grouped)]
    finally:
        torch.backends.cudnn.deterministic = False
        torch.distributed.destroy_process_group()
    if not all(bitwise):
        raise AssertionError(f"phase 27 (d): (1, 1) mesh vs no group bitwise {bitwise} "
                             "(forward, sample)")
    row.update(one_group_backend=backend, one_group_bitwise=bitwise)
    log(f"[27] (d) a group of one ({backend}) on a (1, 1) mesh: the fp32 forward and the "
        f"bf16 T={T} sample inside image_rows bitwise equal to the run without a group")
    row["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[27] phase seconds {row['phase_seconds']:.2f}")
    return row


# every workflow of the dry run but phase 27's flagship block
SPACE_WORKFLOWS = tuple(w for w in dryrun_multichip.WORKFLOW_NAMES if w != "blur")


def spatial_workflows(card: str) -> dict:
    """Phase 28, as the module docstring says.  Returns the phase's row."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        weights = f"{folder}/flagship.pt"
        torch.save(seeded_unet(SEED, "cpu", **FLAGSHIP).state_dict(), weights)
        t0 = time.perf_counter()
        res = dryrun_multichip.run(SPACE, "cuda", flagship=True, weights=weights, space=SPACE,
                                   workflows=SPACE_WORKFLOWS)["workflow_checks"]
        dry_s = time.perf_counter() - t0
    flows = res["workflows"]
    resnet = flows["resnet"]["rows"][0]
    if not (res["backend"] == "gloo" and res["mesh"] == [1, SPACE]
            and set(flows) == set(SPACE_WORKFLOWS) - {"loss"}
            and set(resnet["collectives_by_kind"]) == {"halo", "sum", "rows"}):
        raise AssertionError(f"phase 28: backend {res['backend']}, mesh {res['mesh']}, "
                             f"workflows {sorted(flows)}, ResNet collectives "
                             f"{resnet['collectives_by_kind']}")
    # check_workflows held the tolerances and the launches (17 x depth a
    # process on the UnetConvNext, 0 on the ResNet); this logs them
    for name, w in flows.items():
        for r in w["rows"]:
            log(f"[28] {'(b)' if name == 'resnet' else '(a)'} {name} {r['routine']}"
                + (f" recon_noise_std {r['recon_noise_std']}" if r["recon_noise_std"] else "")
                + f" T={w['T']} {w['size']}px B={dryrun_multichip.FLAGSHIP.space_batch} on "
                f"{SPACE} row blocks: degrade at T rel err {w['degrade_rel_err']:.3e} "
                f"(<= {dryrun_multichip.DEGRADE_REL}), draws equal {w['draws_equal']}; fp32 "
                f"forward rel L2 {r['forward_rel_l2']:.3e} {r['collectives_by_kind']}; "
                f"{r['dtype']} sample from level {r['depth']} rel L2 "
                f"{r['samples_rel_l2']:.3e} (<= {r['samples_bound']:.3e}"
                + (f"; one process an image at a time, GroupNorms on the plain chain: "
                   f"{r['split_rel_l2']:.3e}" if "split_rel_l2" in r else "") + "); front "
                f"launches per process {r['launches']} (one process {r['launches_1']}); wall "
                f"s per process {r['seconds']} vs one process {r['seconds_1']:.3f}")
    loss = res["loss"]
    log(f"[28] (c) flagship fp32 loss on {SPACE} row blocks {loss['loss']:.7f} vs one process "
        f"{loss['loss_1']:.7f} (rtol {dryrun_multichip.LOSS_RTOL}); group-summed gradients "
        f"rel L2 {loss['grad_rel_l2']:.3e} (<= {dryrun_multichip.GRAD_REL_L2}); "
        f"{loss['collectives_by_kind']}")
    row = dict(phase="28", dryrun=res, dryrun_seconds=dry_s,
               phase_seconds=time.perf_counter() - t_phase)
    log(f"[28] {dry_s:.2f} s with the processes' start-up; phase seconds "
        f"{row['phase_seconds']:.2f}; card: {card}")
    return row


def native_loader(card: str, cli_row: dict) -> dict:
    """Phase 29: the loaders' native helper against its numpy path."""
    from PIL import Image

    t_phase = time.perf_counter()
    if os.environ.get("COLDDIFF_NO_NATIVE"):
        raise AssertionError("phase 29: COLDDIFF_NO_NATIVE is set, so the loaders ran numpy")
    if cli_row["test_native_crops"] < CLI_TEST_END:
        raise AssertionError(f"phase 25's test cropped {cli_row['test_native_crops']} images "
                             f"through the native helper, expected >= {CLI_TEST_END}")
    row = dict(phase="29", cli_test_native_crops=cli_row["test_native_crops"],
               library=native.library_path().name)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        native.build(Path(tmp) / "fresh.so")
        row.update(build_seconds=time.perf_counter() - t0)
        folder = Path(tmp) / "png"
        write_pngs(folder, NATIVE_FOLDER_B, CLI_SIDE, SEED + 29)
        big = int(IMG * 1.12)
        rng = np.random.default_rng(SEED + 29)
        resized = [np.asarray(Image.open(p).resize((big, big), Image.BILINEAR))
                   for p in sorted(folder.glob("*.png"))]
        crops = [(int(rng.integers(0, big - IMG + 1)), int(rng.integers(0, big - IMG + 1)),
                  bool(rng.random() < 0.5)) for _ in resized]
        cifar = rng.integers(0, 256, (NATIVE_CIFAR_B, CIFAR, CIFAR, 3), dtype=np.uint8)

        def folder_batch():
            ds = ImageFolderDataset(str(folder), IMG, aug="aug1", seed=SEED)
            return np.stack([ds[i] for i in range(NATIVE_FOLDER_B)])

        def crop_batch():
            return np.stack([native.crop_flip_normalize(a, y0, x0, IMG, flip)
                             for a, (y0, x0, flip) in zip(resized, crops)])

        def cifar_batch():
            ds = ArrayDataset(cifar, aug="cifar", seed=SEED)
            return np.stack([ds[i] for i in range(NATIVE_CIFAR_B)])

        def use(path):
            if path == "numpy":
                os.environ["COLDDIFF_NO_NATIVE"] = "1"
            else:
                os.environ.pop("COLDDIFF_NO_NATIVE", None)
            native.reset()
            if (native.get_lib() is None) != (path == "numpy"):
                raise AssertionError(f"phase 29: the {path} path did not take effect")

        batches = (("folder", folder_batch), ("crop", crop_batch), ("cifar", cifar_batch))
        out, times = {}, {}
        try:
            for path in ("native", "numpy"):
                use(path)
                calls0 = sum(native.calls.values())
                out[path] = [fn() for _, fn in batches]
                ran = sum(native.calls.values()) - calls0
                want = NATIVE_FOLDER_B * 2 + NATIVE_CIFAR_B if path == "native" else 0
                if ran != want:
                    raise AssertionError(f"phase 29: the {path} path made {ran} native "
                                         f"calls, expected {want}")
            # the two paths in turns, each first in every other round
            for rep in range(NATIVE_REPS):
                for path in ("native", "numpy")[::1 if rep % 2 == 0 else -1]:
                    use(path)
                    for name, fn in batches:
                        t0 = time.perf_counter()
                        fn()
                        times.setdefault((name, path), []).append(time.perf_counter() - t0)
        finally:
            os.environ.pop("COLDDIFF_NO_NATIVE", None)
            native.reset()
        for (name, path), ts in times.items():
            row[f"{name}_ms_{path}"] = 1e3 * float(np.median(ts))
    for name, a, b in zip(("folder", "crop", "cifar"), out["native"], out["numpy"]):
        diff = np.abs(a.astype(np.float64) - b)
        if not (a.shape == b.shape and a.dtype == b.dtype == np.float32
                and diff.max() <= NATIVE_MAX_DIFF):
            raise AssertionError(f"phase 29 {name}: native vs numpy {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}, max |diff| {diff.max()} "
                                 f"(<= {NATIVE_MAX_DIFF})")
        row.update({f"{name}_max_abs_diff": float(diff.max()),
                    f"{name}_elements_differing": int((diff > 0).sum()),
                    f"{name}_elements": int(diff.size)})
    row.update(phase_seconds=time.perf_counter() - t_phase)
    log(f"[29] native loader helper ({row['library']}; a fresh g++ build "
        f"{row['build_seconds']:.3f} s): B={NATIVE_FOLDER_B} aug1 {CLI_SIDE} px PNGs -> "
        f"{IMG} px, a batch with decode and resize {row['folder_ms_native']:.3f} ms native vs "
        f"{row['folder_ms_numpy']:.3f} ms numpy, the crops alone "
        f"{row['crop_ms_native']:.3f} vs {row['crop_ms_numpy']:.3f} ms; B={NATIVE_CIFAR_B} "
        f"CIFAR pad-4 crops {row['cifar_ms_native']:.3f} vs {row['cifar_ms_numpy']:.3f} ms; "
        + ", ".join(f"{n} {row[n + '_elements_differing']} of {row[n + '_elements']} "
                    f"elements differ, max {row[n + '_max_abs_diff']:.3e}"
                    for n in ("folder", "crop", "cifar"))
        + f" (<= {NATIVE_MAX_DIFF:.3e}); phase 25's test made "
        f"{row['cli_test_native_crops']} native crops; card host of: {card}")
    return row


def _docs_hashes() -> dict:
    docs = REPO / "docs" / "examples"
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(docs.iterdir()) if p.is_file()}


def _sampler_calls(timesteps: int, refresh_every: int, n: int, chunk: int = 16) -> int:
    """Model forwards of one sample of ``n`` images at ``refresh_every``."""
    return -(-timesteps // refresh_every) * -(-n // chunk)


def record_workflows(device, card: str) -> dict:
    """Phase 30: the five record twins through their ``main`` at full width,
    short, under a temporary folder; then the bitwise resume."""
    from colddiff_torch.scripts import (_records, family_b_generation,
                                        family_b_refresh_quality, gmm_generation,
                                        refresh_quality, train_loss_parity)

    t_phase = time.perf_counter()
    mods = {"train_loss_parity": train_loss_parity, "refresh_quality": refresh_quality,
            "family_b_generation": family_b_generation,
            "family_b_refresh_quality": family_b_refresh_quality,
            "gmm_generation": gmm_generation}
    before = _docs_hashes()
    row = dict(phase="30", steps=REC_STEPS, n_gen=REC_N_GEN, refresh_images=REC_REFRESH_IMAGES,
               twins={})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        parity_runs, fb_run, gmm_run = tmp / "parity", tmp / "family_b", tmp / "gmm"
        fb_t, gmm_t = family_b_generation.T, gmm_generation.T
        n = REC_N_GEN
        # each timed sample is one forward of warm-up on one chunk, then the
        # sample (``_records.timed_call``); GMM's rows are not warmed
        plans = {
            "train_loss_parity": ([str(REC_STEPS), "--runs", str(parity_runs)],
                                  2 * REC_STEPS * ACCUM),
            "refresh_quality": (["--checkpoint", str(parity_runs / "fp32" / "model.pt"),
                                 "--n_images", str(REC_REFRESH_IMAGES)],
                                sum(1 + _sampler_calls(T, k, REC_REFRESH_IMAGES)
                                    for k in (*refresh_quality.FP32_KS,
                                              *refresh_quality.BF16_KS))),
            "family_b_generation": ([str(REC_STEPS), "--run", str(fb_run), "--n_gen", str(n)],
                                    REC_STEPS * ACCUM + 2 * (1 + _sampler_calls(fb_t, 1, n))),
            "family_b_refresh_quality": (["--checkpoint", str(fb_run / "model.pt"),
                                          "--n_gen", str(n)],
                                         sum(1 + _sampler_calls(fb_t, k, n)
                                             for k in family_b_refresh_quality.KS)),
            "gmm_generation": ([str(REC_STEPS), "--run", str(gmm_run), "--n_gen", str(n)],
                               REC_STEPS * ACCUM + 2 * _sampler_calls(gmm_t, 1, n)),
        }
        for name, (argv, forwards) in plans.items():
            out = tmp / f"torch_{name}.json"
            reset_peak(device)
            zero_launches()
            t0 = time.perf_counter()
            rc = mods[name].main([*argv, "--out", str(out)])
            torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            launches, small, wide = launch_counts()
            got = json.loads(out.read_text())
            want = _records.key_paths(json.loads(
                (REPO / "docs" / "examples" / REC_JAX[name]).read_text()))
            missing = sorted(want - _records.key_paths(got))
            if rc != 0 or missing:
                raise AssertionError(f"phase 30 {name}: exit {rc}, JAX record keys missing "
                                     f"{missing}")
            if (launches, small, wide) != (17 * forwards, forwards, 0):
                raise AssertionError(f"phase 30 {name}: front launches {(launches, small, wide)}"
                                     f", expected {(17 * forwards, forwards, 0)} ({forwards} "
                                     "forwards, 17 fronts each, the stem small-C)")
            r = dict(seconds=seconds, forwards=forwards, launches=launches,
                     small_c_launches=small, peak_bytes=torch.cuda.max_memory_allocated(device))
            if name == "train_loss_parity":
                for tag in ("fp32", "bf16"):
                    losses = [json.loads(s)["loss"] for s in
                              (parity_runs / tag / "losses.jsonl").read_text().splitlines()]
                    first = float(np.mean(losses[:REC_FALL]))
                    last = float(np.mean(losses[-REC_FALL:]))
                    if not (len(losses) == REC_STEPS and all(map(math.isfinite, losses))
                            and last < first):
                        raise AssertionError(f"phase 30 {name} {tag}: losses {losses} not "
                                             f"finite or not falling ({first} -> {last})")
                    r[f"{tag}_loss_first{REC_FALL}_mean"] = first
                    r[f"{tag}_loss_last{REC_FALL}_mean"] = last
                    r[f"{tag}_wall_s"] = got[tag]["wall_s"]
                r["tail50_rel_diff"] = got["tail50_rel_diff"]
            elif "loss_trajectory" in got:
                losses = [p["loss"] for p in got["loss_trajectory"]]
                if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
                    raise AssertionError(f"phase 30 {name}: losses {got['loss_trajectory']} "
                                         "not finite or not falling")
                r.update(loss_trajectory=got["loss_trajectory"],
                         train_time_s=got["train_time_s"])
                held = got["anchors_vs_jax"]
                if not all(v["within"] for v in held.values()):
                    raise AssertionError(f"phase 30 {name}: anchors against JAX {held}")
                r.update(anchors_vs_jax={k: v["diff"] for k, v in held.items()},
                         calibration=got["calibration"])
            for part in ("sweep", "bf16_sweep"):
                if part in got:
                    r[part] = got[part]
            for part in ("routines", "gmm"):
                if part in got:
                    r[part] = got[part]
            row["twins"][name] = r
            log(f"[30] {name}: {seconds:.1f} s, {forwards} forwards, front launches "
                f"{launches} (small-C {small}), JAX record keys all present; card: {card}")
        pngs = sorted(p.name for p in tmp.glob("*.png"))
        if len(pngs) != 6:
            raise AssertionError(f"phase 30: sample grids {pngs}, expected 6")

        # the resume: 10 steps, a new Trainer from the checkpoint, 10 more,
        # against 20 unbroken, with cuDNN's algorithm choice fixed
        prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            fbg = family_b_generation
            a = fbg.make_trainer(tmp / "unbroken", device=device)
            pa, _ = _records.run_steps(a, REC_STEPS, every=1, save_every=REC_RESUME_AT)
            b = fbg.make_trainer(tmp / "resumed", device=device)
            _records.run_steps(b, REC_RESUME_AT, every=1, save_every=REC_RESUME_AT)
            del b
            b = fbg.make_trainer(tmp / "resumed", device=device)
            resumed_at = b.step
            pb, _ = _records.run_steps(b, REC_STEPS, every=1, save_every=REC_RESUME_AT)
            sa, sb = a.state(), b.state()
            same = {k: all(torch.equal(x, y) for x, y in zip(sa[k].values(), sb[k].values()))
                    for k in ("model", "ema")}
            same["opt"] = all(torch.equal(x, y)
                              for i in sa["opt"]["state"]
                              for x, y in zip(sa["opt"]["state"][i].values(),
                                              sb["opt"]["state"][i].values()))
            same["losses"] = pa == pb
            same["generator"] = torch.equal(sa["generator"], sb["generator"])
            del a, b, sa, sb
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
        if not (resumed_at == REC_RESUME_AT and all(same.values())):
            raise AssertionError(f"phase 30 resume: resumed at {resumed_at}, bitwise {same}")
        row["resume"] = dict(cut=REC_RESUME_AT, steps=REC_STEPS, bitwise=same,
                             cudnn_restored=(torch.backends.cudnn.deterministic,
                                             torch.backends.cudnn.benchmark) == prev)
        log(f"[30] a Family-B run of {REC_RESUME_AT} steps resumed to {REC_STEPS} == "
            f"{REC_STEPS} unbroken, bitwise: {same} (cuDNN deterministic for this check, "
            f"restored to {prev})")
    after = _docs_hashes()
    if after != before:
        changed = sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))
        raise AssertionError(f"phase 30: docs/examples/ changed: {changed}")
    row.update(docs_examples_unchanged=True, phase_seconds=time.perf_counter() - t_phase)
    gc.collect()
    return row


def init_stats(model: torch.nn.Module) -> dict:
    """The JAX rule's statistics of ``model``'s parameters: the pooled std
    of w * sqrt(fan_in) over every conv and linear weight (fan_in the Flax
    kernel's, ``layers._flax_fan_in``), its largest |w| * sqrt(fan_in),
    the largest |bias|, and the largest |scale - 1| or |offset| of the
    norms."""
    sums, n, wmax, bmax, nmax = [0.0, 0.0], 0, 0.0, 0.0, 0.0
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
                z = m.weight.double() * math.sqrt(layers._flax_fan_in(m))
                sums[0] += z.sum().item()
                sums[1] += z.square().sum().item()
                n += z.numel()
                wmax = max(wmax, z.abs().max().item())
                if m.bias is not None:
                    bmax = max(bmax, m.bias.abs().max().item())
            elif isinstance(m, (ChannelLayerNorm, torch.nn.GroupNorm)):
                g, b = (m.g, m.b) if isinstance(m, ChannelLayerNorm) else (m.weight, m.bias)
                nmax = max(nmax, (g - 1).abs().max().item(), b.abs().max().item())
    mean = sums[0] / n
    return dict(weights=n, pooled_std=math.sqrt(sums[1] / n - mean * mean), pooled_mean=mean,
                max_abs_scaled=wmax, max_abs_bias=bmax, max_norm_dev=nmax)


def init_rule(device, card: str) -> dict:
    """Phase 31: the flagship and the CIFAR-10 ResNet built through the CLI's
    ``build`` (``--seed``), each held to the JAX package's initial
    distribution (``layers.init_as_flax``) and rebuilt bitwise from its
    seed; the flagship's initial fp32 loss on one synthetic batch of 16.
    Returns the phase's row."""
    t_phase = time.perf_counter()
    flags = {
        "UnetConvNext(64, (1, 2, 4, 8))": [
            "--dataset", "synthetic", "--model", "UnetConvNext", "--dim", "64",
            "--image_size", str(IMG), "--time_steps", str(T), "--blur_routine",
            "Exponential_reflect", "--blur_size", "15", "--blur_std", "0.01"],
        "UnetResNet cifar10": ["--dataset", "cifar10", "--model", "UnetResNet"],
    }
    row = dict(phase="31", seed=SEED, bound=INIT_BOUND, std_tol=INIT_STD_TOL, families={})
    for family, argv in flags.items():
        args = cli_main.build_parser().parse_args(
            ["train", *argv, "--device", str(device), "--seed", str(SEED)])
        t0 = time.perf_counter()
        d, model, size, _ = cli_main.build(args)
        build_s = time.perf_counter() - t0
        again = cli_main.build(args)[1]
        bitwise = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                        again.state_dict().values()))
        del again
        st = init_stats(model)
        r = dict(st, build_s=build_s, rebuilt_bitwise=bitwise,
                 params=sum(p.numel() for p in model.parameters()))
        if not (bitwise and abs(st["pooled_std"] - 1.0) <= INIT_STD_TOL
                and st["max_abs_scaled"] <= INIT_BOUND * (1 + 1e-6)
                and st["max_abs_bias"] == 0.0 and st["max_norm_dev"] == 0.0):
            raise AssertionError(f"phase 31 {family}: leaves the JAX rule's bands: {r}")
        if model.__class__ is UnetConvNext:
            model = model.to(device)
            ds = SyntheticDataset(size, 3, length=BATCH)
            x = torch.from_numpy(np.stack([ds[i] for i in range(BATCH)])).to(device)
            zero_launches()
            with torch.no_grad():
                loss = d.loss(model, x, torch.Generator(device=device).manual_seed(SEED)).item()
                out_std = model(x, torch.full((BATCH,), T // 2, device=device)).std().item()
            torch.cuda.synchronize(device)
            launches, small, _ = launch_counts()
            if not (math.isfinite(loss) and (launches, small) == (34, 2)):
                raise AssertionError(f"phase 31: initial loss {loss}, front launches "
                                     f"{(launches, small)}, expected (34, 2)")
            r.update(initial_loss_fp32=loss, jax_first10_loss_fp32=JAX_FIRST10_LOSS,
                     output_std_t100=out_std, launches=launches)
        row["families"][family] = r
        log(f"[31] {family} ({r['params']} parameters, built in {build_s:.2f} s, rebuilt "
            f"bitwise from --seed {SEED}: {bitwise}): pooled std of w*sqrt(fan_in) "
            f"{st['pooled_std']:.6f} (1 +- {INIT_STD_TOL}), mean {st['pooled_mean']:.2e}, "
            f"max |w|*sqrt(fan_in) {st['max_abs_scaled']:.6f} (<= {INIT_BOUND:.6f}), max "
            f"|bias| {st['max_abs_bias']}, max norm deviation {st['max_norm_dev']}"
            + (f"; initial fp32 loss {r['initial_loss_fp32']:.6f} on a synthetic batch of "
               f"{BATCH} (JAX record a's first-10 mean {JAX_FIRST10_LOSS}), output std at "
               f"t={T // 2} {r['output_std_t100']:.4f}, front launches {r['launches']}"
               if "initial_loss_fp32" in r else "") + f"; card: {card}")
        del model, d
    gc.collect()
    torch.cuda.empty_cache()
    row["phase_seconds"] = time.perf_counter() - t_phase
    return row


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
    # (shift, split) of each kernel's float4 path, for quad_path
    quad_args = {"roll_whole_row": (shift, width), "dyn_sublane": (0, 0),
                 "roll_then_slice": (shift, probe_script.SPLIT), "masked_norm": (0, 0)}
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


def resnet_norm_calls(device) -> Counter:
    """(C, H, swish) -> calls of ``group_norm_swish`` in one forward of the
    CIFAR-10 ResNet of ``get_model``, from a forward pre-hook on each
    ``FusedGroupNormSwish``; the forward's kernel launches checked to be
    one a call."""
    model = seeded_resnet(SEED, device).to(torch.bfloat16)
    calls = Counter()

    def hook(m, args):
        calls[(args[0].shape[1], args[0].shape[2], m.swish)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, layers.FusedGroupNormSwish)]
    before = gn_ops.group_norm_swish.launches
    try:
        with torch.inference_mode():
            model(torch.zeros(2, CIFAR, CIFAR, 3, device=device, dtype=torch.bfloat16),
                  torch.tensor([1, 2], device=device))
    finally:
        for h in handles:
            h.remove()
    launched = gn_ops.group_norm_swish.launches - before
    if launched != sum(calls.values()):
        raise AssertionError(f"a ResNet forward made {sum(calls.values())} GroupNorm-swish "
                             f"calls and {launched} kernel launches")
    return calls


def group_norm_row(gen, b, c, h, swish, device, timed=True) -> dict:
    """The kernel against the plain version at [b, c, h, h] bf16 (and fp32
    when not ``timed``), its form, and, when ``timed``, its device time
    beside the plain chain's, ``F.group_norm``'s (one call, its own affine
    before any rounding: a yardstick, not the same function) and the bound:
    x read once, the output written once, gamma and beta read once."""
    row = dict(shape=[b, c, h, h], swish=swish)
    for dtype in (torch.bfloat16,) if timed else (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        x = (torch.randn(b, c, h, h, generator=gen, device=device) * 2 + 0.5).to(
            dtype).contiguous(memory_format=torch.channels_last)
        gamma = (torch.rand(c, generator=gen, device=device) + 0.5).to(dtype)
        beta = (torch.randn(c, generator=gen, device=device) * 0.1).to(dtype)
        args = (x, gamma, beta, 32, 1e-6, swish)
        got = gn_ops.group_norm_swish(*args)
        want = gn_ops.group_norm_swish_plain(*args)
        if not torch.equal(got, gn_ops.group_norm_swish(*args)):
            raise AssertionError(f"group_norm_swish {row['shape']} {tag}: two runs differ")
        err = (got.float() - want.float()).abs()
        share = (got != want).float().mean().item()
        tol = GN_BF16_TOL if dtype == torch.bfloat16 else GN_FP32_TOL
        if not (bool((err <= tol + tol * want.float().abs()).all())
                and (dtype == torch.float32 or share <= GN_BF16_MISMATCH)):
            raise AssertionError(f"group_norm_swish {row['shape']} {tag}: max err "
                                 f"{err.max().item()}, elements not equal {share}")
        row.update({f"form_{tag}": gn_ops.kernel_form(h * h, c, dtype),
                    f"max_abs_err_{tag}": err.max().item(), f"not_equal_{tag}": share})
    if timed:
        bound_ms, bound_by = bound(2 * x.nbytes + gamma.nbytes + beta.nbytes, 0)
        row.update(bound_us=1e3 * bound_ms, bound_by=bound_by)
        timed_row(row, "ms", lambda: gn_ops.group_norm_swish(*args))
        timed_row(row, "plain_ms", lambda: gn_ops.group_norm_swish_plain(*args), PLAIN_RUN)
        timed_row(row, "library_ms", lambda: F.group_norm(x, 32, gamma, beta, 1e-6))
        row["bound_share"] = bound_ms / row["ms"]
    return row


def resnet_train_steps(device, folder: str, plain: bool):
    """Median wall ms of GN_TRAIN_STEPS bf16 ``Trainer.train_step`` calls of
    the CIFAR-10 ResNet at B=GN_TRAIN_BATCH (dropout 0.1), after 3 warm-up
    steps, and the kernel's launches over the timed steps.  ``plain``: every
    GroupNorm-swish runs the plain chain under direct autograd, the path
    before the kernel.  (The two paths alternated step by step in one
    Trainer slowed the plain one to 190-280 ms a step.)"""
    kernel = gn_ops.group_norm_swish
    patch = (mock.patch.object(gn_ops, "group_norm_swish", gn_ops.group_norm_swish_plain)
             if plain else contextlib.nullcontext())
    tr = Trainer(cifar_blur(device), seeded_resnet(SEED, device),
                 SyntheticDataset(CIFAR, 3, length=4 * GN_TRAIN_BATCH),
                 train_batch_size=GN_TRAIN_BATCH, gradient_accumulate_every=1, bf16=True,
                 num_workers=1, seed=SEED, device=device, results_folder=folder)
    times, losses = [], []
    with patch:
        for _ in range(3):
            tr.train_step(tr._next_superbatch())
        before = kernel.launches
        for _ in range(GN_TRAIN_STEPS):
            batch = tr._next_superbatch()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            losses.append(tr.train_step(batch).item())
            torch.cuda.synchronize(device)
            times.append(1e3 * (time.perf_counter() - t0))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ResNet train steps ({'plain' if plain else 'kernel'}): "
                             f"losses {losses}")
    return float(np.median(times)), kernel.launches - before


def group_norm_kernel(device, card: str):
    """Phase 32: the GroupNorm-swish kernel (``csrc/group_norm_swish.cu``),
    which replaces no TPU kernel: at each (C, H, swish) of a CIFAR-10
    ResNet forward, at B=GN_BATCH in bf16, against the plain version
    (two runs bitwise equal), timed beside its bound, the plain chain and
    ``F.group_norm``, and summed over the forward's 51 calls; the streaming
    form at GN_STREAM_SHAPES in bf16 and fp32; then the ResNet's bf16
    train step at B=GN_TRAIN_BATCH on the plain path and the kernel's, a
    Trainer a turn.  Returns the phase's row."""
    t_phase = time.perf_counter()
    calls = resnet_norm_calls(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    rows = []
    for (c, h, swish), n in sorted(calls.items()):
        row = group_norm_row(gen, GN_BATCH, c, h, swish, device)
        row["calls"] = n
        rows.append(row)
        log(f"[32] {row['shape']} swish {swish} x{n}: {row['ms'] * 1e3:.3f} us, bound "
            f"{row['bound_us']:.3f} us ({100 * row['bound_share']:.2f}%), plain "
            f"{row['plain_ms'] * 1e3:.3f} us, F.group_norm {row['library_ms'] * 1e3:.3f} us; "
            f"form {row['form_bf16']}, max err {row['max_abs_err_bf16']:.3e}, not equal "
            f"{row['not_equal_bf16']:.2e}" + (f"; host-paced: {row['host_paced']}"
                                              if "host_paced" in row else ""))
    total = {k: sum(r["calls"] * r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_us")}
    n_calls = sum(calls.values())
    log(f"[32] the {n_calls} GroupNorm-swish calls of a forward at B={GN_BATCH} bf16: kernel "
        f"{total['ms']:.4f} ms, bound {total['bound_us'] / 1e3:.4f} ms "
        f"({100 * total['bound_us'] / 1e3 / total['ms']:.2f}%), plain {total['plain_ms']:.4f} "
        f"ms, F.group_norm {total['library_ms']:.4f} ms; card: {card}")
    stream = [group_norm_row(gen, GN_STREAM_BATCH, c, h, True, device, timed=False)
              for c, h in GN_STREAM_SHAPES]
    for r in stream:
        if not (r["form_bf16"]["chunks"] > 1 and r["form_fp32"]["chunks"] > 1):
            raise AssertionError(f"{r['shape']} did not take the streaming form: {r}")
        log(f"[32] streaming form {r['shape']}: bf16 {r['form_bf16']} max err "
            f"{r['max_abs_err_bf16']:.3e}; fp32 {r['form_fp32']} max err "
            f"{r['max_abs_err_fp32']:.3e}")
    train = {}
    with tempfile.TemporaryDirectory() as folder:
        for i, plain in enumerate((True, False, False, True)):
            ms, launched = resnet_train_steps(device, f"{folder}/{i}", plain)
            train.setdefault("plain" if plain else "kernel", []).append((ms, launched))
            reset_peak(device)
    if {n for _, n in train["plain"]} != {0} or {n for _, n in train["kernel"]} != {
            n_calls * GN_TRAIN_STEPS}:
        raise AssertionError(f"train-step launches {train}: one forward a step launches "
                             f"{n_calls}, its backward recomputes in plain PyTorch")
    log(f"[32] ResNet bf16 train step B={GN_TRAIN_BATCH} (median of {GN_TRAIN_STEPS}), "
        f"one Trainer a turn, plain, kernel, kernel, plain: plain "
        f"{[round(ms, 3) for ms, _ in train['plain']]} ms, kernel "
        f"{[round(ms, 3) for ms, _ in train['kernel']]} ms; card: {card}")
    seconds = time.perf_counter() - t_phase
    log(f"[32] phase seconds {seconds:.2f}")
    return dict(phase="32", rows=rows, total=total, calls=n_calls, stream=stream,
                train_step_ms=train, phase_seconds=seconds)


def ada_group_norm_row(device, card: str) -> dict:
    """Phase 33: the GroupNorm-swish kernel with a per-image [B, C] affine at
    ADA_GN_SHAPE in bf16 (see the module docstring).  Returns the row."""
    b, c, h = ADA_GN_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    x = (torch.randn(b, c, h, h, generator=gen, device=device) * 2 + 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    gamma = (torch.rand(b, c, generator=gen, device=device) + 0.5).to(torch.bfloat16)
    beta = (torch.randn(b, c, generator=gen, device=device) * 0.1).to(torch.bfloat16)
    args = (x, gamma, beta, 32, 1e-5, True)
    before = gn_ops.group_norm_swish.launches
    got = gn_ops.group_norm_swish(*args)
    torch.cuda.synchronize()
    if gn_ops.group_norm_swish.launches != before + 1:
        raise AssertionError("a per-image affine call launched "
                             f"{gn_ops.group_norm_swish.launches - before} kernels, not 1")
    if not torch.equal(got, gn_ops.group_norm_swish(*args)):
        raise AssertionError("per-image affine: two runs differ")
    for i in range(b):
        one = gn_ops.group_norm_swish(x[i:i + 1], gamma[i], beta[i], 32, 1e-5, True)
        if not torch.equal(got[i:i + 1], one):
            raise AssertionError(f"per-image affine: image {i} differs from its [C] call")
    want = gn_ops.group_norm_swish_plain(*args)
    err = (got.float() - want.float()).abs()
    share = (got != want).float().mean().item()
    if not (bool((err <= GN_BF16_TOL + GN_BF16_TOL * want.float().abs()).all())
            and share <= GN_BF16_MISMATCH):
        raise AssertionError(f"per-image affine: max err {err.max().item()}, elements not "
                             f"equal {share}")
    row = dict(shape=[b, c, h, h], form=gn_ops.kernel_form(h * h, c, torch.bfloat16),
               max_abs_err=err.max().item(), not_equal=share)
    bound_ms, row["bound_by"] = bound(2 * x.nbytes + gamma.nbytes + beta.nbytes, 0)
    row["bound_us"] = 1e3 * bound_ms
    timed_row(row, "ms", lambda: gn_ops.group_norm_swish(*args))
    timed_row(row, "shared_affine_ms",
              lambda: gn_ops.group_norm_swish(x, gamma[0], beta[0], 32, 1e-5, True))
    row["bound_share"] = bound_ms / row["ms"]
    log(f"[33] per-image affine {row['shape']} bf16: {row['ms'] * 1e3:.3f} us, bound "
        f"{row['bound_us']:.3f} us ({100 * row['bound_share']:.2f}%), [C] affine "
        f"{row['shared_affine_ms'] * 1e3:.3f} us; form {row['form']}, max err "
        f"{row['max_abs_err']:.3e}, not equal {share:.2e}; card: {card}")
    return row


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
                                                snapshot=True)[1:4]
        fgen_row.update(train_images_per_s=ips, train_peak_bytes=peak,
                        train_launches=fg_launches)
        log(f"[14] fade_generation Trainer.train() B={BATCH} x accum {ACCUM} {IMG}px bf16, "
            f"3 steps (the last with save + EMA snapshot, T=750): {ips:.3f} train images/s "
            f"(median of the 2 steps without the snapshot), peak memory {peak} bytes "
            f"({peak / 2**30:.2f} GiB), front launches {fg_launches}; card: {card}")
        flows.append(random_fade_path(dev, folder + "/p15", card))
    # 16. all_sample
    flows.append(trajectories(model16, dev, card))
    # 17-20. noise, mix, snow, fade_naive
    with tempfile.TemporaryDirectory() as folder:
        flows += last_workflows(model16, dev, folder, card)
    del model16
    log("[11-20] " + json.dumps(flows))

    # 21-23. CIFAR-10 with the ResNet UNet, the other training routines,
    # sample_multi_step
    with tempfile.TemporaryDirectory() as folder:
        late = [resnet_cifar(dev, folder + "/p21", card)]
        reset_peak(dev)
        late += routine_workflows(dev, folder + "/p22", card)
    reset_peak(dev)
    late.append(multi_step_path(dev, card))
    log("[21-23] " + json.dumps(late))

    # 24. the eval surface
    reset_peak(dev)
    eval_row = eval_path(dev, card)
    log("[24] " + json.dumps(eval_row))

    # 25. the command line
    reset_peak(dev)
    cli_row = cli_path(dev, card)
    log("[25] " + json.dumps(cli_row))

    # 26. the Trainer under a process group; two processes on the card
    reset_peak(dev)
    log("[26] " + json.dumps(parallel_path(dev, card, eval_row["scores"]), default=float))

    # 27. row sharding: two processes on the card, and a group of one
    reset_peak(dev)
    space_row = spatial_path(dev, card)
    log("[27] " + json.dumps(space_row, default=float))

    # 28. row sharding on the other workflows, the ResNet and the loss
    reset_peak(dev)
    flows_row = spatial_workflows(card)
    log("[28] " + json.dumps(flows_row, default=float))

    # 29. the loaders' native helper on the card's host
    log("[29] " + json.dumps(native_loader(card, cli_row)))

    # 30. the record workflows, short, at full width
    reset_peak(dev)
    log("[30] " + json.dumps(record_workflows(dev, card), default=float))

    # 31. the JAX package's initialisation, through the CLI's build
    log("[31] " + json.dumps(init_rule(dev, card), default=float))

    # 32. the GroupNorm-swish kernel
    reset_peak(dev)
    gn_row = group_norm_kernel(dev, card)
    log("[32] " + json.dumps(gn_row, default=float))

    # 33. the GroupNorm-swish kernel with a per-image affine (ADM's AdaGN)
    log("[33] " + json.dumps(ada_group_norm_row(dev, card), default=float))

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
    gn_big = max(gn_row["rows"], key=lambda r: r["calls"] * r["ms"])
    kernels.append({
        "name": "group_norm_swish", "kernel": "group_norm_swish_kernel", "route": "cuda",
        "source": "colddiff_torch/csrc/group_norm_swish.cu",
        "replaces": "none (colddiff/models/layers.py:92-95: XLA's fusion, no Pallas kernel)",
        # launches: phase 21's bf16 sample (T forwards) and its Trainer's steps
        "launches": late[0]["norm_launches"], "train_launches": late[0]["train_norm_launches"],
        "max_abs_err": max(r["max_abs_err_bf16"] for r in gn_row["rows"]),
        "shape": gn_big["shape"], "dtype": "bfloat16", "ms": gn_big["ms"],
        "plain_ms": gn_big["plain_ms"], "library_ms": gn_big["library_ms"],
        "bound_ms": gn_big["bound_us"] / 1e3, "bound_us": gn_big["bound_us"],
        "bound_by": gn_big["bound_by"], "forward_ms": gn_row["total"]["ms"],
        "forward_bound_ms": gn_row["total"]["bound_us"] / 1e3,
    })
    log(f"[27] front launches of the row-sharded T={T} sample, per process: "
        f"{space_row['dryrun']['launches']} (17 x {T}; one process {space_row['dryrun']['launches_1']})")
    log("[28] front launches of the row-sharded samples, per process: " + ", ".join(
        f"{name} {r['routine']} {r['launches']}"
        for name, w in flows_row["dryrun"]["workflows"].items() for r in w["rows"]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
