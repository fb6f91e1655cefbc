"""Unified CLI mirroring the reference entry scripts' flag surface, the
twin of ``colddiff/cli/main.py``.

  python -m colddiff_torch.cli.main train --degradation blur --dataset mnist \
      --data_path ./root_mnist --time_steps 20 --blur_size 11 --blur_std 7.0 \
      --blur_routine Constant --sampling_routine x0_step_down

  python -m colddiff_torch.cli.main test --test_type test_data \
      --load_path ./results/model.pt ...

Flag names, aliases, defaults and choices are the JAX CLI's (--time_steps,
--blur_routine, --sampling_routine, --train_routine, --test_type,
--residual, --remove_time_embed, --loss_type, --discrete, ...), plus
``--device``: the entry points run on ``cuda`` and raise without a card
unless ``--device cpu`` is passed.  The checkpoint is
``<results>/model.pt``.

Several processes (colddiff/cli/main.py:509-521): ``--multihost`` joins
the group that a launcher such as ``torchrun`` describes in the
environment; ``--coordinator_address host:port --num_processes N
--process_id i`` joins one without a launcher; ``--param_sharding fsdp``
shards the Trainer's state (alone, a group of one process).  Every process
runs the same command; the restart supervisor decides before any group or
card is touched.  ``--eval_mesh auto`` shards evaluation over the group
when it has more than one process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="colddiff_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--degradation", "--forward_process_type",
                        dest="degradation", default="blur",
                        choices=["blur", "noise", "mix", "decolor", "fade",
                                 "fade_naive", "fade_generation", "resolution",
                                 "snow"])
        sp.add_argument("--dataset", default="folder",
                        help="mnist | cifar10 | folder | synthetic | celeba "
                             "| flowers | lsun_church (named sets parse the "
                             "standard torchvision on-disk layouts)")
        sp.add_argument("--data_path", default="./data")
        sp.add_argument("--data_path_2", default=None,
                        help="second dataset folder (demixing/animorphosis)")
        sp.add_argument("--image_size", "--resolution", dest="image_size",
                        type=int, default=None)
        sp.add_argument("--channels", type=int, default=None)
        sp.add_argument("--time_steps", type=int, default=50)
        sp.add_argument("--sample_steps", type=int, default=None,
                        help="reverse-sample from this level (default: T)")
        sp.add_argument("--model", default="UnetConvNext",
                        choices=["UnetConvNext", "UnetResNet", "UnetADM"])
        sp.add_argument("--dim", type=int, default=64)
        sp.add_argument("--remove_time_embed", action="store_true")
        sp.add_argument("--residual", action="store_true")
        sp.add_argument("--output_mean_scale", action="store_true")
        sp.add_argument("--random_aug", action="store_true")
        sp.add_argument("--exp_name", default=None,
                        help="results subfolder name under --save_folder")
        sp.add_argument("--loss_type", default="l1", choices=["l1", "l2", "sqrt"])
        sp.add_argument("--train_routine", default="Final")
        sp.add_argument("--sampling_routine", default="x0_step_down")
        sp.add_argument("--discrete", action="store_true")
        sp.add_argument("--recon_noise_std", type=float, default=0.0)
        sp.add_argument("--save_folder", default="./results")
        sp.add_argument("--load_path", default=None,
                        help="a colddiff_torch checkpoint (<results>/model.pt)")
        sp.add_argument("--load_torch_path", default=None,
                        help="a reference PyTorch model.pt checkpoint "
                             "({step, model, ema})")
        sp.add_argument("--resume_training", action="store_true",
                        help="auto-resume from the latest checkpoint")
        sp.add_argument("--batch_size", "--bs", dest="batch_size",
                        type=int, default=32)
        sp.add_argument("--seed", "--order_seed", dest="seed", type=int,
                        default=0)
        sp.add_argument("--bf16", action="store_true")
        sp.add_argument("--param_sharding", default="replicated",
                        choices=["replicated", "fsdp"],
                        help="fsdp: the parameters, EMA and Adam moments sharded "
                             "over the processes (fully_shard)")
        # several processes: a launcher's environment (--multihost) or the
        # three explicit values
        sp.add_argument("--multihost", action="store_true",
                        help="join the process group a launcher (torchrun) describes")
        sp.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 (without a launcher)")
        sp.add_argument("--num_processes", type=int, default=None)
        sp.add_argument("--process_id", type=int, default=None)
        # blur
        sp.add_argument("--blur_routine", default="Incremental")
        sp.add_argument("--blur_size", type=int, default=3, dest="blur_size")
        sp.add_argument("--blur_std", type=float, default=0.1)
        # fade
        sp.add_argument("--fade_routine", default="Incremental")
        sp.add_argument("--kernel_std", type=float, default=0.1)
        sp.add_argument("--initial_mask", type=int, default=11)
        sp.add_argument("--reverse", action="store_true")
        # resolution
        sp.add_argument("--resolution_routine", default="Incremental")
        # decolor
        sp.add_argument("--decolor_routine", default="Constant")
        sp.add_argument("--decolor_ema_factor", type=float, default=0.9)
        sp.add_argument("--decolor_total_remove", action="store_true")
        sp.add_argument("--to_lab", action="store_true")
        # snow
        sp.add_argument("--snow_level", type=int, default=1)
        sp.add_argument("--random_snow", action="store_true")
        sp.add_argument("--single_snow", action="store_true")
        sp.add_argument("--fix_brightness", action="store_true")
        # the one flag the JAX CLI lacks
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; never falls back to the CPU")

    tr = sub.add_parser("train")
    common(tr)
    tr.add_argument("--train_steps", type=int, default=700000)
    tr.add_argument("--lr", type=float, default=2e-5)
    tr.add_argument("--grad_accum", type=int, default=2)
    tr.add_argument("--ema_decay", type=float, default=0.995)
    tr.add_argument("--save_and_sample_every", type=int, default=1000)
    tr.add_argument("--restart_every_steps", type=int, default=0,
                    help="checkpoint and respawn a fresh worker process "
                         "every N steps; the run resumes where it stopped")
    tr.add_argument("--restart_rss_gb", type=float, default=0.0,
                    help="also respawn when host RSS crosses this many GB")

    te = sub.add_parser("test")
    common(te)
    te.add_argument("--test_type", default="test_data",
                    help="any name of TEST_TYPES, e.g. train_data | test_data | "
                         "test_fid_distance_decrease_from_manifold | "
                         "test_sample_and_save_for_fid | "
                         "train_distribution_mean_blur_torch_gmm | "
                         "test_paper_showing_diffusion_images")
    te.add_argument("--refresh_every", type=int, default=1,
                    help="opt-in sampling acceleration (beyond reference): "
                         "refresh the x0 prediction every K reverse steps "
                         "and reuse it in between (1 = exact reference "
                         "algorithm)")
    te.add_argument("--fid_weights", default=None)
    te.add_argument("--eval_mesh", choices=["auto", "off"], default="auto",
                    help="auto: shard evaluation over the processes; "
                         "off: every process evaluates the whole batch")
    te.add_argument("--gmm_cluster", type=int, default=1)
    te.add_argument("--gmm_size", type=int, default=16,
                    help="low-res side for the degraded-image GMM")
    te.add_argument("--gmm_sample_at", type=int, default=None,
                    help="degradation level the blur-GMM is fitted at")
    te.add_argument("--noise", type=float, default=0.0)
    te.add_argument("--test_start", type=int, default=0)
    te.add_argument("--test_end", type=int, default=500)
    return p


_DATASET_DEFAULTS = {
    "mnist": dict(image_size=28, channels=1),
    "cifar10": dict(image_size=32, channels=3),
    "folder": dict(image_size=128, channels=3),
    "synthetic": dict(image_size=32, channels=3),
}


def make_dataset(args, image_size, train=True, channels=3):
    from ..data.datasets import (
        ArrayDataset,
        ImageFolderDataset,
        SyntheticDataset,
        load_cifar10_batches,
        load_mnist_idx,
    )

    if args.dataset == "synthetic":
        return SyntheticDataset(image_size, channels, length=512, seed=args.seed)
    folder_aug = "random_aug" if getattr(args, "random_aug", False) else "aug1"
    if args.dataset == "mnist":
        return ArrayDataset(load_mnist_idx(args.data_path, train=train))
    if args.dataset == "cifar10":
        return ArrayDataset(
            load_cifar10_batches(args.data_path, train=train),
            aug="cifar" if train else None,
        )
    if args.dataset in ("celeba", "flowers", "lsun_church"):
        from ..data.get_dataset import get_dataset as named_dataset

        name = {"celeba": "CelebA", "flowers": "flower",
                "lsun_church": "lsun_church"}[args.dataset]
        split = "train" if train else (
            "val" if args.dataset == "lsun_church" else "test")
        return named_dataset(
            f"{name}_{split}", args.data_path, image_size,
            random_aug=getattr(args, "random_aug", False), seed=args.seed,
        )
    return ImageFolderDataset(
        args.data_path, image_size, aug=folder_aug if train else "center",
        seed=args.seed,
    )


def make_operator(args, image_size, channels):
    from ..operators import get_operator

    name = args.degradation
    cfg = {"timesteps": args.time_steps}
    if name == "blur":
        cfg.update(image_size=image_size, blur_routine=args.blur_routine,
                   kernel_size=args.blur_size, kernel_std=args.blur_std,
                   discrete=args.discrete)
    elif name in ("noise", "mix"):
        pass
    elif name == "decolor":
        cfg.update(channels=channels, decolor_routine=args.decolor_routine,
                   decolor_ema_factor=args.decolor_ema_factor,
                   decolor_total_remove=args.decolor_total_remove,
                   to_lab=args.to_lab)
    elif name == "fade":
        cfg.update(image_size=image_size, fade_routine=args.fade_routine,
                   kernel_std=args.kernel_std, initial_mask=args.initial_mask,
                   discrete=args.discrete)
    elif name == "fade_naive":
        cfg.update(image_size=image_size, fade_routine=args.fade_routine)
    elif name == "fade_generation":
        cfg.update(image_size=image_size, kernel_std=args.kernel_std,
                   initial_mask=args.initial_mask, reverse=args.reverse)
    elif name == "resolution":
        cfg.update(image_size=image_size,
                   resolution_routine=args.resolution_routine)
    elif name == "snow":
        cfg.update(image_size=image_size, snow_level=args.snow_level,
                   random_snow=args.random_snow, single_snow=args.single_snow,
                   fix_brightness=args.fix_brightness,
                   batch_size=args.batch_size)
    return get_operator(name, device=args.device, **cfg)


def build(args):
    import torch

    from ..diffusion import ColdDiffusion
    from ..models import get_model

    defaults = _DATASET_DEFAULTS.get(args.dataset, _DATASET_DEFAULTS["folder"])
    image_size = args.image_size or defaults["image_size"]
    channels = args.channels or defaults["channels"]
    op = make_operator(args, image_size, channels)
    diffusion = ColdDiffusion(
        op=op, image_size=image_size, channels=channels,
        loss_type=args.loss_type, train_routine=args.train_routine,
        sampling_routine=args.sampling_routine,
        discrete=args.discrete, recon_noise_std=args.recon_noise_std,
    )
    # the weights start from --seed, as the JAX Trainer's init from key(seed)
    # does, so every process of a run builds the same model
    torch.manual_seed(args.seed)
    model = get_model(
        args.model, dataset=args.dataset, image_size=image_size,
        channels=channels, with_time_emb=not args.remove_time_embed,
        residual=args.residual, dim=args.dim,
        output_mean_scale=args.output_mean_scale,
    )
    return diffusion, model, image_size, channels


def _results_folder(args):
    return (os.path.join(args.save_folder, args.exp_name)
            if args.exp_name else args.save_folder)


_RESTART_EXIT_CODE = 75  # EX_TEMPFAIL: worker hit a restart boundary


def _supervise_train(raw_argv):
    """Supervisor for long runs: respawn clean worker processes until done.

    The worker trains up to the next --restart_every_steps / --restart_rss_gb
    boundary, checkpoints, and exits with _RESTART_EXIT_CODE; each respawn
    starts from a fresh process (its host memory freed) that resumes from
    the rolling checkpoint.  The supervisor itself never touches a device.
    Returns the last worker's exit code.
    """
    child_argv = list(raw_argv)
    if "--resume_training" not in child_argv:
        child_argv.append("--resume_training")
    env = dict(os.environ, COLDDIFF_RESTART_WORKER="1")
    n = 0
    while True:
        n += 1
        r = subprocess.run([sys.executable, "-m", "colddiff_torch.cli.main",
                            *child_argv], env=env)
        if r.returncode != _RESTART_EXIT_CODE:
            return r.returncode
        print(f"[supervisor] worker {n} hit restart boundary; respawning",
              flush=True)


def _is_restart_supervisor(args) -> bool:
    return bool((args.restart_every_steps or args.restart_rss_gb)
                and not os.environ.get("COLDDIFF_RESTART_WORKER"))


def _second_dataset(args, image_size, aug):
    """mix's endpoint images, from --data_path_2."""
    if args.degradation != "mix":
        return None
    if args.data_path_2 is None:
        raise SystemExit("--data_path_2 required for mix/animorphosis")
    from ..data.datasets import ImageFolderDataset

    return ImageFolderDataset(args.data_path_2, image_size, aug=aug, seed=args.seed + 1)


def run_train(args, raw_argv=None):
    from ..train import Trainer

    if _is_restart_supervisor(args) and raw_argv is not None:
        # normally handled in main() before any device use; kept here as a
        # backstop for programmatic callers
        sys.exit(_supervise_train(raw_argv))

    diffusion, model, image_size, channels = build(args)
    ds = make_dataset(args, image_size, train=True, channels=channels)
    ds2 = _second_dataset(args, image_size, "aug1")
    trainer = Trainer(
        diffusion, model, ds, second_dataset=ds2,
        train_batch_size=args.batch_size, train_lr=args.lr,
        train_num_steps=args.train_steps,
        gradient_accumulate_every=args.grad_accum, ema_decay=args.ema_decay,
        save_and_sample_every=args.save_and_sample_every,
        results_folder=_results_folder(args), load_path=args.load_path,
        load_torch_path=args.load_torch_path,
        auto_resume=args.resume_training,
        restart_every_steps=args.restart_every_steps,
        restart_rss_gb=args.restart_rss_gb,
        bf16=args.bf16, seed=args.seed, to_lab=args.to_lab,
        param_sharding=args.param_sharding, device=args.device,
    )
    if trainer.train() == "restart":
        sys.exit(_RESTART_EXIT_CODE)


# --test_type -> the EvalHarness method it runs (colddiff/cli/main.py:403-500)
TEST_TYPES = {
    **dict.fromkeys(("train_data", "test_data"), "test_from_data"),
    **dict.fromkeys(("mixup", "mixup_train_data", "mixup_test_data"), "test_with_mixup"),
    **dict.fromkeys(("test_from_random", "test_random", "train_random"), "test_from_random"),
    "controlled_direct_reconstruct": "controlled_direct_reconstruct",
    **dict.fromkeys(("save_training_data", "train_save_orig_data_same_as_trained",
                     "test_save_orig_data_same_as_tested"), "save_training_data"),
    **dict.fromkeys(("test_fid_distance_decrease_from_manifold",
                     "train_fid_distance_decrease_from_manifold"),
                    "fid_distance_decrease_from_manifold"),
    "test_sample_and_save_for_fid": "sample_and_save_for_fid",
    **dict.fromkeys(("train_distribution_mean_blur_torch_gmm",
                     "train_distribution_mean_blur_torch_gmm_ablation"), "gmm_mean_samples"),
    "train_distribution_blur_torch_gmm": "gmm_blur_samples",
    "train_distribution_gmm": "gmm_vector_samples",
    **dict.fromkeys(("train_distribution_save_gmm", "train_distribution_save_gmm_slowly",
                     "train_distribution_save_pytorch_gmm"), "gmm_vector_samples_and_save"),
    **dict.fromkeys(("train_distribution_vector_from_blur_gmm",
                     "sample_as_a_vector_from_blur_pytorch_gmm_and_save"),
                    "gmm_from_blur_samples_and_save"),
    **dict.fromkeys(("sample_from_train_data", "sample_from_test_data"),
                    "sample_from_data_save"),
    **dict.fromkeys(("test_save_images", "test_data_save_results"),
                    "test_from_data_save_results"),
    "sample_from_blur": "sample_from_blur",
    # test_paper_series, test_paper, test_rebuttal: snowification/test.py:177-185
    **dict.fromkeys(("test_paper_showing_diffusion_images",
                     "train_paper_showing_diffusion_images", "test_paper_series"),
                    "paper_showing_diffusion_images"),
    **dict.fromkeys(("test_paper_invert_section_images",
                     "train_paper_invert_section_images", "test_paper"),
                    "paper_invert_section_images"),
    "test_paper_showing_diffusion_images_diff": "paper_showing_diffusion_images_diff",
    "test_paper_showing_sampling_diff_images": "paper_showing_sampling_diff_images",
    **dict.fromkeys(("test_paper_showing_diffusion_images_cover_page",
                     "train_paper_showing_diffusion_images_cover_page", "test_rebuttal"),
                    "paper_cover_page"),
    "train_paper_showing_diffusion_images_cover_page_both_sampling":
        "paper_cover_page_both_sampling",
    "test_paper_trajectory_strip": "paper_trajectory_strip",
    "forward_and_backward": "forward_and_backward",
}

# names the reference's test scripts dispatch but whose Trainer methods were
# never defined upstream (copy-pasted dispatch tables, e.g.
# resolution-diffusion-pytorch/cifar10_test.py:70,120-125,156) -- fail
# loudly instead of silently misbehaving
DEAD_UPSTREAM = ("train_distribution_cov_vector", "train_data_dropout",
                 "test_data_dropout", "test_paper_showing_diffusion_imgs_og")


def _check_test_type(tt: str) -> None:
    if tt in DEAD_UPSTREAM:
        raise SystemExit(
            f"--test_type {tt} is dead in the reference (dispatched by its "
            "test scripts but the Trainer method was never defined); no "
            "behavior exists to match")
    if tt not in TEST_TYPES:
        raise SystemExit(f"unknown --test_type {tt}")


def _host(x) -> np.ndarray:
    import torch

    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def dispatch(harness, args, ds, ds2=None):
    """Run ``args.test_type``'s harness method (``TEST_TYPES``) on ``ds``
    with the CLI's arguments, as colddiff/cli/main.py:388-500 does; over
    several processes, rank 0 writes the files."""
    from ..parallel import process_index
    from ..utils import save_image_grid

    writes = process_index() == 0

    tt = args.test_type
    _check_test_type(tt)

    def first_batch(n=None):
        return np.stack([ds[i] for i in range(min(n or args.batch_size, len(ds)))])

    def mixup(h):
        b = first_batch(2 * args.batch_size)
        half = len(b) // 2
        h.test_with_mixup(b[:half], b[half:])

    def manifold(h):
        out = h.fid_distance_decrease_from_manifold(
            ds, start=args.test_start, end=args.test_end, batch_size=args.batch_size)
        if writes:
            with open(Path(_results_folder(args)) / "manifold_metrics.json", "w") as f:
                json.dump(out, f, indent=2, default=float)

    def gmm_mean(h):
        res = h.gmm_mean_samples(ds, clusters=args.gmm_cluster, num=args.batch_size,
                                 noise_level=args.noise)
        if writes:
            save_image_grid(_host(res.img), h.results_folder / "gmm_samples.png")

    def gmm_blur(h):
        res = h.gmm_blur_samples(
            ds, clusters=args.gmm_cluster, num=args.batch_size,
            sample_at=args.gmm_sample_at or args.sample_steps,
            gmm_res=args.gmm_size, noise_level=args.noise)
        if writes:
            save_image_grid(_host(res.img), h.results_folder / "gmm_blur_samples.png")

    runners = {
        "test_from_data": lambda h: h.test_from_data(first_batch()),
        "test_with_mixup": mixup,
        "test_from_random": lambda h: h.test_from_random(first_batch()),
        "controlled_direct_reconstruct":
            lambda h: h.controlled_direct_reconstruct(first_batch()),
        "save_training_data": lambda h: h.save_training_data(ds),
        "fid_distance_decrease_from_manifold": manifold,
        "sample_and_save_for_fid": lambda h: h.sample_and_save_for_fid(
            batch_size=args.batch_size, endpoint_dataset=ds2),
        "gmm_mean_samples": gmm_mean,
        "gmm_blur_samples": gmm_blur,
        "gmm_vector_samples": lambda h: h.gmm_vector_samples(
            ds, siz=args.gmm_size, clusters=args.gmm_cluster, num=args.batch_size),
        "gmm_vector_samples_and_save": lambda h: h.gmm_vector_samples_and_save(
            ds, siz=args.gmm_size, clusters=args.gmm_cluster, n_sample=args.test_end,
            batch_size=args.batch_size),
        "gmm_from_blur_samples_and_save": lambda h: h.gmm_from_blur_samples_and_save(
            ds, start=args.test_start, end=args.test_end, siz=args.gmm_size,
            clusters=args.gmm_cluster, n_sample=args.test_end, batch_size=args.batch_size,
            sample_at=args.gmm_sample_at or None),
        "sample_from_data_save": lambda h: h.sample_from_data_save(
            ds, start=args.test_start, end=args.test_end, batch_size=args.batch_size),
        "test_from_data_save_results": lambda h: h.test_from_data_save_results(
            ds, num=args.test_end, batch_size=args.batch_size),
        "sample_from_blur": lambda h: h.sample_from_blur(first_batch(),
                                                          start=args.test_start),
        "paper_showing_diffusion_images": lambda h: h.paper_showing_diffusion_images(
            first_batch(4), s_times=args.sample_steps),
        "paper_invert_section_images": lambda h: h.paper_invert_section_images(
            first_batch(), s_times=args.sample_steps),
        "paper_showing_diffusion_images_diff":
            lambda h: h.paper_showing_diffusion_images_diff(first_batch(4),
                                                            s_times=args.sample_steps),
        "paper_showing_sampling_diff_images":
            lambda h: h.paper_showing_sampling_diff_images(first_batch(4),
                                                           s_times=args.sample_steps),
        "paper_cover_page": lambda h: h.paper_cover_page(first_batch(6)),
        "paper_cover_page_both_sampling":
            lambda h: h.paper_cover_page_both_sampling(first_batch(4)),
        "paper_trajectory_strip": lambda h: h.paper_trajectory_strip(first_batch(4)),
        "forward_and_backward": lambda h: h.forward_and_backward(first_batch(4)),
    }
    runners[TEST_TYPES[tt]](harness)


def run_test(args):
    import torch

    from ..eval.harness import EvalHarness
    from ..parallel import make_mesh, process_count
    from ..train import Trainer

    _check_test_type(args.test_type)
    diffusion, model, image_size, channels = build(args)
    ds = make_dataset(args, image_size, train=False, channels=channels)
    trainer = Trainer(
        diffusion, model, ds, train_batch_size=args.batch_size,
        results_folder=_results_folder(args), load_path=args.load_path,
        load_torch_path=args.load_torch_path,
        train_num_steps=0, seed=args.seed, device=args.device,
    )
    ds2 = _second_dataset(args, image_size, "center")
    # mesh-parallel eval over the processes (colddiff/cli/main.py:364-375);
    # one process evaluates on its one card
    mesh = None
    if args.eval_mesh == "auto" and process_count() > 1:
        mesh = trainer.mesh or make_mesh(torch.device(args.device).type)
    elif (args.eval_mesh == "auto" and torch.device(args.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        print(f"colddiff_torch: {torch.cuda.device_count()} cards visible; evaluating "
              f"on {args.device} alone (one process a card, through torchrun or "
              "--num_processes, shards it)", file=sys.stderr, flush=True)
    harness = EvalHarness(trainer.diffusion, trainer.ema_model,
                          results_folder=_results_folder(args),
                          fid_weights=args.fid_weights, to_lab=args.to_lab,
                          endpoint_dataset=ds2, mesh=mesh,
                          refresh_every=args.refresh_every, bf16=args.bf16,
                          device=args.device)
    del trainer  # the training weights and Adam's moments: the harness needs neither
    dispatch(harness, args, ds, ds2)


def main(argv=None):
    import torch
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    raw_argv = [str(a) for a in (argv if argv is not None else sys.argv[1:])]
    if args.command == "train" and _is_restart_supervisor(args):
        # supervise before touching a device or joining a group: the workers
        # own the card and the group
        sys.exit(_supervise_train(raw_argv))
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("colddiff_torch runs on a CUDA device by default, but none "
                           "is available; pass --device cpu to run on the CPU")
    # the degrade math and the metrics refuse TF32 (ops/linop.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = bool(args.multihost or args.coordinator_address or args.param_sharding == "fsdp")
    if joined:
        from ..parallel import init_multihost

        init_multihost(args.coordinator_address, num_processes=args.num_processes,
                       process_id=args.process_id, device=args.device)
    try:
        if args.command == "train":
            run_train(args, raw_argv)
        else:
            run_test(args)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
