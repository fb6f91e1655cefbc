"""colddiff_torch's CUDA kernels on the GPU (skips without one).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Whether a card is present is decided inside each test, never at import.
"""

import pytest
import torch

from colddiff_torch.models import UnetConvNext
from colddiff_torch.ops import convnext_front as front_mod
from colddiff_torch.ops import group_norm as gn_mod
from colddiff_torch.ops.convnext_front import (MAX_CHANNELS, SMALL_C, TILE_MAX_CHANNELS,
                                              convnext_front, convnext_front_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _front_args(gen, b, c, h, w, with_cond, dtype, device):
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    x = randn(b, c, h, w).contiguous(memory_format=torch.channels_last)
    cond = randn(b, c) if with_cond else None
    gamma = (torch.rand(c, generator=gen, device=device) + 0.5).to(dtype)
    return x, randn(c, 1, 7, 7, scale=0.05), randn(c, scale=0.1), cond, gamma, randn(c, scale=0.1)


# the tile kernel (C >= 32) and the small-C kernel, the latter at every
# padded width (1, 2, 4, 8, 16, 32 channels) with C at and between them, on
# tiles cut by the image edge (9x11, 130x7) and at the stem
FRONT_CASES = [(2, 64, 32, 32, True, True), (2, 3, 16, 16, False, True),
               (1, 1024, 8, 8, True, True), (2, 96, 9, 11, True, False),
               (1, 1, 5, 3, True, True), (2, 32, 9, 11, True, True)]
FRONT_CASES += [(b, c, h, w, norm, with_cond) for c in (1, 2, 3, 4, 5, 8, 16, 17, 31)
                for b, h, w in ((2, 9, 11), (1, 130, 7))
                for norm in (True, False) for with_cond in (True, False)]
FRONT_CASES += [(3, 3, 128, 128, norm, with_cond)
                for norm in (True, False) for with_cond in (True, False)]
# the tile kernel's edges: C at each tile configuration's bound and between,
# C not a multiple of the 16-byte unit (33, 100 in bf16), tiles cut by the
# image edge, H or W below 7, B = 1 and 3
FRONT_CASES += [(b, c, h, w, norm, with_cond)
                for c in (32, 33, 48, 64, 100, 128, 256, 512, 1024)
                for h, w in ((9, 11), (130, 7), (17, 33), (5, 3), (1, 1))
                for b, norm, with_cond in ((1, True, True), (3, True, False),
                                           (1, False, True), (3, False, False))]
# images big enough that each tile configuration keeps its own tile (the
# kernel takes a smaller tile when the grid would have < 256 blocks), cut by
# the edge on both axes (37 x 70)
FRONT_CASES += [(b, c, 37, 70, norm, norm) for b, c in
                ((16, 33), (16, 64), (8, 100), (8, 128), (4, 200), (4, 256), (2, 300),
                 (2, 512)) for norm in (True, False)]
# the cluster form (C > 1024), at the same edges: C just past the tile
# kernel, the 16*dim fronts of dim = 80, 96, 128 and 256, and C not a
# multiple of the 16-byte unit (1025)
FRONT_CASES += [(b, c, h, w, norm, with_cond)
                for c in (1025, 1280, 1536, 2048, 4096)
                for h, w in ((9, 11), (130, 7), (17, 33), (5, 3), (1, 1))
                for b, norm, with_cond in ((1, True, True), (3, True, False),
                                           (1, False, True), (3, False, False))]
# the cluster form's slabs: C = 8192 (a cluster of 8 slabs of 1024), and a
# last slab of a few channels in each configuration (1032 = 4 x 256 + 8,
# 2049 = 4 x 512 + 1, 4097 = 4 x 1024 + 1)
FRONT_CASES += [(b, c, h, w, norm, with_cond)
                for c in (1032, 2049, 4097, 8192)
                for h, w in ((9, 11), (5, 3), (1, 1))
                for b, norm, with_cond in ((1, True, True), (3, True, False),
                                           (1, False, True), (3, False, False))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,norm,with_cond", FRONT_CASES)
def test_kernel_matches_plain(cuda, dtype, b, c, h, w, norm, with_cond):
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _front_args(gen, b, c, h, w, with_cond, dtype, cuda)
    before = (convnext_front.launches, convnext_front.small_c_launches,
              convnext_front.wide_c_launches)
    got = convnext_front(*args, norm=norm)
    torch.cuda.synchronize()
    assert convnext_front.launches == before[0] + 1
    assert convnext_front.small_c_launches == before[1] + (c < SMALL_C)
    assert convnext_front.wide_c_launches == before[2] + (c > TILE_MAX_CHANNELS)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    want = convnext_front_plain(*[None if a is None else a.float() for a in args], norm=norm)
    # fp32: summation order only; bf16: one rounding of outputs up to ~4
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 64])
def test_kernel_reads_the_weights_own_storage(cuda, monkeypatch, c):
    """A CUDA call passes w's own storage: the wrapper makes no weight copy."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _front_args(gen, 2, c, 16, 16, True, torch.bfloat16, cuda)
    kernel, seen = front_mod._kernel(), []

    def spy(*a):
        seen.append(a[1])
        return kernel(*a)

    monkeypatch.setattr(front_mod, "_kernel", lambda: spy)
    convnext_front(*args)
    assert seen == [args[1].data_ptr()]


@pytest.mark.cuda
def test_cuda_tensors_never_fall_back(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = list(_front_args(gen, 1, 8, 6, 6, True, torch.float64, cuda))
    with pytest.raises(TypeError):  # fp64 is not a kernel dtype
        convnext_front(*args)
    args = [None if a is None else a.float() for a in args]
    args[0] = args[0].contiguous()  # NCHW memory, not channels_last
    with pytest.raises(ValueError):
        convnext_front(*args)


@pytest.mark.cuda
def test_channels_above_the_limit_raise(cuda):
    """Past MAX_CHANNELS the wrapper raises, naming the limit; it never runs
    the plain version on a CUDA tensor."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _front_args(gen, 1, MAX_CHANNELS + 1, 2, 2, True, torch.float32, cuda)
    before = convnext_front.launches
    with pytest.raises(ValueError, match=rf"1\.\.{MAX_CHANNELS} channels \(MAX_CHANNELS\)"):
        convnext_front(*args)
    assert convnext_front.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1280, 8192])
def test_wide_c_call_allocates_only_its_output(cuda, dtype, c):
    """A C > 1024 call is one launch of the cluster form and allocates its
    output alone: no workspace."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _front_args(gen, 2, c, 16, 16, True, dtype, cuda)
    convnext_front(*args)  # the library is built and the cluster size checked
    torch.cuda.synchronize()
    before = (convnext_front.launches, convnext_front.wide_c_launches)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = convnext_front(*args)
    torch.cuda.synchronize()
    assert (convnext_front.launches, convnext_front.wide_c_launches) == (before[0] + 1,
                                                                        before[1] + 1)
    out_bytes = out.untyped_storage().nbytes()
    assert out_bytes == 2 * c * 16 * 16 * out.element_size()
    assert torch.cuda.max_memory_allocated() - base == out_bytes
    assert torch.cuda.memory_allocated() - base == out_bytes


@pytest.mark.cuda
def test_cluster_config_follows_c(cuda):
    """k = ceil(C / S) blocks of at most 8, each slab a multiple of 128
    channels; C outside the cluster form raises."""
    for dtype in (torch.float32, torch.bfloat16):
        for c in (1025, 1280, 2048, 2049, 4096, 4097, 8192):
            cfg = front_mod.cluster_config(c, dtype)
            assert cfg["slab"] % 128 == 0 and 1 <= cfg["k"] <= 8
            assert (cfg["k"] - 1) * cfg["slab"] < c <= cfg["k"] * cfg["slab"]
        for c in (TILE_MAX_CHANNELS, MAX_CHANNELS + 1):
            with pytest.raises(ValueError):
                front_mod.cluster_config(c, dtype)
    with pytest.raises(ValueError):
        front_mod.cluster_config(1280, torch.float64)


@pytest.mark.cuda
def test_dim80_unet_gpu_matches_cpu(cuda):
    """UnetConvNext(dim=80) has a 1280-channel front at ups.0.0 (16*dim),
    which the cluster form takes; fp32 at 128 px, rel L2 <= 1e-3 as
    chip_smoke.py phase 4 holds the flagship."""
    torch.manual_seed(0)
    model = UnetConvNext(dim=80, dim_mults=(1, 2, 4, 8)).eval()
    x = torch.rand(1, 128, 128, 3) * 2 - 1
    t = torch.tensor([5])
    with torch.inference_mode():
        want = model(x, t)
        before, wide = convnext_front.launches, convnext_front.wide_c_launches
        got = model.to(cuda)(x.to(cuda), t.to(cuda)).cpu()
    assert convnext_front.launches == before + 17
    assert convnext_front.wide_c_launches == wide + 1
    rel = ((got.double() - want.double()).norm() / want.double().norm()).item()
    assert rel <= 1e-3


@pytest.mark.cuda
def test_small_unet_gpu_matches_cpu(cuda):
    torch.manual_seed(0)
    model = UnetConvNext(dim=8, dim_mults=(1, 2)).eval()
    x = torch.rand(2, 16, 16, 3) * 2 - 1
    t = torch.tensor([3, 7])
    with torch.inference_mode():
        want = model(x, t)
        before = convnext_front.launches
        got = model.to(cuda)(x.to(cuda), t.to(cuda)).cpu()
    assert convnext_front.launches == before + 9  # 9 block fronts at dim_mults (1, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _probe_cases():
    """(name, batch, rows, width, shift, split, storage offset): the probes'
    own shapes; every roll shift and split edge on 16-byte widths (the float4
    path) and on odd ones (8577, 130: the float path); a batch of 3; an input
    at storage offset 1 (misaligned: the float path); dyn_sublane with row
    counts that leave a short last strip; counts past the grid's limits."""
    cases = []
    for w in (8576, 8577, 130):
        splits = (0, 8190, 8192, w) if w > 8192 else (0, w - 68, w - 66, w)
        for shift in (0, 1, 63, 64, w - 64, w - 1):
            cases.append(("roll", 1, 64, w, shift, w, 0))
            cases += [("roll_slice", 1, 64, w, shift, split, 0) for split in splits]
        cases += [("dyn_sublane", b, rows, w, 0, 0, 0)
                  for rows in (7, 8, 13, 70, 71) for b in (1, 3)]
    cases += [("roll", 3, 64, 8576, 8512, 8576, 0), ("roll_slice", 3, 64, 8576, 8512, 8192, 0),
              ("roll", 1, 64, 8576, 8512, 8576, 1), ("roll_slice", 1, 64, 8576, 8512, 8192, 1),
              ("dyn_sublane", 1, 70, 8576, 0, 0, 1), ("dyn_sublane", 3, 70, 8576, 0, 0, 1)]
    # more rows, batches or strips than gridDim.y and .z hold (65,535): the grid loops
    cases += [("roll_slice", 1, 65537, 8, 4, 4, 0), ("dyn_sublane", 65537, 7, 8, 0, 0, 0),
              ("dyn_sublane", 1, 4 * 65535 + 11, 4, 0, 0, 0)]
    # masked_norm: row counts 1, 3, 64 and past the grid's 65,535; one group,
    # three, the probe's 128; the float4 path (offset 0, or 4 floats: still
    # 16-byte aligned) and the float path (offset 1)
    cases += [("masked_norm", b, rows, w, 0, 0, offset)
              for rows in (1, 3, 64) for w in (64, 192, 8192) for b in (1, 3)
              for offset in (0, 1, 4)]
    cases += [("masked_norm", 1, 65537, 64, 0, 0, offset) for offset in (0, 1)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,rows,width,shift,split,offset", _probe_cases())
def test_probe_kernel_matches_plain(cuda, name, b, rows, width, shift, split, offset):
    from colddiff_torch.ops import bisect_mosaic as ops

    gen = torch.Generator(device=cuda).manual_seed(0)
    n = b * rows * width
    x = torch.empty(n + offset, device=cuda)[offset:].view(b, rows, width)
    x.copy_(torch.randn(b, rows, width, generator=gen, device=cuda))
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset == 1)
    if name == "masked_norm":  # the wrapper's path: float4 unless misaligned
        assert ops.quad_path(x.data_ptr(), 0, width) is (offset != 1)
    kernel, plain, args = {
        "roll": (ops.probe_roll, ops.roll_plain, (shift,)),
        "roll_slice": (ops.probe_roll_slice, ops.roll_slice_plain, (shift, split)),
        "masked_norm": (ops.probe_masked_norm, ops.masked_norm_plain, ()),
        "dyn_sublane": (ops.probe_dyn_sublane, ops.dyn_sublane_plain, ()),
    }[name]
    before = kernel.launches
    got = kernel(x, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(x, *args)
    # the rolls are copies and dyn_sublane adds its rows in the plain
    # version's order; masked_norm's mean differs in fp32 summation order
    tol = 1e-5 if name == "masked_norm" else 0.0
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol
    with pytest.raises(TypeError):  # fp64 is not a kernel dtype: no fallback
        kernel(x.double(), *args)


def _small_bf16_trainer(device, folder, **kw):
    from colddiff_torch.data import SyntheticDataset
    from colddiff_torch.diffusion import ColdDiffusion
    from colddiff_torch.operators import get_operator
    from colddiff_torch.train import Trainer

    op = get_operator("blur", image_size=16, timesteps=8, blur_routine="Exponential_reflect",
                      kernel_size=15, kernel_std=0.01, device=device)
    torch.manual_seed(0)
    return Trainer(ColdDiffusion(op=op, image_size=16), UnetConvNext(dim=8, dim_mults=(1, 2)),
                   SyntheticDataset(16, 3, length=8), train_batch_size=2,
                   gradient_accumulate_every=2, results_folder=str(folder), num_workers=1,
                   bf16=True, device=device, **kw)


@pytest.mark.cuda
def test_bf16_trainer_step_on_the_card(cuda, tmp_path):
    tr = _small_bf16_trainer(cuda, tmp_path)
    before = convnext_front.launches
    loss = tr.train_step(tr._next_superbatch()).item()
    assert convnext_front.launches == before + 9 * 2  # 9 fronts x 2 microbatches
    assert torch.isfinite(torch.tensor(loss))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in tr.model.parameters())


@pytest.mark.cuda
def test_bf16_trainer_train_loop_snapshots_on_the_card(cuda, tmp_path):
    """train(): two steps, then the checkpoint and the EMA sample grids,
    whose T=8 reverse steps also run the kernel."""
    tr = _small_bf16_trainer(cuda, tmp_path, train_num_steps=2, save_and_sample_every=2)
    before = convnext_front.launches
    assert tr.train(log_every=1) == "done"
    assert convnext_front.launches == before + 2 * 9 * 2 + 8 * 9
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2
    for name in ("og", "xt", "direct_recons", "sample", "model"):
        assert list(tmp_path.glob(f"{name}*")), name


# ---------------------------------------------------------------------- #
# the ResNet UNet, sample_multi_step and the metrics on the card (stock
# torch ops: no hand-written kernel runs here)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,size", [
    (dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,)), 16),
    (dict(ch=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,)), 32),
])
def test_resnet_unet_gpu_matches_cpu(cuda, cfg, size):
    """fp32 with TF32 off, rel L2 <= 1e-3 as the ConvNeXt UNet is held; the
    wider case is the CIFAR-10 configuration of get_model."""
    from colddiff_torch.models import UnetResNet

    torch.manual_seed(0)
    model = UnetResNet(**cfg, resolution=size, dropout=0.1).eval()
    x = torch.rand(2, size, size, 3) * 2 - 1
    t = torch.tensor([3, 40])
    with torch.inference_mode():
        want = model(x, t)
        before = convnext_front.launches
        got = model.to(cuda)(x.to(cuda), t.to(cuda)).cpu()
    assert convnext_front.launches == before  # the ResNet family launches no front
    rel = ((got.double() - want.double()).norm() / want.double().norm()).item()
    assert rel <= 1e-3


@pytest.mark.cuda
def test_dropout_generator_on_the_card(cuda):
    """A CUDA generator: the same seed gives the same masks, another seed
    others, and the device's global stream plays no part."""
    from colddiff_torch.models import layers

    x = torch.randn(4, 64, 16, 16, device=cuda).contiguous(memory_format=torch.channels_last)

    def run(seed):
        return layers.dropout(x, 0.1, True, torch.Generator(device=cuda).manual_seed(seed))

    a = run(3)
    torch.cuda.manual_seed(123)
    assert torch.equal(a, run(3)) and not torch.equal(a, run(4))
    keep = (a != 0).float().mean().item()
    assert 0.85 < keep < 0.95
    with pytest.raises(ValueError, match="generator"):
        layers.dropout(x, 0.1, True, None)


@pytest.mark.cuda
def test_sample_multi_step_gpu_matches_cpu(cuda):
    from colddiff_torch.diffusion import ColdDiffusion
    from colddiff_torch.operators import get_operator
    from colddiff_torch.sampling import sample_multi_step

    torch.manual_seed(0)
    model = UnetConvNext(dim=8, dim_mults=(1, 2)).eval()
    x = torch.rand(4, 16, 16, 3) * 2 - 1
    t_start, t_end = torch.tensor([8, 5, 3, 1]), torch.tensor([0, 2, 0, 0])
    runs = []
    for dev in ("cpu", cuda):
        op = get_operator("blur", image_size=16, timesteps=8,
                          blur_routine="Exponential_reflect", kernel_size=15,
                          kernel_std=0.01, device=dev)
        d = ColdDiffusion(op=op, image_size=16, sampling_routine="x0_step_down")
        m = model.to(dev)
        runs.append(sample_multi_step(d, lambda xt, t: m(xt, t), x.to(dev), t_start.to(dev),
                                      t_end.to(dev)).cpu())
    want, got = runs
    rel = ((got.double() - want.double()).norm() / want.double().norm()).item()
    assert rel <= 1e-3


@pytest.mark.cuda
def test_metrics_gpu_matches_cpu_and_refuse_tf32(cuda, monkeypatch):
    from colddiff_torch.eval import metrics

    gen = torch.Generator().manual_seed(0)
    a = torch.rand(4, 32, 32, 3, generator=gen) * 2 - 1
    b = (a + 0.1 * torch.randn(a.shape, generator=gen)).clamp(-1, 1)
    for fn in (metrics.ssim, metrics.rmse, metrics.psnr):
        want, got = fn(a, b), fn(a.to(cuda), b.to(cuda)).cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", True)
        for fn in (metrics.ssim, metrics.rmse, metrics.psnr):
            with pytest.raises(RuntimeError, match="fp32"):
                fn(a.to(cuda), b.to(cuda))
        monkeypatch.undo()  # back to False, as the cuda fixture set it


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [(128, 64), (100, 16), (32, 299), (16, 64)])
def test_resize_gpu_matches_cpu(cuda, src, dst):
    from colddiff_torch.ops.image import resize_bilinear

    x = torch.rand(2, src, src, 3, generator=torch.Generator().manual_seed(src)) * 2 - 1
    torch.testing.assert_close(resize_bilinear(x.to(cuda), dst).cpu(), resize_bilinear(x, dst),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_fid_features_and_gmm_gpu_match_cpu(cuda, tmp_path, monkeypatch):
    """The Inception pool3 graph on synthetic fp32 weights (rel L2 1e-3: ~96
    conv layers summed in other orders), the fallback extractor (1e-5) and
    fit_gmm from one init (1e-4 of each field's max) on the card vs the
    CPU; each refuses TF32 on the card."""
    import numpy as np

    from colddiff_torch.eval import fid, gmm

    path = tmp_path / "synth.pth"
    torch.save({k: torch.as_tensor(v)
                for k, v in fid.synth_state_dict(dtype=np.float32).items()}, path)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(4, 64, 64, 3, generator=gen) * 2 - 1
    for make, rel in ((lambda dev: fid.inception_features_from_torch_checkpoint(path, dev),
                       1e-3), (lambda dev: fid.fid_features_fn(device=dev), 1e-5)):
        want, got = make("cpu")(x), make(cuda)(x).cpu()
        assert ((got.double() - want.double()).norm() / want.double().norm()).item() <= rel
    centers = torch.rand(3, 8, generator=gen) * 6 - 3
    pts = centers.repeat_interleave(200, 0) + 0.2 * torch.randn(600, 8, generator=gen)
    init = torch.tensor([0, 250, 450])
    want = gmm.fit_gmm(pts, 3, init_idx=init)
    got = gmm.fit_gmm(pts.to(cuda), 3, init_idx=init.to(cuda))
    for g, w in zip(got, want):
        assert ((g.cpu() - w).abs().max() / w.abs().max()).item() <= 1e-4
    draws = gmm.sample_gmm(got, torch.Generator(device=cuda).manual_seed(1), 16)
    assert draws.shape == (16, 8) and draws.is_cuda and torch.isfinite(draws).all()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="fp32"):
        fid.fid_features_fn(device=cuda)(x)
    monkeypatch.undo()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="fp32"):
        gmm.fit_gmm(pts.to(cuda), 3, init_idx=init.to(cuda))


# ---------------------------------------------------------------------- #
# the CLI on the card (its default device), remat, the Lab conversions


@pytest.mark.cuda
def test_cli_train_then_test_on_the_card(cuda, tmp_path):
    """No --device: the CLI runs on cuda.  One train step, its checkpoint,
    then the manifold test from it; every model call launches the fronts."""
    import json

    from colddiff_torch.cli.main import main

    flags = ["--degradation", "blur", "--blur_size", "3", "--blur_std", "1.0",
             "--blur_routine", "Constant", "--dataset", "synthetic", "--image_size", "16",
             "--time_steps", "3", "--dim", "8", "--batch_size", "4",
             "--save_folder", str(tmp_path)]
    before = convnext_front.launches
    main(["train", *flags, "--train_steps", "1", "--save_and_sample_every", "1"])
    fronts = 17  # the ConvNeXt blocks of UnetConvNext(dim=8), dim_mults (1, 2, 4, 8)
    # 2 microbatches, then the snapshot's 3 reverse steps
    assert convnext_front.launches - before == fronts * (2 + 3)
    before = convnext_front.launches
    main(["test", *flags, "--test_type", "test_fid_distance_decrease_from_manifold",
          "--test_end", "8", "--load_path", str(tmp_path / "model.pt")])
    assert convnext_front.launches - before == fronts * 3 * 2  # T=3, 2 batches of 4
    metrics = json.loads((tmp_path / "manifold_metrics.json").read_text())
    assert metrics["refresh_every"] == 1


@pytest.mark.cuda
def test_remat_on_the_card_launches_the_fronts_twice(cuda, tmp_path):
    """remat: the recompute runs each front's kernel again in the backward
    pass; the step's loss is the step's without remat."""
    runs = []
    for remat in (False, True):
        tr = _small_bf16_trainer(cuda, tmp_path / str(remat), remat=remat)
        t = torch.tensor([[0, 7], [3, 5]], device=cuda)
        before = convnext_front.launches
        loss = tr.train_step(tr._next_superbatch(), t=t).item()
        runs.append((loss, convnext_front.launches - before))
    assert runs[0] == (runs[1][0], 9 * 2) and runs[1][1] == 2 * 9 * 2


@pytest.mark.cuda
def test_lab_and_hsv_gpu_match_cpu(cuda):
    from colddiff_torch.ops.image import hsv2rgb, lab2rgb, rgb2hsv, rgb2lab

    x = torch.rand(2, 33, 17, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    for fn, inp in ((rgb2lab, x), (lab2rgb, rgb2lab(x)), (rgb2hsv, (x + 1) / 2),
                    (hsv2rgb, rgb2hsv((x + 1) / 2))):
        want, got = fn(inp), fn(inp.to(cuda)).cpu()
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5, fn.__name__


# ---------------------------------------------------------------------- #
# parallelism on the card


@pytest.mark.cuda
def test_two_process_gloo_step_on_the_card_equals_one(cuda):
    """Two processes sharing the card over gloo with CUDA tensors: the
    replicated step, the sampling run and the mesh harness equal one
    process's (dryrun_multichip's tiny check), and the FSDP step runs."""
    from colddiff_torch.scripts import dryrun_multichip

    res = dryrun_multichip.run(2, "cuda")
    assert res["backend"] == "gloo" and res["device"] == "cuda"
    assert res["launches"][0] == res["launches"][1] > 0
    assert torch.isfinite(torch.tensor(res["fsdp_loss"]))


@pytest.mark.cuda
def test_two_process_row_sharded_dryrun_on_the_card(cuda):
    """dryrun_multichip's spatial block on a (1, 2) mesh of two processes
    sharing the card over gloo: the halo'd fronts through the kernel against
    the whole-image kernel, the forward and the samples against one process
    (its tiny check, 2e-5), and 9 front launches a forward on each process."""
    from colddiff_torch.scripts import dryrun_multichip

    res = dryrun_multichip.run(2, "cuda", space=2)
    assert res["backend"] == "gloo" and res["device"] == "cuda" and res["mesh"] == [1, 2]
    assert res["launches"] == [9 * 4] * 2 and res["samples_max_err"] <= 2e-5


def _halo_front_rank(rank, port, out):
    """One of two processes: the flagship's distinct block fronts on its
    row half, against the whole-image kernel (dryrun_multichip.spatial_fronts)."""
    import torch.distributed as dist

    from colddiff_torch import parallel
    from colddiff_torch.scripts.dryrun_multichip import front_shapes, spatial_fronts

    dev = parallel.init_multihost(f"localhost:{port}", 2, rank, device="cuda", backend="gloo")
    torch.backends.cudnn.allow_tf32 = False
    shapes = list(dict.fromkeys(front_shapes(
        UnetConvNext(dim=64, dim_mults=(1, 2, 4, 8)).to(dev), 128, dev)))
    rows = spatial_fronts(shapes, 2, parallel.make_mesh_2d(1, 2, "cuda"), dev)
    if rank == 0:
        torch.save(rows, out)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_halo_front_matches_whole_image_kernel_at_each_flagship_c(cuda, tmp_path):
    """Every distinct front of the flagship UNet (C = 3 to 1024, 16 to 128
    px) on row halves of two processes: the kernel on the block extended by
    3 rows of its neighbour equals the whole-image kernel's rows (fp32
    1e-4, bf16 2e-2), and the exchange sends 3 rows each way."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "fronts.pt"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_halo_front_rank, args=(r, port, str(out))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    rows = torch.load(out)
    assert {r["shape"][3] for r in rows} == {3, 64, 128, 256, 512, 1024}
    for r in rows:
        assert r["max_abs_err_fp32"] <= 1e-4 and r["max_abs_err_bf16"] <= 2e-2, r
        b, h, w, c = r["shape"]
        assert r["exchanged"] == [["halo", [b, c, 6, w]]], r


@pytest.mark.cuda
def test_front_refuses_a_dtensor_weight(cuda):
    """A sharded weight never reaches the kernel: the wrapper raises rather
    than read the local shard's storage."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from colddiff_torch.parallel import init_multihost, make_mesh

    init_multihost(device="cuda")
    try:
        gen = torch.Generator(device=cuda).manual_seed(0)
        x, w, b, cond, g, beta = _front_args(gen, 2, 64, 8, 8, True, torch.float32, cuda)
        w_dt = distribute_tensor(w, make_mesh("cuda"), [Shard(0)])
        with pytest.raises(TypeError, match="DTensor"):
            convnext_front(x, w_dt, b, cond, g, beta)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_span_markers_pair_with_boundaries_on_the_profilers_clock(cuda, tmp_path):
    """A bf16 Trainer step under a CUDA-only profiler: one marker kernel a
    span boundary, the front's backward's from the autograd engine's
    thread; each marker starts on the device after its boundary's host
    time, and one launched on an idle card within 1 ms of it: the host's
    ``time.time_ns`` and the device trace share one clock."""
    import threading
    import time

    from torch.profiler import ProfilerActivity, profile

    from colddiff_torch import tracing

    tr = _small_bf16_trainer(cuda, tmp_path)  # prepares the markers on the card
    tr.train_step(tr._next_superbatch())  # warm
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device=cuda).add_(1)  # the profiler records from its first kernel on
        torch.cuda.synchronize()
        time.sleep(0.05)
        with tracing.span("idle_card"):
            torch.cuda.synchronize()
        tr.train_step(tr._next_superbatch())
        torch.cuda.synchronize()
    bounds = tracing.boundaries()
    cpu = torch.autograd.DeviceType.CPU
    marks = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() != cpu and e.name().startswith(tracing.MARKER))
    names = [n for _, n, _, _ in bounds]
    assert len(marks) == len(bounds) and names.count("convnext_front.backward") == 2 * 9 * 2
    main = threading.get_ident()
    assert {t for _, n, t, _ in bounds if n == "convnext_front.backward"} - {main}
    assert {t for _, n, t, _ in bounds if n != "convnext_front.backward"} == {main}
    lags = [m - b[3] for m, b in zip(marks, bounds)]
    assert min(lags) >= 0, f"a marker starts {-min(lags)} ns before its boundary"
    assert lags[0] < 1_000_000
    print(f"shared clock: idle-card marker {lags[0]} ns after its boundary; "
          f"lags {min(lags)}-{max(lags)} ns over {len(lags)} boundaries")


# the (C, H) of the CIFAR-10 ResNet's 51 GroupNorm-swish calls a forward
GN_SHAPES = [(256, 4), (256, 16), (128, 32), (256, 8), (512, 4), (512, 8), (512, 16),
             (256, 32), (128, 16), (384, 16), (384, 32)]
# the streaming form: images larger than a cluster's registers, at 64 and 128 px
GN_STREAM_SHAPES = [(256, 64), (128, 128)]


def _gn_args(gen, b, c, h, dtype, device):
    x = (torch.randn(b, c, h, h, generator=gen, device=device) * 2 + 0.5).to(dtype)
    gamma = (torch.rand(c, generator=gen, device=device) + 0.5).to(dtype)
    beta = (torch.randn(c, generator=gen, device=device) * 0.1).to(dtype)
    return x.contiguous(memory_format=torch.channels_last), gamma, beta


def _check_gn(got, want):
    """The kernel against the plain version on the card.  fp32: the
    statistics' summation order only (1e-5).  bf16: each rounds the same
    values at the same points, but a normalized value that lies near a
    rounding boundary may land on the other bf16 neighbour in one of them,
    and that ulp carries through the rounded product with gamma and sum with
    beta: two bf16 ulps (2**-6 relative), on at most 1% of the elements."""
    assert got.dtype == want.dtype and got.is_contiguous(memory_format=torch.channels_last)
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6, atol=2 ** -6)
    assert (got != want).float().mean().item() <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h", GN_SHAPES + GN_STREAM_SHAPES)
def test_group_norm_kernel_matches_plain(cuda, c, h, dtype, swish):
    """At an odd batch; the ResNet's shapes keep the image on chip in bf16,
    the 64 and 128 px ones take the streaming form."""
    gen = torch.Generator(device=cuda).manual_seed(c * h)
    x, gamma, beta = _gn_args(gen, 3, c, h, dtype, cuda)
    before = gn_mod.group_norm_swish.launches
    got = gn_mod.group_norm_swish(x, gamma, beta, 32, 1e-6, swish)
    torch.cuda.synchronize()
    assert gn_mod.group_norm_swish.launches == before + 1
    chunks = gn_mod.kernel_form(h * h, c, dtype)["chunks"]
    if (c, h) in GN_STREAM_SHAPES:
        assert chunks > 1
    elif dtype == torch.bfloat16:
        assert chunks == 1
    _check_gn(got, gn_mod.group_norm_swish_plain(x, gamma, beta, 32, 1e-6, swish))


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", [(256, 4), (384, 32), (128, 128)])
def test_group_norm_kernel_is_deterministic(cuda, c, h):
    """One block, a cluster of 7 and the streaming form: two runs bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x, gamma, beta = _gn_args(gen, 5, c, h, torch.bfloat16, cuda)
    runs = [gn_mod.group_norm_swish(x, gamma, beta, 32) for _ in range(2)]
    assert torch.equal(*runs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_gradients_equal_plain_autograd(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    args = _gn_args(gen, 3, 128, 16, dtype, cuda)
    w = torch.randn(3, 128, 16, 16, generator=gen, device=cuda).to(dtype)
    grads = []
    for fn in (gn_mod.group_norm_swish, gn_mod.group_norm_swish_plain):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        (fn(*leaves, 32, 1e-6, True).float() * w).sum().backward()
        grads.append([a.grad for a in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want)


@pytest.mark.cuda
def test_group_norm_bf16_swish_rounds_as_f_silu(cuda):
    """The kernel's bf16 swish (the hardware's exp2 and reciprocal) gives
    F.silu of its output without swish, bitwise, for y over [-80, 80]:
    gamma from 2**-6 to 2**3.8 spreads the normalized values over the range."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, _, beta = _gn_args(gen, 8, 512, 32, torch.bfloat16, cuda)
    gamma = (2.0 ** torch.linspace(-6, 3.8, 512, device=cuda)).to(torch.bfloat16)
    y = gn_mod.group_norm_swish(x, gamma, beta, 32, 1e-6, False)
    assert y.abs().max().item() <= 80 and y.unique().numel() > 4000
    assert torch.equal(gn_mod.group_norm_swish(x, gamma, beta, 32, 1e-6, True),
                       torch.nn.functional.silu(y))


@pytest.mark.cuda
def test_cifar_resnet_forward_launches_51_group_norms(cuda):
    from colddiff_torch.models import get_model

    model = get_model("UnetResNet", dataset="cifar10").to(cuda).to(torch.bfloat16).eval()
    x = torch.rand(2, 32, 32, 3, device=cuda, dtype=torch.bfloat16) * 2 - 1
    before = gn_mod.group_norm_swish.launches, gn_mod.group_norm_swish.row_sharded_calls
    with torch.inference_mode():
        model(x, torch.tensor([3, 40], device=cuda))
    assert (gn_mod.group_norm_swish.launches - before[0],
            gn_mod.group_norm_swish.row_sharded_calls - before[1]) == (51, 0)


@pytest.mark.cuda
def test_group_norm_refuses_what_the_kernel_does_not_take(cuda):
    """NCHW memory, a dtype other than fp32 / bf16, C not split by the
    groups and a gamma wider than x raise; nothing launches."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, gamma, beta = _gn_args(gen, 2, 64, 8, torch.bfloat16, cuda)
    before = gn_mod.group_norm_swish.launches
    with pytest.raises(ValueError, match="channels_last"):
        gn_mod.group_norm_swish(x.contiguous(), gamma, beta, 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gn_mod.group_norm_swish(x.half(), gamma.half(), beta.half(), 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gn_mod.group_norm_swish(x.double(), gamma.double(), beta.double(), 32)
    with pytest.raises(ValueError, match="groups"):
        gn_mod.group_norm_swish(x, gamma, beta, 24)
    with pytest.raises(TypeError, match="wider"):
        gn_mod.group_norm_swish(x, gamma.float(), beta, 32)
    assert gn_mod.group_norm_swish.launches == before
