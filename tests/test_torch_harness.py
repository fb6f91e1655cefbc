"""The port's EvalHarness == colddiff.eval.harness.EvalHarness.

The toy configuration of tests/test_eval.py:69-110: blur ``Constant``
kernel 3 std 1 at 16 px, T=3, x0_step_down, ``UnetConvNext(dim=8, (1,
2))``, the port's weights converted from the Flax params.  Blur draws
nothing, so both sides sample the same trajectories; the GMM routine
replays JAX's draws.  Tolerances (fp32 on both sides):
  - ``fid_distance_decrease_from_manifold`` over 288 images at batch 32,
    enough that the fallback extractor's 128-d covariances have full rank:
    every FID key rtol 1e-3 (the fp32 UNets' ~1e-6 differences go through
    a 128-d matrix square root), RMSE and SSIM atol 1e-5, the stamps equal;
  - arrays a method returns: atol 1e-4, the fp32 UNet's summation orders
    over 3 steps (as tests/test_torch_sampling.py);
  - the files a method writes: the same names, and each PNG's and each
    GIF frame's pixels within one uint8 level (an fp32 difference can move
    a value across a rounding edge).

Torch runs one thread in this file (a module fixture): the suite's test
processes share the machine's cores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.eval.harness import EvalHarness as JEvalHarness
from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.operators import get_operator as jget_operator
from colddiff_torch.data import SyntheticDataset
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.eval import EvalHarness
from colddiff_torch.eval import harness as harness_mod
from colddiff_torch.models import UnetConvNext
from colddiff_torch.models.convert import convnext_state_dict_from_flax
from colddiff_torch.operators import get_operator
from tests.test_torch_unet_convnext import flax_convnext_params

S = 16
DIM, MULTS = 8, (1, 2)
BLUR = dict(image_size=S, timesteps=3, blur_routine="Constant", kernel_size=3, kernel_std=1.0)
ARRAY_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_inception_weights(monkeypatch):
    """Both packages would take Inception weights from here: the fallback
    extractor is the one compared."""
    monkeypatch.delenv("COLDDIFF_INCEPTION_WEIGHTS", raising=False)


@pytest.fixture(scope="module")
def flax_params():
    return flax_convnext_params(DIM, MULTS, seed=3)


def _pair(root, flax_params, op_name="blur", op_cfg=BLUR, routine="x0_step_down", **kw):
    """A JAX harness and a port harness on one configuration and one set of
    weights, writing under root/jax and root/port."""
    jd = JColdDiffusion(op=jget_operator(op_name, **op_cfg), image_size=S, channels=3,
                        sampling_routine=routine)
    d = ColdDiffusion(op=get_operator(op_name, **op_cfg, device="cpu"), image_size=S,
                      channels=3, sampling_routine=routine)
    model = UnetConvNext(dim=DIM, dim_mults=MULTS)
    model.load_state_dict(convnext_state_dict_from_flax(flax_params), strict=True)
    params = jax.tree_util.tree_map(jnp.asarray, flax_params)
    return (JEvalHarness(jd, JUnetConvNext(dim=DIM, dim_mults=MULTS), params,
                         results_folder=str(root / "jax"), **kw),
            EvalHarness(d, model, results_folder=str(root / "port"), device="cpu", **kw))


@pytest.fixture(scope="module")
def blur_pair(tmp_path_factory, flax_params):
    return _pair(tmp_path_factory.mktemp("blur"), flax_params)


@pytest.fixture(scope="module")
def batch():
    ds = SyntheticDataset(S, 3, length=6, seed=4)
    return np.stack([ds[i] for i in range(6)])


def _files(root, pattern):
    return sorted(str(p.relative_to(root)) for p in root.glob(pattern) if p.is_file())


def _frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB"), np.int16) for f in ImageSequence.Iterator(im)]


def assert_same_files(jroot, troot, pattern, count):
    """The same ``count`` file names under both roots, each image's pixels
    (every frame of a GIF) within one uint8 level."""
    names = _files(jroot, pattern)
    assert len(names) == count and _files(troot, pattern) == names
    for name in names:
        want, got = _frames(jroot / name), _frames(troot / name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.abs(g - w).max() <= 1, name


def assert_close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ARRAY_ATOL)


def test_manifold_harness_matches_jax(blur_pair):
    jh, h = blur_pair
    ds = SyntheticDataset(S, 3, length=288, seed=1)
    want = jh.fid_distance_decrease_from_manifold(ds, batch_size=32)
    got = h.fid_distance_decrease_from_manifold(ds, batch_size=32)
    assert list(got) == list(want)
    assert got["extractor"] == "fallback-random-projection"
    assert (got["refresh_every"], got["bf16"]) == (1, False)
    for k, v in want.items():
        if "fid" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
        elif k.startswith(("rmse", "ssim")):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert all(np.isfinite(v) for k, v in got.items() if k != "extractor")


def test_manifold_batch_keeps_the_batch(blur_pair, batch):
    """A ragged batch of 6 at batch_size 4 (4 + 2): the rows the harness
    keeps equal JAX's, and the sampled rows a direct prepare_start + sample
    on the same batch."""
    jh, h = blur_pair
    rows, jrows = [[] for _ in range(4)], [[] for _ in range(4)]
    for lo in (0, 4):
        h._manifold_batch(batch[lo:lo + 4], h._generator(None), *rows)
        jh._manifold_batch(batch[lo:lo + 4], jax.random.key(0), *jrows)
    for r, jr in zip(rows, jrows):
        assert_close(np.concatenate(r), np.concatenate(jr))
    direct = harness_mod.sample(h.d, h.denoise,
                                harness_mod.prepare_start(h.d, torch.from_numpy(batch[:4])))
    torch.testing.assert_close(torch.from_numpy(rows[2][0]), direct.img, rtol=0, atol=0)


def test_sample_and_save_for_fid_matches_jax(tmp_path, flax_params):
    """Family B (hot noise, ddim) from a second dataset's images: no draws,
    so both sides write the same PNGs; then from the port's own noise."""
    jh, h = _pair(tmp_path, flax_params, "noise", dict(timesteps=3), routine="ddim")
    ep = SyntheticDataset(S, 3, length=5, seed=9)
    for hh in (jh, h):
        hh.sample_and_save_for_fid(num=7, batch_size=4, endpoint_dataset=ep)
    assert_same_files(jh.results_folder, h.results_folder, "fid_out/*.png", 7)
    out = h.sample_and_save_for_fid(num=5, batch_size=4, out_name="noise_out")
    assert len(_files(out, "*.png")) == 5


def test_gmm_mean_samples_match_jax_with_its_draws(blur_pair, monkeypatch):
    """One cluster (EM's first step leaves the fit independent of its
    init); JAX's categorical and normal draws of ``sample_gmm`` replayed."""
    jh, h = blur_pair
    ds = SyntheticDataset(S, 3, length=20, seed=2)
    num = 5
    want = jh.gmm_mean_samples(ds, clusters=1, num=num)
    s_rng = jax.random.split(jax.random.key(0), 4)[1]
    k_rng, g_rng = jax.random.split(s_rng)
    comp = torch.from_numpy(np.array(jax.random.categorical(k_rng, jnp.zeros(1),
                                                            shape=(num,))))
    z = torch.from_numpy(np.array(jax.random.normal(g_rng, (num, 3))))
    real = harness_mod.sample_gmm
    monkeypatch.setattr(harness_mod, "sample_gmm",
                        lambda gmm, gen, n: real(gmm, gen, n, comp=comp, z=z))
    got = h.gmm_mean_samples(ds, clusters=1, num=num)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert_close(g, w)


def test_gmm_routines_on_the_port(tmp_path, flax_params):
    """The port's own draws through the other GMM routines: shapes, finite
    values, and the files each writes."""
    _, h = _pair(tmp_path, flax_params)
    ds = SyntheticDataset(S, 3, length=24, seed=5)
    gen = torch.Generator().manual_seed(0)
    res = h.gmm_blur_samples(ds, clusters=2, num=3, gmm_res=4, noise_level=0.01,
                             generator=gen, max_fit=16)
    assert res.img.shape == (3, S, S, 3) and torch.isfinite(res.img).all()
    res = h.gmm_mean_samples(ds, clusters=2, num=3, noise_level=0.002, generator=gen)
    assert res.img.shape == (3, S, S, 3) and torch.isfinite(res.img).all()
    res = h.gmm_vector_samples(ds, siz=4, clusters=2, num=3, generator=gen, max_fit=16)
    assert res.x0_trajectory.shape == (3, 3, S, S, 3) and torch.isfinite(res.img).all()
    for name in ("og-4-2-vec.png", "Gif-4-2-vec-x0.gif", "Gif-4-2-vec-xt.gif"):
        assert (h.results_folder / name).exists()
    out = h.gmm_vector_samples_and_save(ds, siz=4, clusters=2, n_sample=5, batch_size=4,
                                        generator=gen, max_fit=16)
    assert _files(out, "*.png") == [f"sample-x0-{i}.png" for i in range(5)]
    out = h.gmm_from_blur_samples_and_save(ds, end=10, siz=4, clusters=2, n_sample=3,
                                           batch_size=2, generator=gen)
    assert out.name == "port_4_2_1" and len(_files(out, "*.png")) == 3
    assert len(_files(out.with_name("port_gmm_4_2_1"), "*.png")) == 3


def test_test_from_data_and_siblings_match_jax(blur_pair, batch, tmp_path):
    jh, h = blur_pair
    for hh in (jh, h):
        hh.test_from_data(batch[:4], milestone=7)
        hh.test_with_mixup(batch[:2], batch[2:4])
        hh.test_from_random(batch[:3])
        hh.controlled_direct_reconstruct(batch[:4], extra="c")
    jroot, root = jh.results_folder, h.results_folder
    assert_same_files(jroot, root, "*-7*", 2 + 2 * 3 + 1)  # og, x0/xt per step, 2 gifs
    assert_same_files(jroot, root, "*-mixup*", 9)
    assert_same_files(jroot, root, "*-random*", 9)
    assert_same_files(jroot, root, "sample-*-c.png", 4)
    assert_close(h.opt(batch[:4], t=2), jh.opt(batch[:4], t=2))
    assert_close(h.opt(batch[:4]), jh.opt(batch[:4]))
    ds = SyntheticDataset(S, 3, length=3, seed=6)
    for hh in (jh, h):
        hh.save_training_data(ds, num=5)
    assert_same_files(jroot, root, "training_data/*.png", 3)


def test_save_and_figure_routines_match_jax(blur_pair, batch):
    jh, h = blur_pair
    ds = SyntheticDataset(S, 3, length=9, seed=7)
    for hh in (jh, h):
        hh.sample_from_data_save(ds, start=1, end=7, batch_size=4)
        hh.test_from_data_save_results(ds, num=5, batch_size=5)
        hh.forward_and_backward(batch[:2])
        hh.paper_cover_page(batch[:3], n_frames=3)
        hh.paper_invert_section_images(batch[:3])
        hh.sample_from_blur(batch[:2], start=1)
        hh.paper_trajectory_strip(batch)
    jroot, root = jh.results_folder, h.results_folder
    assert_same_files(jroot, root, "sample_from_data/*.png", 6)  # 1 < idx <= 7
    for tag in ("orig", "blur", "d_deblur", "deblur"):
        assert_same_files(jroot.with_name(f"jax_{tag}"), root.with_name(f"port_{tag}"),
                          "*.png", 5)
    assert_same_files(jroot, root, "fb-*.gif", 2)
    assert_same_files(jroot, root, "cover_page.png", 1)
    assert_same_files(jroot, root, "*_0.png", 5)  # one invert-section panel set
    assert_same_files(jroot, root, "sample-*-from_blur.png", 4)
    assert_same_files(jroot, root, "trajectory_strip.png", 1)
    for name in ("paper_showing_diffusion_images", "paper_showing_diffusion_images_diff",
                 "paper_showing_sampling_diff_images", "paper_cover_page_both_sampling"):
        for hh in (jh, h):
            for p in hh.results_folder.glob("all_*.png"):
                p.unlink()
            getattr(hh, name)(batch[:2])
        n = len(_files(jroot, "all_*.png"))
        assert n >= 1, name
        assert_same_files(jroot, root, "all_*.png", n)
    assert_same_files(jroot, root, "x0_alg*.png", 4)


def test_to_lab_and_bf16_match_jax(tmp_path, flax_params, batch):
    """Lab in and out of the model space, and bf16 compute on a bf16 copy of
    the model: the bf16 samples within 3e-2 relative L2 of JAX's (the two
    frameworks round to bf16 at other places, as in
    tests/test_torch_train.py's bf16 step; 3 steps compound it)."""
    jh, h = _pair(tmp_path, flax_params, to_lab=True)
    assert_close(h.opt(batch[:2]), jh.opt(batch[:2]))
    got, want = h.test_from_data(batch[:2], milestone=1), jh.test_from_data(batch[:2],
                                                                          milestone=1)
    assert_close(got.xt, want.xt)
    jh, h = _pair(tmp_path / "bf16", flax_params, bf16=True, model_chunk=2)
    assert next(h.model.parameters()).dtype == torch.bfloat16
    got = h.controlled_direct_reconstruct(batch[:3]).img
    want = np.asarray(jh.controlled_direct_reconstruct(batch[:3]).img)
    assert got.dtype == torch.float32
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 3e-2, rel


def test_mesh_and_a_missing_card_raise(tmp_path):
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S)
    model = UnetConvNext(dim=DIM, dim_mults=MULTS)
    # a mesh spans a process group: none without init_multihost
    from colddiff_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_multihost"):
        EvalHarness(d, model, results_folder=str(tmp_path), mesh=make_mesh("cpu"),
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EvalHarness(d, model, results_folder=str(tmp_path))
