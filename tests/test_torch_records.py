"""The record twins (``colddiff_torch/scripts/``) == the JAX record pipelines.

Each twin's ``evaluate`` (or training loop) runs at a toy size: a
``UnetConvNext(dim=8, (1, 2))`` at 16 px with the port's weights converted
from Flax params, T of 4-8, a few images.  Each is held against the same
pipeline assembled from the JAX package's public functions, with JAX's
draws injected.  Tolerances (fp32 on both sides unless said):
  - Family-B generation (``x0_step_down`` and ``ddim`` from JAX's noise) and
    its ``refresh_every`` sweep: images within relative L2 1e-5, and the
    generated mean and std within 1e-5;
  - the deblurring refresh sweep: each K's RMSE and SSIM within 1e-5
    absolute in fp32; the bf16 rows within 2e-2 relative (RMSE) and 2e-2
    absolute (SSIM), the bf16 train-step tolerance of
    ``tests/test_torch_train.py``, since bf16 rounds at other places in the
    two frameworks;
  - GMM generation at noise 0.0 and 0.002 with JAX's GMM draws and
    symmetry noise replayed: images within relative L2 1e-5 (the fp32
    UNets' summation orders move a few of the 6,144 values by ~1.5e-5);
  - loss parity: a 3-step fp32 trajectory with JAX's t draws replayed
    (blur draws no endpoint), the losses within rtol 1e-5 and the
    parameters within ``tests/test_torch_train.py``'s fp32 bound.
Proxy-FID is not compared here: ``tests/test_torch_fid.py`` compares it.
Then each twin's record holds the JAX record's keys, no default output is a
JAX record, running the twins leaves ``docs/examples/`` as it was, and each
``main`` raises on ``cuda`` without a card.

Torch runs one thread in this file (a module fixture).
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.eval import metrics as jmetrics
from colddiff.eval.harness import EvalHarness as JEvalHarness
from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.operators import get_operator as jget_operator
from colddiff.sampling import prepare_start as jprepare_start
from colddiff.sampling import sample as jsample
from colddiff.utils import bf16_params as jbf16_params
from colddiff_torch.data import SyntheticDataset
from colddiff_torch.eval import harness as harness_mod
from colddiff_torch.models import UnetConvNext
from colddiff_torch.models.convert import convnext_state_dict_from_flax
from colddiff_torch.scripts import (_records, family_b_generation, family_b_refresh_quality,
                                    gmm_generation, refresh_quality, train_loss_parity)
from tests.test_torch_train import _assert_fp32_params, _jax_blob, _replayed_t
from tests.test_torch_unet_convnext import flax_convnext_params

S, DIM, MULTS = 16, 8, (1, 2)
TOY = dict(image_size=S, dim=DIM, dim_mults=MULTS, n_data=16, device="cpu")
N_GEN, N_TRAIN = 8, 16
IMG_REL_L2 = 1e-5
METRIC_ATOL = 1e-5
BF16_RTOL = 2e-2
REPO = Path(__file__).resolve().parents[1]
DOCS = REPO / "docs" / "examples"
TWINS = {"train_loss_parity": (train_loss_parity, "train_bf16_parity.json"),
         "refresh_quality": (refresh_quality, "refresh_quality.json"),
         "family_b_generation": (family_b_generation, "family_b_generation.json"),
         "family_b_refresh_quality": (family_b_refresh_quality,
                                      "family_b_refresh_quality.json"),
         "gmm_generation": (gmm_generation, "gmm_generation.json")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_inception_weights(monkeypatch):
    monkeypatch.delenv("COLDDIFF_INCEPTION_WEIGHTS", raising=False)


@pytest.fixture(scope="module")
def flax_params():
    return flax_convnext_params(DIM, MULTS, seed=3)


@pytest.fixture(scope="module")
def models(flax_params):
    """(the JAX model and params, the port's model with the same weights)."""
    model = UnetConvNext(dim=DIM, dim_mults=MULTS)
    model.load_state_dict(convnext_state_dict_from_flax(flax_params), strict=True)
    return (JUnetConvNext(dim=DIM, dim_mults=MULTS),
            jax.tree_util.tree_map(jnp.asarray, flax_params), model.eval())


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_denoise(jmodel, params, bf16=False):
    if bf16:
        pb = jbf16_params(params)
        return lambda x, t: jmodel.apply(pb, x.astype(jnp.bfloat16), t).astype(jnp.float32)
    return lambda x, t: jmodel.apply(params, x, t)


# ---------------------------------------------------------------------- #
# Family B: generation and its refresh sweep


@pytest.fixture(scope="module")
def family_b(models):
    """JAX's noise, its images by each routine and K, and the port's
    evaluate of both twins on that noise."""
    jmodel, params, model = models
    t = 6
    jd = JColdDiffusion(op=jget_operator("noise", timesteps=t), image_size=S, channels=3,
                        sampling_routine="x0_step_down")
    noise = jax.random.normal(jax.random.key(7), (N_GEN, S, S, 3))
    den = _jax_denoise(jmodel, params)
    want = {}
    for routine in family_b_generation.ROUTINES:
        fixed = routine == "x0_step_down"
        want[routine] = np.asarray(jnp.clip(jsample(
            jd.replace(sampling_routine=routine), den, noise, x_end=noise if fixed else None,
            rng=jax.random.key(1)).img, -1, 1))
    for k in family_b_refresh_quality.KS:
        want[k] = np.asarray(jnp.clip(jsample(jd, den, noise, x_end=noise,
                                              rng=jax.random.key(1), refresh_every=k).img,
                                      -1, 1))
    d = family_b_generation.diffusion(timesteps=t, image_size=S, device="cpu")
    ds = SyntheticDataset(S, 3, length=N_TRAIN)
    pnoise = torch.from_numpy(np.asarray(noise))
    got = {}
    gen_out = family_b_generation.evaluate(model, ds, d, n_gen=N_GEN, n_train=N_TRAIN,
                                           noise=pnoise, chunk=4, keep=got)
    sweep_out = family_b_refresh_quality.evaluate(model, ds, d, n_gen=N_GEN, n_train=N_TRAIN,
                                                  noise=pnoise, chunk=4, keep=got)
    return want, got, gen_out, sweep_out


@pytest.mark.parametrize("routine", family_b_generation.ROUTINES)
def test_family_b_generation_matches_jax(family_b, routine):
    want, got, out, _ = family_b
    assert _rel_l2(got[routine], want[routine]) <= IMG_REL_L2
    entry = out["routines"][routine]
    assert abs(entry["gen_mean"] - float(want[routine].mean())) <= METRIC_ATOL
    assert abs(entry["gen_std"] - float(want[routine].std())) <= METRIC_ATOL


@pytest.mark.parametrize("k", family_b_refresh_quality.KS)
def test_family_b_refresh_sweep_matches_jax(family_b, k):
    want, got, _, out = family_b
    assert _rel_l2(got[k], want[k]) <= IMG_REL_L2
    entry = next(e for e in out["sweep"] if e["refresh_every"] == k)
    assert abs(entry["gen_mean"] - float(want[k].mean())) <= METRIC_ATOL
    assert abs(entry["gen_std"] - float(want[k].std())) <= METRIC_ATOL


# ---------------------------------------------------------------------- #
# the deblurring refresh sweep


@pytest.fixture(scope="module")
def refresh(models):
    jmodel, params, model = models
    t, n = 8, 4
    blur = dict(image_size=S, timesteps=t, blur_routine="Exponential_reflect",
                kernel_size=15, kernel_std=0.01)
    jd = JColdDiffusion(op=jget_operator("blur", **blur), image_size=S, channels=3,
                        sampling_routine="x0_step_down")
    ds = SyntheticDataset(S, 3, length=n)
    og = np.stack([ds[i] for i in range(n)])
    start = jprepare_start(jd, jnp.asarray(og), op_rng=None)
    og01 = (jnp.asarray(og) + 1) / 2
    want = {}
    for tag, ks, bf16 in (("sweep", refresh_quality.FP32_KS, False),
                          ("bf16_sweep", refresh_quality.BF16_KS, True)):
        den = _jax_denoise(jmodel, params, bf16)
        for k in ks:
            img = jnp.clip(jsample(jd, den, start, rng=jax.random.key(0),
                                   refresh_every=k).img, -1, 1)
            want[tag, k] = {"rmse": float(jmetrics.rmse(og01, (img + 1) / 2)),
                            "ssim": float(jmetrics.ssim(og01, (img + 1) / 2)),
                            "img": np.asarray(img)}
    want["degraded"] = {"rmse": float(jmetrics.rmse(og01, (jnp.clip(start, -1, 1) + 1) / 2)),
                        "ssim": float(jmetrics.ssim(og01, (jnp.clip(start, -1, 1) + 1) / 2))}
    d = refresh_quality.diffusion(image_size=S, timesteps=t, device="cpu")
    got = {}
    out = refresh_quality.evaluate(model, d, torch.from_numpy(og), chunk=2, keep=got)
    return want, got, out


@pytest.mark.parametrize("tag,k", [("sweep", k) for k in refresh_quality.FP32_KS]
                         + [("bf16_sweep", k) for k in refresh_quality.BF16_KS])
def test_refresh_quality_matches_jax(refresh, tag, k):
    want, got, out = refresh
    entry = next(e for e in out[tag] if e["refresh_every"] == k)
    w = want[tag, k]
    if tag == "sweep":
        assert abs(entry["rmse"] - w["rmse"]) <= METRIC_ATOL
        assert abs(entry["ssim"] - w["ssim"]) <= METRIC_ATOL
        assert _rel_l2(got[tag, k].clamp(-1, 1), w["img"]) <= IMG_REL_L2
    else:
        assert entry["rmse"] == pytest.approx(w["rmse"], rel=BF16_RTOL)
        assert abs(entry["ssim"] - w["ssim"]) <= BF16_RTOL
    for key in ("rmse", "ssim"):
        assert abs(out["degraded"][key] - want["degraded"][key]) <= METRIC_ATOL
    summary = out["summary"]
    assert summary["rmse_refresh4"] == float(f"{out['sweep'][2]['rmse']:.4g}")
    assert summary["bf16_refresh8_ssim"] == float(f"{out['bf16_sweep'][2]['ssim']:.4g}")


# ---------------------------------------------------------------------- #
# GMM generation


@pytest.fixture(scope="module")
def gmm(models, tmp_path_factory):
    """JAX's harness at each noise level, and the port's evaluate with
    JAX's categorical and normal GMM draws and its symmetry noise."""
    jmodel, params, model = models
    t = 4
    jd = JColdDiffusion(op=jget_operator("blur", image_size=S, timesteps=t,
                                         blur_routine="Exponential", kernel_size=15,
                                         kernel_std=0.01, discrete=True),
                        image_size=S, channels=3, sampling_routine="x0_step_down",
                        discrete=True)
    ds = SyntheticDataset(S, 3, length=N_TRAIN)
    jh = JEvalHarness(jd, jmodel, params, results_folder=str(tmp_path_factory.mktemp("jax_gmm")))
    key = jax.random.key(3)
    want = {lvl: np.asarray(jnp.clip(jh.gmm_mean_samples(ds, clusters=1, num=N_GEN,
                                                         noise_level=lvl, rng=key).img, -1, 1))
            for lvl in gmm_generation.NOISE_LEVELS}
    _, s_rng, n_rng, _ = jax.random.split(key, 4)
    k_rng, g_rng = jax.random.split(s_rng)
    comp = torch.from_numpy(np.array(jax.random.categorical(k_rng, jnp.zeros(1),
                                                            shape=(N_GEN,))))
    z = torch.from_numpy(np.array(jax.random.normal(g_rng, (N_GEN, 3))))
    sym = torch.from_numpy(np.array(jax.random.normal(n_rng, (N_GEN, S, S, 3))))
    mp = pytest.MonkeyPatch()
    real_sample, real_randn = harness_mod.sample_gmm, torch.randn
    mp.setattr(harness_mod, "sample_gmm", lambda g, gen, n: real_sample(g, gen, n, comp=comp,
                                                                         z=z))

    def randn(shape, *a, **kw):
        return sym.clone() if tuple(shape) == tuple(sym.shape) else real_randn(shape, *a, **kw)

    mp.setattr(torch, "randn", randn)
    try:
        d = gmm_generation.diffusion(timesteps=t, image_size=S, device="cpu")
        got = {}
        out = gmm_generation.evaluate(model, ds, d, n_gen=N_GEN, n_train=N_TRAIN,
                                      noise=np.zeros((N_TRAIN // 2, S, S, 3), np.float32),
                                      chunk=4, keep=got)
    finally:
        mp.undo()
    return want, got, out


@pytest.mark.parametrize("level", gmm_generation.NOISE_LEVELS)
def test_gmm_generation_matches_jax_with_its_draws(gmm, level):
    want, got, out = gmm
    assert _rel_l2(got[level], want[level]) <= IMG_REL_L2
    entry = out["gmm"][str(level)]
    assert entry["noise_level"] == level
    assert abs(entry["gen_mean"] - float(want[level].mean())) <= METRIC_ATOL


# ---------------------------------------------------------------------- #
# loss parity


def test_loss_parity_trajectory_matches_jax_trainer(tmp_path):
    """The twin's Trainer and loop for 3 fp32 steps from the JAX Trainer's
    state, JAX's t draws replayed through ``draws``."""
    from colddiff.data import datasets as jdatasets
    from colddiff.parallel import make_mesh
    from colddiff.train import Trainer as JTrainer

    t, b = 8, 2
    jd = JColdDiffusion(op=jget_operator("blur", image_size=S, timesteps=t,
                                         blur_routine="Exponential_reflect", kernel_size=15,
                                         kernel_std=0.01),
                        image_size=S, sampling_routine="x0_step_down")
    jtr = JTrainer(jd, JUnetConvNext(dim=DIM, dim_mults=MULTS),
                   jdatasets.SyntheticDataset(S, 3, length=16), train_batch_size=b,
                   gradient_accumulate_every=2, save_and_sample_every=10**9, num_workers=1,
                   seed=0, results_folder=str(tmp_path / "jax"),
                   mesh=make_mesh(jax.devices()[:1]))
    ptr = train_loss_parity.make_trainer(tmp_path / "port", timesteps=t, batch=b, **TOY)
    names = [n for n, _ in ptr.model.named_parameters()]
    ptr.load_state(_jax_blob(jtr, names))
    jlosses = []

    def draws(i):
        jbatch, _ = jtr._next_superbatch()
        ts = _replayed_t(jtr.state.rng, t)
        jtr.state, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
        jlosses.append(float(jloss))
        return {"t": ts}

    points, _ = _records.run_steps(ptr, 3, every=1, save_every=100, draws=draws, quiet=True)
    losses = [p["loss"] for p in points]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = _jax_blob(jtr, names)
    assert ptr.step == want["step"] == 3
    for part in ("model", "ema"):
        _assert_fp32_params(ptr.state()[part], want[part], part)
    entry = train_loss_parity.evaluate(points, 1.0)
    assert entry["loss_first10_mean"] == pytest.approx(np.mean(jlosses), rel=1e-5)
    assert entry["losses_every10"] == [round(losses[0], 5)]


class _Killed(Exception):
    pass


def test_a_cut_run_resumes_bitwise(tmp_path):
    """A run killed between checkpoints (before its 4th step, the last
    checkpoint after the 2nd), a new Trainer from the checkpoint, on to 4
    == 4 unbroken, with the loss points up to the checkpoint kept and the
    one after it taken again; a finished run resumes at its end."""
    kw = dict(timesteps=4, batch=2, **TOY)
    a = family_b_generation.make_trainer(tmp_path / "a", **kw)
    pa, _ = _records.run_steps(a, 4, every=1, save_every=2)
    b = family_b_generation.make_trainer(tmp_path / "b", **kw)
    _records.run_steps(b, 3, every=1, save_every=2)  # a whole run of 3 steps
    assert family_b_generation.make_trainer(tmp_path / "b", **kw).step == 3

    def kill(i):
        if i == 3:
            raise _Killed
        return {}

    b = family_b_generation.make_trainer(tmp_path / "c", **kw)
    with pytest.raises(_Killed):
        _records.run_steps(b, 4, every=1, save_every=2, draws=kill)
    log = (tmp_path / "c" / "losses.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in log] == [0, 1, 2]
    b = family_b_generation.make_trainer(tmp_path / "c", **kw)
    assert b.step == 2
    pb, _ = _records.run_steps(b, 4, every=1, save_every=2)
    assert pa == pb
    for x, y in zip(a.state()["model"].values(), b.state()["model"].values()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("anchor_within,claim_held,want", [
    (True, True, 0), (True, False, 0), (False, True, 1), (False, False, 1)])
def test_exit_code_fails_on_an_anchor_miss_and_records_a_claim_miss(anchor_within, claim_held,
                                                                    want, capsys):
    """A generation record exits 1 when an anchor held against the JAX
    record misses its limit; a claim that misses is printed and exits 0."""
    result = {"anchors_vs_jax": {"train_mean": _records.compare_ulps(
                  0.5 + (0 if anchor_within else 1e-5), 0.5)},
              "claims": {"x0_step_down_at_or_below_ddim": {"held": claim_held}}}
    assert _records.exit_code(result) == want
    printed = capsys.readouterr().out
    assert ("claim missed" in printed) == (not claim_held)
    assert ("anchors out of their limits" in printed) == (not anchor_within)


@pytest.mark.parametrize("name,good,bad", [
    ("family_b_generation", {"x0_step_down": 2.0, "ddim": 2.5}, {"x0_step_down": 3.5, "ddim": 3.0}),
    ("gmm_generation", {"0.0": 2.0, "0.002": 2.1}, {"0.0": 3.0, "0.002": 3.5})])
def test_generation_claims_are_checked(name, good, bad):
    """Each generation record's claims against a noise ceiling of 30, on
    rows that hold them and on rows that miss both."""
    mod = TWINS[name][0]
    held = mod.claims(good, 30.0)
    assert len(held) == 2 and all(c["held"] for c in held.values())
    assert not any(c["held"] for c in mod.claims(bad, 30.0).values())
    first = next(iter(good))
    assert set(mod.claims({first: good[first]}, 30.0)) == {"far_below_noise_ceiling"}


# ---------------------------------------------------------------------- #
# the records: keys, paths, docs/examples untouched, no card


def _hashes() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(DOCS.iterdir()) if p.is_file()}


def test_records_have_the_jax_keys_and_leave_docs_examples_alone(tmp_path, models):
    """Each twin's record at a toy size: the JAX record's key paths and the
    twin's declared additions (the card, torch, the device, the checkpoint,
    the anchors held against JAX), written under tmp_path with its grids,
    while docs/examples/ stays byte for byte as it was."""
    before = _hashes()
    _, _, model = models
    kw = dict(timesteps=4, batch=2, **TOY)
    got = {}
    ptr = train_loss_parity.make_trainer(tmp_path / "parity" / "fp32", **kw)
    runs = {tag: train_loss_parity.evaluate(*_records.run_steps(ptr, 2, every=1, save_every=100,
                                                                quiet=True))
            for tag in ("fp32", "bf16")}
    got["train_loss_parity"] = train_loss_parity.record(runs, 2, "cpu")
    d = refresh_quality.diffusion(image_size=S, timesteps=4, device="cpu")
    og = torch.from_numpy(np.stack([SyntheticDataset(S, 3, length=2)[i] for i in range(2)]))
    got["refresh_quality"] = refresh_quality.record(
        refresh_quality.evaluate(model, d, og, checkpoint="x"), "cpu")
    for name, mod in (("family_b_generation", family_b_generation),
                      ("gmm_generation", gmm_generation)):
        tr = mod.make_trainer(tmp_path / name, **kw)
        losses, seconds = _records.run_steps(tr, 2, every=mod.LOSS_EVERY, save_every=5000)
        got[name] = {**_records.train_record(tr, mod.config(tr), 2, losses, seconds),
                     **mod.evaluate(tr.ema_model.eval(), tr._dataset, tr.diffusion, n_gen=4,
                                    n_train=N_TRAIN, record=_records.jax_record(mod.JAX_RECORD),
                                    png_prefix=tmp_path / f"torch_{name}")}
        if name == "family_b_generation":
            got["family_b_refresh_quality"] = family_b_refresh_quality.record(
                "x", family_b_refresh_quality.evaluate(tr.ema_model.eval(), tr._dataset,
                                                       tr.diffusion, n_gen=4,
                                                       n_train=N_TRAIN), "cpu")
    for name, (mod, jax_name) in TWINS.items():
        want = _records.key_paths(json.loads((DOCS / jax_name).read_text()))
        path = _records.write_json(tmp_path / f"torch_{name}.json", got[name])
        have = {k for k in _records.key_paths(json.loads(path.read_text()))
                if k.split("/")[0] not in mod.EXTRA_KEYS or "/" not in k}
        assert have == want | mod.EXTRA_KEYS, name
    assert len(list(tmp_path.glob("torch_*.png"))) == 6
    assert _hashes() == before


@pytest.mark.parametrize("name", sorted(TWINS))
def test_default_outputs_are_torch_records(name):
    mod, jax_name = TWINS[name]
    args = vars(mod.parser().parse_args([]))
    assert args["device"] == "cuda"
    for key in ("out", "run", "runs", "checkpoint"):
        if key in args:
            rel = Path(args[key]).resolve().relative_to(REPO)
            assert rel.parts[0] in ("docs", "runs") and rel.parts[-1 if key == "out" else
                                                                   1].startswith("torch_"), rel
            assert _records.out_path(args[key]) == Path(args[key]).resolve()
    with pytest.raises(ValueError, match="JAX record"):
        _records.out_path(DOCS / jax_name)
    with pytest.raises(ValueError, match="JAX record"):
        _records.out_path(REPO / "runs" / "gmm_gen64" / "model.pt")


@pytest.mark.parametrize("name", sorted(TWINS))
def test_main_raises_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TWINS[name][0].main(["--out", str(tmp_path / "torch_x.json")])
    assert not list(tmp_path.iterdir())
