"""Row (spatial) sharding beyond the flagship path: the eight other
operators, the ResNet UNet, every sampler and ``ColdDiffusion.loss`` inside
``parallel.image_rows``, against JAX and against one process.

One group of four CPU processes over gloo (one torch thread each) runs a
(2, 2) and a (1, 4) ``make_mesh_2d`` mesh: on (2, 2) each process holds 8
of 16 rows of one image; on (1, 4) 4 rows of two, and 2 at the UNets'
second level.  Each rank runs the same calls, rank 0 saves what they gave,
and this process computes JAX's references meanwhile (each JAX function
compiled once); the one-process references of the port run here after.

Tolerances, stated per check:
  - each operator's ``degrade`` at every level 0..T (T=4, 16 px), gathered,
    against JAX's single-device run and JAX's make_mesh_2d(2, 4) run with
    ``shard_images``: 2e-5;
  - a T=4 ``prepare_start`` + ``sample`` with UnetConvNext(dim=8, (1, 2))
    on a seeded Flax parameter tree (converted for the port), gathered,
    against JAX's single-device run: 2e-5, as
    tests/test_torch_spatial.py holds blur's; both sides are given the
    same endpoints (numpy-seeded) and JAX's crop offsets (threefry is not
    replayed), and snow's fields come from one numpy seed on both;
  - the other samplers (ddim, default, the spiral routines, recon noise,
    ``all_sample``'s frames, ``sample_multi_step``) against the port's
    own whole-image run: 2e-5;
  - UnetResNet(ch=32, ch_mult=(1, 2), num_res_blocks=1,
    attn_resolutions=(8,), resolution=16) fp32 forward against JAX (single
    device and the (2, 4) mesh) at rtol 2e-4 / atol 2e-5, the tolerance of
    tests/test_torch_unet_resnet.py's fp32 twin; against the port's own
    whole-image run (also with average-pool resampling, and in training
    mode with dropout) at 2e-5;
  - ``ColdDiffusion.loss`` with t and noise from JAX's key, against JAX's
    ``loss`` on ``shard_images`` over the (2, 4) mesh: 1e-5; the
    parameter gradients summed over the space axis (and averaged over the
    data axis) against one process's: rtol 1e-4 (atol 1e-6);
  - ``GaussianNoise.sample_x_end`` and ``Final_small_noise``'s draw: each
    block is its rows of the one-process draw, bitwise.
"""

import os
import socket
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from colddiff_torch import parallel
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext, UnetResNet
from colddiff_torch.operators import get_operator
from colddiff_torch.parallel import spatial
from colddiff_torch.sampling import all_sample, prepare_start, sample, sample_multi_step

N = 4
MESHES = ((2, 2), (1, 4))
MESH_IDS = ["2x2", "1x4"]
S, B, T = 16, 2, 4
# key: (registry name, configuration, JAX-checked sampling routine, endpoint)
OPS = {
    "noise": ("noise", dict(timesteps=T), "x0_step_down", "normal"),
    "mix": ("mix", dict(timesteps=T), "x0_step_down", "image"),
    "decolor": ("decolor", dict(timesteps=T, decolor_routine="Linear",
                                decolor_total_remove=True), "x0_step_down", None),
    "fade": ("fade", dict(image_size=S, timesteps=T, fade_routine="Incremental",
                          kernel_std=0.2, initial_mask=3), "x0_step_down", None),
    "fade_random": ("fade", dict(image_size=S, timesteps=T, fade_routine="Random_Incremental",
                                 kernel_std=0.1, initial_mask=1), "x0_step_down", None),
    "fade_naive": ("fade_naive", dict(image_size=S, timesteps=T, fade_routine="Spiral_2"),
                   "x0_step_down_spiral_2_fix", "spiral"),
    "fade_generation": ("fade_generation", dict(image_size=S, timesteps=T, kernel_std=0.3,
                                                initial_mask=2, reverse=True),
                        "x0_step_down", "colour"),
    "resolution": ("resolution", dict(image_size=S, timesteps=T,
                                      resolution_routine="Incremental_factor_2"),
                   "x0_step_down", None),
    "snow": ("snow", dict(image_size=S, timesteps=T, snow_level=4, random_snow=True, seed=3,
                          batch_size=B), "x0_step_down", None),
}
# the other samplers, against the port's whole-image run: (op key, routine,
# recon_noise_std); the drawing ones draw from a seeded generator
VARIANTS = [("noise", "ddim", 0.0), ("fade_generation", "ddim", 0.0),
            ("fade_naive", "x0_step_down_spiral_2_rand", 0.0), ("snow", "x0_step_down", 0.01),
            ("fade", "default", 0.0), ("resolution", "default", 0.0), ("mix", "default", 0.0)]
MULTI_STEP = ("fade", "noise")
BLUR = dict(image_size=S, timesteps=T, blur_routine="Constant", kernel_size=3, kernel_std=1.0)
# (train routine, loss type): JAX's loss on its mesh; then port-only routines
JAX_LOSSES = [("Final", "l1"), ("Final_small_noise", "l2"), ("Final_random_mean", "sqrt")]
PORT_LOSSES = [("Gradient_norm", "l1"), ("Step", "l1")]
RESNET = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=S)


def _inputs():
    """Images, endpoints and the ResNet's levels, as numpy fp32 / int."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1.0, 1.0, (B, S, S, 3)).astype(np.float32)
    ends = {
        "normal": rng.standard_normal((B, S, S, 3)).astype(np.float32),
        "image": rng.uniform(-1.0, 1.0, (B, S, S, 3)).astype(np.float32),
        "colour": np.broadcast_to(rng.uniform(-0.5, 0.5, (B, 1, 1, 3)),
                                  (B, S, S, 3)).astype(np.float32),
        "spiral": np.broadcast_to(rng.uniform(0.0, 1.0, (B, 1, 1, 3)),
                                  (B, S, S, 3)).astype(np.float32),
    }
    return x, ends, np.asarray([3, 150])


def _levels(level):
    """Both images' levels: level and T - level (every level over 0..T)."""
    return torch.tensor([level, T - level])


def _op(key, offsets=None):
    name, cfg, _, _ = OPS[key]
    op = get_operator(name, **cfg, device="cpu")
    if offsets is not None and key == "fade_random":
        op.offsets = offsets
    return op


def _diffusion(key, offsets, routine=None, recon_noise_std=0.0):
    return ColdDiffusion(op=_op(key, offsets), image_size=S,
                         sampling_routine=routine or OPS[key][2],
                         recon_noise_std=recon_noise_std)


def _convnext(state):
    model = UnetConvNext(dim=8, dim_mults=(1, 2), channels=3)
    model.load_state_dict(state)
    return model.eval()


def _resnet(state, **cfg):
    model = UnetResNet(**RESNET, **cfg)
    model.load_state_dict(state)
    return model.eval()


class _Place:
    """How a run places its inputs: whole (one process), or this process's
    block of a mesh (``shard_images``, ``shard_batch``) and back."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def img(self, a):
        a = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        return a if self.mesh is None else parallel.shard_images(a, self.mesh)

    def rows(self, a):
        a = torch.as_tensor(a)
        return a if self.mesh is None else parallel.shard_batch(a, self.mesh["data"])

    def whole(self, a):
        return a if self.mesh is None else parallel.gather_images(a, self.mesh)


def _degrades(p: _Place, inputs, key):
    """``degrade`` of one operator at every level 0..T, whole images."""
    x, ends = inputs["x"], inputs["ends"]
    op = _op(key, inputs["offsets"])
    end = OPS[key][3]
    kw = {} if end is None else {"x_end": p.img(ends[end])}
    xb = p.img(x)
    return torch.stack([p.whole(op.degrade(xb, p.rows(_levels(level)), og=xb, **kw))
                        for level in range(T + 1)])


def _sample(p: _Place, inputs, model, key, routine=None, recon_noise_std=0.0):
    d = _diffusion(key, inputs["offsets"], routine, recon_noise_std)
    end = OPS[key][3]
    x_end = None if end is None else p.img(inputs["ends"][end])
    gen = torch.Generator().manual_seed(9)
    with torch.inference_mode():
        start = prepare_start(d, p.img(inputs["x"]), x_end=x_end)
        return p.whole(sample(d, model, start, x_end=x_end, generator=gen).img)


def _trajectories(p: _Place, inputs, model):
    d = _diffusion("fade", None)
    with torch.inference_mode():
        res = all_sample(d, model, prepare_start(d, p.img(inputs["x"])), traj_stride=2)
    return [torch.stack([p.whole(f) for f in traj])
            for traj in (res.x0_trajectory, res.xt_trajectory)] + [p.whole(res.img)]


def _multi_step(p: _Place, inputs, model, key):
    d = _diffusion(key, None)
    end = OPS[key][3]
    x_end = None if end is None else p.img(inputs["ends"][end])
    x = p.img(inputs["x"])
    start = prepare_start(d, x, x_end=x_end)
    return p.whole(sample_multi_step(d, model, start, p.rows(torch.tensor([4, 3])),
                                     p.rows(torch.tensor([1, 0])), x_end=x_end))


def _resnet_forwards(p: _Place, inputs, states):
    """The fp32 forward (with the collectives it made), the forward with
    average-pool resampling, and a training-mode forward with dropout."""
    x, t = p.img(inputs["x"]), p.rows(torch.as_tensor(inputs["t"]))
    spatial.collectives.clear()
    with torch.no_grad():
        out = {"eval": p.whole(_resnet(states["resnet"])(x, t))}
        kinds = Counter()
        for (kind, _), count in spatial.collectives.items():
            kinds[kind] += count
        out["collectives"] = dict(kinds)
        out["pool"] = p.whole(_resnet(states["resnet_pool"], resamp_with_conv=False)(x, t))
        model = _resnet(states["resnet"], dropout=0.1).train()
        out["dropout"] = p.whole(model(x, t, generator=torch.Generator().manual_seed(5)))
    return out


def _loss(p: _Place, inputs, model, routine, loss_type, part=slice(None)):
    """The loss and the parameter gradients (all of them, flat) of the batch
    rows ``part``, [1] and [1, P]; on a mesh, each data index's ([D] and
    [D, P]), its gradients summed over the space axis."""
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      train_routine=routine, loss_type=loss_type)
    model.zero_grad()
    t, noise = inputs["loss_draws"][routine]
    x, t = torch.from_numpy(inputs["x"])[part], t[part]
    noise = None if noise is None else noise[part]
    noise = None if noise is None else (p.img(noise) if noise.shape[1] > 1 else p.rows(noise))
    loss = d.loss(model, p.img(x), None, t=p.rows(t), noise=noise)
    loss.backward()
    value = loss.detach().reshape(1)
    grads = torch.cat([q.grad.flatten() for q in model.parameters()])[None]
    if p.mesh is not None:
        torch.distributed.all_reduce(grads, group=p.mesh["space"].get_group())
        value, grads = (parallel.gather_rows(v, p.mesh["data"]) for v in (value, grads))
    return dict(loss=value, grads=grads)


def _losses(p: _Place, inputs, states):
    """:func:`_loss` of every case: on a mesh, each data index's; on one
    process, for each data axis size D of ``MESHES``, each of the D parts
    of the batch on its own (what a data index holds)."""
    cases = {c: (_convnext(states["convnext"]), *c) for c in JAX_LOSSES + PORT_LOSSES}
    cases[("resnet", "l1")] = (_resnet(states["resnet"]), "Final", "l1")
    if p.mesh is not None:
        return {c: _loss(p, inputs, *args) for c, args in cases.items()}
    out = {}
    for parts in sorted({data for data, _ in MESHES}):
        b = B // parts
        for c, args in cases.items():
            runs = [_loss(p, inputs, *args, part=slice(i * b, (i + 1) * b))
                    for i in range(parts)]
            out[(parts, c)] = {k: torch.cat([r[k] for r in runs]) for k in ("loss", "grads")}
    return out


def _draws(p: _Place, inputs):
    """GaussianNoise's endpoint, and Final_small_noise's input to the model
    at t = -1 (the clean passthrough: the image plus 0.001 of the draw)."""
    x = p.img(inputs["x"])
    x_end = _op("noise").sample_x_end(torch.Generator().manual_seed(21), x)
    seen = []

    def denoise(xt, t):
        seen.append(xt)
        return xt

    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      train_routine="Final_small_noise")
    d.loss(denoise, x, torch.Generator().manual_seed(22), t=p.rows(torch.tensor([-1, -1])))
    return dict(x_end=p.whole(x_end), small_noise=p.whole(seen[0]))


def _runs(p: _Place, inputs, states):
    """Every check's side of one placement: whole (one process) or a mesh."""
    got = {"degrade": {k: _degrades(p, inputs, k) for k in OPS}}
    convnext = _convnext(states["convnext"])
    got["sample"] = {k: _sample(p, inputs, convnext, k) for k in OPS}
    got["variant"] = {v: _sample(p, inputs, convnext, v[0], v[1], v[2]) for v in VARIANTS}
    got["traj"] = _trajectories(p, inputs, convnext)
    got["multi_step"] = {k: _multi_step(p, inputs, convnext, k) for k in MULTI_STEP}
    got["resnet"] = _resnet_forwards(p, inputs, states)
    got["loss"] = _losses(p, inputs, states)
    got["draw"] = _draws(p, inputs)
    return got


def _rank(rank, port, root, queue):
    """One process of the group: every check's row-sharded side, on both
    meshes, once ``queue`` gives the inputs' path."""
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(N))
    torch.set_num_threads(1)
    parallel.init_multihost(f"localhost:{port}", N, rank, device="cpu")
    meshes = {shape: parallel.make_mesh_2d(*shape, "cpu") for shape in MESHES}
    inputs, states = torch.load(queue.get(timeout=300), weights_only=False)
    got = {}
    for shape, mesh in meshes.items():
        with parallel.image_rows(mesh):
            got[shape] = _runs(_Place(mesh), inputs, states)
    torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save(got, Path(root) / "got.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_inputs(root):
    """The inputs both sides share: images and endpoints, JAX's crop
    offsets and loss draws, and the Flax parameter trees (seeded numpy
    draws, ``flax_convnext_params``, ``flax_resnet_params``) with their
    conversions to the port's state dicts."""
    import jax
    import jax.numpy as jnp

    from colddiff.operators import get_operator as jget_operator
    from colddiff_torch.models.convert import (convnext_state_dict_from_flax,
                                               resnet_state_dict_from_flax)
    from tests.test_torch_unet_convnext import flax_convnext_params
    from tests.test_torch_unet_resnet import flax_resnet_params

    x, ends, t = _inputs()
    name, cfg, _, _ = OPS["fade_random"]
    jfade = jget_operator(name, **cfg).randomize(jax.random.key(4), B)
    offsets = torch.from_numpy(np.array(jfade.offsets)).long()
    params = flax_convnext_params(8, (1, 2), seed=5)
    resnet, pool = flax_resnet_params(**RESNET), flax_resnet_params(resamp_with_conv=False,
                                                                    **RESNET)
    draws = {}
    for routine, _ in JAX_LOSSES + PORT_LOSSES:
        # JAX's loss: t from the first half of its key, the noise from the second
        t_key, noise_key = jax.random.split(jax.random.key(31))
        lt = np.asarray(jax.random.randint(t_key, (B,), 0, T))
        noise = None
        if routine == "Final_small_noise":
            noise = np.asarray(jax.random.normal(noise_key, (B, S, S, 3)))
        elif routine == "Final_random_mean":
            noise = np.asarray(jax.random.normal(noise_key, (B, 1, 1, 3), jnp.float32))
        draws[routine] = (torch.from_numpy(np.array(lt)).long(),
                          None if noise is None else torch.from_numpy(np.array(noise)))
    inputs = dict(x=x, ends=ends, t=t, offsets=offsets, loss_draws=draws)
    states = dict(convnext=convnext_state_dict_from_flax(params),
                  resnet=resnet_state_dict_from_flax(resnet),
                  resnet_pool=resnet_state_dict_from_flax(pool))
    path = root / "inputs.pt"
    torch.save((inputs, states), path)
    return path, inputs, dict(convnext=params, resnet=resnet, resnet_pool=pool)


def _jax_runs(inputs, params):
    """JAX's references: the degrades (one device, and the (2, 4) mesh), the
    T=4 samples, the ResNet's forward (both) and the losses on the mesh."""
    import jax
    import jax.numpy as jnp

    from colddiff.diffusion import ColdDiffusion as JColdDiffusion
    from colddiff.models import UnetConvNext as JUnetConvNext
    from colddiff.models import UnetResNet as JUnetResNet
    from colddiff.operators import get_operator as jget_operator
    from colddiff.parallel import make_mesh_2d, replicate, shard_images
    from colddiff.sampling import prepare_start as jprepare_start
    from colddiff.sampling import sample as jsample

    x, ends = jnp.asarray(inputs["x"]), {k: jnp.asarray(v) for k, v in inputs["ends"].items()}
    jops = {}
    for key, (name, cfg, _, _) in OPS.items():
        jops[key] = jget_operator(name, **cfg)
        if key == "fade_random":  # the offsets _jax_inputs gave the port
            jops[key] = jops[key].randomize(jax.random.key(4), B)

    def degrades(x, ends):
        out = {}
        for key, op in jops.items():
            end = OPS[key][3]
            kw = {} if end is None else {"x_end": ends[end]}
            out[key] = jnp.stack([op.degrade(x, jnp.asarray([lv, T - lv]), og=x, **kw)
                                  for lv in range(T + 1)])
        return out

    mesh = make_mesh_2d(2, 4)
    placed = {k: shard_images(v, mesh) for k, v in ends.items()}
    out = dict(degrade=jax.device_get(jax.jit(degrades)(x, ends)),
               degrade_mesh=jax.device_get(jax.jit(degrades)(shard_images(x, mesh), placed)))

    model = JUnetConvNext(dim=8, dim_mults=(1, 2), channels=3)
    out["sample"] = {}
    for key, op in jops.items():
        d = JColdDiffusion(op=op, image_size=S, channels=3, sampling_routine=OPS[key][2])
        end = OPS[key][3]
        x_end = None if end is None else ends[end]

        def run(x, x_end, d=d):
            start = jprepare_start(d, x, x_end=x_end)
            return jsample(d, lambda xt, tt: model.apply(params["convnext"], xt, tt), start,
                           x_end=x_end).img

        out["sample"][key] = np.asarray(jax.jit(run)(x, x_end))

    t = jnp.asarray(inputs["t"])
    for name, cfg in (("resnet", {}), ("resnet_pool", dict(resamp_with_conv=False))):
        fwd = jax.jit(JUnetResNet(**RESNET, **cfg).apply)
        out[name] = np.asarray(fwd(params[name], x, t))
        out[name + "_mesh"] = np.asarray(fwd(replicate(params[name], mesh),
                                             shard_images(x, mesh), t))

    out["loss"] = {}
    blur = jget_operator("blur", **BLUR)
    cparams = replicate(params["convnext"], mesh)
    for routine, loss_type in JAX_LOSSES:
        d = JColdDiffusion(op=blur, image_size=S, channels=3, train_routine=routine,
                           loss_type=loss_type)

        def loss(p, x, d=d):
            return d.loss(lambda xt, tt: model.apply(p, xt, tt), x, jax.random.key(31))

        out["loss"][routine] = float(jax.jit(loss)(cparams, shard_images(x, mesh)))
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four-process group's results, JAX's, and the shared inputs."""
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("spatial_ops")
    port = _free_port()
    ctx = mp.get_context("spawn")
    queues = [ctx.Queue() for _ in range(N)]
    procs = [ctx.Process(target=_rank, args=(r, port, str(root), q))
             for r, q in enumerate(queues)]
    for p in procs:
        p.start()
    try:
        path, inputs, params = _jax_inputs(root)
        for q in queues:
            q.put(str(path))
        jax_out = _jax_runs(inputs, params)
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * N
    return torch.load(root / "got.pt", weights_only=False), jax_out, path


@pytest.fixture(scope="module")
def one(group):
    """The port's one-process runs of the same checks (no group)."""
    inputs, states = torch.load(group[2], weights_only=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _runs(_Place(), inputs, states)
    finally:
        torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("key", list(OPS))
def test_degrade_on_row_blocks_matches_jax(group, key, shape):
    """Every level 0..T, gathered, == JAX on one device and on its (2, 4)
    mesh: the per-pixel tables cut to the block's rows, the crop rows of
    the 2S grid, the gathered rows of the resize product."""
    got, want, _ = group
    for ref in ("degrade", "degrade_mesh"):
        _close(got[shape]["degrade"][key], want[ref][key], 2e-5, ref)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("key", list(OPS))
def test_row_sharded_sample_matches_jax(group, key, shape):
    """prepare_start + a T=4 sample, the UNet on row blocks, == JAX's."""
    got, want, _ = group
    _close(got[shape]["sample"][key], want["sample"][key], 2e-5)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("variant", VARIANTS, ids=[f"{k}-{r}-{s}" for k, r, s in VARIANTS])
def test_other_samplers_match_one_process(group, one, variant, shape):
    """ddim, the default routine, the spiral routine that redraws its
    endpoint each step and recon_noise_std's draw, on row blocks, == the
    whole-image run (the draws are the whole images')."""
    _close(group[0][shape]["variant"][variant], one["variant"][variant], 2e-5)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_all_sample_frames_match_one_process(group, one, shape):
    """all_sample's frames are row blocks that gather_images joins."""
    for got, want, what in zip(group[0][shape]["traj"], one["traj"], ("x0", "xt", "img")):
        _close(got, want, 2e-5, what)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("key", MULTI_STEP)
def test_sample_multi_step_matches_one_process(group, one, key, shape):
    _close(group[0][shape]["multi_step"][key], one["multi_step"][key], 2e-5)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_resnet_forward_on_row_blocks_matches_jax(group, shape):
    """The ResNet's halo'd convs, its Downsample's bottom row, the group's
    GroupNorm statistics and the gathered attention keys == JAX's forward
    on one device and on its (2, 4) mesh."""
    got, want, _ = group
    for ref in ("resnet", "resnet_mesh"):
        np.testing.assert_allclose(got[shape]["resnet"]["eval"].numpy(), want[ref],
                                   rtol=2e-4, atol=2e-5, err_msg=ref)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("what", ["eval", "pool", "dropout"])
def test_resnet_on_row_blocks_matches_one_process(group, one, what, shape):
    """Against the port's whole-image run: the forward, the average-pool
    resampler, and training mode, whose dropout masks are the whole
    images' draw."""
    _close(group[0][shape]["resnet"][what], one["resnet"][what], 2e-5)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_resnet_pool_forward_matches_jax(group, shape):
    got, want, _ = group
    for ref in ("resnet_pool", "resnet_pool_mesh"):
        np.testing.assert_allclose(got[shape]["resnet"]["pool"].numpy(), want[ref],
                                   rtol=2e-4, atol=2e-5, err_msg=ref)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_resnet_collectives(group, shape):
    """A forward's exchanges: halos (3x3 convs and the Downsample's row),
    sums (two a GroupNorm), rows (the attention's keys and values); no max."""
    kinds = group[0][shape]["resnet"]["collectives"]
    # halos: conv_in, 8 ResnetBlocks x 2 convs, the Downsample, the Upsample's
    # conv, conv_out; 21 GroupNorms (8 x 2, 4 attentions, norm_out); 4 attentions
    assert kinds == {"halo": 20, "sum": 2 * 21, "rows": 4}, kinds


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("routine,loss_type", JAX_LOSSES)
def test_loss_on_row_blocks_matches_jax(group, routine, loss_type, shape):
    """The whole images' loss, the same on every process of a space axis, ==
    JAX's loss on shard_images (t and the noise from JAX's key).  JAX's is
    the whole batch's: the data indices' means of equal parts, averaged
    (for the sqrt loss, their squares averaged, then the root)."""
    got, want, _ = group
    per_index = got[shape]["loss"][(routine, loss_type)]["loss"].double()
    whole = per_index.square().mean().sqrt() if loss_type == "sqrt" else per_index.mean()
    _close(whole, want["loss"][routine], 1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", JAX_LOSSES + PORT_LOSSES + [("resnet", "l1")],
                         ids=lambda c: f"{c[0]}-{c[1]}" if isinstance(c, tuple) else str(c))
def test_group_summed_gradients_equal_one_process(group, one, case, shape):
    """Each process seeds the loss it holds with 1; the group's parameter
    gradients, summed, equal one process's on the same images (not S times
    them), for each data index."""
    got, want = group[0][shape]["loss"][case], one["loss"][(shape[0], case)]
    _close(got["loss"], want["loss"], 1e-5, "loss")
    np.testing.assert_allclose(got["grads"].numpy(), want["grads"].numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("what", ["x_end", "small_noise"])
def test_row_draws_are_the_one_process_draws(group, one, what, shape):
    """GaussianNoise.sample_x_end and Final_small_noise's normals are the
    whole images' draw, each block its rows of it: bitwise."""
    assert torch.equal(group[0][shape]["draw"][what], one["draw"][what])
