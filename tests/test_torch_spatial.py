"""The port's row (spatial) sharding (``parallel.make_mesh_2d``,
``shard_images``, ``image_rows``) against one process and against JAX's
``make_mesh_2d`` run.

One group of four CPU processes over gloo (one torch thread each) runs a
(2, 2) and a (1, 4) mesh: on (2, 2) each process holds 8 of 16 rows; on
(1, 4) 4, and at the UNet's second level 2, thinner than the front's
3-row halo, so the front there takes the thin-shard rule (the whole rows,
gathered).  Each rank runs the same calls, rank 0 saves what they gave,
and this process computes the references (JAX's meanwhile).

Tolerances, stated per check:
  - sampling of tests/test_parallel.py:137-171's configuration (blur
    Constant, kernel 3, std 1.0, T=4, 16 px, UnetConvNext(dim=8, (1, 2)),
    x from default_rng(0), JAX's weights): the gathered samples against
    JAX's single-device run and JAX's make_mesh_2d(2, 4) run at 2e-5, as
    that test holds JAX's mesh run;
  - the front alone against ``convnext_front_reference``: output 3e-5,
    gradients 2e-4, as tests/test_pallas.py:151-189;
  - ``apply_rowcol`` and blur's discrete collapse: 1e-6 of the whole image
    (fp32 products in another order);
  - ``recon_noise_std`` sampling against one process: 2e-5;
  - a (1, 1) mesh against no group, and shard/gather: bitwise.
"""

import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from colddiff_torch import parallel
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext, UnetResNet
from colddiff_torch.operators import get_operator
from colddiff_torch.ops import linop
from colddiff_torch.ops.convnext_front import convnext_front
from colddiff_torch.parallel import spatial
from colddiff_torch.sampling import prepare_start, sample

N = 4
MESHES = ((2, 2), (1, 4))
S, B = 16, 2
BLUR = dict(image_size=S, timesteps=4, blur_routine="Constant", kernel_size=3, kernel_std=1.0)
# the front alone: (C, image side, mesh); 8 px on (1, 4) is 2 rows a process
FRONTS = [(8, 16, m) for m in MESHES] + [(64, 16, m) for m in MESHES] + [(8, 8, (1, 4))]
RECON_NOISE = 0.01


def _x():
    return np.random.default_rng(0).standard_normal((B, S, S, 3)).astype(np.float32)


def _front_inputs(c: int, side: int):
    """NHWC x and JAX-layout front arguments, as numpy fp32 (test_pallas.py's draws)."""
    rng = np.random.default_rng(c + side)
    x = rng.standard_normal((B, side, side, c)).astype(np.float32)
    wk = (rng.standard_normal((7, 7, c)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    cond = rng.standard_normal((B, c)).astype(np.float32)
    gamma = (rng.random(c) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, wk, bias, cond, gamma, beta


def _diffusion(recon_noise_std: float = 0.0, discrete: bool = False):
    op = get_operator("blur", **BLUR, discrete=discrete, device="cpu")
    return ColdDiffusion(op=op, image_size=S, sampling_routine="x0_step_down",
                         recon_noise_std=recon_noise_std)


def _model(state):
    model = UnetConvNext(dim=8, dim_mults=(1, 2), channels=3)
    model.load_state_dict(state)
    return model.eval()


def _sample(model, x, generator=None, recon_noise_std=0.0):
    d = _diffusion(recon_noise_std)
    with torch.inference_mode():
        return sample(d, model, prepare_start(d, x), generator=generator).img


def _degrades(x, n, row, col):
    """Blur's discrete degrade at levels ``n`` (T among them: the collapse),
    a two-step ``degrade_range`` and ``apply_rowcol`` with ``row`` and ``col``."""
    op = _diffusion(discrete=True).op
    return [op.degrade(x, n), op.degrade_range(x, 1, 3), linop.apply_rowcol(x, row, col)]


def _degrade_inputs():
    rng = np.random.default_rng(5)
    return (torch.from_numpy(rng.standard_normal((B, S, S, 3)).astype(np.float32)),
            torch.tensor([BLUR["timesteps"], 2]),
            torch.from_numpy(rng.standard_normal((B, S, S)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((B, S, S)).astype(np.float32)))


def _front(mesh, c, side):
    """The front on this process's block, with its backward: the gathered
    output and x gradient (NHWC), the weight gradient summed over the
    processes, and the slabs the exchange sent."""
    x, wk, bias, cond, gamma, beta = (torch.from_numpy(a) for a in _front_inputs(c, side))
    w = wk.permute(2, 0, 1)[:, None].contiguous().requires_grad_()
    data = mesh["data"]
    xb = parallel.shard_images(x, mesh).contiguous().requires_grad_()
    spatial.collectives.clear()
    with parallel.image_rows(mesh):
        y = convnext_front(xb.permute(0, 3, 1, 2), w, bias, parallel.shard_batch(cond, data),
                           gamma, beta)
        (y ** 2).sum().backward()
    gw = w.grad.clone()
    torch.distributed.all_reduce(gw)
    return dict(y=parallel.gather_images(y.detach().permute(0, 2, 3, 1), mesh),
                gx=parallel.gather_images(xb.grad, mesh), gw=gw[:, 0].permute(1, 2, 0),
                exchanged=sorted(spatial.collectives))


def _rank(rank, port, root, inputs):
    """One process of the group: every check's row-sharded side; ``inputs``
    gives the path of JAX's weights when they are ready."""
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(N))
    torch.set_num_threads(1)
    parallel.init_multihost(f"localhost:{port}", N, rank, device="cpu")
    meshes = {shape: parallel.make_mesh_2d(*shape, "cpu") for shape in MESHES}
    got = {"front": {}, "sample": {}, "degrade": {}, "noise": {}}
    for c, side, shape in FRONTS:
        got["front"][(c, side, shape)] = _front(meshes[shape], c, side)

    x, n, row, col = _degrade_inputs()
    for shape, mesh in meshes.items():
        data = mesh["data"]
        with parallel.image_rows(mesh):
            got["degrade"][shape] = [
                parallel.gather_images(y, mesh) for y in _degrades(
                    parallel.shard_images(x, mesh), parallel.shard_batch(n, data),
                    parallel.shard_batch(row, data), parallel.shard_batch(col, data))]

    # the drawn noise of the whole images: this block's rows of the global draw
    mesh = meshes[(2, 2)]
    gen = torch.Generator().manual_seed(3)
    with parallel.image_rows(mesh):
        got["draw"] = parallel.draw_rows(
            lambda n, h: torch.rand(n, h, 5, 3, generator=gen), 1, h=S // 2)
    got["draw_place"] = (mesh["data"].get_local_rank(), mesh["space"].get_local_rank())

    # shard/gather, and the wrong sizes, on (1, 4)
    mesh = meshes[(1, 4)]
    got["round_trip"] = parallel.gather_images(parallel.shard_images(x, mesh), mesh)
    errors = {}
    with parallel.image_rows(mesh):
        # H = 12 rows: 3 a process, not divisible by the 2 of one downsample
        twelve = parallel.shard_images(torch.zeros(1, 12, 12, 3), mesh)
        try:
            UnetConvNext(dim=8, dim_mults=(1, 2))(twelve, n[:1])
        except ValueError as e:
            errors["H"] = str(e)
        try:
            UnetResNet(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                       resolution=12)(twelve, n[:1])
        except ValueError as e:
            errors["H_resnet"] = str(e)
    for fn in (lambda: parallel.shard_images(torch.zeros(1, 14, 14, 3), mesh),
               lambda: parallel.make_mesh_2d(3, 2, "cpu")):
        try:
            fn()
        except ValueError as e:
            errors.setdefault("wrong", []).append(str(e))
    got["errors"] = errors

    # JAX's configuration on both meshes, from JAX's weights; and with
    # recon_noise_std, drawn from one seed on every process
    model = _model(torch.load(inputs.get(timeout=300)))
    for shape, mesh in meshes.items():
        with parallel.image_rows(mesh):
            got["sample"][shape] = parallel.gather_images(
                _sample(model, parallel.shard_images(torch.from_numpy(_x()), mesh)), mesh)
            got["noise"][shape] = parallel.gather_images(_sample(
                model, parallel.shard_images(torch.from_numpy(_x()), mesh),
                torch.Generator().manual_seed(9), RECON_NOISE), mesh)
    torch.distributed.destroy_process_group()

    if rank == 0:
        # a group of one on a (1, 1) mesh, against no group
        parallel.init_multihost(device="cpu")
        mesh = parallel.make_mesh_2d(1, 1, "cpu")
        with parallel.image_rows(mesh):
            got["one"] = parallel.gather_images(
                _sample(model, parallel.shard_images(torch.from_numpy(_x()), mesh)), mesh)
        torch.distributed.destroy_process_group()
        got["none"] = _sample(model, torch.from_numpy(_x()))
        torch.save(got, Path(root) / "got.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_runs(root):
    """JAX's weights (saved as the port's state dict) and the samples of
    tests/test_parallel.py:137-171: one device and make_mesh_2d(2, 4)."""
    import jax
    import jax.numpy as jnp

    from colddiff.diffusion import ColdDiffusion as JColdDiffusion
    from colddiff.models import UnetConvNext as JUnetConvNext
    from colddiff.operators import get_operator as jget_operator
    from colddiff.parallel import make_mesh_2d, replicate, shard_images
    from colddiff.sampling import prepare_start as jprepare_start
    from colddiff.sampling import sample as jsample
    from colddiff_torch.models.convert import convnext_state_dict_from_flax

    d = JColdDiffusion(op=jget_operator("blur", **BLUR), image_size=S, channels=3,
                       sampling_routine="x0_step_down")
    model = JUnetConvNext(dim=8, dim_mults=(1, 2), channels=3)
    x = jnp.asarray(_x())
    params = model.init(jax.random.key(0), x, jnp.zeros((B,), jnp.int32))
    path = root / "jax_weights.pt"
    torch.save(convnext_state_dict_from_flax(jax.device_get(params)), path)

    def run(x, params):
        return jsample(d, lambda xt, t: model.apply(params, xt, t), jprepare_start(d, x)).img

    single = np.asarray(jax.jit(run)(x, params))
    mesh = make_mesh_2d(2, 4)
    sharded = np.asarray(jax.jit(run)(shard_images(x, mesh), replicate(params, mesh)))
    return path, dict(single=single, mesh=sharded)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four-process group's results, and JAX's."""
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("spatial")
    port = _free_port()
    ctx = mp.get_context("spawn")
    queues = [ctx.Queue() for _ in range(N)]
    procs = [ctx.Process(target=_rank, args=(r, port, str(root), q))
             for r, q in enumerate(queues)]
    for p in procs:
        p.start()
    try:
        path, jax_out = _jax_runs(root)
        for q in queues:
            q.put(str(path))
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * N
    return torch.load(root / "got.pt"), jax_out, root


# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_row_sharded_sampling_matches_jax(group, shape):
    """The gathered samples == JAX's single-device run and JAX's (2, 4)
    mesh run (halos through every conv, token collectives through the
    attention, the sharded-H degrade)."""
    got, want, _ = group
    for ref in ("single", "mesh"):
        np.testing.assert_allclose(got["sample"][shape].numpy(), want[ref], rtol=2e-5,
                                   atol=2e-5, err_msg=ref)


@pytest.mark.parametrize("c,side,shape", FRONTS,
                         ids=[f"C{c}-{s}px-{m[0]}x{m[1]}" for c, s, m in FRONTS])
def test_front_on_row_blocks_matches_reference(group, c, side, shape):
    """Output and gradients (x; the weight's summed over the processes)
    against convnext_front_reference; the exchange sends 3 rows each way,
    never the row axis, unless the block is thinner than 3 rows (then it
    gathers the rows, and its backward sums the whole gradient)."""
    import jax
    import jax.numpy as jnp

    from colddiff.ops.pallas.convnext_front import convnext_front_reference

    got = group[0]["front"][(c, side, shape)]
    x, wk, bias, cond, gamma, beta = (jnp.asarray(a) for a in _front_inputs(c, side))
    want = convnext_front_reference(x, wk, bias, cond, gamma, beta)
    gx, gw = jax.grad(lambda x, wk: jnp.sum(
        convnext_front_reference(x, wk, bias, cond, gamma, beta) ** 2), argnums=(0, 1))(x, wk)
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got["gx"].numpy(), np.asarray(gx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["gw"].numpy(), np.asarray(gw), rtol=2e-4, atol=2e-4)
    h = side // shape[1]
    b = B // shape[0]
    if h >= 3:  # the forward's and the backward's slabs: 3 rows each way
        assert got["exchanged"] == [("halo", (b, c, 6, side))]
    else:
        assert got["exchanged"] == [("rows", (b, c, h, side)), ("sum", (b, c, side, side))]


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_degrades_on_row_blocks_match_the_whole_image(group, shape):
    got = group[0]["degrade"][shape]
    x, n, row, col = _degrade_inputs()
    for g, want, what in zip(got, _degrades(x, n, row, col),
                             ("degrade (discrete collapse at T)", "degrade_range",
                              "apply_rowcol")):
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_recon_noise_sampling_matches_one_process(group, shape):
    """recon_noise_std's noise is drawn for the whole images on every
    process, which keeps its block: the run equals one process's."""
    got, _, root = group
    want = _sample(_model(torch.load(root / "jax_weights.pt")), torch.from_numpy(_x()),
                   torch.Generator().manual_seed(9), RECON_NOISE)
    torch.testing.assert_close(got["noise"][shape], want, rtol=2e-5, atol=2e-5)


def test_draw_rows_keeps_this_blocks_rows_of_the_whole_draw(group):
    got = group[0]
    d, s = got["draw_place"]
    full = torch.rand(2, S, 5, 3, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got["draw"], full[d:d + 1, s * S // 2:(s + 1) * S // 2])


def test_group_of_one_is_bitwise_no_group_and_blocks_round_trip(group):
    got, _, _ = group
    assert torch.equal(got["one"], got["none"])
    assert torch.equal(got["round_trip"], _degrade_inputs()[0])


def test_refusals_and_wrong_arguments(group):
    """Inside a row-sharded context both UNet families refuse an H whose
    blocks do not halve at every downsample; wrong sizes raise ValueError."""
    errors = group[0]["errors"]
    assert set(errors) == {"H", "H_resnet", "wrong"}
    assert "H divisible by space * 2 = 8, got H = 12" in errors["H"]
    assert errors["H_resnet"].startswith("UnetResNet with 1 downsamples under row sharding")
    assert "H divisible by space * 2 = 8, got H = 12" in errors["H_resnet"]
    assert "do not divide over the 4 processes of the space axis" in errors["wrong"][0]
    assert errors["wrong"][1] == "mesh 3x2 needs 6 processes, have 4"
