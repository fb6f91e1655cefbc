"""What every driver shares: finding a cell's files by name, the seeded
inputs (weights and clean images), the port's model and diffusion built
from a configuration, the device record, the guard against the JAX package,
and the judgement of the compared numbers."""

from __future__ import annotations

import json
import math
import os
import sys
from pathlib import Path

import torch
from torch import nn

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules a run may not hold: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "colddiff")
# lecun_normal's truncation: std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The workload ``name`` of ``BENCHMARK.json``, with its configuration,
    traffic mix and limits read from their files, and the metrics it
    reports (``end_to_end`` and ``per_layer``)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]

    def reports(m):
        return name in m.get("workloads", [name])

    return {"name": name, "config": load_json(ROOT / config_file),
            "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)],
            "chips": w["chips"]}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (``colddiff_torch`` is not ``colddiff``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program_env() -> None:
    """Settings the run needs before the program loads: full fp32 matmuls
    (the degrade refuses TF32) and no Flax through a library."""
    os.environ.setdefault("USE_FLAX", "0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def scratch_dir(name: str) -> Path:
    """A folder under the run's ``TMPDIR`` for what the program writes,
    removed when the process exits."""
    import atexit
    import shutil
    import tempfile

    path = tempfile.mkdtemp(prefix=f"bench_{name}_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return Path(path)


def flax_fan_in(m: nn.Module) -> int:
    """fan_in of the Flax kernel a torch weight maps to."""
    w = m.weight
    if isinstance(m, nn.Linear):
        return w.shape[1]
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()


@torch.no_grad()
def make_weights(model: nn.Module, seed: int, device) -> dict:
    """A state dict for ``model``'s names and shapes, drawn by Flax's default
    rule from ``seed`` on ``device``: ``lecun_normal`` weights (a normal of
    variance 1 / fan_in truncated at two stds, by the inverse CDF), zero
    biases, norm scales one and offsets zero.  ``model`` may live on the
    meta device: only its names and shapes are read.  One draw serves all
    the weights."""
    weights, scales = [], []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            weights.append(m.weight)
            scales.append(math.sqrt(1.0 / flax_fan_in(m)) / _TRUNC_STD)
    sizes = [w.numel() for w in weights]
    gen = torch.Generator(device=device).manual_seed(seed)
    lim = math.erf(math.sqrt(2.0))
    flat = torch.empty(sum(sizes), device=device).uniform_(-lim, lim, generator=gen)
    flat.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    flat.mul_(torch.tensor(scales, device=device).repeat_interleave(
        torch.tensor(sizes, device=device), output_size=flat.numel()))
    drawn = {id(w): part.view(w.shape) for w, part in zip(weights, flat.split(sizes))}
    out = {}
    for name, p in model.named_parameters():
        if id(p) in drawn:
            out[name] = drawn[id(p)]
        elif name.endswith(".bias") or name.endswith(".b"):
            out[name] = torch.zeros(p.shape, device=device)
        else:  # LayerNorm and GroupNorm scales
            out[name] = torch.ones(p.shape, device=device)
    return out


def port_model(config: dict, weights: dict, device):
    """The port's UNet of the configuration, holding ``weights``."""
    from . import families

    # built on the meta device: the benchmark's weights replace the port's own draw
    model = families.find(config).port(config).to_empty(device=device)
    model.load_state_dict(weights)
    return model


def port_diffusion(config: dict, device):
    """The port's ``ColdDiffusion`` of the configuration, its operator on ``device``."""
    from colddiff_torch.diffusion import ColdDiffusion
    from colddiff_torch.operators import get_operator

    deg = config["degradation"]
    op = get_operator(deg["kind"], device=device, timesteps=deg["time_steps"],
                      image_size=config["image_size"], blur_routine=deg["blur_routine"],
                      kernel_size=deg["blur_size"], kernel_std=deg["blur_std"])
    return ColdDiffusion(op=op, image_size=config["image_size"], channels=config["channels"],
                         loss_type=config["loss_type"], train_routine=config["train_routine"],
                         sampling_routine=config["sampling_routine"])


@torch.no_grad()
def make_pool(seed: int, n: int, size: int, channels: int, device) -> torch.Tensor:
    """[n, size, size, channels] smooth structured images in [-1, 1]: three
    Gaussian bumps of random colour and a colour gradient, scaled to a peak
    of 1 (the recipe of ``SyntheticDataset``), all drawn at once from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    centre, sigma = u(n, 3, 2), 0.05 + 0.2 * u(n, 3)  # drawn in this order
    colour, ramp = u(n, 3, channels), u(n, channels)
    grid = torch.arange(size, device=device, dtype=torch.float32) / size
    dy = (grid[None, None, :] - centre[..., 1:2]) ** 2  # [n, 3, size] rows
    dx = (grid[None, None, :] - centre[..., 0:1]) ** 2  # columns
    img = torch.zeros(n, size, size, channels, device=device)
    for k in range(3):
        bump = torch.exp(-(dy[:, k, :, None] + dx[:, k, None, :])
                         / (2 * sigma[:, k, None, None] ** 2))
        img += bump[..., None] * colour[:, k, None, None, :]
    img += 0.3 * (grid[:, None] + grid[None, :])[None, ..., None] * ramp[:, None, None, :]
    img /= img.amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-6)
    return img * 2.0 - 1.0


def device_record(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}).  A number
    that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks

