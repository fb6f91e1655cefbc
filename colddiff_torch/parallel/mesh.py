"""Device mesh, batch rows and parameter placement over the process group.

Twin of ``colddiff/parallel/mesh.py``.  The JAX package runs SPMD over a
1-D ``Mesh(('data',))`` in one program: the global batch is sharded over
the chips, and every random draw of a step is made for the global batch
inside it.  Torch runs one process per card, each on its rows of the
global batch, so the same step needs three things here:

  - :func:`shard_batch` takes this process's contiguous rows of a batch that
    every process holds whole, and :func:`gather_rows` joins the processes'
    rows again;
  - :func:`batch_rows` makes every draw of a batch-shaped random tensor inside
    it (the Trainer's t, endpoints, operator state and noise, dropout masks,
    the samplers' noise) draw for the global batch from the generator every
    process holds alike, and keep this process's rows
    (:func:`draw_rows`), so an n-process step equals the 1-process step;
    :func:`local_rows` gives those rows' place in the global batch;
  - :func:`shard_state` places a model's parameters: replicated (a broadcast
    from rank 0) or sharded by ``fully_shard`` with :func:`fsdp_sharding`'s
    placements; :func:`put_like` and :func:`full_state_dict` load and gather
    a whole state dict either way.

Spatial sharding (``make_mesh_2d``, ``image_sharding``, ``shard_images``)
is not ported: ROADMAP.md section 1, item 12b.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["make_mesh", "make_mesh_2d", "shard_batch", "gather_rows", "replicate",
           "all_reduce_mean", "data_sharding", "replicated_sharding", "fsdp_sharding",
           "shard_state", "put_like", "shard_like", "full_state_dict", "is_sharded",
           "image_sharding", "shard_images", "batch_rows", "local_rows", "draw_rows"]

_ITEM_12B = ("spatial (row) sharding is not ported to colddiff_torch; see ROADMAP.md "
             "section 1, item 12b")
_BUCKET_BYTES = 64 << 20  # one collective moves at most this many bytes

# (rank, world) of the batch rows that draws keep, set by batch_rows
_ROWS: contextvars.ContextVar = contextvars.ContextVar("colddiff_torch_rows", default=None)


def make_mesh(device_type: str = "cuda", axis_name: str = "data"):
    """A 1-D ``DeviceMesh`` named ``(axis_name,)`` over the process group
    (:func:`colddiff_torch.parallel.init_multihost` first)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh spans the process group: call "
                           "colddiff_torch.parallel.init_multihost first")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(*args, **kwargs):
    raise NotImplementedError(f"make_mesh_2d: {_ITEM_12B}")


def image_sharding(*args, **kwargs):
    raise NotImplementedError(f"image_sharding: {_ITEM_12B}")


def shard_images(*args, **kwargs):
    raise NotImplementedError(f"shard_images: {_ITEM_12B}")


def data_sharding(mesh, batch_dim: int = 0) -> tuple:
    """The placement that splits dimension ``batch_dim`` over the mesh."""
    del mesh
    return (Shard(batch_dim),)


def replicated_sharding(mesh) -> tuple:
    del mesh
    return (Replicate(),)


def shard_batch(batch, mesh, batch_dim: int = 0):
    """This process's contiguous rows, along ``batch_dim``, of a batch (a
    tensor or an array) that every process holds whole: rank r of n keeps
    rows [r b, (r + 1) b) of b = rows / n, as the JAX mesh places them."""
    rank, world = mesh.get_local_rank(), mesh.size()
    n = batch.shape[batch_dim]
    if n % world:
        raise ValueError(f"a batch of {n} rows does not divide over {world} processes")
    per = n // world
    return batch[(slice(None),) * batch_dim + (slice(rank * per, (rank + 1) * per),)]


def _buckets(tensors):
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or size + nbytes > _BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def _bucketed(tensors, collective: Callable[[torch.Tensor], None]) -> None:
    """``collective`` on flat buckets of ``tensors``, in place (the buckets are
    contiguous, as gloo needs, whatever the tensors' memory formats)."""
    for bucket in _buckets(list(tensors)):
        flat = _flatten_dense_tensors(bucket)
        collective(flat)
        for t, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(v)


def all_reduce_mean(tensors, mesh) -> None:
    """In place: each tensor becomes its mean over the processes (a sum,
    then a division by their count), in flat buckets."""
    world, group = mesh.size(), mesh.get_group()

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _bucketed(tensors, mean)


def gather_rows(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The processes' equal blocks of ``x`` along ``dim`` joined in rank
    order, on every process.  A sum of zero-padded copies, which is exact
    and needs only ``all_reduce`` (gloo takes it for CUDA tensors too)."""
    world = mesh.size()
    if world == 1:
        return x
    x = x.movedim(dim, 0)
    n = x.shape[0]
    out = x.new_zeros((world * n, *x.shape[1:]))
    rank = mesh.get_local_rank()
    out[rank * n:(rank + 1) * n] = x
    dist.all_reduce(out, group=mesh.get_group())
    return out.movedim(0, dim)


def _tensors(tree):
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    return [t for v in tree for t in _tensors(v)]


def replicate(tree, mesh):
    """Broadcast a module's parameters and buffers (or a tensor, or a list or
    dict of them) from rank 0 in place, so every process holds rank 0's
    values; returns ``tree``."""
    if mesh.size() > 1:
        group = mesh.get_group()
        src = dist.get_global_rank(group, 0)
        _bucketed(_tensors(tree), lambda flat: dist.broadcast(flat, src, group=group))
    return tree


def fsdp_sharding(params, mesh, min_size: int = 2 ** 14) -> dict:
    """``{name: placement}`` for a module's parameters (or a dict of
    tensors), the JAX package's leaf rule (colddiff/parallel/mesh.py:
    207-242) on torch shapes: a tensor of fewer than ``min_size`` elements
    stays replicated; any other shards on its largest dimension that the
    mesh size divides, the later one on a tie, or stays replicated when
    none does.  ``mesh`` is a ``DeviceMesh`` or its size."""
    n = mesh if isinstance(mesh, int) else mesh.size()
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    out = {}
    for name, a in items:
        best = None
        if a.dim() and a.numel() >= min_size:
            for dim in range(a.dim()):
                if a.shape[dim] % n == 0 and (best is None or a.shape[dim] >= a.shape[best]):
                    best = dim
        out[name] = (Replicate(),) if best is None else (Shard(best),)
    return out


def is_sharded(model: nn.Module) -> bool:
    """Whether ``fully_shard`` holds ``model``'s parameters."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def shard_state(model: nn.Module, mesh, mode: str = "replicated", *,
                min_size: int = 2 ** 14, mp_policy=None):
    """Place ``model``'s parameters on the mesh per ``mode``; returns
    ``(model, {name: placement})``.

    ``replicated``: every process holds every parameter, rank 0's values
    (:func:`replicate`).  ``fsdp``: after the same broadcast,
    ``fully_shard`` splits each parameter that :func:`fsdp_sharding` shards,
    and gathers it at the forward; the parameters it replicates stay whole
    on every process, outside ``fully_shard``, so the caller reduces their
    gradients (``all_reduce_mean``).  ``mp_policy`` is ``fully_shard``'s
    ``MixedPrecisionPolicy``: it casts the sharded parameters at the gather,
    and the caller casts the replicated ones."""
    if mode not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_sharding mode: {mode!r}")
    replicate(model, mesh)
    if mode == "replicated":
        return model, {name: replicated_sharding(mesh) for name, _ in model.named_parameters()}
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    placements = fsdp_sharding(model, mesh, min_size)
    named = list(model.named_parameters())
    by_id = {id(p): placements[name][0] for name, p in named}
    whole = {p for name, p in named if isinstance(placements[name][0], Replicate)}
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: by_id[id(p)],
                ignored_params=whole or None, mp_policy=mp_policy or MixedPrecisionPolicy())
    return model, placements


def _whole(value):
    """``value`` with every sharded tensor in it gathered whole."""
    if isinstance(value, DTensor):
        (place,) = value.placements
        return gather_rows(value.to_local(), value.device_mesh, dim=place.dim).contiguous()
    if isinstance(value, Mapping):
        return {k: _whole(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_whole(v) for v in value]
    return value


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` placed as ``like``: this process's shard of it, as a DTensor,
    when ``like`` is sharded; ``full`` itself otherwise."""
    if not isinstance(like, DTensor):
        return full
    (place,) = like.placements
    mesh = like.device_mesh
    local = full.chunk(mesh.size(), dim=place.dim)[mesh.get_local_rank()]
    return DTensor.from_local(local.to(like.device, like.dtype).contiguous(), mesh,
                              like.placements, run_check=False)


def put_like(state: Mapping[str, torch.Tensor], model: nn.Module) -> nn.Module:
    """Load a whole state dict (every process holds it) into ``model``,
    sharded as ``model`` is: each process copies in its shards."""
    if not is_sharded(model):
        model.load_state_dict(state)
        return model
    own = model.state_dict()
    if set(own) != set(state):
        raise KeyError(f"state dict keys differ: missing {sorted(set(own) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, t in own.items():
            src = shard_like(state[name], t)
            (t.to_local() if isinstance(t, DTensor) else t).copy_(
                src.to_local() if isinstance(src, DTensor) else src)
    return model


def full_state_dict(tree):
    """A module's (or a state dict's, an optimizer's) whole state dict with
    its own names: the shards of a sharded model gathered, a collective that
    every process enters.  (Gathered with :func:`gather_rows`: ``torch``'s
    own ``get_model_state_dict`` stops the process over gloo with CUDA
    tensors.)"""
    if isinstance(tree, nn.Module):
        if not is_sharded(tree):
            return tree.state_dict()
        tree = tree.state_dict()
    return _whole(tree)


@contextlib.contextmanager
def batch_rows(rank: int, world: int):
    """Inside, a batch of n rows is rank ``rank``'s rows of a global batch of
    ``n * world``: :func:`draw_rows` draws for the global batch and keeps
    those rows, and :func:`local_rows` gives their place."""
    token = _ROWS.set((rank, world))
    try:
        yield
    finally:
        _ROWS.reset(token)


def local_rows(n: int) -> slice:
    """The place of this process's ``n`` rows in the global batch: rows [r n,
    (r + 1) n) of rank r inside :func:`batch_rows`, else [0, n)."""
    here = _ROWS.get()
    if here is None:
        return slice(0, n)
    return slice(here[0] * n, (here[0] + 1) * n)


def draw_rows(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``draw(n)``, a random tensor of ``n`` rows; inside :func:`batch_rows`,
    this process's rows of ``draw(n * world)``, the draw of the global batch
    that every process makes alike from its generator."""
    here = _ROWS.get()
    if here is None:
        return draw(n)
    rank, world = here
    return draw(n * world)[rank * n:(rank + 1) * n]
