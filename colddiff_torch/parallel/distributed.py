"""Multi-process start-up: one process per card, joined into one process group.

Twin of ``colddiff/parallel/distributed.py``.  JAX runs one process per host
over all of its chips; torch runs one process per card.  Every process calls
:func:`init_multihost` first; the Trainer, the ``EvalHarness`` and
``colddiff_torch.parallel.make_mesh`` then span the group.

Per-process responsibilities, as in the JAX package:
  - data: each process reads its own stripe of the dataset
    (``DataLoader(..., process_index=, process_count=)``) and holds its
    contiguous rows of every global batch;
  - state: every process builds the model from the same seed, and the
    Trainer broadcasts rank 0's weights before the first step;
  - checkpoints: ``Trainer.save()`` and ``load()`` are entered by every
    process (do not guard them by rank); rank 0 alone writes the file.

Backend rule: NCCL when every process of the host has a card of its own;
gloo on the CPU, or when processes share a card (NCCL refuses two ranks on
one device).  The choice is printed on stderr.  A ``cuda`` run never moves
to the CPU: without a card, :func:`init_multihost` raises.

Which processes share a host is read from the launcher's ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` (``torchrun`` sets both).  Without them, every process
is taken to run on this host: a run across hosts through the explicit
arguments sets them, or passes ``backend=``.
"""

from __future__ import annotations

import os
import socket
import sys
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_multihost", "process_index", "process_count", "local_device"]


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def local_device(device: torch.device | str = "cuda", rank: Optional[int] = None) -> torch.device:
    """This process's device: its card for a ``cuda`` run, ``cuda:<LOCAL_RANK
    mod the cards>``, so processes beyond the card count share cards; the CPU
    for a ``cpu`` run.  Raises on a ``cuda`` run without a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA run, but no CUDA device is available; pass "
                           "device='cpu' (CLI: --device cpu) to run on the CPU")
    if device.index is not None:
        return device
    rank = process_index() if rank is None else rank
    return torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device: torch.device | str = "cuda", **kwargs) -> torch.device:
    """Join this process into the process group; returns its device.

    With ``coordinator_address`` (``host:port`` of process 0),
    ``num_processes`` and ``process_id``, the group meets at
    ``tcp://<coordinator_address>``.  With none of them, the launcher's
    environment gives the rank (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them), JAX's autodetection's
    counterpart; without a launcher, the process forms a group of one on a
    free local port.  ``kwargs`` go to ``torch.distributed.init_process_group``
    (``backend=`` overrides the backend rule of the module docstring)."""
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("pass coordinator_address, num_processes and process_id "
                             "together, or none of them")
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        rank, world = 0, 1
        init_method = f"tcp://localhost:{_free_port()}"
    dev = local_device(device, rank)
    backend = kwargs.pop("backend", None)
    if backend is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = ("nccl" if dev.type == "cuda" and local_world <= torch.cuda.device_count()
                   else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    print(f"colddiff_torch: process {rank} of {world}, backend {backend}, device {dev}",
          file=sys.stderr, flush=True)
    return dev
