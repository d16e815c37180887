"""Start the process group of a distributed run (``core.distributed``'s layouts).

``init`` reads ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or
takes its rank, world size and rendezvous from the caller (tests pass a
``file://`` store), picks the backend (``pick_backend``), sets the rank's
device and starts the default group with a timeout, so a hung collective
raises instead of waiting for ever.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch svm_bsgd --svm-layout slots --stream DIR
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def pick_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the ``local_world`` ranks of a host has a card of its
    own; gloo when ranks share a card (NCCL refuses two ranks on one device)
    or run on the CPU.  gloo takes the CUDA tensors of the collectives
    ``core.distributed`` calls (``all_gather``, ``all_reduce``) and copies
    them through pinned host memory inside the collective; the port stages
    nothing itself."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: the CPU, or the card ``local_rank`` modulo the
    cards there are (ranks beyond the last card share it); None is the card."""
    from ..core import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init(device=None, *, rank: int | None = None, world_size: int | None = None,
         init_method: str = "env://", timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Start the default process group and return this rank's device.

    Without ``rank``/``world_size`` they come from ``torchrun``'s environment,
    as does the rendezvous (``env://``).  The backend is ``pick_backend``'s
    for the ranks on this host (``LOCAL_WORLD_SIZE``, else the world size)."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = _rank_device(device, local_rank)
    dist.init_process_group(pick_backend(dev, local_world), init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shutdown() -> None:
    """End the default process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()
