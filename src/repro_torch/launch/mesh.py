"""Device meshes (counterpart of ``repro.launch.mesh``).

Functions, not module constants: importing this module starts no process
group and touches no device.  A mesh is a ``torch.distributed`` ``DeviceMesh``
with named dims; the default process group must be running
(``launch.dist.init``), and the mesh's size must be its world size.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import init_device_mesh


# a string whose hash every rank must agree on (any string would do)
_HASH_PROBE = "repro_torch.launch.mesh"


def _check_hashing() -> None:
    """Raise unless every rank hashes strings alike.  Some of DTensor's
    sharding choices follow the hash seed: 4 CPU ranks training the smoke
    MoE and SSM models agree when started with one ``PYTHONHASHSEED`` and
    hang in each other's collectives when each has its own."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1 or dist.get_backend() == "fake":
        return
    seeds = [None] * dist.get_world_size()
    dist.all_gather_object(seeds, hash(_HASH_PROBE))
    if len(set(seeds)) > 1:
        raise RuntimeError("the ranks hash strings differently: start every rank with the "
                           "same PYTHONHASHSEED (DTensor's sharding choices depend on it)")


def make_mesh(shape, axes, *, device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the default
    group's ranks, on the card unless ``device`` says otherwise (the CPU
    tests pass ``"cpu"``).  Every rank must have been started with the same
    ``PYTHONHASHSEED`` (``_check_hashing``)."""
    device_type = "cuda" if device is None else torch.device(device).type
    mesh = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    _check_hashing()
    return mesh


def start_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world`` ranks
    (``torch.testing._internal.distributed.fake_pg``): collectives return at
    once and move nothing.  For dry runs, whose tensors are fake too."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is "
                           f"running; a fake group of {world} cannot start beside it")
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False, device=None, fake: bool = False):
    """16 x 16 = 256 ranks a pod; multi-pod adds a leading pure-DP pod axis.
    ``fake`` starts a fake group of that many ranks first (``start_fake_group``),
    for the dry run on one host."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake:
        start_fake_group(math.prod(shape))
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device=None):
    """Every rank of the default group as a 1-D ``("data",)`` mesh."""
    import torch.distributed as dist

    return make_mesh((dist.get_world_size(),), ("data",), device=device)
