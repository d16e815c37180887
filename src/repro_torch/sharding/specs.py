"""Logical axes -> mesh-axis specs for parameters, batches and caches.

PyTorch counterpart of ``repro.sharding.specs``.  A mesh is given by its axis
names and sizes: a dict such as ``{"data": 16, "model": 16}`` or a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``.  A
spec is a tuple with one entry a dim: a mesh-axis name, a tuple of names
(the batch dim over ``("pod", "data")``), or None (replicated), entry for
entry the reference's ``PartitionSpec``.

Each parameter carries its logical axes (``p.axes``, set where the model
builds it, ``models.common.empty_param``), and the rules map them to mesh
axes.  Resolution is size-aware: a dim that its mesh axis does not divide
falls back to replication (smollm's 15 heads, yi's 4 KV heads), and a mesh
axis is used at most once a spec.  A model built on the ``meta`` device
resolves without memory, so the 236B and 671B configs do too.

Strategies:
  * tp   — tensor parallelism over ``model`` (heads, ffn, vocab, experts,
           inner);
  * fsdp — adds ZeRO-3-style sharding of the ``embed`` dim over ``data``.

The port's parameters are one tensor a layer where the reference stacks a
scanned unit's layers along a leading ``layers`` dim, which its rules never
shard: a layer's spec here is the reference's without that first entry.

On a ``DeviceMesh`` a spec becomes one DTensor placement a mesh dim
(``placements``), a model's parameters become DTensors at their specs'
placements (``distribute_model``), and ``param_shardings`` / ``to_shardings``
give the ``NamedSharding`` (mesh and placements) that a checkpoint restores
a leaf onto.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

TP_RULES = {
    "vocab": "model", "q_heads": "model", "kv_heads": "model", "ffn": "model",
    "experts": "model", "inner": "model",
    "expert_ffn": None, "embed": None, "head": None, "layers": None,
    "q_lora": None, "kv_lora": None, "frame": None, "embed_out": None,
    None: None,
}

# base ranks of each cache leaf kind (``models`` init_*_cache)
_CACHE_RANK = {"k": 4, "v": 4, "pos": 2, "ckv": 3, "krope": 3, "conv_x": 3, "conv_bc": 3,
               "ssm": 4}


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a dict or a ``DeviceMesh``."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve specs")
    return dict(zip(names, mesh.mesh.shape))


def rules_for(strategy: str) -> dict:
    rules = dict(TP_RULES)
    if strategy == "fsdp":
        rules["embed"] = "data"
    elif strategy != "tp":
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    return rules


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _dp_entry(sizes: dict):
    """The batch dim's spec entry: ``("pod", "data")`` or ``"data"``."""
    return ("pod", "data") if "pod" in sizes else "data"


def resolve_spec(axes: tuple, shape, mesh, rules) -> tuple:
    """The spec of one tensor of logical ``axes`` and ``shape``."""
    sizes = mesh_shape(mesh)
    entries, used = [], set()
    for name, dim in zip(axes, shape):
        ax = rules.get(name)
        if ax is not None and ax not in sizes:
            ax = None                            # a mesh without this axis
        if ax is not None and ax not in used and dim % sizes[ax] == 0:
            entries.append(ax)
            used.add(ax)
        else:
            entries.append(None)
    return tuple(entries)


def param_specs(model, mesh, strategy: str = "tp") -> dict:
    """``{parameter name: spec}`` of every parameter of ``model``."""
    rules = rules_for(strategy)
    return {name: resolve_spec(p.axes, p.shape, mesh, rules)
            for name, p in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives: a ``DeviceMesh`` and one placement a mesh dim
    (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: object
    placements: tuple


def placements(spec: tuple, mesh) -> tuple:
    """A spec as one DTensor placement a dim of ``mesh``: a dim's named entry
    is ``Shard(dim)`` on that mesh dim, a tuple entry such as ``("pod",
    "data")`` ``Shard(dim)`` on each of its mesh dims (the first named the
    outer), every other mesh dim ``Replicate()``.  A mesh dim of size 1 is
    ``Replicate()`` whatever the spec: the one rank holds the same bytes
    either way, and DTensor views and contractions take fewer detours
    through a replicated dim."""
    names, sizes = mesh.mesh_dim_names, mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for ax in entry if isinstance(entry, tuple) else (entry,):
            if ax is None:
                continue
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not a dim of the mesh {names}")
            if sizes[ax] > 1:
                out[names.index(ax)] = Shard(dim)
    return tuple(out)


def to_shardings(spec_tree, mesh):
    """``spec_tree`` (dicts and lists of specs) with every spec a
    ``NamedSharding`` on ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: to_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [to_shardings(v, mesh) for v in spec_tree]
    return NamedSharding(mesh, placements(spec_tree, mesh))


def param_shardings(model, mesh, strategy: str = "tp") -> dict:
    """``{parameter name: NamedSharding}`` of every parameter of ``model``."""
    return to_shardings(param_specs(model, mesh, strategy), mesh)


def _local_shard(full: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's block of ``full`` at ``places``, cut where ``full`` lies (the
    host, for a model larger than a card).  Every ``Shard`` divides its dim,
    as ``resolve_spec`` makes it."""
    coord = mesh.get_coordinate()
    for mdim, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(mdim)
            if full.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does not split over {n}")
            full = full.chunk(n, dim=pl.dim)[coord[mdim]]
    return full


def from_full(full: torch.Tensor, mesh, places) -> DTensor:
    """A DTensor on ``mesh`` at ``places`` of the global tensor ``full``, which
    every rank holds alike: each rank moves only its own block to the mesh's
    device, with no collective (``distribute_tensor(..., src_data_rank=None)``,
    which would move the whole tensor to the device first)."""
    local = _local_shard(full, mesh, places).to(mesh.device_type).contiguous()
    return DTensor.from_local(local, mesh, places, run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


# attributes the port hangs on a parameter: its logical axes (``param_specs``)
# and the scanned mark (``train.optimizer.decays``)
CARRIED = ("axes", "scanned")


def distribute_model(model: nn.Module, mesh, strategy: str = "tp", *, seed: int | None = None):
    """Replace every parameter of ``model`` by a DTensor ``nn.Parameter`` at its
    spec's placements on ``mesh``, carrying ``CARRIED`` over; returns the model.

    With ``seed`` None the values are the model's own.  With a seed the model
    may be built on ``meta``: each parameter is drawn on the host, one at a
    time in ``init_``'s order (``model.init_plan()``) from a CPU generator
    seeded with ``seed``, and only this rank's block reaches the device, so
    no device ever holds a sharded parameter whole."""
    shardings = param_shardings(model, mesh, strategy)
    named = dict(model.named_parameters())
    if seed is None:
        order = [(name, None) for name in named]
    else:
        ids = {id(p): name for name, p in named.items()}
        order = [(ids[id(p)], fill) for p, fill in model.init_plan()]
        if sorted(n for n, _ in order) != sorted(named):
            raise ValueError("init_plan() does not draw every parameter once")
        gen = torch.Generator()
        gen.manual_seed(seed)
    with torch.no_grad():
        for name, fill in order:
            p = named[name]
            if fill is None:
                full = p.detach()
            else:
                full = torch.empty(p.shape, dtype=p.dtype)
                fill(full, gen)
            new = nn.Parameter(from_full(full, mesh, shardings[name].placements),
                               requires_grad=p.requires_grad)
            for attr in CARRIED:
                if hasattr(p, attr):
                    setattr(new, attr, getattr(p, attr))
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, new)
    return model


def batch_spec(mesh, batch: dict) -> dict:
    """The leading (batch) dim of every leaf over ``dp_axes(mesh)``; leaves are
    tensors or anything with a ``shape``."""
    dp = _dp_entry(mesh_shape(mesh))
    return {k: (dp,) + (None,) * (len(v.shape) - 1) for k, v in batch.items()}


def _cache_leaf(name: str, shape, sizes: dict, policy: str) -> tuple:
    dp = _dp_entry(sizes)
    model = sizes["model"]
    if name not in _CACHE_RANK:
        return (None,) * len(shape)
    if name in ("k", "v"):                       # (B, W, Hkv, hd)
        head = "model" if shape[2] % model == 0 else None
        spec = (None, "data", head, None) if policy == "sequence" else (dp, None, head, None)
    elif name == "pos":                          # (B, W)
        spec = (None, "data") if policy == "sequence" else (dp, None)
    elif name in ("ckv", "krope"):               # (B, S, r)
        spec = (None, "data", None) if policy == "sequence" else (dp, None, None)
    elif name in ("conv_x", "conv_bc"):          # (B, K-1, C)
        spec = ((None, None, "model" if shape[2] % model == 0 else None)
                if policy == "sequence" else (dp, None, None))
    else:                                        # ssm: (B, H, N, P)
        hspec = "model" if shape[1] % model == 0 else None
        spec = (None, hspec, None, None) if policy == "sequence" else (dp, hspec, None, None)
    fixed = []                                   # divisibility guard on every entry
    for entry, dim in zip(spec, shape):
        size = 1
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                size *= sizes[ax]
        fixed.append(entry if dim % size == 0 else None)
    return tuple(fixed)


def cache_specs(cache, mesh, *, policy: str = "batch") -> list:
    """Specs of a decode cache (``models.init_cache``: one dict a layer).

    ``policy="batch"`` shards the batch dim over ``dp_axes`` and head-like
    dims over ``model`` where they divide; ``"sequence"`` (a batch too small
    to shard, long-context decode) shards the cache's sequence dim over
    ``data`` instead.  The mesh must have a ``model`` axis."""
    sizes = mesh_shape(mesh)
    return [{k: _cache_leaf(k, tuple(t.shape), sizes, policy) for k, t in layer.items()}
            for layer in cache]
