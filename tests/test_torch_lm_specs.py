"""The port's sharding specs (``repro_torch.sharding.specs``) against the
reference's (``repro.sharding.specs``) for every architecture at its
published size.

The port resolves each parameter's logical axes (``p.axes``) on a model
built on the ``meta`` device, so the 236B and 671B configs need no memory;
the reference resolves its axes tree against ``jax.eval_shape`` of its init.
A mesh is its axis names and sizes (a dict here, an ``AbstractMesh`` for the
reference).  The reference stacks a scanned unit's layers along a leading
``layers`` dim that its rules never shard, so each port layer's spec must
equal the reference's without that entry; every other spec must be equal
entry for entry.
"""
import jax
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES
from repro.configs import get as jget
from repro.launch.inputs import abstract_params
from repro.models import lm as jlm
from repro.sharding import specs as jspecs
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.models import LM, init_cache
from repro_torch.sharding import specs

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}, "1": {"data": 1}}


def _abstract(mesh: dict):
    return AbstractMesh(tuple(mesh.values()), tuple(mesh))


def _flat_specs(tree) -> dict:
    """A reference spec tree as ``{dotted path: tuple}``."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in leaves:
        name = ".".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
        out[name] = tuple(spec)
    return out


def _unstack(cfg, flat: dict) -> dict:
    """The reference's body specs (leading ``layers`` entry) per port layer."""
    body = {k: v for k, v in flat.items() if k.startswith("body.")}
    for name, spec in body.items():
        assert spec[0] is None, name                     # the layers dim is never sharded
    rest = {k: v for k, v in flat.items() if not k.startswith("body.")}
    groups = cfg.n_scan_groups
    stacked = {k: np.empty(groups, dtype=object) for k in body}
    for k, spec in body.items():
        for g in range(groups):
            stacked[k][g] = spec[1:]
    return convert._layer_names(cfg, {**rest, **stacked})


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch(request):
    jcfg, cfg = jget(request.param), get(request.param)
    shapes, axes = abstract_params(jcfg)
    model = LM(cfg, torch.device("meta"))
    return dict(jcfg=jcfg, cfg=cfg, shapes=shapes, axes=axes, model=model)


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
def test_param_specs_match_reference(arch, mesh, strategy):
    want = _flat_specs(jspecs.param_specs(arch["axes"], arch["shapes"], _abstract(MESHES[mesh]),
                                          strategy))
    want = _unstack(arch["cfg"], want)
    got = specs.param_specs(arch["model"], MESHES[mesh], strategy)
    assert got.keys() == want.keys()
    for name, spec in got.items():
        assert spec == tuple(want[name]), (name, spec, want[name])
    if mesh == "16x16":         # something shards: the rules are not all None
        assert any(any(e is not None for e in s) for s in got.values())


def test_unknown_strategy_is_refused(arch):
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        specs.param_specs(arch["model"], MESHES["2x4"], "zero")


def test_batch_spec_matches_reference():
    batch = {"tokens": torch.empty(8, 16, dtype=torch.int64, device="meta"),
             "labels": torch.empty(8, 16, dtype=torch.int64, device="meta"),
             "frames": torch.empty(8, 16, 4, device="meta")}
    for mesh in MESHES.values():
        shapes = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32) for k, v in batch.items()}
        want = jspecs.batch_spec(_abstract(mesh), shapes)
        got = specs.batch_spec(mesh, batch)
        assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("policy", ["batch", "sequence"])
def test_cache_specs_match_reference(arch, policy):
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    if cfg.is_encoder:
        return                                   # no decode cache
    b, s = (16, 64) if policy == "batch" else (1, 64)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, b, s))
    cache = init_cache(cfg, b, s, device="meta")
    for name, mesh in MESHES.items():
        if "model" not in mesh:
            with pytest.raises(KeyError):
                specs.cache_specs(cache, mesh, policy=policy)
            continue
        want = _unstack(cfg, _flat_specs(jspecs.cache_specs(jcache, _abstract(mesh),
                                                            policy=policy)))
        got = specs.cache_specs(cache, mesh, policy=policy)
        assert len(got) == cfg.n_layers
        for i, layer in enumerate(got):
            for key, spec in layer.items():
                assert spec == tuple(want[f"layers.{i}.mixer.{key}"]), (name, i, key)


def test_device_mesh_is_read_by_its_names():
    class Mesh:                                    # a DeviceMesh's two attributes
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(2, 4)
    assert specs.mesh_shape(Mesh()) == {"data": 2, "model": 4}
    assert specs.dp_axes(Mesh()) == ("data",)
    assert specs.dp_axes(MESHES["2x16x16"]) == ("pod", "data")
