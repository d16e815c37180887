"""The port's architecture configs (``repro_torch.configs``) against the reference's (CPU).

Every field of every ``get(name)`` and ``get_smoke(name)`` equals the
reference's, and so do the derived plans (``layer_plan``, ``scan_unit``,
``prefix_layers``, ``n_scan_groups``, ``param_count``,
``active_param_count``), ``SHAPES``, ``cell_applicable`` and
``all_cells``.  The package exports the reference's names, and
``repro_torch.models`` every name of ``repro.models``.
"""
import dataclasses

import pytest
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

import repro.configs as jconfigs
import repro.models as jmodels
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels

OVERRIDES = [{}, {"n_layers": 3}, {"dtype": "bfloat16", "attn_chunk": 32}]


def _fields(cfg) -> dict:
    """The config as nested plain dicts (the sub-configs are the two
    packages' own classes)."""
    return dataclasses.asdict(cfg)


def test_configs_export_the_reference_names():
    assert tconfigs.__all__ == jconfigs.__all__
    for name in tconfigs.__all__:
        assert hasattr(tconfigs, name), name


def test_models_export_every_reference_name():
    missing = set(jmodels.__all__) - set(tmodels.__all__)
    assert not missing, sorted(missing)
    for name in tmodels.__all__:
        assert hasattr(tmodels, name), name
    for sub in ("attention", "common", "lm", "mamba2", "mla", "moe"):
        assert getattr(tmodels, sub).__name__ == f"repro_torch.models.{sub}"


def test_registry_tables_match():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert list(tconfigs.all_cells()) == list(jconfigs.all_cells())


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_full_config_matches(arch):
    got, want = tconfigs.get(arch), jconfigs.get(arch)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert _fields(got) == _fields(want)
    assert got.layer_plan() == want.layer_plan()
    assert (got.scan_unit, got.prefix_layers, got.n_scan_groups) == \
        (want.scan_unit, want.prefix_layers, want.n_scan_groups)
    assert (got.head_dim_, got.vocab_padded) == (want.head_dim_, want.vocab_padded)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.moe_dense_ff() == want.moe_dense_ff()
    for shape in jconfigs.SHAPES:
        assert tconfigs.cell_applicable(got, shape) == jconfigs.cell_applicable(want, shape)


@pytest.mark.parametrize("overrides", OVERRIDES, ids=["defaults", "n_layers", "dtype"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_smoke_config_matches(arch, overrides):
    got, want = tconfigs.get_smoke(arch, **overrides), jconfigs.get_smoke(arch, **overrides)
    assert _fields(got) == _fields(want)
    assert got.layer_plan() == want.layer_plan()
    assert (got.scan_unit, got.prefix_layers) == (want.scan_unit, want.prefix_layers)
    assert got.param_count() == want.param_count()


def test_get_accepts_dashes_and_refuses_unknown_names():
    assert tconfigs.get("smollm-360m") == tconfigs.get("smollm_360m")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("gpt2")
