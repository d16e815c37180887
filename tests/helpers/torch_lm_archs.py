"""The per-architecture parity tests, shared by ``tests/test_torch_lm_archs.py``
and ``tests/test_torch_lm_archs_moe.py`` (each defines the module-scoped
``arch_run`` fixture over its architectures, so ``--dist loadfile`` spreads
the reference's compiles over two workers).

At ``get_smoke`` (float32) the port holds the reference's weights and runs
the reference's inputs: the prefill's last logits and cache, 8 decode steps
from the placed prefill cache (logits and final cache), ``encode_step`` for
the encoder, and ``loss_fn``'s value (with MTP for deepseek-v3).  Tolerance
``TOL`` on the logits' scale (``scale_err``); the loss within ``TOL``
relative.  Then the port's own decode against its own full forward at the
reference's 2e-2 (``tests/models/test_archs_smoke.py:90``), and the
converters both ways.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import decode_step, forward, init_cache, init_lm

from .torch_lm import (B, S, STEPS, f32, no_drop, reference_model, run_port, run_reference,
                       scale_err)

TOL = 1e-4
DECODE_VS_FULL = 2e-2


def make_arch_run(arch):
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    params, model = reference_model(jcfg, tcfg)
    ref = run_reference(jcfg, params)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, params=params, model=model, ref=ref,
                port=run_port(tcfg, model, ref))


def test_prefill_matches(arch_run):
    if arch_run["tcfg"].is_encoder:
        got, want = arch_run["port"]["logits"], arch_run["ref"]["logits"]
        assert tuple(got.shape) == want.shape == (B, S, arch_run["tcfg"].vocab_padded)
        assert scale_err(got, want) < TOL
        return
    got, want = arch_run["port"], arch_run["ref"]
    assert tuple(got["last"].shape) == want["last"].shape
    assert scale_err(got["last"], want["last"]) < TOL
    ref_cache = convert.lm_cache_from_numpy(arch_run["tcfg"], want["prefill_cache"],
                                            device="cpu")
    for i, (g, w) in enumerate(zip(got["prefill_cache"], ref_cache)):
        assert g.keys() == w.keys(), i
        for key in g:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, (i, key)
            assert scale_err(g[key], w[key]) < TOL, (i, key)


def test_decode_matches(arch_run):
    if arch_run["tcfg"].is_encoder:     # no decode step: the serving arm refuses it
        from repro_torch.launch.serve import serve
        with pytest.raises(ValueError, match="encoder.*encode_step"):
            serve(arch_run["tcfg"], device="cpu")
        return
    got, want = arch_run["port"], arch_run["ref"]
    assert tuple(got["steps"].shape) == want["steps"].shape == \
        (B, STEPS, arch_run["tcfg"].vocab_padded)
    assert scale_err(got["steps"], want["steps"]) < TOL
    ref_cache = convert.lm_cache_from_numpy(arch_run["tcfg"], want["cache"], device="cpu")
    for g, w in zip(got["cache"], ref_cache):
        for key in g:
            assert scale_err(g[key], w[key]) < TOL, key


def test_loss_matches(arch_run):
    got, want = float(arch_run["port"]["loss"]), float(arch_run["ref"]["loss"])
    assert np.isfinite(got) and abs(got - want) <= TOL * abs(want), (got, want)


def test_decode_matches_own_full_forward(arch_run):
    """16 decode steps from an empty cache against one full forward."""
    cfg = no_drop(arch_run["tcfg"])
    if cfg.is_encoder:
        with torch.no_grad():
            model = init_lm(cfg, seed=1, device="cpu")
            frames = torch.randn(B, S, cfg.frame_dim, generator=torch.Generator().manual_seed(0))
            logits, cache = forward(cfg, model, {"frames": frames})
        assert cache is None and bool(torch.isfinite(logits).all())
        return
    model = init_lm(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 16)))
    with torch.no_grad():
        full, _ = forward(cfg, model, {"tokens": toks})
        cache = init_cache(cfg, B, 20, device="cpu")
        steps = []
        for t in range(16):
            lg, cache = decode_step(cfg, model, cache, toks[:, t:t + 1], t)
            steps.append(lg)
    assert float((full - torch.stack(steps, 1)).abs().max()) < DECODE_VS_FULL


def test_converters_round_trip(arch_run):
    tcfg, params, model = arch_run["tcfg"], arch_run["params"], arch_run["model"]
    back = convert.lm_params_to_numpy(model)
    want = convert._flat(params)
    got = convert._flat(back)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], f32(want[name]), err_msg=name)
    for name, p in model.named_parameters():
        assert p.dtype == getattr(torch, tcfg.dtype) or p.dtype == torch.float32, name
    if tcfg.is_encoder:
        return
    cache = convert.lm_cache_from_numpy(tcfg, arch_run["ref"]["cache"], device="cpu")
    back = convert.lm_cache_to_numpy(tcfg, cache)
    want = convert._flat(arch_run["ref"]["cache"])
    assert convert._flat(back).keys() == want.keys()
    for name, leaf in convert._flat(back).items():
        np.testing.assert_array_equal(leaf, f32(want[name]), err_msg=name)


def test_params_tree_mismatch_is_refused(arch_run):
    tcfg, params = arch_run["tcfg"], arch_run["params"]
    other = dataclasses.replace(tcfg, d_model=tcfg.d_model * 2)
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(other, params, device="cpu")
    flat = dict(params)
    flat.pop("final_norm")
    with pytest.raises(ValueError, match="missing.*final_norm"):
        convert.lm_params_from_numpy(tcfg, flat, device="cpu")
