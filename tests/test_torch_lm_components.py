"""The port's model components against the reference's (CPU, float32 unless named).

Each component gets the reference's weights (``init_*`` of ``repro.models``,
carried over as numpy) and the same numpy inputs.  Tolerances: 1e-5 on
float32 outputs (products summed in another order), exact integer routing
(``sel``, ``pos``, ``keep``), and one bf16 ulp for the bf16 norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_lm import f32, one_thread  # noqa: F401 (autouse fixture)

from repro.configs import get_smoke as jget_smoke
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mamba2 as jm2
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mamba2 as tm2
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(tree):
    """The reference's (array, Axes) init tree as numpy leaves."""
    return jax.tree.map(np.asarray, jcommon.split_params_axes(tree)[0])


def _load(module, params):
    with torch.no_grad():
        for name, leaf in convert._flat(params).items():
            module.get_parameter(name).copy_(_t(leaf))
    return module


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def _both(cfg_kw):
    """The same config in both packages."""
    return JArchConfig(**cfg_kw), ArchConfig(**cfg_kw)


# ------------------------------------------------------------------ common
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3
    g = rng.standard_normal(24).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype), 1e-5)
    got = tcommon.rms_norm(_t(x).to(getattr(torch, dtype)), _t(g).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the fp32 normalise is narrowed before gamma, as in the reference
    _close(got, want, TOL if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("theta", [10000.0, 5_000_000.0])
@pytest.mark.parametrize("batched", [False, True], ids=["positions_1d", "positions_2d"])
def test_apply_rope(theta, batched):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.arange(4090, 4098, dtype=np.int32)
    if batched:
        pos = np.stack([pos, pos - 4000])
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tcommon.apply_rope(_t(x), _t(pos), theta)
    _close(got, want)


def test_softmax_xent_and_swiglu():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    w = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for weight in (None, w):
        want = jcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                    None if weight is None else jnp.asarray(weight))
        got = tcommon.softmax_xent(_t(logits), _t(labels), None if weight is None else _t(weight))
        _close(got, want)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) / 3
                     for s in ((4, 8), (8, 12), (8, 12), (12, 8)))
    _close(tcommon.swiglu(*map(_t, (x, wg, wu, wd))),
           jcommon.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))


def test_trunc_normal_draws_the_reference_distribution():
    gen = torch.Generator().manual_seed(0)
    t = tcommon.trunc_normal_(torch.empty(64, 512), gen)
    z = t.numpy() * np.sqrt(64)                     # default scale 1/sqrt(fan_in)
    assert np.abs(z).max() <= 2.0
    assert abs(z.mean()) < 0.01 and abs(z.std() - 0.8796) < 0.01   # std of N(0,1) on [-2, 2]
    bf = tcommon.trunc_normal_(torch.empty(3, 4, dtype=torch.bfloat16), gen, scale=0.5)
    assert bf.dtype == torch.bfloat16 and float(bf.float().abs().max()) <= 1.0


# --------------------------------------------------------------- attention
ATTN_BASE = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                 vocab_size=64, head_dim=8, dtype="float32", attn_chunk=4096)
ATTN_CASES = {
    "dense": ({}, 16),
    "chunked": ({"attn_chunk": 16}, 32),                   # s = 2 * attn_chunk
    "window": ({"sliding_window": 8}, 24),
    "window_chunked": ({"sliding_window": 8, "attn_chunk": 8}, 24),
    "qk_norm": ({"qk_norm": True}, 16),
    "encoder": ({"causal": False, "is_encoder": True}, 16),
    "encoder_chunked": ({"causal": False, "is_encoder": True, "attn_chunk": 8}, 16),
}


def _attn_pair(kw):
    jcfg, tcfg = _both({**ATTN_BASE, **kw})
    p = _params(jattn.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32))
    return jcfg, tcfg, p, _load(tattn.Attention(tcfg, torch.float32), p)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_full_and_prefill(case):
    kw, s = ATTN_CASES[case]
    jcfg, tcfg, p, mod = _attn_pair(kw)
    x = np.random.default_rng(3).standard_normal((2, s, 32)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want, want_cache = jattn.attention(jcfg, p, jnp.asarray(x), jnp.asarray(pos), mode="prefill")
    with torch.no_grad():
        got, got_cache = mod(_t(x), _t(pos), mode="prefill")
        full, none = mod(_t(x), _t(pos), mode="full")
    _close(got, want)
    assert none is None and torch.equal(full, got)
    for key in ("k", "v", "pos"):
        _close(got_cache[key], want_cache[key])
    assert got_cache["pos"].dtype == torch.int32


@pytest.mark.parametrize("case", ["dense", "window", "qk_norm"])
def test_attention_decode_across_the_ring(case):
    """24 decode steps; with the window of 8 the ring of 8 wraps twice."""
    kw, _ = ATTN_CASES[case]
    jcfg, tcfg, p, mod = _attn_pair(kw)
    x = np.random.default_rng(4).standard_normal((2, 24, 32)).astype(np.float32)
    jc = jattn.init_attn_cache(jcfg, 2, 24, jnp.float32)
    tc = tattn.init_attn_cache(tcfg, 2, 24, torch.float32)
    assert tc["k"].shape == jc["k"].shape and bool((tc["pos"] == -1).all())
    step = jax.jit(lambda p, x, c, t: jattn.attention(jcfg, p, x, None, mode="decode", cache=c,
                                                      cache_pos=t))
    for t in range(24):
        want, jc = step(p, jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t))
        with torch.no_grad():
            got, tc = mod(_t(x[:, t:t + 1]), None, mode="decode", cache=tc,
                          cache_pos=torch.tensor(t, dtype=torch.int32))
        _close(got, want)
    for key in ("k", "v", "pos"):
        _close(tc[key], jc[key])


# --------------------------------------------------------------------- MLA
def _mla_cfgs(**kw):
    jcfg = dataclasses.replace(jget_smoke("deepseek_v2_236b"), attn_chunk=16, **kw)
    tcfg = dataclasses.replace(get_smoke("deepseek_v2_236b"), attn_chunk=16, **kw)
    return jcfg, tcfg


def _mla_pair(q_lora: bool):
    jcfg, tcfg = _mla_cfgs()
    if not q_lora:
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    p = _params(jmla.init_mla(jax.random.PRNGKey(1), jcfg, jnp.float32))
    return jcfg, tcfg, p, _load(tmla.MLA(tcfg, torch.float32), p)


@pytest.mark.parametrize("s", [16, 32], ids=["full", "chunked"])
@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "no_q_lora"])
def test_mla_full_and_prefill(s, q_lora):
    jcfg, tcfg, p, mod = _mla_pair(q_lora)
    x = np.random.default_rng(5).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want, want_cache = jmla.mla_attention(jcfg, p, jnp.asarray(x), jnp.asarray(pos),
                                          mode="prefill")
    with torch.no_grad():
        got, got_cache = mod(_t(x), _t(pos), mode="prefill")
    _close(got, want)
    for key in ("ckv", "krope"):
        _close(got_cache[key], want_cache[key])


def test_mla_absorbed_decode():
    """Prefill 8 positions into a 16-position cache, then 8 decode steps."""
    jcfg, tcfg, p, mod = _mla_pair(True)
    x = np.random.default_rng(6).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    _, jpf = jmla.mla_attention(jcfg, p, jnp.asarray(x[:, :8]), jnp.asarray(pos), mode="prefill")
    jc = jmla.init_mla_cache(jcfg, 2, 16, jnp.float32)
    jc = {k: jax.lax.dynamic_update_slice(jc[k], jpf[k], (0, 0, 0)) for k in jc}
    tc = {k: _t(np.asarray(v)).clone() for k, v in jc.items()}
    step = jax.jit(lambda p, x, c, t: jmla.mla_attention(jcfg, p, x, None, mode="decode",
                                                         cache=c, cache_pos=t))
    for t in range(8, 16):
        want, jc = step(p, jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t))
        with torch.no_grad():
            got, tc = mod(_t(x[:, t:t + 1]), None, mode="decode", cache=tc,
                          cache_pos=torch.tensor(t, dtype=torch.int32))
        _close(got, want)
    for key in ("ckv", "krope"):
        _close(tc[key], jc[key])


# ------------------------------------------------------------------ mamba2
def test_causal_conv_and_its_tail():
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    state = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for st in (None, state):
        want_y, want_tail = jm2._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                                             None if st is None else jnp.asarray(st))
        got_y, got_tail = tm2._causal_conv(_t(u), _t(w), _t(b), None if st is None else _t(st))
        _close(got_y, want_y)
        _close(got_tail, want_tail)
    # chaining: two halves through the carried tail equal the whole
    y_all, _ = tm2._causal_conv(_t(u), _t(w), _t(b))
    y1, tail = tm2._causal_conv(_t(u[:, :3]), _t(w), _t(b))
    y2, _ = tm2._causal_conv(_t(u[:, 3:]), _t(w), _t(b), tail)
    _close(torch.cat([y1, y2], dim=1), y_all)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked(chunk):
    rng = np.random.default_rng(8)
    bsz, s, h, p, n = 2, 32, 3, 4, 5
    args = (rng.standard_normal((bsz, s, h, p)).astype(np.float32),
            rng.standard_normal((bsz, s, h, n)).astype(np.float32),
            rng.standard_normal((bsz, s, h, n)).astype(np.float32),
            rng.uniform(0.01, 0.5, (bsz, s, h)).astype(np.float32),
            -rng.uniform(0.5, 4.0, h).astype(np.float32))
    want_y, want_state = jm2._ssd_chunked(*map(jnp.asarray, args), chunk)
    got_y, got_state = tm2._ssd_chunked(*map(_t, args), chunk)
    assert bool(torch.isfinite(got_y).all())          # exp overflow above the diagonal is masked
    _close(got_y, want_y, 2e-5)
    _close(got_state, want_state, 2e-5)


def test_mamba2_prefill_then_decode():
    jcfg, tcfg = jget_smoke("mamba2_130m"), get_smoke("mamba2_130m")
    p = _params(jm2.init_mamba(jax.random.PRNGKey(2), jcfg, jnp.float32))
    mod = _load(tm2.Mamba2(tcfg, torch.float32), p)
    assert mod.A_log.dtype == mod.dt_bias.dtype == torch.float32
    x = np.random.default_rng(9).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    want, jc = jm2.mamba2(jcfg, p, jnp.asarray(x[:, :16]), mode="prefill")
    with torch.no_grad():
        got, tc = mod(_t(x[:, :16]), mode="prefill")
    _close(got, want)
    step = jax.jit(lambda p, x, c: jm2.mamba2(jcfg, p, x, mode="decode", cache=c))
    for t in range(16, 20):
        want, jc = step(p, jnp.asarray(x[:, t:t + 1]), jc)
        with torch.no_grad():
            got, tc = mod(_t(x[:, t:t + 1]), mode="decode", cache=tc)
        _close(got, want)
    for key in ("conv_x", "conv_bc", "ssm"):
        _close(tc[key], jc[key])


def test_mamba2_prefill_refuses_a_ragged_chunk():
    cfg = get_smoke("mamba2_130m")                       # chunk 16
    mod = tm2.Mamba2(cfg, torch.float32)
    with torch.no_grad():
        mod.init_(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="multiple of the SSD chunk"):
            mod(torch.zeros(1, 24, cfg.d_model), mode="full")


# --------------------------------------------------------------------- MoE
def _jax_route(cfg, p, xf):
    """The reference's routing, line for line from ``repro.models.moe``."""
    m = cfg.moe
    c = jmoe.capacity(m, xf.shape[0])
    logits = (xf.astype(jnp.float32) @ p["router"]).astype(jnp.float32)
    scores = jax.nn.sigmoid(logits) if m.router == "sigmoid" else jax.nn.softmax(logits, -1)
    gate, sel = jax.lax.top_k(scores, m.top_k)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9) * m.routed_scale
    onehot = jax.nn.one_hot(sel.reshape(-1), m.num_experts, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos_all, sel.reshape(-1, 1), axis=1)[:, 0]
    return gate, sel, pos, pos < c


@pytest.mark.parametrize("capacity", ["drops", "default"])
@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "deepseek_v3_671b"],
                         ids=["softmax", "sigmoid"])
def test_moe_routing_and_output(arch, capacity):
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    if capacity == "drops":       # 32 tokens x 2 choices into 4 experts of 6 slots
        over = dict(capacity_factor=0.375, min_capacity=2)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **over))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **over))
    assert tmoe.capacity(tcfg.moe, 32) == jmoe.capacity(jcfg.moe, 32)
    p = _params(jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32))
    mod = _load(tmoe.MoE(tcfg, torch.float32), p)
    assert mod.router.dtype == torch.float32
    x = np.random.default_rng(10).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    xf = x.reshape(32, -1)
    gate, sel, pos, keep = _jax_route(jcfg, p, jnp.asarray(xf))
    tg, tsel, tpos, tkeep, _ = tmoe.route(tcfg.moe, mod.router, _t(xf),
                                          tmoe.capacity(tcfg.moe, 32))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    assert (capacity == "drops") == (not bool(tkeep.all()))
    _close(tg, gate)
    with torch.no_grad():
        got = mod(_t(x))
    _close(got, jmoe.moe_ffn(jcfg, p, jnp.asarray(x)))


def test_moe_dropped_copy_contributes_nothing():
    """With one slot an expert, every token's output is its kept copies alone."""
    cfg = get_smoke("deepseek_v2_236b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.01,
                                                           min_capacity=1, n_shared=0))
    mod = tmoe.MoE(cfg, torch.float32)
    with torch.no_grad():
        mod.init_(torch.Generator().manual_seed(1))
        x = torch.randn(1, 12, cfg.d_model, generator=torch.Generator().manual_seed(2))
        y = mod(x)
        _, _, _, keep, _ = tmoe.route(cfg.moe, mod.router, x[0], 1)
    kept_tokens = keep.reshape(12, -1).any(dim=1)
    assert int(keep.sum()) <= cfg.moe.num_experts
    assert bool((y[0][~kept_tokens] == 0).all()) and bool((y[0][kept_tokens] != 0).any())
