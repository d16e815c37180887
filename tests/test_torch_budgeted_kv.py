"""The port's budgeted KV cache (``repro_torch.core.budgeted_kv``) against the reference (CPU).

The same drifting stream of keys and values (numpy, seeded) goes through
the reference's jitted ``kv_append`` and the port's, under both policies,
from below the budget, through it, and far past it.  After every append the
port's k and v are within 1e-5 of the reference's and ``count`` is equal;
at every maintained append each (batch, head)'s chosen pair (i_min, j) is
the reference's exactly (recomputed from the reference's own ops, the
``rbf_row`` plain version and the same table).  ``kv_attend`` within 1e-5,
and merging no worse than eviction (the reference's own bound,
``tests/core/test_budgeted_kv.py:67``).  The converters go both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_lm import one_thread  # noqa: F401 (autouse fixture)

from repro.core import budgeted_kv as jkv
from repro.core.lookup import default_table as jdefault_table
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import budgeted_kv as tkv
from repro_torch.core.lookup import default_table as tdefault_table

B, H, D, W = 2, 3, 16, 8
GAMMA = 1.0 / (2.0 * D ** 0.5)
TOL = 1e-5


def _stream(t_steps: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    for t in range(t_steps):
        center = np.sin(np.arange(D) * 0.1 + t * 0.02)
        k = (center + 0.3 * rng.standard_normal((B, 1, H, D))).astype(np.float32)
        yield k, rng.standard_normal((B, 1, H, D)).astype(np.float32)


def _jax_choice(state, table):
    """The reference's (i_min, j) per (batch, head), from its own ops."""
    def one(k_bh, v_bh):
        idx = jnp.arange(k_bh.shape[0])
        active = idx < state.count
        norm = jnp.linalg.norm(v_bh, axis=-1)
        imp = jnp.where(active, norm, jnp.inf)
        i_min = jnp.argmin(imp)
        a_min = imp[i_min]
        kappa = jops.rbf_row(k_bh, k_bh[i_min], GAMMA, impl="ref")
        a_j = jnp.where(active, norm, 0.0)
        m = jnp.clip(a_min / jnp.where(a_min + a_j == 0, 1.0, a_min + a_j), 0, 1)
        wd = (a_min + a_j) ** 2 * table.lookup_wd_norm(m, jnp.clip(kappa, 0.0, 1.0))
        return i_min, jnp.argmin(jnp.where(active & (idx != i_min), wd, jnp.inf))
    f = jax.vmap(jax.vmap(one, in_axes=(1, 1)), in_axes=(0, 0))
    return tuple(np.asarray(a) for a in f(state.k, state.v))


@pytest.fixture(scope="module")
def tables():
    return jdefault_table(), tdefault_table()


@pytest.mark.parametrize("policy", ["merge", "evict"])
def test_kv_append_matches_the_reference(policy, tables):
    jtab, ttab = tables
    jst = jkv.init_kv_state(B, W, H, D, jnp.float32)
    tst = tkv.init_kv_state(B, W, H, D, torch.float32)
    maintained = 0
    for t, (k, v) in enumerate(_stream(3 * W + 5)):
        if tst.count >= W and policy == "merge":
            want = _jax_choice(jst, jtab)
            kt, vt = tst.k.permute(0, 2, 1, 3), tst.v.permute(0, 2, 1, 3)
            i_min, j, *_ = tkv.merge_choice(kt, vt, tst.count, GAMMA, ttab)
            np.testing.assert_array_equal(i_min.numpy(), want[0], err_msg=f"i_min at {t}")
            np.testing.assert_array_equal(j.numpy(), want[1], err_msg=f"j at {t}")
            maintained += 1
        jst = jkv.kv_append(jst, jnp.asarray(k), jnp.asarray(v), GAMMA, jtab, policy=policy)
        tst = tkv.kv_append(tst, torch.from_numpy(k), torch.from_numpy(v), GAMMA, ttab,
                            policy=policy)
        assert tst.count == int(jst.count) == min(t + 1, W)
        np.testing.assert_allclose(tst.k.numpy(), np.asarray(jst.k), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tst.v.numpy(), np.asarray(jst.v), rtol=TOL, atol=TOL)
    assert maintained == (2 * W + 5 if policy == "merge" else 0)
    q = np.random.default_rng(9).standard_normal((B, 1, H, D)).astype(np.float32)
    np.testing.assert_allclose(tkv.kv_attend(tst, torch.from_numpy(q), 0.25).numpy(),
                               np.asarray(jkv.kv_attend(jst, jnp.asarray(q), 0.25)),
                               rtol=TOL, atol=TOL)


def test_below_the_budget_is_exact_and_attend_matches():
    st = tkv.init_kv_state(B, W, H, D, torch.float32)
    ks, vs = [], []
    for k, v in _stream(5, seed=1):
        st = tkv.kv_append(st, torch.from_numpy(k), torch.from_numpy(v), GAMMA,
                           tdefault_table())
        ks.append(torch.from_numpy(k))
        vs.append(torch.from_numpy(v))
    assert st.count == 5 and bool((st.k[:, 5:] == 0).all())
    torch.testing.assert_close(st.k[:, :5], torch.cat(ks, 1))
    q = torch.from_numpy(np.random.default_rng(2).standard_normal((B, 1, H, D)).astype(np.float32))
    scores = torch.softmax(torch.einsum("bqhd,bwhd->bhqw", q, torch.cat(ks, 1)) * 0.25, -1)
    full = torch.einsum("bhqw,bwhd->bqhd", scores, torch.cat(vs, 1))
    torch.testing.assert_close(tkv.kv_attend(st, q, 0.25), full, rtol=1e-5, atol=1e-5)


def test_merge_no_worse_than_evict(tables):
    """The paper's merge-beats-removal claim, transferred to KV caches."""
    _, ttab = tables
    d, w, t_steps = 32, 32, 96
    gamma, scale = 1.0 / (2.0 * d ** 0.5), 1.0 / d ** 0.5
    states = {p: tkv.init_kv_state(B, w, H, d, torch.float32) for p in ("merge", "evict")}
    rng = np.random.default_rng(1)
    fk, fv = [], []
    for t in range(t_steps):
        center = np.sin(np.arange(d) * 0.1 + t * 0.02)
        k = torch.from_numpy((center + 0.3 * rng.standard_normal((B, 1, H, d))).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((B, 1, H, d)).astype(np.float32))
        for p in states:
            states[p] = tkv.kv_append(states[p], k, v, gamma, ttab, policy=p)
        fk.append(k)
        fv.append(v)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, d)).astype(np.float32))
    s = torch.softmax(torch.einsum("bqhd,bwhd->bhqw", q, torch.cat(fk, 1)) * scale, -1)
    out_f = torch.einsum("bhqw,bwhd->bqhd", s, torch.cat(fv, 1))
    errs = {p: float(torch.linalg.norm(tkv.kv_attend(st, q, scale) - out_f))
            for p, st in states.items()}
    assert errs["merge"] <= errs["evict"] * 1.05, errs


def test_kv_state_converters_round_trip(tables):
    jtab, _ = tables
    jst = jkv.init_kv_state(B, W, H, D, jnp.float32)
    for k, v in _stream(W + 2):
        jst = jkv.kv_append(jst, jnp.asarray(k), jnp.asarray(v), GAMMA, jtab)
    tst = convert.kv_state_from_numpy({f: np.asarray(x) for f, x in jst._asdict().items()},
                                      device="cpu")
    assert tst.count == W and isinstance(tst.count, int)
    back = convert.kv_state_to_numpy(tst)
    for f in ("k", "v", "count"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jst, f)))
    assert back["count"].dtype == np.int32


def test_unknown_policy_is_refused():
    st = tkv.init_kv_state(1, 2, 1, 4, torch.float32)
    with pytest.raises(ValueError, match="policy"):
        tkv.kv_append(st, torch.zeros(1, 1, 1, 4), torch.zeros(1, 1, 1, 4), 0.1,
                      tdefault_table(), policy="drop")
