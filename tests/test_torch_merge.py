"""One budget-maintenance event in the port against the JAX reference (CPU).

Identical over-budget states (made with numpy) go through
``repro.core.budget.maintenance_step`` and its port for each scoring method.
Decisions (fixed partner, merge partner, merge or removal) must be equal;
the merge coefficient and weight degradation agree within stated bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import budget as jbudget
from repro.core.lookup import default_table as jax_default_table
from repro_torch.core import budget as tbudget
from repro_torch.core import merge_math as tmm
from repro_torch.core.lookup import default_table as torch_default_table

METHODS = ["lookup-wd", "lookup-h", "gss", "gss-precise"]
GAMMA = 1.0


def _state(seed, slots=21, dim=5, same_sign=False):
    rng = np.random.default_rng(seed)
    sv_x = (0.5 * rng.standard_normal((slots, dim))).astype(np.float32)
    mag = (np.abs(rng.standard_normal(slots)) + 0.05).astype(np.float32)
    sign = np.ones(slots) if same_sign else np.where(rng.random(slots) < 0.5, 1.0, -1.0)
    return sv_x, (sign * mag).astype(np.float32), slots


def _both(method, sv_x, alpha, count):
    lookup = method.startswith("lookup")
    _, _, jcount, ji = jbudget.maintenance_step(
        jnp.asarray(sv_x), jnp.asarray(alpha), jnp.int32(count), GAMMA, method=method,
        table=jax_default_table() if lookup else None)
    tsv, talpha, tcount, ti = tbudget.maintenance_step(
        torch.tensor(sv_x), torch.tensor(alpha), torch.tensor(count, dtype=torch.int32), GAMMA,
        method=method, table=torch_default_table() if lookup else None)
    assert int(jcount) == int(tcount) == count - 1
    return ji, ti, tsv, talpha


def _h_tol(method):
    # the lookups are the same float32 arithmetic on bit-identical tables;
    # the searches end where flat objectives let float32 exp's last bit
    # steer them (see test_torch_kernels.test_gss_matches_reference)
    return 1e-6 if method.startswith("lookup") else tmm.EPS_STANDARD


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed", range(4))
def test_maintenance_step_decisions_match(method, seed):
    sv_x, alpha, count = _state(seed)
    ji, ti, _, _ = _both(method, sv_x, alpha, count)
    assert int(ti.i_min) == int(ji.i_min)
    assert int(ti.j_star) == int(ji.j_star)
    assert bool(ti.merged) == bool(ji.merged) is True
    assert abs(float(ti.h_star) - float(ji.h_star)) <= _h_tol(method)
    np.testing.assert_allclose(float(ti.wd_star), float(ji.wd_star), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_maintenance_step_state_matches(method):
    sv_x, alpha, count = _state(7)
    jsv, jalpha, _, _ = jbudget.maintenance_step(
        jnp.asarray(sv_x), jnp.asarray(alpha), jnp.int32(count), GAMMA, method=method,
        table=jax_default_table() if method.startswith("lookup") else None)
    _, _, tsv, talpha = _both(method, sv_x, alpha, count)
    # z = h x_a + (1-h) x_b and alpha_z move with h: exact-table methods to
    # round-off, the searches within their h bound times |x_a - x_b|
    tol = 1e-5 if method.startswith("lookup") else 2e-2
    np.testing.assert_allclose(tsv.numpy(), np.asarray(jsv), atol=tol, rtol=0)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=tol, rtol=1e-5)
    assert talpha[count - 1] == 0.0


@pytest.mark.parametrize("method", METHODS)
def test_removal_fallback_without_same_sign_partner(method):
    """The min-|alpha| SV is the only one of its sign: it is removed."""
    sv_x, alpha, count = _state(3, same_sign=True)
    alpha[5] = -0.01                       # lone negative, smallest |alpha|
    ji, ti, tsv, talpha = _both(method, sv_x, alpha, count)
    assert int(ti.i_min) == int(ji.i_min) == 5
    assert bool(ti.merged) is bool(ji.merged) is False
    assert float(ti.h_star) == float(ji.h_star) == 1.0
    np.testing.assert_allclose(float(ti.wd_star), float(ji.wd_star), rtol=1e-6)
    # the last SV moved into the hole, its old slot zeroed
    np.testing.assert_array_equal(tsv[5].numpy(), sv_x[count - 1])
    assert float(talpha[5]) == alpha[count - 1] and float(talpha[count - 1]) == 0.0


@pytest.mark.parametrize("method", METHODS)
def test_candidate_scores_match(method):
    sv_x, alpha, count = _state(11)
    i_min = int(np.argmin(np.abs(alpha)))
    valid = (alpha * alpha[i_min] > 0) & (np.arange(count) != i_min)
    kappa = np.exp(-GAMMA * ((sv_x - sv_x[i_min]) ** 2).sum(-1)).astype(np.float32)
    lookup = method.startswith("lookup")
    jwd, jh = jbudget.candidate_scores(jnp.asarray(alpha), jnp.asarray(kappa), i_min,
                                       jnp.asarray(valid), method,
                                       jax_default_table() if lookup else None)
    twd, th = tbudget.candidate_scores(torch.tensor(alpha), torch.tensor(kappa),
                                       torch.tensor([i_min]), torch.tensor(valid), method,
                                       torch_default_table() if lookup else None)
    jwd = np.asarray(jwd)
    np.testing.assert_allclose(twd.numpy()[valid], jwd[valid], rtol=1e-4, atol=1e-6)
    assert np.isinf(twd.numpy()[~valid]).all() and np.isinf(jwd[~valid]).all()
    assert int(torch.argmin(twd)) == int(np.argmin(jwd))
    if method == "lookup-wd":
        assert th is None                   # h is read at the winner only
    else:
        assert np.abs(th.numpy() - np.asarray(jh)).max() <= _h_tol(method)


def test_run_maintenance_masks_events_below_budget():
    sv_x, alpha, count = _state(2)
    args = (torch.tensor(sv_x), torch.tensor(alpha), None, torch.tensor(count, dtype=torch.int32),
            torch.tensor(4, dtype=torch.int32), GAMMA, torch_default_table())
    sv, al, km, c, n = tbudget.run_maintenance(*args, budget=count)    # not over budget
    assert torch.equal(sv, args[0]) and torch.equal(al, args[1]) and km is None
    assert int(c) == count and int(n) == 4
    sv, al, km, c, n = tbudget.run_maintenance(*args, budget=count - 2, unroll=3)
    assert int(c) == count - 2 and int(n) == 6         # third event masked out
    assert (al[count - 2:] == 0).all()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("same_sign", [False, True], ids=["merge", "removal"])
def test_binary_event_equals_class_axis_event(method, same_sign):
    """The binary step's event (no class axis) and the class-axis event at
    C = 1 are one event: equal state and info, bit for bit, executed or
    masked.  ``same_sign`` with one SV of the other sign forces the removal
    fallback."""
    sv_x, alpha, slots = _state(7, same_sign=same_sign)
    if same_sign:
        alpha[int(np.argmin(np.abs(alpha)))] *= -1.0
    table = torch_default_table() if method.startswith("lookup") else None
    sv, al = torch.tensor(sv_x), torch.tensor(alpha)
    for execute in (True, False):
        ex = torch.tensor([execute])
        count = torch.tensor(slots - 2, dtype=torch.int32)
        b_sv, b_al, b_count, b_info = tbudget._merge_once_binary(
            sv, al, count, GAMMA, method, table, execute=ex[0], impl="ref")
        c_sv, c_al, _, c_count, c_info = tbudget._merge_once(
            sv[None], al[None], None, count.reshape(1), GAMMA, method, table, execute=ex,
            impl="ref")
        assert torch.equal(b_sv, c_sv[0]) and torch.equal(b_al, c_al[0])
        assert int(b_count) == int(c_count[0]) == slots - 2 - int(execute)
        for b, c in zip(b_info, c_info):
            assert torch.equal(b, c[0])
        assert bool(b_info.merged) is not same_sign
