"""The port's drain-to-budget maintenance against the JAX reference (CPU).

The reference's ``run_maintenance`` and ``run_maintenance_classes`` default
to ``unroll=0``: a while loop of events until ``count <= budget``.  The
port's default is the same drain, run as the largest excess of masked
events.  Banks are made with numpy from a seed, three SVs over their
budget, and go through both packages with default arguments.  Integer state
(count, events) must be equal; floats agree within 1e-5, the float32
round-off of the two packages' kernel rows and exp/log (as in
``test_torch_kernel_cache.py``).  A drain of e events must equal the port's
own ``unroll=e`` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import budget as jbudget
from repro.core import kernel_cache as jkc
from repro.core.lookup import default_table as jax_default_table
from repro_torch.core import budget as tbudget
from repro_torch.core.lookup import default_table as torch_default_table

GAMMA = 0.7
BUDGET, EXCESS = 8, 3
TOL = 1e-5


def _bank(seed, s=BUDGET + EXCESS + 2, d=5, count=BUDGET + EXCESS):
    rng = np.random.default_rng(seed)
    sv = (0.6 * rng.standard_normal((s, d))).astype(np.float32)
    alpha = ((np.abs(rng.standard_normal(s)) + 0.05)
             * np.where(rng.random(s) < 0.4, -1.0, 1.0)).astype(np.float32)
    alpha[count:] = 0.0
    kmat = np.asarray(jkc.exact_cache(jnp.asarray(sv), GAMMA))
    return sv, alpha, kmat


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=0)


def _binary(strategy, cached, seed=3, **kw):
    sv, alpha, kmat = _bank(seed)
    count = BUDGET + EXCESS
    args = dict(budget=BUDGET, strategy=strategy, merge_batch=2, **kw)
    j = jbudget.run_maintenance(jnp.asarray(sv), jnp.asarray(alpha),
                                jnp.asarray(kmat) if cached else None, jnp.int32(count),
                                jnp.int32(0), GAMMA, jax_default_table(), **args)
    ins = [torch.tensor(sv), torch.tensor(alpha), torch.tensor(kmat) if cached else None,
           torch.tensor(count, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)]
    return j, ins, args


@pytest.mark.parametrize("strategy,cached", [("merge", False), ("merge", True),
                                             ("multi-merge", False), ("multi-merge", True)])
def test_binary_drain_matches_reference_defaults(strategy, cached):
    j, ins, args = _binary(strategy, cached)
    t = tbudget.run_maintenance(*ins, GAMMA, torch_default_table(), **args)
    jsv, jal, jkm, jc, jn = j
    tsv, tal, tkm, tc, tn = t
    assert (int(tc), int(tn)) == (int(jc), int(jn))
    assert int(tc) <= BUDGET
    if strategy == "merge":             # one SV an event: three events
        assert (int(tc), int(tn)) == (BUDGET, EXCESS)
    _close(tsv, jsv)
    _close(tal, jal)
    if cached:
        c = int(tc)
        _close(tkm[:c, :c], np.asarray(jkm)[:c, :c])


@pytest.mark.parametrize("strategy,cached", [("merge", False), ("multi-merge", True)])
def test_binary_drain_equals_unroll_of_its_events(strategy, cached):
    _, ins, args = _binary(strategy, cached, seed=5)
    drained = tbudget.run_maintenance(*ins, GAMMA, torch_default_table(), **args)
    unrolled = tbudget.run_maintenance(*ins, GAMMA, torch_default_table(), unroll=EXCESS,
                                       **args)
    for a, b in zip(drained, unrolled):
        assert (a is None and b is None) or torch.equal(a, b)


def test_binary_drain_leaves_a_state_at_budget_unchanged():
    sv, alpha, _ = _bank(7, count=BUDGET)
    ins = [torch.tensor(sv), torch.tensor(alpha), None, torch.tensor(BUDGET, dtype=torch.int32),
           torch.tensor(2, dtype=torch.int32)]
    out = tbudget.run_maintenance(*ins, GAMMA, torch_default_table(), budget=BUDGET)
    assert torch.equal(out[0], ins[0]) and torch.equal(out[1], ins[1])
    assert (int(out[3]), int(out[4])) == (BUDGET, 2)


def _stack(excess=(EXCESS, 0, 1), seed=30):
    counts = np.array([BUDGET + e for e in excess], np.int32)
    banks = [_bank(seed + q, count=int(c)) for q, c in enumerate(counts)]
    sv, alpha, kmat = (np.stack([b[k] for b in banks]) for k in range(3))
    return sv, alpha, kmat, counts


def test_class_axis_drain_matches_reference_defaults():
    sv, alpha, kmat, counts = _stack()
    j = jbudget.run_maintenance_classes(jnp.asarray(sv), jnp.asarray(alpha), jnp.asarray(kmat),
                                        jnp.asarray(counts), jnp.zeros(3, jnp.int32),
                                        jax_default_table(), budget=BUDGET, impl="ref")
    ins = [torch.tensor(a) for a in (sv, alpha, kmat, counts, np.zeros(3, np.int32))]
    t = tbudget.run_maintenance_classes(*ins, torch_default_table(), budget=BUDGET)
    assert torch.equal(ins[3], torch.tensor(counts))    # the inputs are left as they were
    jsv, jal, jkm, jc, jn = (np.asarray(a) for a in j)
    tsv, tal, tkm, tc, tn = (a.numpy() for a in t)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, [BUDGET] * 3)
    np.testing.assert_array_equal(tn, [EXCESS, 0, 1])
    _close(tsv, jsv)
    _close(tal, jal)
    for q in range(3):
        _close(tkm[q, :BUDGET, :BUDGET], jkm[q, :BUDGET, :BUDGET])


def test_class_axis_drain_equals_unroll_of_its_rounds():
    sv, alpha, kmat, counts = _stack(seed=40)
    tab = torch_default_table()
    ins = lambda: [torch.tensor(a) for a in (sv, alpha, kmat, counts, np.zeros(3, np.int32))]
    drained = tbudget.event_rounds_(*ins(), tab, budget=BUDGET)
    unrolled = tbudget.event_rounds_(*ins(), tab, budget=BUDGET, unroll=EXCESS)
    for a, b in zip(drained, unrolled):
        assert torch.equal(a, b)
    # one class: the single-class engine drains as well
    one = tbudget.run_maintenance_classes(*(t[:1] for t in ins()), tab, budget=BUDGET)
    np.testing.assert_array_equal(one[3].numpy(), [BUDGET])
    np.testing.assert_array_equal(one[4].numpy(), [EXCESS])


def test_class_axis_drain_with_no_class_over_budget_is_a_no_op():
    sv, alpha, kmat, counts = _stack(excess=(0, 0, 0), seed=50)
    ins = [torch.tensor(a) for a in (sv, alpha, kmat, counts, np.zeros(3, np.int32))]
    out = tbudget.run_maintenance_classes(*ins, torch_default_table(), budget=BUDGET)
    for a, b in zip(out, ins):
        assert torch.equal(a, b)


def test_negative_unroll_raises():
    _, ins, args = _binary("merge", False)
    with pytest.raises(ValueError, match="unroll"):
        tbudget.run_maintenance(*ins, GAMMA, torch_default_table(), unroll=-1, **args)
