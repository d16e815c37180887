"""A step's masked event rounds in one call (``ops.merge_event_rounds``) on the CPU.

The plain version ``ref.merge_event_rounds`` is held bit for bit to the
round loop that ``core.budget.event_rounds_`` ran before it (one
``merge_event`` a round and the count updates around it), and its integer
state exactly, its floats within the kernel-cache tests' tolerance, to the
JAX reference's ``budget.run_maintenance_classes``.  The CUDA wrapper's
refusals and the cluster-size rule are checked without a card; the kernel
itself is held to the plain version on the card by ``chip_smoke.py``.
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
from repro_torch.kernels import _build, merge_event, ops, ref

GAMMA = 0.7
BUDGET = 11
ENTRY_TOL = 1e-6     # one exp/log rounding on a unit-scale cache entry (test_torch_kernel_cache)


@pytest.fixture(scope="module")
def tables():
    return jax_default_table(), torch_default_table()


def _classes(seed, c=4, s=18, d=5, counts=(18, 11, 14, 9)):
    """Stacked class states with exact caches, mixed signs, and counts over,
    at and under BUDGET (excess 7, 0, 3, -2); class 0's cheapest SV is its
    only positive one, so its first event falls back to removal."""
    rng = np.random.default_rng(seed)
    sv = (0.6 * rng.standard_normal((c, s, d))).astype(np.float32)
    alpha = ((np.abs(rng.standard_normal((c, s))) + 0.05)
             * np.where(rng.random((c, s)) < 0.4, -1.0, 1.0)).astype(np.float32)
    alpha[0] = -np.abs(alpha[0])
    alpha[0, 3] = 0.01
    count = np.asarray(counts, np.int32)
    for q in range(c):
        alpha[q, count[q]:] = 0.0
    kmat = np.stack([np.asarray(jkc.exact_cache(jnp.asarray(sv[q]), GAMMA)) for q in range(c)])
    n_events = rng.integers(0, 9, c).astype(np.int32)
    return sv, alpha, kmat.astype(np.float32), count, n_events


def _torch(arrays, sv_dtype=torch.float32):
    sv, alpha, kmat, count, n_events = (torch.tensor(a) for a in arrays)
    return [sv.to(sv_dtype), alpha, kmat, count, n_events]


def _loop_before(sv_x, alpha, kmat, count, n_events, table, unroll):
    """``event_rounds_``'s body before the rounds became one call: a
    ``merge_event`` round and the count updates around it, ``unroll`` times."""
    for _ in range(unroll):
        over = count > BUDGET
        ops.merge_event(sv_x, alpha, kmat, count, over, table)
        count = count - over.to(count.dtype)
        n_events = n_events + over.to(n_events.dtype)
    return sv_x, alpha, kmat, count, n_events


@pytest.mark.parametrize("sv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("unroll", [1, 4, 8])
def test_rounds_equal_the_round_loop_bit_for_bit(unroll, sv_dtype, tables):
    _, tt = tables
    arrays = _classes(3)
    want = _loop_before(*_torch(arrays, sv_dtype), tt, unroll)
    ins = _torch(arrays, sv_dtype)
    got = ref.merge_event_rounds(*ins, tt.h_table, tt.wd_table, rounds=unroll, budget=BUDGET)
    assert all(g is i for g, i in zip(got, ins))                # all five in place
    engine = tbudget.event_rounds_(*_torch(arrays, sv_dtype), tt, budget=BUDGET, unroll=unroll)
    for name, w, g, e in zip(("sv_x", "alpha", "kmat", "count", "n_events"), want, got, engine):
        assert torch.equal(g, w), name
        assert torch.equal(e, w), name
    excess = np.maximum(arrays[3] - BUDGET, 0)
    np.testing.assert_array_equal(got[3].numpy(), arrays[3] - np.minimum(excess, unroll))
    np.testing.assert_array_equal(got[4].numpy(), arrays[4] + np.minimum(excess, unroll))
    for q in np.nonzero(arrays[3] <= BUDGET)[0]:                # at or under budget: untouched
        assert torch.equal(got[0][q], _torch(arrays, sv_dtype)[0][q])
        np.testing.assert_array_equal(got[1][q].numpy(), arrays[1][q])
        np.testing.assert_array_equal(got[2][q].numpy(), arrays[2][q])


@pytest.mark.parametrize("unroll", [1, 4, 8])
def test_rounds_match_the_reference_engine(unroll, tables):
    jt, tt = tables
    arrays = _classes(5)
    j = jbudget.run_maintenance_classes(*(jnp.asarray(a) for a in arrays), jt, budget=BUDGET,
                                        impl="ref", unroll=unroll)
    t = ops.merge_event_rounds(*_torch(arrays), tt, rounds=unroll, budget=BUDGET)
    jsv, jal, jkm, jc, jn = (np.asarray(a) for a in j)
    tsv, tal, tkm, tc, tn = (a.numpy() for a in t)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tsv, jsv, atol=ENTRY_TOL, rtol=0)
    np.testing.assert_allclose(tal, jal, atol=ENTRY_TOL, rtol=0)
    np.testing.assert_allclose(tkm, jkm, atol=ENTRY_TOL, rtol=0)


def test_engine_leaves_the_callers_counters(tables):
    _, tt = tables
    ins = _torch(_classes(7))
    count, n_events = ins[3].clone(), ins[4].clone()
    out = tbudget.event_rounds_(*ins, tt, budget=BUDGET, unroll=4)
    assert torch.equal(ins[3], count) and torch.equal(ins[4], n_events)
    assert not torch.equal(out[3], count) and out[0] is ins[0]   # the state itself in place


def test_cpu_rounds_launch_nothing(tables):
    _, tt = tables
    ops.reset_launch_counts()
    ops.merge_event_rounds(*_torch(_classes(9)), tt, rounds=8, budget=BUDGET)
    assert ops.launch_counts()["merge_event_rounds"] == 0
    assert set(ops.launch_counts().values()) == {0}
    merge_event.rounds_launches = 2
    assert ops.launch_counts()["merge_event_rounds"] == 2
    ops.reset_launch_counts()
    assert merge_event.rounds_launches == 0


def test_cuda_impl_on_cpu_tensors_raises(tables):
    _, tt = tables
    with pytest.raises(ValueError, match="CUDA"):
        ops.merge_event_rounds(*_torch(_classes(9)), tt, rounds=8, budget=BUDGET, impl="cuda")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0, so that the wrapper's checks past
    the device check run here (the compiled library is never reached)."""

    def get_device(self):
        return 0


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def _bad_calls(tt):
    """(what is wrong, arguments, keywords, the error) for merge_event_rounds_cuda."""
    sv, al, km, count, n = _torch(_classes(1))
    h, wd = tt.h_table, tt.wd_table
    card = lambda *ts: [_card(t) for t in ts]
    ok = card(sv, al, km, count, n, h, wd)
    kw = dict(rounds=8, budget=BUDGET)
    return [
        ("CPU tensors", [sv, al, km, count, n, h, wd], kw, (ValueError, "CUDA")),
        ("one input on the CPU", [sv] + ok[1:], kw, (ValueError, "CUDA")),
        ("fp64 bank", card(sv.double(), al, km, count, n, h, wd), kw, (TypeError, "fp32 or bf16")),
        ("int64 count", card(sv, al, km, count.long(), n, h, wd), kw, (TypeError, "int32")),
        ("int64 n_events", card(sv, al, km, count, n.long(), h, wd), kw, (TypeError, "int32")),
        ("fp64 cache", card(sv, al, km.double(), count, n, h, wd), kw, (TypeError, "fp32")),
        ("alpha of another S", card(sv, al[:, :-1].contiguous(), km, count, n, h, wd), kw,
         (ValueError, "pair")),
        ("n_events of another C", card(sv, al, km, count, n[:-1].contiguous(), h, wd), kw,
         (ValueError, "pair")),
        ("tables of two shapes", card(sv, al, km, count, n, h, wd[:-1].contiguous()), kw,
         (ValueError, "share")),
        ("no rounds", ok, dict(rounds=0, budget=BUDGET), (ValueError, "rounds")),
        ("an unknown cluster size", ok, dict(kw, cluster=3), (ValueError, "cluster")),
    ]


@pytest.mark.parametrize("case", range(11))
def test_rounds_wrapper_refuses_before_the_library(case, tables, monkeypatch):
    def touched(*_a, **_k):
        raise AssertionError("the wrapper reached the compiled library")

    monkeypatch.setattr(_build, "function", touched)
    monkeypatch.setattr(_build, "load", touched)
    calls = _bad_calls(tables[1])
    assert len(calls) == 11
    what, args, kw, (err, match) = calls[case]
    with pytest.raises(err, match=match):
        merge_event.merge_event_rounds_cuda(*args, **kw)


@pytest.mark.parametrize("c,resident,want", [
    (10, {16: 21, 8: 45, 4: 92, 2: 198, 1: 396}, 16),   # every size fits: the largest
    (10, {16: 9, 8: 45, 4: 92, 2: 198, 1: 396}, 8),     # one class short at 16
    (10, {16: 10, 8: 45, 4: 92, 2: 198, 1: 396}, 16),   # exactly all C resident
    (1, {16: 0, 8: 0, 4: 3, 2: 6, 1: 12}, 4),           # the card refuses 16 and 8
    (200, {16: 8, 8: 16, 4: 33, 2: 66, 1: 132}, 1),     # none holds all C: one block a class
    (3, {}, 1),                                          # nothing resident at all
])
def test_cluster_choice_is_the_largest_resident_size(c, resident, want):
    k = _build.choose_cluster(c, resident)
    assert k == want and k in _build.CLUSTER_SIZES and k >= 1
    assert all(resident.get(bigger, 0) < c for bigger in _build.CLUSTER_SIZES if bigger > k)


@pytest.mark.parametrize("cluster", [None, 1, 16])
@pytest.mark.parametrize("entry", ["merge_event_cuda", "merge_event_rounds_cuda"])
def test_event_wrappers_launch_at_the_fixed_cluster_size(entry, cluster, tables, monkeypatch):
    """Unless the caller fixes K, both event entries launch at ``CLUSTER``
    blocks a class, with no occupancy query."""
    seen = []

    def fake(name, symbol, argtypes):
        def launch(*args):
            seen.append((symbol, args))
            return 0
        return launch

    monkeypatch.setattr(_build, "function", fake)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    sv, al, km, count, n = (_card(t) for t in _torch(_classes(2)))
    h, wd = (_card(t) for t in (tables[1].h_table, tables[1].wd_table))
    kw = {} if cluster is None else dict(cluster=cluster)
    if entry == "merge_event_cuda":
        merge_event.merge_event_cuda(sv, al, km, count, _card(count > BUDGET), h, wd, **kw)
        k = seen[0][1][13]
    else:
        merge_event.merge_event_rounds_cuda(sv, al, km, count, n, h, wd, rounds=8,
                                            budget=BUDGET, **kw)
        k = seen[0][1][15]
    assert [s for s, _ in seen] == [entry.removesuffix("_cuda") + "_launch"]
    assert merge_event.CLUSTER in _build.CLUSTER_SIZES
    assert k == (merge_event.CLUSTER if cluster is None else cluster)
