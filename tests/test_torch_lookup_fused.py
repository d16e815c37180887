"""The port's fused Lookup-WD choices (``merge_pick``, ``multi_merge_choose``) on the CPU.

On the CPU ``ops.merge_pick`` and ``ops.multi_merge_choose`` run their plain
versions (``kernels.ref``); the CUDA kernels (``csrc/merge_lookup.cu``,
``csrc/merge_multi.cu``) are held against those on the card by
``chip_smoke.py``.  Here the plain versions must equal, bit for bit, the
sequences of operations that ``core.budget`` ran before them (restated
below as ``_old_*``), and the events built on them must agree with the JAX
reference: decisions exactly, floats within the tolerance stated at each
check.  The wrappers must refuse what their kernels do not take before they
touch any compiled library.
"""
import jax
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
from repro_torch.kernels import _build, merge_lookup, merge_multi, ops, ref

GAMMA = 0.5
NO_PARTNER = ref.NO_PARTNER


@pytest.fixture(scope="module")
def table():
    return torch_default_table()


def _row(rng, s, neg=0.4):
    return ((np.abs(rng.standard_normal(s)) * 0.2 + 0.01)
            * np.where(rng.random(s) < neg, -1.0, 1.0)).astype(np.float32)


def _fixed(alpha, count):
    """The active min-|alpha| slot (first on ties) and its alpha, per row."""
    idx = torch.arange(alpha.shape[-1])
    i_min = torch.argmin(torch.where(idx < count[..., None], alpha.abs(), torch.inf), dim=-1)
    i_min = i_min.reshape(-1)
    return i_min, alpha.reshape(-1, alpha.shape[-1]).gather(1, i_min[:, None])[:, 0]


def _old_pick_binary(alpha, kappa, count, i_min, a_min, table):
    """``core.budget._merge_once_binary`` step 3 under lookup-wd before ``merge_pick``."""
    idx = torch.arange(alpha.shape[0])
    valid = (idx < count) & (alpha * a_min > 0) & (idx != i_min)
    wd, _ = ops.merge_scores(alpha, kappa, valid, a_min, table.wd_table)
    j_star = torch.argmin(wd).reshape(1)
    wd_j = wd.index_select(0, j_star)
    a_j, kappa_j = alpha.index_select(0, j_star), kappa.index_select(0, j_star)
    _, h_j = ops.merge_scores(a_j, kappa_j, torch.ones_like(wd_j < NO_PARTNER), a_min,
                              table.h_table)
    return j_star, wd_j, h_j


def _old_pick_rows(alpha, kappa, count, i_min, a_min, table):
    """``core.budget._merge_once`` step 3 under lookup-wd before ``merge_pick``."""
    ar, idx = torch.arange(alpha.shape[0]), torch.arange(alpha.shape[1])
    valid = (idx < count[:, None]) & (alpha * a_min[:, None] > 0) & (idx != i_min[:, None])
    wd, _ = ops.merge_scores(alpha, kappa, valid, a_min, table.wd_table)
    j_star = torch.argmin(wd, dim=1)
    wd_j = wd[ar, j_star]
    a_j, kappa_j = alpha[ar, j_star], kappa[ar, j_star]
    _, h_j = ops.merge_scores(a_j[:, None], kappa_j[:, None],
                              torch.ones_like(wd_j < NO_PARTNER)[:, None], a_min, table.h_table)
    return j_star, wd_j, h_j[:, 0]


def _pick_case(case, rng):
    """(alpha, kappa, count) of shape (R, s), (R, s), (R,) for one named case."""
    r, s = {"random": (1, 501), "rows": (10, 508), "ties": (3, 64), "all-invalid": (2, 40),
            "s=1": (1, 1)}[case]
    alpha = np.stack([_row(rng, s) for _ in range(r)])
    kappa = rng.random((r, s)).astype(np.float32)
    count = rng.integers(max(s // 2, 1), s + 1, r).astype(np.int32)
    if case == "ties":
        # slots 5 and 9 carry the same (alpha, kappa) and the best score of
        # their row: the lower slot must win
        kappa *= 0.9
        for q in range(r):
            alpha[q] = np.abs(alpha[q]) + 0.3
            alpha[q, 2] = 0.05                     # the fixed partner
            alpha[q, [5, 9]] = 0.06
            kappa[q, [5, 9]] = 0.999
        count[:] = s
    if case == "all-invalid":
        alpha = -np.abs(alpha)
        alpha[:, 0] = 0.001                        # a lone positive fixed partner
    return (torch.tensor(alpha), torch.tensor(kappa), torch.tensor(count))


@pytest.mark.parametrize("case", ["random", "rows", "ties", "all-invalid", "s=1"])
def test_merge_pick_equals_the_old_sequence(case, table):
    alpha, kappa, count = _pick_case(case, np.random.default_rng(len(case)))
    i_min, a_min = _fixed(alpha, count)
    got = ops.merge_pick(alpha, kappa, count, i_min, a_min, table)
    want = _old_pick_rows(alpha, kappa, count, i_min, a_min, table)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    if alpha.shape[0] == 1:      # the binary form: one row without the row axis
        got_b = ops.merge_pick(alpha[0], kappa[0], count[0], i_min, a_min, table)
        for g, w in zip(got_b, _old_pick_binary(alpha[0], kappa[0], count[0], i_min, a_min,
                                                table)):
            assert g.shape == w.shape and torch.equal(g, w)
    j_star, wd_j, _ = got
    if case == "ties":
        assert (j_star == 5).all() and (wd_j < NO_PARTNER).all()
    if case in ("all-invalid", "s=1"):
        assert (j_star == 0).all() and (wd_j >= NO_PARTNER).all()


def test_merge_pick_matches_the_reference_event(table):
    """The port's pick against the reference's uncached ``_merge_once`` on the
    same kappa row: partner and merge-or-remove exactly; the score and h
    within the rtol 1e-4 that the reference's own lookup kernel is held to."""
    rng = np.random.default_rng(3)
    jt = jax_default_table()
    for trial in range(6):
        s, count = 40, 33 + trial
        alpha = _row(rng, s)
        alpha[count:] = 0.0
        kappa = rng.random(s).astype(np.float32)
        sv = rng.standard_normal((s, 3)).astype(np.float32)
        _, _, _, _, info = jbudget._merge_once(
            jnp.asarray(sv), jnp.asarray(alpha), None, jnp.int32(count), GAMMA, "lookup-wd", jt,
            kappa_row=jnp.asarray(kappa))
        t_alpha, t_count = torch.tensor(alpha), torch.tensor(count, dtype=torch.int32)
        i_min, a_min = _fixed(t_alpha, t_count)
        j_star, wd_j, h_j = ops.merge_pick(t_alpha, torch.tensor(kappa), t_count, i_min, a_min,
                                           table)
        assert int(i_min[0]) == int(info.i_min)
        assert int(j_star[0]) == int(info.j_star)
        assert bool(wd_j[0] < NO_PARTNER) == bool(info.merged)
        if bool(info.merged):
            np.testing.assert_allclose(float(wd_j[0]), float(info.wd_star), rtol=1e-4)
            np.testing.assert_allclose(float(h_j[0]), float(info.h_star), rtol=1e-4, atol=1e-6)


def _old_choose(alpha, kappa_rows, a_idx, a_min, count, budget, table):
    """``core.budget._multi_merge_once`` steps 3-4 under lookup-wd before
    ``multi_merge_choose``: the mask, both tables, the greedy loop, the h gather."""
    c, p, s = kappa_rows.shape
    idx, ar = torch.arange(s), torch.arange(c)
    arc = ar[:, None]
    active = idx < count[:, None]
    self_mask = idx[None, None, :] == a_idx[:, :, None]
    valid = active[:, None, :] & (a_min[:, :, None] * alpha[:, None, :] > 0) & ~self_mask
    wd, h = ops.multi_merge_scores(alpha, kappa_rows, valid, a_min, table)
    excess = count - budget
    taken = torch.zeros((c, s), dtype=torch.bool)
    consumed = torch.zeros((c, p), dtype=torch.bool)
    n_exec = torch.zeros_like(count)
    b_list, merged_list, exec_list = [], [], []
    for q in range(p):
        wd_q = torch.where(taken, torch.inf, wd[:, q])
        j_q = torch.argmin(wd_q, dim=1)
        exec_q = ~consumed[:, q] & (n_exec < excess)
        merged_q = exec_q & (wd_q[ar, j_q] < NO_PARTNER)
        b_list.append(j_q)
        merged_list.append(merged_q)
        exec_list.append(exec_q)
        taken = (taken | ((idx == j_q[:, None]) & merged_q[:, None])
                 | ((idx == a_idx[:, q, None]) & exec_q[:, None]))
        consumed = consumed | ((a_idx == j_q[:, None]) & merged_q[:, None])
        n_exec = n_exec + exec_q.to(n_exec.dtype)
    b_idx = torch.stack(b_list, dim=1)
    return (b_idx, torch.stack(merged_list, dim=1), torch.stack(exec_list, dim=1),
            h[arc, torch.arange(p), b_idx])


def _choose_case(p, case, seed):
    """A class-axis state with its P fixed partners, as ``_multi_merge_once``
    picks them: (alpha, kappa_rows, a_idx, a_min, count, budget)."""
    rng = np.random.default_rng(seed)
    c, s, budget = 5, 60, 48
    alpha = np.stack([_row(rng, s) for _ in range(c)])
    count = np.array([s, budget, s - 3, budget - 4, budget + 1], np.int32)
    if case == "consumed":
        # in every class the two smallest |alpha| share a sign: pair 0's best
        # partner is pair 1's fixed slot, so pair 1 is skipped
        alpha = np.abs(alpha) + 0.05
        alpha[:, 7], alpha[:, 3] = 0.001, 0.002
        count[:] = s
    if case == "excess<P":
        count[:] = budget + 2
    for q in range(c):
        alpha[q, count[q]:] = 0.0
    alpha, count = torch.tensor(alpha), torch.tensor(count)
    idx = torch.arange(s)
    abs_a = torch.where(idx < count[:, None], alpha.abs(), torch.inf)
    a_idx = torch.sort(abs_a, dim=1, stable=True).indices[:, :p]
    a_min = alpha[torch.arange(c)[:, None], a_idx]
    kappa_rows = rng.random((c, p, s)).astype(np.float32)
    if case == "consumed":
        kappa_rows *= 0.95
        kappa_rows[:, 0, 3] = 0.999
    kappa_rows = torch.tensor(kappa_rows)
    return alpha, kappa_rows, a_idx, a_min, count, budget


@pytest.mark.parametrize("p,case", [(1, "random"), (4, "random"), (8, "random"),
                                    (4, "consumed"), (4, "excess<P"), (8, "excess<P")])
def test_multi_merge_choose_equals_the_old_loop(p, case, table):
    args = _choose_case(p, case, seed=p)
    got = ops.multi_merge_choose(*args, table)
    want = _old_choose(*args, table)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    b_idx, merged, execute, _ = got
    alpha, _, a_idx, _, count, budget = args
    n_exec = execute.sum(dim=1)
    assert (n_exec <= torch.clamp(count - budget, min=0)).all()
    assert not (merged & ~execute).any()
    if case == "consumed":
        assert torch.equal(b_idx[:, 0], a_idx[:, 1]) and merged[:, 0].all()
        assert not execute[:, 1].any()
    if case == "excess<P":
        assert (n_exec == 2).all()
    if case == "random":
        assert not execute[3].any() and execute[0].any()   # class 3 is below its budget


def _cache_state(p, seed):
    rng = np.random.default_rng(seed)
    c, s, d, budget = 4, 24, 5, 18
    sv = rng.standard_normal((c, s, d)).astype(np.float32)
    kmat = np.asarray(jax.vmap(lambda x: jkc.exact_cache(x, GAMMA))(jnp.asarray(sv)))
    alpha = np.stack([_row(rng, s) for _ in range(c)])
    count = np.array([s, budget, s - 2, budget + 3], np.int32)
    for q in range(c):
        alpha[q, count[q]:] = 0.0
    return sv, alpha, kmat, count, budget


@pytest.mark.parametrize("p", [1, 4, 8])
def test_multi_merge_once_matches_the_reference(p, table):
    """A cached multi-merge event, one class at a time, against the reference's
    ``_multi_merge_once``: count exactly, floats within the 1e-5 that
    ``test_run_maintenance_with_cache_matches_reference`` holds them to."""
    sv, alpha, kmat, count, budget = _cache_state(p, seed=20 + p)
    jt = jax_default_table()
    t = tbudget._multi_merge_once(*(torch.tensor(a) for a in (sv, alpha, kmat, count)), GAMMA,
                                  "lookup-wd", table, budget, p)
    for q in range(count.shape[0]):
        j = jbudget._multi_merge_once(jnp.asarray(sv[q]), jnp.asarray(alpha[q]),
                                      jnp.asarray(kmat[q]), jnp.int32(count[q]), GAMMA,
                                      "lookup-wd", jt, budget, p, "ref")
        n = int(j[3])
        assert int(t[3][q]) == n
        if count[q] <= budget:
            assert n == count[q]
            continue
        np.testing.assert_allclose(t[0][q].numpy(), np.asarray(j[0]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(t[1][q].numpy(), np.asarray(j[1]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(t[2][q, :n, :n].numpy(), np.asarray(j[2])[:n, :n], atol=1e-5,
                                   rtol=0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0, so that a wrapper's checks past
    the device check run here (the compiled library is never reached)."""

    def get_device(self):
        return 0


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def _wrapper_calls(table):
    f = lambda *shape: torch.zeros(*shape)
    i32 = lambda *shape: torch.zeros(*shape, dtype=torch.int32)
    i64 = lambda *shape: torch.zeros(*shape, dtype=torch.int64)
    tab = table.wd_table
    return {
        "merge_scores": (merge_lookup.merge_scores_cuda,
                         [f(2, 8), f(2, 8), torch.ones(2, 8, dtype=torch.bool), f(2), tab],
                         1, [f(2, 8), f(2, 7), torch.ones(2, 8, dtype=torch.bool), f(2), tab]),
        "merge_pick": (merge_lookup.merge_pick_cuda,
                       [f(2, 8), f(2, 8), i32(2), i64(2), f(2), tab, tab],
                       2, [f(2, 8), f(2, 8), i32(3), i64(2), f(2), tab, tab]),
        "multi_merge_scores": (merge_multi.multi_merge_scores_cuda,
                               [f(2, 8), f(2, 3, 8), torch.ones(2, 3, 8, dtype=torch.bool),
                                f(2, 3), tab, tab],
                               3, [f(2, 8), f(2, 3, 8), torch.ones(2, 3, 8, dtype=torch.bool),
                                   f(5), tab, tab]),
        "multi_merge_choose": (merge_multi.multi_merge_choose_cuda,
                               [f(2, 8), f(2, 3, 8), i64(2, 3), f(2, 3), i32(2), 4, tab, tab],
                               4, [f(2, 8), f(2, 3, 8), i64(2, 4), f(2, 3), i32(2), 4, tab, tab]),
    }


@pytest.mark.parametrize("name", ["merge_scores", "merge_pick", "multi_merge_scores",
                                  "multi_merge_choose"])
def test_wrappers_refuse_what_their_kernel_does_not_take(name, table, monkeypatch):
    def touched(*_a, **_k):
        raise AssertionError("a wrapper reached the compiled library")

    monkeypatch.setattr(_build, "function", touched)
    monkeypatch.setattr(_build, "load", touched)
    fn, args, bad_dtype, bad_shape = _wrapper_calls(table)[name]
    card = [_card(a) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CUDA"):          # CPU tensors
        fn(*args)
    wrong = list(card)
    wrong[bad_dtype] = _card(args[bad_dtype].double())    # a wrong dtype
    with pytest.raises(TypeError):
        fn(*wrong)
    with pytest.raises(ValueError, match="pair|share"):   # mismatched shapes
        fn(*[_card(a) if isinstance(a, torch.Tensor) else a for a in bad_shape])
    with pytest.raises(ValueError, match="CUDA"):          # one input left on the CPU
        fn(*([args[0]] + card[1:]))


def test_multi_merge_choose_refuses_more_pairs_or_scores_than_a_block_holds(table, monkeypatch):
    monkeypatch.setattr(_build, "function", lambda *a: pytest.fail("library reached"))
    tab = _card(table.wd_table)
    for p, s in [(600, 100), (8, 8_000)]:   # pair lists and scores above 227 KB
        args = [_card(torch.zeros(2, s)), _card(torch.zeros(2, p, s)),
                _card(torch.zeros(2, p, dtype=torch.int64)), _card(torch.zeros(2, p)),
                _card(torch.zeros(2, dtype=torch.int32)), 4, tab, tab]
        with pytest.raises(ValueError, match="shared memory"):
            merge_multi.multi_merge_choose_cuda(*args)


def test_new_launch_counters_are_read_and_reset(table):
    assert {"merge_pick", "multi_merge_choose"} <= set(ops.launch_counts())
    merge_lookup.pick_launches, merge_multi.choose_launches = 3, 5
    assert ops.launch_counts()["merge_pick"] == 3
    assert ops.launch_counts()["multi_merge_choose"] == 5
    ops.reset_launch_counts()
    args = _choose_case(4, "random", seed=0)
    ops.multi_merge_choose(*args, table)
    alpha, kappa, count = _pick_case("rows", np.random.default_rng(0))
    ops.merge_pick(alpha, kappa, count, *_fixed(alpha, count), table)
    assert set(ops.launch_counts().values()) == {0}    # the CPU path launches nothing


@pytest.mark.parametrize("op", ["merge_pick", "multi_merge_choose"])
def test_cuda_impl_of_the_new_ops_on_cpu_tensors_raises(op, table):
    alpha, kappa, count = _pick_case("rows", np.random.default_rng(1))
    calls = {"merge_pick": lambda: ops.merge_pick(alpha, kappa, count, *_fixed(alpha, count),
                                                  table, impl="cuda"),
             "multi_merge_choose": lambda: ops.multi_merge_choose(
                 *_choose_case(4, "random", seed=1), table, impl="cuda")}
    with pytest.raises(ValueError, match="CUDA"):
        calls[op]()
