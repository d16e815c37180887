"""Multi-merge with more than 32 pairs an event in the port (CPU).

The reference accepts any ``merge_batch`` up to the budget; the port's
kernels once kept static lists of 32 pairs and refused more.  The lists are
now sized by P in shared memory.  Here the port's multi-merge event at
P = 40, with the kernel cache and without it, is held to the reference's
``_multi_merge_once`` one class at a time (count exactly, floats within the
1e-5 of ``test_torch_lookup_fused``), a drain at P = 40 to the reference's
``run_maintenance``, and the two wrappers must take P = 40 through their
checks to the compiled library.
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
from repro_torch.kernels import _build, merge_multi
from repro_torch.kernels import train_step as train_step_kernel

GAMMA = 0.5
P = 40
TOL = 1e-5


def _state(seed, c=3, s=160, d=4, budget=60):
    rng = np.random.default_rng(seed)
    sv = (0.8 * rng.standard_normal((c, s, d))).astype(np.float32)
    kmat = np.asarray(jax.vmap(lambda x: jkc.exact_cache(x, GAMMA))(jnp.asarray(sv)))
    alpha = ((np.abs(rng.standard_normal((c, s))) * 0.2 + 0.01)
             * np.where(rng.random((c, s)) < 0.4, -1.0, 1.0)).astype(np.float32)
    count = np.array([s, budget - 1, s - 5][:c], np.int32)
    for q in range(c):
        alpha[q, count[q]:] = 0.0
    return sv, alpha, kmat, count, budget


@pytest.mark.parametrize("cached", [True, False])
def test_multi_merge_once_beyond_32_pairs_matches_the_reference(cached):
    sv, alpha, kmat, count, budget = _state(3)
    jt, tt = jax_default_table(), torch_default_table()
    t = tbudget._multi_merge_once(torch.tensor(sv), torch.tensor(alpha),
                                  torch.tensor(kmat) if cached else None, torch.tensor(count),
                                  GAMMA, "lookup-wd", tt, budget, P)
    executed = 0
    for q in range(count.shape[0]):
        j = jbudget._multi_merge_once(jnp.asarray(sv[q]), jnp.asarray(alpha[q]),
                                      jnp.asarray(kmat[q]) if cached else None,
                                      jnp.int32(count[q]), GAMMA, "lookup-wd", jt, budget, P,
                                      "ref")
        n = int(j[3])
        assert int(t[3][q]) == n
        executed = max(executed, int(count[q]) - n)
        if count[q] <= budget:
            assert n == count[q]
            continue
        np.testing.assert_allclose(t[0][q].numpy(), np.asarray(j[0]), atol=TOL, rtol=0)
        np.testing.assert_allclose(t[1][q].numpy(), np.asarray(j[1]), atol=TOL, rtol=TOL)
        if cached:
            np.testing.assert_allclose(t[2][q, :n, :n].numpy(), np.asarray(j[2])[:n, :n],
                                       atol=TOL, rtol=0)
    assert executed > 32          # one event retired more pairs than the old lists held


def test_drain_at_40_pairs_matches_the_reference():
    sv, alpha, kmat, count, budget = _state(5, c=1)
    args = dict(budget=budget, strategy="multi-merge", merge_batch=P)
    j = jbudget.run_maintenance(jnp.asarray(sv[0]), jnp.asarray(alpha[0]), jnp.asarray(kmat[0]),
                                jnp.int32(count[0]), jnp.int32(0), GAMMA, jax_default_table(),
                                **args)
    t = tbudget.run_maintenance(torch.tensor(sv[0]), torch.tensor(alpha[0]),
                                torch.tensor(kmat[0]), torch.tensor(count[0]),
                                torch.tensor(0, dtype=torch.int32), GAMMA, torch_default_table(),
                                **args)
    assert (int(t[3]), int(t[4])) == (int(j[3]), int(j[4]))
    assert int(t[3]) <= budget
    n = int(t[3])
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t[2][:n, :n].numpy(), np.asarray(j[2])[:n, :n], atol=TOL, rtol=0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0 (the library is never reached)."""

    def get_device(self):
        return 0


class _Reached(Exception):
    pass


def _reach(*_a, **_k):
    raise _Reached


def test_wrappers_take_more_than_32_pairs_to_the_library(monkeypatch):
    monkeypatch.setattr(_build, "function", _reach)
    monkeypatch.setattr(_build, "load", _reach)
    card = lambda t: torch.Tensor._make_subclass(_OnCard, t)
    tab = card(torch_default_table().wd_table)
    c, s = 2, 100
    args = [card(torch.zeros(c, s)), card(torch.zeros(c, P, s)),
            card(torch.zeros(c, P, dtype=torch.int64)), card(torch.zeros(c, P)),
            card(torch.zeros(c, dtype=torch.int32)), 50, tab, tab]
    with pytest.raises(_Reached):
        merge_multi.multi_merge_choose_cuda(*args)
    train_step_kernel.cluster_size.cache_clear()
    train_step_kernel._smem_need.cache_clear()
    with pytest.raises(_Reached):     # the cluster choice asks the library first
        train_step_kernel.cluster_size(False, c, s, 8, 8, True, P)
    assert _build.pair_choice_bytes(P) == (P * 23 + 15) // 16 * 16
    assert _build.pair_choice_bytes(P) % 16 == 0
