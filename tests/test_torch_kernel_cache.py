"""The port's kernel cache and cached maintenance against the JAX reference (CPU).

Caches made with numpy from a seed go through every ``repro.core.kernel_cache``
function and its port, then through each maintenance strategy, the fused
event engine and whole cached epochs.  Integer state must be equal; float
state agrees within the tolerance stated at each check: cache entries are
exp/log of float32 values, where XLA's and PyTorch's last bits may differ
(1e-6 on entries in [0, 1]), and whole epochs are held no tighter than the
~3e-5 by which the reference's own engines differ (ROADMAP.md Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro.core import budget as jbudget
from repro.core import kernel_cache as jkc
from repro.core.lookup import default_table as jax_default_table
from repro_torch import convert
from repro_torch.core import bsgd as tbsgd
from repro_torch.core import budget as tbudget
from repro_torch.core import kernel_cache as tkc
from repro_torch.core.lookup import default_table as torch_default_table
from repro_torch.data import make_two_moons

CPU = "cpu"
GAMMA = 0.7
ENTRY_TOL = 1e-6     # one exp/log rounding on a unit-scale cache entry


def _bank(seed, s=20, d=5, count=None):
    rng = np.random.default_rng(seed)
    sv = (0.6 * rng.standard_normal((s, d))).astype(np.float32)
    count = s if count is None else count
    alpha = ((np.abs(rng.standard_normal(s)) + 0.05)
             * np.where(rng.random(s) < 0.4, -1.0, 1.0)).astype(np.float32)
    alpha[count:] = 0.0
    kmat = np.asarray(jkc.exact_cache(jnp.asarray(sv), GAMMA))
    return sv, alpha, kmat, count


def _close(got, want, tol=ENTRY_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("stacked", [False, True])
def test_exact_cache_matches_reference(stacked):
    sv = np.stack([_bank(s)[0] for s in range(3)])
    got = tkc.exact_cache(torch.tensor(sv if stacked else sv[0]), GAMMA).numpy()
    want = np.stack([np.asarray(jkc.exact_cache(jnp.asarray(v), GAMMA)) for v in sv])
    _close(got, want if stacked else want[0])
    assert (np.diagonal(got, axis1=-2, axis2=-1) == 1.0).all()


def test_z_rows_match_reference():
    _, _, kmat, _ = _bank(1)
    got = tkc.merge_z_row(torch.tensor(kmat), torch.tensor(3), torch.tensor(11), 0.3)
    want = jkc.merge_z_row(jnp.asarray(kmat), 3, 11, 0.3)
    _close(got, want)
    got = tkc.z_row_from_rows(torch.tensor(kmat[3]), torch.tensor(kmat[11]),
                              torch.tensor(kmat[3, 11]), 0.3)
    _close(got, jkc.z_row_from_rows(jnp.asarray(kmat[3]), jnp.asarray(kmat[11]),
                                    kmat[3, 11], 0.3))
    # the clamp at log k = 0 keeps near-duplicate entries at or below 1
    assert float(got.max()) <= 1.0


def test_insert_rows_matches_reference():
    sv, _, kmat, _ = _bank(2)
    rng = np.random.default_rng(5)
    s = kmat.shape[0]
    idx = np.array([4, s, 9, s], np.int32)                    # two rows dropped
    k_new_old = rng.random((4, s)).astype(np.float32)
    k_new_new = rng.random((4, 4)).astype(np.float32)
    got = tkc.insert_rows(torch.tensor(kmat), torch.tensor(idx), torch.tensor(k_new_old),
                          torch.tensor(k_new_new))
    want = jkc.insert_rows(jnp.asarray(kmat), jnp.asarray(idx), jnp.asarray(k_new_old),
                           jnp.asarray(k_new_new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))     # pure moves: bit for bit


@pytest.mark.parametrize("pair", [(2, 7, 19), (7, 2, 7), (0, 5, 12)])
def test_apply_merge_and_removal_match_reference(pair):
    i, j, last = pair
    _, _, kmat, _ = _bank(3)
    got = tkc.apply_merge(torch.tensor(kmat), torch.tensor(i), torch.tensor(j),
                          torch.tensor(last), 0.35)
    _close(got, jkc.apply_merge(jnp.asarray(kmat), i, j, last, 0.35))
    got = tkc.apply_removal(torch.tensor(kmat), torch.tensor(i), torch.tensor(last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jkc.apply_removal(
        jnp.asarray(kmat), i, last)))


def test_apply_multi_merge_and_permute_match_reference():
    _, _, kmat, _ = _bank(4)
    s = kmat.shape[0]
    a = np.array([1, 5, 9, 14], np.int32)
    b = np.array([3, 6, 12, 17], np.int32)
    h = np.array([0.2, 0.5, 0.7, 0.9], np.float32)
    w = np.array([1, s, 9, 14], np.int32)                     # pair 1 fell back
    got = tkc.apply_multi_merge(torch.tensor(kmat), torch.tensor(a), torch.tensor(b),
                                torch.tensor(h), torch.tensor(w))
    want = jkc.apply_multi_merge(jnp.asarray(kmat), jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(h), jnp.asarray(w))
    _close(got, want)
    g = got.numpy()
    np.testing.assert_array_equal(g, g.T)                     # I2 exactly
    perm = np.random.default_rng(6).permutation(s)
    np.testing.assert_array_equal(
        tkc.permute(torch.tensor(kmat), torch.tensor(perm)).numpy(),
        np.asarray(jkc.permute(jnp.asarray(kmat), jnp.asarray(perm))))


def test_stacked_updates_equal_per_class_updates():
    """The class-axis form of each update is the single-cache form, class by class."""
    km = np.stack([_bank(s)[2] for s in range(3)])
    t = torch.tensor
    i, j, last = np.array([2, 5, 0]), np.array([7, 1, 4]), np.array([19, 18, 17])
    h = np.array([0.1, 0.5, 0.8], np.float32)
    got = tkc.apply_merge(t(km), t(i), t(j), t(last), t(h))
    for q in range(3):
        np.testing.assert_array_equal(
            got[q].numpy(), tkc.apply_merge(t(km[q]), t(i[q]), t(j[q]), t(last[q]),
                                            t(h[q])).numpy())
    got = tkc.apply_removal(t(km), t(i), t(last))
    for q in range(3):
        np.testing.assert_array_equal(
            got[q].numpy(), tkc.apply_removal(t(km[q]), t(i[q]), t(last[q])).numpy())


def test_check_invariants_names_each_violation():
    sv, _, kmat, count = _bank(8)
    t = torch.tensor
    tkc.check_invariants(t(kmat), t(sv), count, GAMMA)
    tkc.check_invariants(t(np.stack([kmat, kmat])), t(np.stack([sv, sv])), t([count, 5]), GAMMA)
    bad = kmat.copy()
    bad[2, 3] += 1e-3
    with pytest.raises(tkc.CacheInvariantError, match="I2"):
        tkc.check_invariants(t(bad), t(sv), count, GAMMA)
    bad = kmat.copy()
    bad[4, 4] = 0.999
    with pytest.raises(tkc.CacheInvariantError, match="I3"):
        tkc.check_invariants(t(bad), t(sv), count, GAMMA)
    bad = kmat.copy()
    bad[2, 3] = bad[3, 2] = bad[2, 3] + 1e-3
    with pytest.raises(tkc.CacheInvariantError, match=r"\[class 1\]: I1"):
        tkc.check_invariants(t(np.stack([kmat, bad])), t(np.stack([sv, sv])),
                             t([count, count]), GAMMA)
    assert tkc.invariant_errors(t(np.stack([kmat, bad])), t(np.stack([sv, sv])),
                                t([count, count]), GAMMA)[1] >= 1e-3


def test_cached_merge_once_matches_reference():
    sv, alpha, kmat, count = _bank(9, count=18)
    jt, tt = jax_default_table(), torch_default_table()
    merge_once = jax.jit(jbudget._merge_once, static_argnums=(5,))
    jsv, jal, jkm, jc, ji = merge_once(jnp.asarray(sv), jnp.asarray(alpha), jnp.asarray(kmat),
                                       jnp.int32(count), GAMMA, "lookup-wd", jt)
    tsv, tal, tkm, tcnt, ti = tbudget._merge_once(
        torch.tensor(sv[None]), torch.tensor(alpha[None]), torch.tensor(kmat[None]),
        torch.tensor([count], dtype=torch.int32), GAMMA, "lookup-wd", tt)
    assert (int(ti.i_min[0]), int(ti.j_star[0]), bool(ti.merged[0])) == \
        (int(ji.i_min), int(ji.j_star), bool(ji.merged))
    assert int(tcnt[0]) == int(jc) == count - 1
    _close(tsv[0], jsv)
    _close(tal[0], jal)
    _close(tkm[0], jkm)


STRATEGIES = ["merge", "multi-merge", "removal", "removal-project", "quantized"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_maintenance_with_cache_matches_reference(strategy):
    budget, over = 14, 4
    sv, alpha, kmat, _ = _bank(10, s=budget + over)
    count = budget + over
    jt, tt = jax_default_table(), torch_default_table()
    kw = dict(budget=budget, strategy=strategy, method="lookup-wd", merge_batch=3)
    jout = jbudget.run_maintenance(jnp.asarray(sv), jnp.asarray(alpha), jnp.asarray(kmat),
                                   jnp.int32(count), jnp.int32(0), GAMMA, jt, unroll=over,
                                   impl="ref", **kw)
    tout = tbudget.run_maintenance(torch.tensor(sv), torch.tensor(alpha), torch.tensor(kmat),
                                   torch.tensor(count, dtype=torch.int32),
                                   torch.tensor(0, dtype=torch.int32), GAMMA, tt, unroll=over,
                                   **kw)
    jsv, jal, jkm, jc, jn = (np.asarray(a) for a in jout)
    tsv, tal, tkm, tc, tn = (a.numpy() for a in tout)
    assert (int(tc), int(tn)) == (int(jc), int(jn))
    assert int(tc) == budget
    c = int(tc)
    np.testing.assert_allclose(tsv, jsv, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tal, jal, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tkm[:c, :c], jkm[:c, :c], atol=1e-5, rtol=0)
    tkc.check_invariants(torch.tensor(tkm), torch.tensor(tsv), c, GAMMA)


def _stack(c=3, s=16, d=5, seed=20):
    banks = [_bank(seed + q, s=s, d=d) for q in range(c)]
    sv, alpha, kmat = (np.stack([b[k] for b in banks]) for k in range(3))
    return sv, alpha, kmat


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
def test_run_maintenance_classes_matches_reference(impl):
    budget, unroll = 11, 4
    sv, alpha, kmat = _stack()
    count = np.array([16, 11, 13], np.int32)         # excess 5 > unroll, 0, 2
    for q in range(3):
        alpha[q, count[q]:] = 0.0
    jt, tt = jax_default_table(), torch_default_table()
    j = jbudget.run_maintenance_classes(jnp.asarray(sv), jnp.asarray(alpha), jnp.asarray(kmat),
                                        jnp.asarray(count), jnp.zeros(3, jnp.int32), jt,
                                        budget=budget, impl=impl, unroll=unroll)
    ins = [torch.tensor(a) for a in (sv, alpha, kmat, count, np.zeros(3, np.int32))]
    t = tbudget.run_maintenance_classes(*ins, tt, budget=budget, unroll=unroll)
    assert torch.equal(ins[1], torch.tensor(alpha))   # the inputs are left as they were
    jsv, jal, jkm, jc, jn = (np.asarray(a) for a in j)
    tsv, tal, tkm, tc, tn = (a.numpy() for a in t)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, [12, 11, 11])    # unroll bounds the rounds
    np.testing.assert_array_equal(tn, [4, 0, 2])
    np.testing.assert_array_equal(tsv[1], sv[1])       # the class at budget: untouched
    np.testing.assert_array_equal(tkm[1], kmat[1])
    _close(tsv, jsv)
    _close(tal, jal)
    _close(tkm, jkm)


def test_run_maintenance_classes_drains_and_exits_early():
    sv, alpha, kmat = _stack(c=4)
    tt = torch_default_table()
    args = [torch.tensor(a) for a in (sv, alpha, kmat)]
    under = torch.tensor([10, 9, 12, 3], dtype=torch.int32)
    out = tbudget.run_maintenance_classes(*args, under, torch.zeros(4, dtype=torch.int32), tt,
                                          budget=12, unroll=3)
    for a, b in zip(out[:3], args):
        assert torch.equal(a, b)                       # no class over budget: a no-op
    over = torch.tensor([15, 13, 12, 16], dtype=torch.int32)
    args[1] = torch.where(torch.arange(16) < over[:, None], args[1], 0.0)
    sv2, al2, km2, c2, n2 = tbudget.run_maintenance_classes(
        *args, over, torch.zeros(4, dtype=torch.int32), tt, budget=12, unroll=4)
    np.testing.assert_array_equal(c2.numpy(), [12, 12, 12, 12])
    np.testing.assert_array_equal(n2.numpy(), [3, 1, 0, 4])
    assert (al2.numpy()[:, 12:] == 0).all()


@pytest.fixture(scope="module")
def moons():
    x, y = make_two_moons(np.random.default_rng(1), 240, noise=0.3)
    return x, y, np.random.default_rng(2).permutation(240)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(maintenance="multi-merge", batch_size=4),
    dict(maintenance="removal-project"),
    dict(maintenance="quantized", batch_size=2),
    dict(maintenance_engine="pallas", batch_size=4),
    dict(method="lookup-h", maintenance="multi-merge", batch_size=4),
], ids=["merge", "multi-merge", "removal-project", "quantized", "engine-pallas",
        "multi-merge-lookup-h"])
def test_cached_binary_epoch_matches_reference(kw, moons):
    x, y, perm = moons
    kw = dict(budget=10, lambda_=1e-3, gamma=2.0, use_kernel_cache=True,
              unroll_maintenance=True, **kw)
    jcfg, tcfg = jbsgd.BSGDConfig(**kw), tbsgd.BSGDConfig(**kw)
    js = jbsgd.train_epoch(jcfg, jcfg.table(), jbsgd.init_state(jcfg, 2), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(perm), impl="ref")
    ts = tbsgd.train_epoch(tcfg, tcfg.table(), tbsgd.init_state(tcfg, 2, device=CPU), x, y,
                           perm, device=CPU)
    assert int(ts.n_merges) >= 10
    # integers bit for bit; floats within the reference engines' own drift
    assert_state_parity(js, jbsgd.SVMState(**convert.state_to_numpy(ts)), atol_float=3e-5,
                        rtol=1e-5, context=str(kw))
    tkc.check_invariants(ts.kmat, ts.sv_x, ts.count, kw["gamma"])


def test_kmeans_and_seed_codebook_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((60, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jcent = jbudget.kmeans_codebook(key, jnp.asarray(x), 5, iters=6)
    init = np.asarray(jax.random.choice(key, 60, (5,), replace=False))
    tcent = tbudget.kmeans_codebook(x, 5, iters=6, init=init)
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), atol=1e-5, rtol=1e-5)
    kw = dict(budget=8, use_kernel_cache=True, maintenance="quantized")
    jcfg, tcfg = jbsgd.BSGDConfig(**kw), tbsgd.BSGDConfig(**kw)
    js = jbudget.seed_codebook(jbsgd.init_state(jcfg, 3), jcent, 0.5)
    ts = tbudget.seed_codebook(tbsgd.init_state(tcfg, 3, device=CPU), tcent, 0.5)
    assert int(ts.count) == int(js.count) == 5
    np.testing.assert_allclose(ts.kmat.numpy(), np.asarray(js.kmat), atol=1e-5, rtol=0)
    tkc.check_invariants(ts.kmat, ts.sv_x, ts.count, 0.5)
    with pytest.raises(ValueError, match="kernel cache"):
        tbudget.seed_codebook(tbsgd.init_state(tbsgd.BSGDConfig(budget=8), 3, device=CPU),
                              tcent, 0.5)
