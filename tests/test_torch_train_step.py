"""The port's fused train step (``step_engine="pallas"``) against the JAX reference (CPU).

On the CPU ``ops.train_step`` runs the plain version ``kernels.ref.train_step_fused``
(the CUDA kernel ``csrc/train_step.cu`` is held against it on the card by
``chip_smoke.py``).  Inputs are made with numpy from a seed and go through
the reference's ``ops.train_step`` (its oracle, and where stated its Pallas
kernel in interpret mode) and through the port.  Integer state must be
equal; floats agree within rtol 1e-5 and atol 5e-5, the reference's own
kernel-against-oracle tolerance, and never tighter than the 3.3e-5 by which
the reference's fused and composed steps differ (ROADMAP.md Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro.core import kernel_cache as jkc
from repro.core import multiclass as jmc
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import bsgd as tbsgd
from repro_torch.core import budget as tbudget
from repro_torch.core import kernel_cache as tkc
from repro_torch.core import multiclass as tmc
from repro_torch.core.lookup import default_table as torch_default_table
from repro_torch.data import make_blobs_multiclass, make_two_moons
from repro_torch.kernels import ops, ref

CPU = "cpu"
GAMMA = 0.5
LAMBDA = 1e-3
STEP_FIELDS = ("sv_x", "alpha", "kmat", "count", "step", "n_inserts", "n_merges")
RTOL, ATOL = 1e-5, 5e-5       # the reference's kernel-vs-oracle tolerance
EPOCH_ATOL = 5e-5             # no tighter than the reference's own 3.3e-5 drift
# The class-axis epochs: at C = 4 under multi-merge the port sits 9.0e-5 off
# the reference in one merged z of 400 entries (alpha 2.6e-5), with its
# composed engine exactly as far off as its fused one: the last-bit drift of
# earlier steps moves a merge's m by a few ulps at a cell of the h table
# where h jumps between its two mirror modes (ROADMAP.md Queue 3,
# test_multi_merge_epoch_parts_at_a_mirror_mode_cell).
MC_EPOCH_ATOL = 1e-4


@pytest.fixture(scope="module")
def tables():
    jt = jbsgd.BSGDConfig(method="lookup-wd").table()
    return jt, torch_default_table()


def _step_args(c, slots, dim, count, batch, seed=0):
    """A stacked near-budget state with exact caches and one minibatch, as
    numpy arrays (the reference's ``tests/kernels/test_train_step.py`` recipe)."""
    rng = np.random.default_rng(seed)
    sv = rng.normal(size=(c, slots, dim)).astype(np.float32)
    al = (rng.normal(size=(c, slots)) * 0.05).astype(np.float32)
    al[:, count:] = 0.0
    km = np.asarray(jax.vmap(lambda x: jkc.exact_cache(x, GAMMA))(jnp.asarray(sv)))
    rng = np.random.default_rng(seed + 99)
    xb = rng.normal(size=(batch, dim)).astype(np.float32)
    yb = np.where(rng.random((c, batch)) < 0.5, -1.0, 1.0).astype(np.float32)
    k_bb = np.asarray(jops.rbf_matrix(jnp.asarray(xb), jnp.asarray(xb), GAMMA, impl="ref"))
    cnt = np.full((c,), count, np.int32)
    step = np.full((c,), 5, np.int32)
    zero = np.zeros((c,), np.int32)
    return [sv, al, km, cnt, step, zero, zero.copy(), xb, yb, k_bb]


def _jax_step(args, table, impl, bf16=False, **kw):
    ins = [jnp.asarray(a) for a in args]
    if bf16:
        ins[0] = ins[0].astype(jnp.bfloat16)
    return jops.train_step(*ins, table, impl=impl, **kw)


def _torch_step(args, table, bf16=False, **kw):
    ins = [torch.tensor(a) for a in args]
    if bf16:
        ins[0] = ins[0].to(torch.bfloat16)
    return ops.train_step(*ins, table, **kw)


def _assert_step(jout, tout, *, tag, atol=ATOL):
    for name, j, t in zip(STEP_FIELDS, jout, tout):
        j = np.asarray(jnp.asarray(j).astype(jnp.float32)) if j.dtype == jnp.bfloat16 \
            else np.asarray(j)
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=f"{tag}:{name}")
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=atol, err_msg=f"{tag}:{name}")


def _kw(budget, batch, maintenance):
    return dict(budget=budget, lambda_=LAMBDA, gamma=GAMMA, batch_size=batch,
                maintenance=maintenance, merge_batch=4)


@pytest.mark.parametrize("maintenance", ["merge", "multi-merge"])
@pytest.mark.parametrize("c,budget,dim,batch", [(2, 120, 128, 8), (3, 40, 6, 8), (1, 60, 17, 4)])
def test_fused_step_matches_reference(maintenance, c, budget, dim, batch, tables):
    args = _step_args(c, budget + batch, dim, budget - 2, batch, seed=c * 13 + budget)
    kw = _kw(budget, batch, maintenance)
    jout = _jax_step(args, tables[0], "ref", **kw)
    tout = _torch_step(args, tables[1], **kw)
    assert int(tout[6].sum()) > 0                 # events actually fire
    _assert_step(jout, tout, tag=maintenance)


@pytest.mark.parametrize("maintenance", ["merge", "multi-merge"])
def test_fused_step_matches_reference_pallas_kernel(maintenance, tables):
    """Against the TPU kernel's semantics: its Pallas kernel in interpret mode."""
    args = _step_args(3, 48, 6, 38, 8, seed=5)
    kw = _kw(40, 8, maintenance)
    jout = _jax_step(args, tables[0], "pallas_interpret", **kw)
    tout = _torch_step(args, tables[1], **kw)
    assert int(tout[6].sum()) > 0
    _assert_step(jout, tout, tag=maintenance)


def test_fused_step_under_budget_rounds_are_noops(tables):
    """Far below the budget the step inserts and never merges: the masked
    rounds leave the insert's state bit for bit (the composed insert)."""
    args = _step_args(2, 108, 10, 20, 8, seed=1)
    kw = _kw(100, 8, "merge")
    tout = _torch_step(args, tables[1], **kw)
    _assert_step(_jax_step(args, tables[0], "ref", **kw), tout, tag="noop")
    assert int(tout[6].sum()) == 0 and int(tout[5].sum()) > 0
    sv, al, km, cnt, step, nin, nmg, xb, yb, k_bb = (torch.tensor(a) for a in args)
    cfg = tbsgd.BSGDConfig(budget=100, lambda_=LAMBDA, gamma=GAMMA, batch_size=8,
                           use_kernel_cache=True)
    k_b = ref.rbf_matrix(xb, sv.reshape(-1, 10), GAMMA).view(8, 2, 108).transpose(0, 1)
    mid = tbsgd.insert_from_rows(cfg, tbsgd.SVMState(sv, al, cnt, step, nin, nmg, km), xb, yb,
                                 k_b.contiguous(), k_bb)
    for name, want, got in zip(STEP_FIELDS, (mid.sv_x, mid.alpha, mid.kmat, mid.count, mid.step,
                                             mid.n_inserts, mid.n_merges), tout):
        assert torch.equal(got, want), name


def test_fused_step_bf16_bank(tables):
    """A bf16 bank against the reference's Pallas kernel (its plain RBF squares
    a bf16 bank in bf16, ROADMAP.md Queue 3), at its own bf16 tolerance."""
    args = _step_args(2, 48, 9, 38, 8, seed=3)
    args[2] = np.asarray(jax.vmap(lambda x: jkc.exact_cache(x, GAMMA))(
        jnp.asarray(args[0], jnp.bfloat16)))
    kw = _kw(40, 8, "multi-merge")
    jout = _jax_step(args, tables[0], "pallas_interpret", bf16=True, **kw)
    tout = _torch_step(args, tables[1], bf16=True, **kw)
    assert tout[0].dtype == torch.bfloat16 and tout[2].dtype == torch.float32
    assert int(tout[6].sum()) > 0
    _assert_step(jout, tout, tag="bf16", atol=1e-2)


@pytest.mark.parametrize("maintenance", ["merge", "multi-merge"])
def test_fused_step_chain_of_three(maintenance, tables):
    """State feeds state for three steps; integer state exact at every step."""
    args = _step_args(2, 32, 7, 22, 8, seed=4)
    kw = _kw(24, 8, maintenance)
    jst = [jnp.asarray(a) for a in args[:7]]
    tst = [torch.tensor(a) for a in args[:7]]
    rng = np.random.default_rng(11)
    for i in range(3):
        xb = rng.normal(size=(8, 7)).astype(np.float32)
        yb = np.where(rng.random((2, 8)) < 0.5, -1.0, 1.0).astype(np.float32)
        k_bb = np.asarray(jops.rbf_matrix(jnp.asarray(xb), jnp.asarray(xb), GAMMA, impl="ref"))
        jst = list(jops.train_step(*jst, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(k_bb),
                                   tables[0], impl="ref", **kw))
        tst = list(ops.train_step(*tst, torch.tensor(xb), torch.tensor(yb), torch.tensor(k_bb),
                                  tables[1], **kw))
        _assert_step(jst, tst, tag=f"{maintenance} step {i}")
    assert int(tst[6].sum()) > 0


def _event_state(seed, c=4, s=24, d=5, budget=17):
    """Stacked classes for one multi-merge round: exact caches, mixed signs,
    class 0 full, class 1 at the budget (over clear), class 2 a removal
    fallback (its smallest-|alpha| SV is the only positive one)."""
    rng = np.random.default_rng(seed)
    sv = rng.normal(size=(c, s, d)).astype(np.float32)
    km = np.asarray(jax.vmap(lambda x: jkc.exact_cache(x, GAMMA))(jnp.asarray(sv)))
    al = (np.abs(rng.normal(size=(c, s))) * 0.1 + 0.01).astype(np.float32)
    al *= np.where(rng.random((c, s)) < 0.4, -1.0, 1.0).astype(np.float32)
    count = np.array([s, budget, s, budget + 2] + [s] * (c - 4), np.int32)
    al[2] = -np.abs(al[2])
    al[2, 1] = 0.001
    for q in range(c):
        al[q, count[q]:] = 0.0
    return [torch.tensor(a) for a in (sv, al, km)], torch.tensor(count), budget


@pytest.mark.parametrize("merge_batch", [1, 3, 4, 8])
def test_multi_merge_event_equals_budget_multi_merge_once(merge_batch):
    (sv, al, km), count, budget = _event_state(merge_batch)
    table = torch_default_table()
    over = count > budget
    got = ref.multi_merge_event(sv, al, km, count, over, table.h_table, table.wd_table,
                                budget=budget, merge_batch=merge_batch)
    want = tbudget._multi_merge_once(sv, al, km, count, GAMMA, "lookup-wd", table, budget,
                                     merge_batch)
    assert not over[1] and bool(over[0]) and bool(over[2])
    for g, w, orig in zip(got, want, (sv, al, km, count)):
        assert torch.equal(g[over], w[over])
        assert torch.equal(g[~over], orig[~over])     # over clear: bitwise untouched
    # class 2's fixed partner (slot 1) had no same-sign partner: it was removed
    assert int(got[3][2]) < int(count[2]) and not (got[1][2] > 0).any()


def _blobs(c, n=160, dim=5):
    x, y = make_blobs_multiclass(np.random.default_rng(c), n, dim, c, sep=1.0, noise=1.0)
    return x, y, np.random.default_rng(c + 1).permutation(n)


def _mc_kw(maintenance, engine):
    return dict(budget=12, lambda_=LAMBDA, gamma=GAMMA, batch_size=8, method="lookup-wd",
                use_kernel_cache=True, maintenance=maintenance, step_engine=engine)


def _torch_mc_epoch(c, kw, data):
    x, y, perm = data
    cfg = tmc.MulticlassSVMConfig.create(c, **kw)
    return tmc.train_epoch_multiclass(cfg, cfg.table(), tmc.init_multiclass_state(
        cfg, x.shape[1], device=CPU), x, y, perm, device=CPU)


def _as_jax(state):
    return jbsgd.SVMState(**convert.state_to_numpy(state))


@pytest.mark.parametrize("maintenance", ["merge", "multi-merge"])
@pytest.mark.parametrize("c", [2, 4])
def test_fused_epoch_multiclass_matches_reference(maintenance, c):
    data = _blobs(c)
    x, y, perm = data
    kw = _mc_kw(maintenance, "pallas")
    jcfg = jmc.MulticlassSVMConfig.create(c, **kw)
    js = jmc.train_epoch_multiclass(jcfg, jcfg.table(), jmc.init_multiclass_state(jcfg, 5),
                                    jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm),
                                    impl="ref")
    ts = _torch_mc_epoch(c, kw, data)
    assert (ts.n_merges > 0).all() and (ts.count <= 12).all()
    assert_state_parity(js, _as_jax(ts), atol_float=MC_EPOCH_ATOL, atol_cache=MC_EPOCH_ATOL,
                        rtol=RTOL, context=f"{maintenance} C={c}")


def test_multi_merge_epoch_parts_at_a_mirror_mode_cell(monkeypatch):
    """Where the C = 4 multi-merge epoch of
    ``test_fused_epoch_multiclass_matches_reference`` leaves the reference by
    more than 1e-5: at each step the port also steps from the reference's own
    state, so the two port steps differ only by the state they start from.
    Until the parting step the port's step from the reference's state stays
    within 5e-7 of the reference's step (last-bit differences: the margin
    rows' sums and the multiply-adds XLA contracts); at the parting step the
    two port steps differ by more than 1e-5 in sv_x with the integer state
    equal, and the pair whose h moves lies in the h table's mirror-mode
    cell: kappa below e^-2, m within 1e-2 of 1/2, where h jumps between its
    two maxima (corners 0 and 1), so a change of m by a few ulps moves h,
    and the merged z, by ~400 times as much."""
    c = 4
    x, y, perm = _blobs(c)
    kw = _mc_kw("multi-merge", "pallas")
    jcfg, tcfg = (pkg.MulticlassSVMConfig.create(c, **kw) for pkg in (jmc, tmc))
    jt, tt = jcfg.table(), tcfg.table()
    js = jmc.init_multiclass_state(jcfg, 5)
    ts = tmc.init_multiclass_state(tcfg, 5, device=CPU)
    scored = []
    plain_scores = ref.multi_merge_scores_classes

    def spy(*args):
        out = plain_scores(*args)
        scored.append((args, out[1]))
        return out

    monkeypatch.setattr(ref, "multi_merge_scores_classes", spy)
    as_torch = lambda st: tbsgd.SVMState(**{f: None if getattr(st, f) is None else
                                            torch.tensor(np.asarray(getattr(st, f)))
                                            for f in st._fields})
    for i in range(len(x) // 8):
        xb, yb = x[perm[i * 8:(i + 1) * 8]], y[perm[i * 8:(i + 1) * 8]]
        scored.clear()
        from_ref = tmc.train_step_multiclass(tcfg, tt, as_torch(js), torch.tensor(xb),
                                             torch.tensor(yb).long())
        rounds_ref = list(scored)
        scored.clear()
        ts = tmc.train_step_multiclass(tcfg, tt, ts, torch.tensor(xb), torch.tensor(yb).long())
        js = jmc.train_step_multiclass(jcfg, jt, js, jnp.asarray(xb), jnp.asarray(yb),
                                       impl="ref")
        gap = (from_ref.sv_x - ts.sv_x).abs().max().item()
        for f in ("count", "n_inserts", "n_merges"):
            assert torch.equal(getattr(from_ref, f), getattr(ts, f)), (i, f)
        if gap <= 1e-5:
            assert np.abs(from_ref.sv_x.numpy() - np.asarray(js.sv_x)).max() <= 5e-7, i
            continue
        # the parting step: find the pair whose h moved and where it sits
        moved = []
        for (args, h_r), (_, h_p) in zip(rounds_ref, scored):
            alpha, kappa, _, a_min = args[:4]
            k, q, j = np.unravel_index(int((h_r - h_p).abs().argmax()), h_r.shape)
            m = float(a_min[k, q] / (a_min[k, q] + alpha[k, j]))
            moved.append((float((h_r - h_p).abs().max()), m, float(kappa[k, q, j])))
        dh, m, kap = max(moved)
        g = tt.h_table.shape[0] - 1
        cell = tt.h_table[int(m * g):int(m * g) + 2, int(kap * g)]
        assert dh > 1e-5 and abs(m - 0.5) < 1e-2 and kap < np.exp(-2.0)
        assert sorted(cell.tolist()) == [0.0, 1.0]
        return
    pytest.fail("the epoch never left the reference by more than 1e-5")


@pytest.fixture(scope="module")
def moons():
    x, y = make_two_moons(np.random.default_rng(0), 200, noise=0.15)
    return x, y, np.random.default_rng(1).permutation(200)


def _binary_cfg(pkg, maintenance, engine):
    return pkg.BSGDConfig(**_mc_kw(maintenance, engine))


def _torch_binary_epoch(maintenance, engine, moons):
    x, y, perm = moons
    cfg = _binary_cfg(tbsgd, maintenance, engine)
    return tbsgd.train_epoch(cfg, cfg.table(), tbsgd.init_state(cfg, 2, device=CPU), x, y,
                             perm, device=CPU)


@pytest.mark.parametrize("maintenance", ["merge", "multi-merge"])
def test_fused_binary_epoch_matches_reference(maintenance, moons):
    """The binary step lifted to C = 1, a two-moons epoch against the reference's."""
    x, y, perm = moons
    jcfg = _binary_cfg(jbsgd, maintenance, "pallas")
    js = jbsgd.train_epoch(jcfg, jcfg.table(), jbsgd.init_state(jcfg, 2), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(perm), impl="ref")
    ts = _torch_binary_epoch(maintenance, "pallas", moons)
    assert int(ts.n_merges) > 0 and int(ts.count) <= 12
    assert_state_parity(js, _as_jax(ts), atol_float=EPOCH_ATOL, atol_cache=EPOCH_ATOL,
                        rtol=RTOL, context=maintenance)
    assert float(tbsgd.accuracy(ts, x, y, GAMMA, device=CPU)) > 0.8


@pytest.mark.parametrize("maintenance", ["merge", "multi-merge"])
@pytest.mark.parametrize("c", [1, 3])
def test_fused_epoch_matches_composed_epoch(maintenance, c, moons):
    """The port's fused step against its composed step over the same epoch:
    integer state exact, floats within the epoch tolerance."""
    if c == 1:
        st = {e: _torch_binary_epoch(maintenance, e, moons) for e in ("composed", "pallas")}
    else:
        data = _blobs(c)
        st = {e: _torch_mc_epoch(c, _mc_kw(maintenance, e), data) for e in ("composed", "pallas")}
    assert int(st["composed"].n_merges.sum()) > 0
    assert_state_parity(_as_jax(st["composed"]), _as_jax(st["pallas"]), atol_float=EPOCH_ATOL,
                        atol_cache=EPOCH_ATOL, rtol=RTOL, context=f"{maintenance} C={c}")


def test_cache_matches_rebuild_after_fused_training():
    x, y, _ = _blobs(3)
    cfg = tmc.MulticlassSVMConfig.create(3, **_mc_kw("multi-merge", "pallas"))
    st = tmc.fit_multiclass(cfg, x, y, epochs=2, seed=0, device=CPU)
    assert (st.n_merges > 0).all()
    # I1 within the reference's 5e-4 for this test; I2 and I3 exactly
    tkc.check_invariants(st.kmat, st.sv_x, st.count, GAMMA, tol=5e-4)


def _state_snapshot(state):
    return [None if t is None else t.clone() for t in state]


def test_fused_train_step_leaves_the_input_state_unchanged(moons):
    x, y, _ = moons
    cfg = _binary_cfg(tbsgd, "merge", "pallas")
    st = tbsgd.train_epoch(cfg, cfg.table(), tbsgd.init_state(cfg, 2, device=CPU), x, y,
                           np.arange(64), device=CPU)
    before = _state_snapshot(st)
    out = tbsgd.train_step(cfg, cfg.table(), st, torch.tensor(x[64:72]), torch.tensor(y[64:72]))
    for name, t, b in zip(st._fields, st, before):
        assert torch.equal(t, b), name
    assert int(out.step) == int(st.step) + 1 and not torch.equal(out.alpha, st.alpha)


def test_fused_train_step_multiclass_leaves_the_input_state_unchanged():
    x, y, perm = _blobs(3)
    cfg = tmc.MulticlassSVMConfig.create(3, **_mc_kw("multi-merge", "pallas"))
    st = tmc.train_epoch_multiclass(cfg, cfg.table(), tmc.init_multiclass_state(
        cfg, 5, device=CPU), x, y, perm[:96], device=CPU)
    before = _state_snapshot(st)
    out = tmc.train_step_multiclass(cfg, cfg.table(), st, torch.tensor(x[perm[96:104]]),
                                    torch.tensor(y[perm[96:104]]))
    for name, t, b in zip(st._fields, st, before):
        assert torch.equal(t, b), name
    assert (out.step == st.step + 1).all() and not torch.equal(out.alpha, st.alpha)


def test_train_step_dispatch(tables):
    args = [torch.tensor(a) for a in _step_args(2, 20, 4, 10, 4, seed=8)]
    kw = _kw(16, 4, "merge")
    with pytest.raises(ValueError, match="CUDA"):
        ops.train_step(*args, tables[1], impl="cuda", **kw)
    ops.reset_launch_counts()
    out = ops.train_step(*args, tables[1], **kw)
    assert out[0] is args[0] and out[3] is args[3]           # updated in place
    assert ops.launch_counts()["train_step"] == 0
