"""The port's BDCA solver (``repro_torch.core.bdca``) against the JAX reference (CPU).

The same numpy inputs go through ``repro.core.bdca`` (its kernels through
``impl="ref"``) and the port, whose ascent runs ``ref.bdca_ascent``, the
plain version of the ``bdca_ascent`` kernel, on the CPU.  Tolerances:

  * ``box_from_lambda`` equal; ``dual_objective`` and ``kkt_residual``
    within 1e-5 relative (fp32 matrix products summed in another order);
  * ``ascent_rounds`` within 2e-5: the reference's ``f = k @ b`` is an XLA
    matrix-vector product, the port's an ascending sum, so the margins
    start a few ulps apart;
  * a step and an epoch: integer state exact, floats within the epoch
    tolerance of the port's other parity tests (``atol_float=3e-5, rtol=1e-5``,
    no tighter than the ~3e-5 between the reference's own engines,
    ROADMAP.md Queue 3).

Then the port's own versions of the reference's dual properties
(``tests/core/test_bdca.py``), on fixed seeds, and the streaming, publishing
and serving paths under ``solver="bdca"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity

import repro.core as jcore
from repro.core import bdca as jbdca
from repro.core import bsgd as jbsgd
from repro.core import multiclass as jmc
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch.core import bdca as tbdca
from repro_torch.core import bsgd as tbsgd
from repro_torch.core import multiclass as tmc
from repro_torch.kernels import ops

CPU = "cpu"
SLOTS, DIM = 24, 4
ATOL, RTOL = 3e-5, 1e-5
BASE = dict(budget=16, lambda_=1e-3, gamma=2.0, batch_size=4, solver="bdca",
            use_kernel_cache=True, bdca_C=1.5, unroll_maintenance=True)


def _working_set(seed, count, C, frozen=(), at_box=()):
    """The reference test's working set: a unit-diagonal exact Gram (fp32),
    signed coefficients inside the box, zeros past the watermark; slots in
    ``frozen`` set to 0 and those in ``at_box`` to +-C."""
    rng = np.random.default_rng(seed)
    sv = rng.normal(0.0, 1.0, (SLOTS, DIM)).astype(np.float32)
    d2 = ((sv[:, None] - sv[None, :]) ** 2).sum(-1)
    kmat = np.exp(-0.8 * d2).astype(np.float32)
    np.fill_diagonal(kmat, 1.0)
    a = rng.uniform(0.0, C, SLOTS) * rng.choice([-1.0, 1.0], SLOTS)
    a[list(frozen)] = 0.0
    a[list(at_box)] = C * np.sign(a[list(at_box)] + 1e-3)
    a[count:] = 0.0
    return a.astype(np.float32), kmat, np.int32(count)


def _t(a, k, n):
    return torch.tensor(a), torch.tensor(k), torch.tensor(n)


def _j(a, k, n):
    return jnp.asarray(a), jnp.asarray(k), jnp.asarray(n)


def _as_jax(state):
    return jbsgd.SVMState(**convert.state_to_numpy(state))


# ---------------------------------------------------------------------------
# the dual math against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,lam,cap", [(100, 1e-2, 4.0), (1000, 1e-3, 4.0), (500, 1e-2, 4.0),
                                       (3000, 1e-5, 4.0), (1000, 1e-5, 2.0), (26_049, 1e-5, 4.0),
                                       (60_000, 1e-5, 4.0)])
def test_box_from_lambda_equals_reference(n, lam, cap):
    assert tbdca.box_from_lambda(n, lam, cap=cap) == jbdca.box_from_lambda(n, lam, cap=cap)


@pytest.mark.parametrize("n,lam,match", [(0, 1e-3, "n="), (100, 0.0, "lambda_"),
                                         (100, -1.0, "lambda_")])
def test_box_from_lambda_refuses_as_reference(n, lam, match):
    with pytest.raises(ValueError, match=match):
        jbdca.box_from_lambda(n, lam)
    with pytest.raises(ValueError, match=match):
        tbdca.box_from_lambda(n, lam)


@pytest.mark.parametrize("seed,count,C", [(0, 24, 1.0), (1, 10, 0.5), (2, 3, 4.0), (3, 17, 2.2)])
def test_dual_objective_and_kkt_residual_equal_reference(seed, count, C):
    a, k, n = _working_set(seed, count, C, frozen=(1,), at_box=(2,))
    for fn_t, fn_j, args in ((tbdca.dual_objective, jbdca.dual_objective, ()),
                             (tbdca.kkt_residual, jbdca.kkt_residual, (C,))):
        got = float(fn_t(*_t(a, k, n), *args))
        want = float(fn_j(*_j(a, k, n), *args))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5), fn_t.__name__


@pytest.mark.parametrize("rounds", [1, 2, 4])
@pytest.mark.parametrize("case", ["full", "below", "frozen", "box"])
def test_ascent_rounds_equals_reference(rounds, case):
    count = 14 if case == "below" else SLOTS
    C = 0.6 if case == "box" else 1.5
    frozen = (0, 5, 11) if case == "frozen" else ()
    at_box = (3, 8, 20) if case == "box" else ()
    a, k, n = _working_set(7 + rounds, count, C, frozen=frozen, at_box=at_box)
    a_in = torch.tensor(a)
    got = tbdca.ascent_rounds(a_in, torch.tensor(k), torch.tensor(n), C, rounds).numpy()
    assert torch.equal(a_in, torch.tensor(a))                  # the caller's alpha is kept
    want = np.asarray(jbdca.ascent_rounds(*_j(a, k, n), C, rounds))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[count:], 0.0)
    np.testing.assert_array_equal(got[list(frozen)], 0.0)
    assert np.abs(got).max() <= np.float32(C)


def test_ascent_kernel_op_is_in_place_and_zeroes_stale_slots():
    """``ops.bdca_ascent`` (the plain version on the CPU) writes alpha in
    place, zeroes slots past the count, and a stacked call equals each class
    on its own, bit for bit."""
    sets = [_working_set(s, c, 1.0) for s, c in ((0, 24), (1, 9), (2, 0))]
    a = torch.tensor(np.stack([w[0] for w in sets]))
    a[1, 20] = 0.7                                             # garbage past count 9
    k = torch.tensor(np.stack([w[1] for w in sets]))
    n = torch.tensor([w[2] for w in sets])
    rows = [ops.bdca_ascent(a[q].clone(), k[q], n[q], 1.0, 2) for q in range(3)]
    out = ops.bdca_ascent(a, k, n, 1.0, 2)
    assert out is a
    for q in range(3):
        assert torch.equal(a[q], rows[q])
    assert a[1, 9:].eq(0).all() and a[2].eq(0).all()


def test_ascent_kernel_wrapper_refuses_bad_inputs():
    """The CUDA wrapper checks before it touches a library (CPU tensors,
    dtypes, shapes), so a bad call fails here without a card."""
    from repro_torch.kernels import bdca as kbdca
    a, k, n = _t(*_working_set(0, 10, 1.0))
    with pytest.raises(ValueError, match="CUDA"):
        kbdca.bdca_ascent_cuda(a, k, n, 1.0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bdca_ascent(a, k, n, 1.0, 2, impl="cuda")


# ---------------------------------------------------------------------------
# one step, binary and stacked
# ---------------------------------------------------------------------------

def _trained(kw, n=120, seed=3):
    """A reference state trained on blobs: the step tests' starting point."""
    x, y = tdata.make_blobs(np.random.default_rng(seed), n, DIM)
    cfg = jbsgd.BSGDConfig(**kw)
    perm = np.random.default_rng(seed + 1).permutation(n)
    st = jbsgd.train_epoch(cfg, cfg.table(), jbsgd.init_state(cfg, DIM), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(perm), impl="ref")
    return st, x, y


@pytest.mark.parametrize("fn", ["insert_from_rows", "train_step_from_rows"])
def test_step_from_rows_equals_reference_binary(fn):
    js, x, y = _trained(BASE)
    cfg_j, cfg_t = jbsgd.BSGDConfig(**BASE), tbsgd.BSGDConfig(**BASE)
    xb, yb = x[:4], y[:4]
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                  device=CPU)
    k_b = np.asarray(jcore.bsgd.kops.rbf_matrix(jnp.asarray(xb), js.sv_x, 2.0, impl="ref"))
    k_bb = np.asarray(jcore.bsgd.kops.rbf_matrix(jnp.asarray(xb), jnp.asarray(xb), 2.0,
                                                 impl="ref"))
    jargs = (js, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(k_b), jnp.asarray(k_bb))
    targs = (ts, torch.tensor(xb), torch.tensor(yb), torch.tensor(k_b), torch.tensor(k_bb))
    if fn == "insert_from_rows":
        want = jbdca.insert_from_rows(cfg_j, *jargs)
        got = tbdca.insert_from_rows(cfg_t, *targs)
        assert int(got.count) > cfg_t.budget                   # the drain's input
    else:
        want = jbdca.train_step_from_rows(cfg_j, cfg_j.table(), *jargs, impl="ref")
        got = tbsgd.train_step_from_rows(cfg_t, cfg_t.table(), *targs)
    assert_state_parity(want, _as_jax(got), atol_float=ATOL, rtol=RTOL)


def test_insert_from_rows_equals_reference_stacked():
    """The stacked insert (every class in one call, one ascent for all)
    against the reference's vmap of its binary insert."""
    import jax
    kw = {**BASE, "budget": 10}
    x, y = tdata.make_blobs_multiclass(np.random.default_rng(4), 150, DIM, 3, sep=1.5)
    jcfg = jmc.MulticlassSVMConfig.create(3, **kw)
    perm = np.random.default_rng(5).permutation(150)
    js = jmc.train_epoch_multiclass(jcfg, jcfg.table(), jmc.init_multiclass_state(jcfg, DIM),
                                    jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm),
                                    impl="ref")
    xb, yb = jnp.asarray(x[:4]), jnp.asarray(y[:4])
    k_b = jmc.class_kernel_rows(js.sv_x, xb, kw["gamma"], impl="ref")
    k_bb = jcore.bsgd.kops.rbf_matrix(xb, xb, kw["gamma"], impl="ref")
    y_ovr = jmc.ovr_targets(yb, 3)
    want = jax.vmap(lambda s, yc, kc: jbdca.insert_from_rows(jcfg.binary, s, xb, yc, kc, k_bb))(
        js, y_ovr, k_b)
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                  device=CPU)
    got = tbdca.insert_from_rows(tbsgd.BSGDConfig(**kw), ts, torch.tensor(x[:4]),
                                 torch.tensor(np.asarray(y_ovr)), torch.tensor(np.asarray(k_b)),
                                 torch.tensor(np.asarray(k_bb)))
    assert (got.count > kw["budget"]).any()
    assert_state_parity(want, _as_jax(got), atol_float=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# epochs with the permutation passed in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(maintenance_engine="pallas"),
                                dict(maintenance="multi-merge"),
                                dict(maintenance="removal-project")],
                         ids=["merge-xla", "merge-pallas", "multi-merge", "removal-project"])
def test_train_epoch_equals_reference_binary(kw):
    kw = {**BASE, **kw}
    x, y = tdata.make_two_moons(np.random.default_rng(1), 300, noise=0.3)
    perm = np.random.default_rng(2).permutation(300)
    jcfg, tcfg = jbsgd.BSGDConfig(**kw), tbsgd.BSGDConfig(**kw)
    js = jbsgd.train_epoch(jcfg, jcfg.table(), jbsgd.init_state(jcfg, 2), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(perm), impl="ref")
    ts = tbsgd.train_epoch(tcfg, tcfg.table(), tbsgd.init_state(tcfg, 2, device=CPU), x, y,
                           perm, device=CPU)
    assert int(ts.count) == kw["budget"] and int(ts.n_merges) > 20
    assert_state_parity(js, _as_jax(ts), atol_float=ATOL, rtol=RTOL, context=str(kw))
    tcore.kernel_cache.check_invariants(ts.kmat, ts.sv_x, ts.count, kw["gamma"])
    acc = float(tbsgd.accuracy(ts, x, y, kw["gamma"], device=CPU))
    assert round(acc * 300) == round(float(jbsgd.accuracy(js, jnp.asarray(x), jnp.asarray(y),
                                                          kw["gamma"], impl="ref")) * 300)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_train_epoch_equals_reference_class_axis(engine):
    kw = {**BASE, "budget": 10, "gamma": 0.25, "bdca_C": 1.0, "maintenance_engine": engine}
    x, y = tdata.make_blobs_multiclass(np.random.default_rng(0), 240, 6, 3, sep=1.0, noise=1.0)
    perm = np.random.default_rng(1).permutation(240)
    jcfg = jmc.MulticlassSVMConfig.create(3, **kw)
    tcfg = tmc.MulticlassSVMConfig.create(3, **kw)
    js = jmc.train_epoch_multiclass(jcfg, jcfg.table(), jmc.init_multiclass_state(jcfg, 6),
                                    jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm),
                                    impl="ref")
    ts = tmc.train_epoch_multiclass(tcfg, tcfg.table(), tmc.init_multiclass_state(tcfg, 6,
                                                                                   device=CPU),
                                    x, y, perm, device=CPU)
    assert (ts.n_merges > 50).all()
    assert_state_parity(js, _as_jax(ts), atol_float=ATOL, rtol=RTOL, context=engine)
    tcore.kernel_cache.check_invariants(ts.kmat, ts.sv_x, ts.count, kw["gamma"])


# ---------------------------------------------------------------------------
# the port's own dual properties (the reference's, on fixed seeds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,count,C", [(11, 24, 0.3), (12, 9, 1.0), (13, 20, 4.0),
                                          (14, 2, 2.5), (15, 16, 0.8)])
def test_dual_properties(seed, count, C):
    """Over sweeps: the dual objective never falls, the box holds, the
    watermark stays, the KKT residual after 8 sweeps is no worse (and lower
    when it started above 0.5)."""
    a, k, n = _t(*_working_set(seed, count, C))
    prev = float(tbdca.dual_objective(a, k, n))
    r0 = float(tbdca.kkt_residual(a, k, n, C))
    b = a
    for _ in range(8):
        b = tbdca.ascent_rounds(b, k, n, C, 1)
        cur = float(tbdca.dual_objective(b, k, n))
        assert cur >= prev - 1e-4 * max(1.0, abs(prev)), (cur, prev)
        prev = cur
        assert (b.abs() <= C * (1 + 1e-6)).all()
        assert b[count:].eq(0).all()
    r1 = float(tbdca.kkt_residual(b, k, n, C))
    assert r1 <= r0 + 1e-4
    if r0 > 0.5:
        assert r1 < r0


def test_frozen_coordinates_stay_frozen():
    a, k, n = _t(*_working_set(3, 10, 1.0, frozen=(4,)))
    out = tbdca.ascent_rounds(a, k, n, 1.0, 3)
    assert float(out[4]) == 0.0


@pytest.mark.parametrize("knob,match", [
    (dict(solver="bdca", use_kernel_cache=False), "use_kernel_cache"),
    (dict(solver="bdca", use_kernel_cache=True, step_engine="pallas"), "step_engine"),
    (dict(solver="bdca", use_kernel_cache=True, bdca_rounds=0), "bdca_rounds"),
    (dict(solver="bdca", use_kernel_cache=True, bdca_C=0.0), "bdca_C"),
    (dict(solver="smo"), "solver"),
])
def test_config_validation_raises_where_reference_does(knob, match):
    with pytest.raises(ValueError, match=match):
        jbsgd.BSGDConfig(**knob)
    with pytest.raises(ValueError, match=match):
        tbsgd.BSGDConfig(**knob)


def test_adult_standin_accuracy_equals_reference():
    """The ADULT stand-in of ``chip_smoke.py`` (blobs at d = 123, sep 0.25,
    noise 1.3; gamma 2^-7, lambda 1e-5, batch 1, the box clamped to 4 by
    ``box_from_lambda``), cut to 1,000 rows and a budget of 40: the port's
    BDCA epoch reaches the reference's test accuracy to the row, and the
    reference's BDCA stays well below its BSGD on the same rows (every row
    violates the margin at this box): the gap between the solvers is the
    solver's, not the port's."""
    x, y = tdata.make_blobs(np.random.default_rng(0), 1_000, 123, sep=0.25, noise=1.3)
    (xtr, ytr), (xte, yte) = tdata.train_test_split(x, y, test_frac=0.2)
    perm = np.random.default_rng(1).permutation(xtr.shape[0])
    kw = dict(budget=40, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1, use_kernel_cache=True)
    dual = dict(kw, solver="bdca", bdca_C=tbdca.box_from_lambda(xtr.shape[0], 1e-5),
                bdca_rounds=2)
    right = {}
    for name, k in (("bsgd", kw), ("bdca", dual)):
        cfg = jbsgd.BSGDConfig(**k)
        st = jbsgd.train_epoch(cfg, cfg.table(), jbsgd.init_state(cfg, 123), jnp.asarray(xtr),
                               jnp.asarray(ytr), jnp.asarray(perm), impl="ref")
        right[name] = round(float(jbsgd.accuracy(st, jnp.asarray(xte), jnp.asarray(yte),
                                                 cfg.gamma, impl="ref")) * len(yte))
    cfg = tbsgd.BSGDConfig(**dual)
    ts = tbsgd.train_epoch(cfg, cfg.table(), tbsgd.init_state(cfg, 123, device=CPU), xtr, ytr,
                           perm, device=CPU)
    port = round(float(tbsgd.accuracy(ts, xte, yte, cfg.gamma, device=CPU)) * len(yte))
    assert int(ts.n_inserts) == xtr.shape[0]
    assert port == right["bdca"], (port, right)
    assert right["bdca"] <= right["bsgd"] - 0.05 * len(yte), right


# ---------------------------------------------------------------------------
# streaming, publishing, serving
# ---------------------------------------------------------------------------

def _bit_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        assert (u is None and v is None) or (u.dtype == v.dtype and torch.equal(u, v)), name


def test_fit_stream_kill_and_resume_bitwise(tmp_path):
    cfg = tbsgd.BSGDConfig(**{**BASE, "budget": 12, "gamma": 0.5})
    x, y = tdata.make_blobs(np.random.default_rng(1), 230, DIM)
    src = tdata.ArrayChunks(x, y, 37)                          # ragged chunks
    ref = tcore.fit_stream(cfg, src, epochs=2, seed=5, device=CPU)
    ck = str(tmp_path / "ck")
    tcore.fit_stream(cfg, src, epochs=2, seed=5, ckpt_dir=ck, ckpt_every=2, max_chunks=9,
                     device=CPU)                               # a hard kill
    resumed = tcore.fit_stream(cfg, src, epochs=2, seed=5, ckpt_dir=ck, ckpt_every=2,
                               device=CPU)
    _bit_equal(ref, resumed)
    assert int(ref.n_merges) > 0


def test_fit_multiclass_stream_equals_in_memory_epoch():
    cfg = tmc.MulticlassSVMConfig.create(3, **{**BASE, "budget": 10, "gamma": 0.5,
                                               "maintenance_engine": "pallas"})
    x, y = tdata.make_blobs_multiclass(np.random.default_rng(2), 181, DIM, 3, sep=2.0)
    src = tdata.ArrayChunks(x, y, 29)
    streamed = tcore.fit_multiclass_stream(cfg, src, epochs=1, seed=3, device=CPU)
    perm = tdata.epoch_permutation(src, tdata.EpochKey(3, 0))
    mem = tmc.train_epoch_multiclass(cfg, cfg.table(), tmc.init_multiclass_state(cfg, DIM,
                                                                                  device=CPU),
                                     x, y, perm, device=CPU)
    _bit_equal(streamed, mem)


def test_fit_stream_publishes_bank():
    cfg = tbsgd.BSGDConfig(**{**BASE, "budget": 12, "gamma": 0.5})
    x, y = tdata.make_blobs(np.random.default_rng(1), 160, DIM)
    bank = tcore.ModelBank()
    st = tcore.fit_stream(cfg, tdata.ArrayChunks(x, y, 40), epochs=1, seed=0, bank=bank,
                          publish_every=2, device=CPU)
    assert bank.version >= 1
    _, model = bank.current()
    np.testing.assert_array_equal(tcore.predict_labels(model, torch.tensor(x)).numpy(),
                                  tbsgd.predict(st, x, cfg.gamma, device=CPU).numpy())


def test_prequential_stream_trains_bdca():
    cfg = tbsgd.BSGDConfig(**{**BASE, "budget": 12, "gamma": 0.5})
    x, y = tdata.make_blobs(np.random.default_rng(6), 240, DIM)
    src = tdata.ArrayChunks(x, y, 40)
    a = tcore.prequential_stream(cfg, src, device=CPU)
    b = tcore.prequential_stream(cfg, src, device=CPU)
    assert a["n_rows"] == 240 and a["mistakes"] == b["mistakes"]
    _bit_equal(a["state"], b["state"])
    assert int(a["state"].n_merges) > 0 and a["chunk_acc"][-1] > 0.7


@pytest.mark.parametrize("multi", [False, True])
def test_export_model_serves_as_decision_function(multi):
    if multi:
        cfg = tmc.MulticlassSVMConfig.create(3, **{**BASE, "budget": 10, "gamma": 0.5})
        x, y = tdata.make_blobs_multiclass(np.random.default_rng(2), 120, DIM, 3, sep=2.0)
        st = tmc.fit_multiclass(cfg, x, y, epochs=1, seed=1, device=CPU)
        want = tmc.decision_function_multiclass(st, x, 0.5, device=CPU)
        labels = tmc.predict_multiclass(st, x, 0.5, device=CPU)
    else:
        cfg = tbsgd.BSGDConfig(**{**BASE, "budget": 12, "gamma": 0.5})
        x, y = tdata.make_blobs(np.random.default_rng(2), 120, DIM)
        st = tbsgd.fit(cfg, x, y, epochs=1, seed=1, device=CPU)
        want = tbsgd.decision_function(st, x, 0.5, device=CPU)[None]
        labels = tbsgd.predict(st, x, 0.5, device=CPU)
    model = tcore.export_model(st, 0.5)
    xt = torch.tensor(x)
    np.testing.assert_allclose(tcore.serve_scores(model, xt).numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tcore.predict_labels(model, xt).numpy(), labels.numpy())

