"""The port's prequential (test-then-train) pass against the JAX reference (CPU).

``prequential_stream`` visits chunks in natural order, so the two packages
see the same rows with no order passed in.  The same ``DriftChunks`` stream
(numpy in both packages) goes through both: ``mistakes``, ``chunk_mistakes``
and ``chunk_acc`` must be equal, integer state exact, floats within
``atol_float=3e-5, rtol=1e-5`` (the port's epoch tolerance).  Then the
port's own contracts: two passes agree bit for bit, and the drift bites.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

import repro.core as jcore
import repro.data as jdata
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch import data as tdata

CPU = "cpu"
DIM = 6
ATOL, RTOL = 3e-5, 1e-5


def _cfg(pkg, maint="merge", batch=8, **kw):
    return pkg.BSGDConfig(budget=16, lambda_=1e-3, gamma=0.5, method="lookup-wd",
                          batch_size=batch, use_kernel_cache=True, maintenance=maint, **kw)


def _binary_arrays(n=640):
    return tdata.make_blobs(np.random.default_rng(0), n, DIM, sep=2.0)


def _drifted(pkg, x, y, chunk, *, classes=None, shift=False):
    src = pkg.ArrayChunks(x, y, chunk)
    kw = dict(flip=pkg.label_flip_schedule(src.n_chunks, start=0.5, prob=1.0))
    if shift:
        kw["shift"] = pkg.mean_shift_schedule(src.n_chunks, DIM, magnitude=1.0, kind="ramp")
    return pkg.DriftChunks(src, n_classes=classes, seed=7, **kw)


def _record(r):
    return r["n_rows"], r["mistakes"], r["mistake_rate"], r["chunk_mistakes"], r["chunk_acc"]


def _state(r):
    return jcore.SVMState(**convert.state_to_numpy(r["state"]))


@pytest.mark.parametrize("engine", [dict(), dict(step_engine="pallas")], ids=["composed", "fused"])
@pytest.mark.parametrize("chunk,shift", [(64, False), (60, True)], ids=["aligned", "remainder"])
def test_binary_prequential_matches_reference(engine, chunk, shift):
    x, y = _binary_arrays()
    j = jcore.prequential_stream(_cfg(jcore, **engine), _drifted(jdata, x, y, chunk, shift=shift),
                                 impl="ref")
    t = tcore.prequential_stream(_cfg(tcore, **engine), _drifted(tdata, x, y, chunk, shift=shift),
                                 device=CPU)
    assert _record(t) == _record(j)
    assert_state_parity(j["state"], _state(t), atol_float=ATOL, rtol=RTOL)


def _mc_cfgs(**engine):
    return [pkg.MulticlassSVMConfig.create(3, budget=16, lambda_=1e-3, gamma=0.5, batch_size=8,
                                           use_kernel_cache=True, **engine)
            for pkg in (jcore, tcore)]


def _mc_arrays():
    return tdata.make_blobs_multiclass(np.random.default_rng(2), 330, DIM, 3, sep=2.5)


@pytest.mark.parametrize("engine", [dict(), dict(step_engine="pallas")], ids=["composed", "fused"])
def test_multiclass_prequential_matches_reference(engine):
    """The class axis, with 7 remainder rows a chunk (55 = 6 * 8 + 7): scored,
    not trained.  The record and the integer state must be equal; the float
    state parts from the reference at a mirror-mode merge (held by
    ``test_multiclass_prequential_floats_part_only_at_a_mirror_mode_cell``)."""
    x, y = _mc_arrays()
    jcfg, tcfg = _mc_cfgs(**engine)
    j = jcore.prequential_stream(jcfg, _drifted(jdata, x, y, 55, classes=3), impl="ref")
    t = tcore.prequential_stream(tcfg, _drifted(tdata, x, y, 55, classes=3), device=CPU)
    assert _record(t) == _record(j)
    assert t["n_rows"] == 330
    assert int(t["state"].n_inserts.sum()) <= 6 * 8 * 6 * 3
    for f in ("count", "step", "n_inserts", "n_merges"):
        np.testing.assert_array_equal(np.asarray(getattr(j["state"], f)),
                                      getattr(t["state"], f).numpy(), err_msg=f)


@pytest.mark.parametrize("engine", [dict(), dict(step_engine="pallas")], ids=["composed", "fused"])
def test_multiclass_prequential_floats_part_only_at_a_mirror_mode_cell(monkeypatch, engine):
    """The multiclass pass's trained steps in lockstep, for both engines:
    from the reference's state before each step, the port's step must give
    the reference's next state within 5e-6, except at a step where one of
    the port's merges has m within 1e-2 of 1/2 and kappa below e^-2 in an
    h-table cell whose corners span 0 to 1 (the mirror-mode cell, ROADMAP.md
    Queue 3): there h jumps between its two maxima on a last-bit change of
    m, and only the integer state must be equal.  On this drifted stream
    that happens after the drift point, where fresh SVs of equal |alpha|
    merge (m = 1/2).  The composed engine's merges are read at
    ``merge_pick``, the fused engine's at the plain ``merge_event`` rounds
    of its step."""
    from repro.core import multiclass as jmc
    from repro_torch.core import budget as tbudget
    from repro_torch.core import multiclass as tmc
    from repro_torch.kernels import ref as tref

    jcfg, tcfg = _mc_cfgs(**engine)
    jt, tt = jcfg.table(), tcfg.table()
    picks = []
    real_pick, real_event = tbudget.kops.merge_pick, tref.merge_event

    def spy(alpha, kappa, count, i_min, a_min, table, impl="auto"):
        out = real_pick(alpha, kappa, count, i_min, a_min, table, impl=impl)
        picks.append((alpha, kappa, a_min, out[0]))
        return out

    def spy_event(sv_x, alpha, kmat, count, over, h_table, wd_table, decisions=None):
        a0, k0 = alpha.clone(), kmat.clone()
        made = torch.zeros((alpha.shape[0], 3), dtype=torch.int32)
        out = real_event(sv_x, alpha, kmat, count, over, h_table, wd_table, decisions=made)
        q = torch.nonzero(over).flatten()
        i_min = made[q, 0].long()
        picks.append((a0[q], k0[q, i_min], a0[q, i_min], made[q, 1]))
        return out

    monkeypatch.setattr(tbudget.kops, "merge_pick", spy)
    monkeypatch.setattr(tref, "merge_event", spy_event)
    g = tt.h_table.shape[0] - 1

    def mirror_mode(alpha, kappa, a_min, j):
        for q in range(alpha.shape[0]):
            jq = int(j[q])
            m = float(a_min[q] / (a_min[q] + alpha[q, jq]))
            kap = float(kappa[q, jq])
            cell = tt.h_table[int(m * g):int(m * g) + 2, int(kap * g):int(kap * g) + 2]
            if abs(m - 0.5) < 1e-2 and kap < np.exp(-2.0) and \
                    float(cell.min()) < 0.05 and float(cell.max()) > 0.95:
                return True
        return False

    x, y = _mc_arrays()
    src = _drifted(tdata, x, y, 55, classes=3)
    js = jmc.init_multiclass_state(jcfg, DIM)
    parted = []
    for c in range(src.n_chunks):
        xb, yb = src.load(c)
        for i in range(xb.shape[0] // 8):
            xs, ys = xb[i * 8:(i + 1) * 8], yb[i * 8:(i + 1) * 8]
            picks.clear()
            ts = tmc.train_step_multiclass(
                tcfg, tt, tcore.SVMState(*(None if v is None else torch.tensor(np.asarray(v))
                                           for v in js)),
                torch.tensor(xs), torch.tensor(ys).long())
            js = jmc.train_step_multiclass(jcfg, jt, js, jnp.asarray(xs), jnp.asarray(ys),
                                           impl="ref")
            got = jcore.SVMState(**convert.state_to_numpy(ts))
            if all(np.allclose(np.asarray(getattr(js, f)), getattr(got, f), rtol=RTOL, atol=5e-6)
                   for f in ("sv_x", "alpha", "kmat")):
                assert_state_parity(js, got, atol_float=5e-6, atol_cache=5e-6, rtol=RTOL,
                                    context=f"chunk {c} step {i}")
                continue
            for f in ("count", "step", "n_inserts", "n_merges"):
                np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(got, f))
            assert any(mirror_mode(*p) for p in picks), f"chunk {c} step {i} parts elsewhere"
            parted.append((c, i))
    assert parted and parted[0][0] >= src.n_chunks // 2


@pytest.mark.parametrize("engine", [dict(), dict(step_engine="pallas")], ids=["composed", "fused"])
def test_prequential_pass_is_deterministic_and_the_drift_bites(engine):
    x, y = _binary_arrays()
    a, b = (tcore.prequential_stream(_cfg(tcore, **engine), _drifted(tdata, x, y, 64),
                                     device=CPU)
            for _ in range(2))
    assert _record(a) == _record(b)
    for u, v in zip(a["state"], b["state"]):
        assert u is None and v is None or torch.equal(u, v)
    assert a["chunk_acc"][0] == 0.0                # a cold model scores sign(0) = 0
    mid = len(a["chunk_acc"]) // 2
    assert np.mean(a["chunk_acc"][mid:]) < np.mean(a["chunk_acc"][1:mid])
    assert a["chunk_acc"][mid] < a["chunk_acc"][mid - 1] - 0.3


def test_prequential_continues_a_state_and_skips_quarantined_chunks():
    x, y = _binary_arrays(n=320)
    cfg = _cfg(tcore)
    first = tcore.prequential_stream(cfg, tdata.ArrayChunks(x[:160], y[:160], 64), device=CPU)
    before = [None if t is None else t.clone() for t in first["state"]]
    rep = tdata.ResilienceReport()
    src = tdata.FaultyChunks(tdata.ArrayChunks(x[160:], y[160:], 32),
                             tdata.FaultSchedule(fatal_chunks=(2,)))
    r = tcore.prequential_stream(cfg, src, state=first["state"], retry=tdata.RetryPolicy(),
                                 report=rep, device=CPU)
    assert rep.quarantined_chunks() == [2]
    assert r["n_rows"] == 160 - 32 and len(r["chunk_acc"]) == 4
    for u, v in zip(first["state"], before):       # the caller's state is untouched
        assert u is None and v is None or torch.equal(u, v)
    assert int(r["state"].step) > int(first["state"].step)


def test_prequential_rejects_a_non_config():
    with pytest.raises(TypeError, match="BSGDConfig"):
        tcore.prequential_stream(object(), tdata.ArrayChunks(*_binary_arrays(64), 32),
                                 device=CPU)
