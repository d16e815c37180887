"""The port's streaming drivers (CPU): against the JAX reference under the
reference's own shuffle, and against the port's own in-memory epoch, bit for
bit.

  * One epoch of ``train_epoch_stream`` / ``train_epoch_multiclass_stream``
    against the reference's with the same ``jax.random`` key: a test-side
    object hands the port the reference's ``chunk_order`` and ``intra_perm``
    for that key.  Chunks are ragged, so rows carry across chunk boundaries.
    Integer state exact; floats within ``atol_float=3e-5, rtol=1e-5``, the
    port's epoch tolerance (``tests/test_torch_bsgd.py``).
  * The port's streamed epoch equals its in-memory ``train_epoch`` on
    ``epoch_permutation`` bit for bit; ``prefetch=2`` equals ``prefetch=0``;
    kill and resume equal the uninterrupted run, also past a torn step and
    at an epoch boundary.
  * Resilience against the reference: the same retries, quarantines and
    rollbacks, and the same state, for ``tests/core/test_resilience.py``'s
    schedules.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

import repro.core as jcore
import repro.data as jdata
from repro import checkpoint as jckpt
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch import data as tdata

CPU = "cpu"
DIM = 6
ATOL, RTOL = 3e-5, 1e-5
BASE = dict(budget=16, lambda_=1e-4, gamma=0.5, batch_size=4)
CONFIGS = {
    "composed": dict(),
    "cache-fused": dict(use_kernel_cache=True, step_engine="pallas"),
}
MC_CONFIGS = {
    "composed": dict(),
    "cache-fused": dict(use_kernel_cache=True, step_engine="pallas"),
    "event-engine": dict(use_kernel_cache=True, maintenance_engine="pallas"),
}
POLICY = dict(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0)


class JaxOrder:
    """The reference's ``jax.random`` orders for ``key``, as a key the port takes."""

    def __init__(self, key):
        self.key = key

    def chunk_order(self, n):
        return jdata.chunk_order(self.key, n)

    def intra_perm(self, chunk_id, n):
        return jdata.intra_perm(self.key, chunk_id, n)


def _binary(n=197, seed=0):
    return tdata.make_blobs(np.random.default_rng(seed), n, DIM)


def _multi(n=181, seed=1, classes=3):
    return tdata.make_blobs_multiclass(np.random.default_rng(seed), n, DIM, classes, sep=2.0)


def _cfg(pkg, kw):
    return pkg.BSGDConfig(**BASE, **kw)


def _mcfg(pkg, kw, classes=3):
    return pkg.MulticlassSVMConfig.create(classes, **BASE, **kw)


def _as_jax(state):
    return jcore.SVMState(**convert.state_to_numpy(state))


def _bit_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        if u is None:
            assert v is None, name
            continue
        assert u.dtype == v.dtype and torch.equal(u, v), name


# ---------------------------------------------------------------------------
# against the reference, under the reference's shuffle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_binary_stream_epoch_matches_reference(name):
    x, y = _binary()
    key = jax.random.PRNGKey(7)
    jcfg, tcfg = _cfg(jcore, CONFIGS[name]), _cfg(tcore, CONFIGS[name])
    js, jnext, jcarry = jcore.train_epoch_stream(jcfg, jcfg.table(), jcore.init_state(jcfg, DIM),
                                                 jdata.ArrayChunks(x, y, 37), key=key,
                                                 impl="ref")
    src = tdata.ArrayChunks(x, y, 37)
    assert any(n % 4 for n in src.chunk_lens)                 # rows carry
    ts, tnext, tcarry = tcore.train_epoch_stream(tcfg, tcfg.table(),
                                                 tcore.init_state(tcfg, DIM, device=CPU), src,
                                                 key=JaxOrder(key))
    assert jnext == tnext == src.n_chunks
    np.testing.assert_array_equal(jcarry[0], tcarry[0])
    assert int(ts.n_merges) > 0
    assert_state_parity(js, _as_jax(ts), atol_float=ATOL, rtol=RTOL, context=name)


@pytest.mark.parametrize("name", list(MC_CONFIGS))
def test_multiclass_stream_epoch_matches_reference(name):
    x, y = _multi()
    key = jax.random.PRNGKey(5)
    jcfg, tcfg = _mcfg(jcore, MC_CONFIGS[name]), _mcfg(tcore, MC_CONFIGS[name])
    js, _, _ = jcore.train_epoch_multiclass_stream(
        jcfg, jcfg.table(), jcore.init_multiclass_state(jcfg, DIM), jdata.ArrayChunks(x, y, 29),
        key=key, impl="ref")
    ts, _, _ = tcore.train_epoch_multiclass_stream(
        tcfg, tcfg.table(), tcore.init_multiclass_state(tcfg, DIM, device=CPU),
        tdata.ArrayChunks(x, y, 29), key=JaxOrder(key))
    assert bool((ts.n_merges > 0).all())
    assert_state_parity(js, _as_jax(ts), atol_float=ATOL, rtol=RTOL, context=name)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("chunk_rows", [40, 37])
def test_streamed_epoch_equals_in_memory_epoch(name, chunk_rows):
    x, y = _binary()
    cfg = _cfg(tcore, CONFIGS[name])
    src = tdata.ArrayChunks(x, y, chunk_rows)
    st = tcore.fit_stream(cfg, src, epochs=1, seed=3, device=CPU)
    perm = tdata.epoch_permutation(src, tdata.EpochKey(3, 0))
    mem = tcore.train_epoch(cfg, cfg.table(), tcore.init_state(cfg, DIM, device=CPU), x, y, perm,
                            device=CPU)
    _bit_equal(st, mem)


@pytest.mark.parametrize("name", list(MC_CONFIGS))
def test_streamed_multiclass_epoch_equals_in_memory_epoch(name):
    x, y = _multi()
    cfg = _mcfg(tcore, MC_CONFIGS[name])
    src = tdata.ArrayChunks(x, y, 29)
    st = tcore.fit_multiclass_stream(cfg, src, epochs=1, seed=2, device=CPU)
    perm = tdata.epoch_permutation(src, tdata.EpochKey(2, 0))
    mem = tcore.train_epoch_multiclass(cfg, cfg.table(),
                                       tcore.init_multiclass_state(cfg, DIM, device=CPU), x, y,
                                       perm, device=CPU)
    _bit_equal(st, mem)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefetch_is_bitwise_the_synchronous_run(multi, name, watchdog):
    watchdog(120)
    if multi:
        x, y = _multi()
        cfg, fit = _mcfg(tcore, CONFIGS[name]), tcore.fit_multiclass_stream
    else:
        x, y = _binary()
        cfg, fit = _cfg(tcore, CONFIGS[name]), tcore.fit_stream
    src = tdata.ArrayChunks(x, y, 37)
    plain = fit(cfg, src, epochs=2, seed=4, device=CPU)
    pre = fit(cfg, src, epochs=2, seed=4, prefetch=2, device=CPU)
    _bit_equal(plain, pre)
    assert not [t for t in threading.enumerate() if t.name == "chunk-stager"]


def test_file_and_libsvm_sources_train_as_arrays(tmp_path):
    x, y = _binary(n=160)
    cfg = _cfg(tcore, {})
    st_mem = tcore.fit_stream(cfg, tdata.ArrayChunks(x, y, 40), seed=2, device=CPU)
    paths = tdata.write_npz_chunks(str(tmp_path / "npz"), x, y, 40)
    _bit_equal(st_mem, tcore.fit_stream(cfg, tdata.FileChunks(paths), seed=2, device=CPU))
    # LIBSVM text rounds to 6 significant digits: stream the parsed rows alike
    path = str(tmp_path / "d.libsvm")
    tdata.dump_libsvm(path, x, y)
    xp, yp = tdata.parse_libsvm(path, n_features=DIM)
    _bit_equal(tcore.fit_stream(cfg, tdata.ArrayChunks(xp, yp, 40), seed=2, device=CPU),
               tcore.fit_stream(cfg, tdata.LibsvmChunks(path, 40, DIM), seed=2, device=CPU,
                                prefetch=1))


def test_train_epoch_stream_cursor_contract():
    x, y = _binary(n=200)
    cfg = _cfg(tcore, CONFIGS["cache-fused"])
    src, table, key = tdata.ArrayChunks(x, y, 40), cfg.table(), tdata.EpochKey(13, 0)
    full, nc, _ = tcore.train_epoch_stream(cfg, table, tcore.init_state(cfg, DIM, device=CPU),
                                           src, key=key)
    assert nc == src.n_chunks
    st, nc, carry = tcore.train_epoch_stream(cfg, table, tcore.init_state(cfg, DIM, device=CPU),
                                             src, key=key, max_chunks=2)
    assert nc == 2
    st, nc, _ = tcore.train_epoch_stream(cfg, table, st, src, key=key, start_chunk=nc,
                                         carry=carry)
    assert nc == src.n_chunks
    _bit_equal(full, st)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_stream_does_not_consume_caller_state(name):
    x, y = _binary(n=160)
    cfg = _cfg(tcore, CONFIGS[name])
    src = tdata.ArrayChunks(x, y, 40)
    st0 = tcore.fit_stream(cfg, src, seed=0, device=CPU)
    before = [None if t is None else t.clone() for t in st0]
    st1 = tcore.fit_stream(cfg, src, seed=1, state=st0, device=CPU)
    st2 = tcore.fit_stream(cfg, src, seed=1, state=st0, device=CPU)
    _bit_equal(st0, tcore.SVMState(*before))
    _bit_equal(st1, st2)
    assert int(st1.step) > int(st0.step)


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True])
def test_kill_and_resume_bitwise(tmp_path, multi, watchdog):
    """Killed after 9 chunks (no final checkpoint: a hard kill), resumed from
    the every-2-chunks checkpoint: the same bits as the uninterrupted run,
    across an epoch boundary, with ragged chunks and prefetch."""
    watchdog(120)
    if multi:
        x, y = _multi(n=230)
        cfg, fit = _mcfg(tcore, CONFIGS["cache-fused"]), tcore.fit_multiclass_stream
    else:
        x, y = _binary(n=230)
        cfg, fit = _cfg(tcore, CONFIGS["cache-fused"]), tcore.fit_stream
    src = tdata.ArrayChunks(x, y, 37)                          # 7 ragged chunks
    ref = fit(cfg, src, epochs=2, seed=5, device=CPU)
    ck = str(tmp_path / "ck")
    fit(cfg, src, epochs=2, seed=5, ckpt_dir=ck, ckpt_every=2, max_chunks=9, device=CPU,
        prefetch=2)
    steps = tckpt.all_steps(ck)
    assert steps and max(steps) <= 9
    meta = tckpt.load_metadata(ck, max(steps))
    assert meta == {"kind": "stream-epoch", "epoch": 1, "next_chunk": 2, "n_chunks": 7,
                    "seed": 5, "shuffle": "numpy"}
    resumed = fit(cfg, src, epochs=2, seed=5, ckpt_dir=ck, ckpt_every=2, device=CPU,
                  prefetch=2)
    _bit_equal(ref, resumed)


def test_resume_walks_back_past_a_torn_step(tmp_path):
    x, y = _binary(n=230)
    cfg = _cfg(tcore, {})
    src = tdata.ArrayChunks(x, y, 37)
    ref = tcore.fit_stream(cfg, src, epochs=1, seed=8, device=CPU)
    ck = str(tmp_path / "ck")
    tcore.fit_stream(cfg, src, epochs=1, seed=8, ckpt_dir=ck, ckpt_every=2, max_chunks=5,
                     device=CPU)
    assert tckpt.all_steps(ck) == [2, 4]
    arrays = os.path.join(ck, "step_00000004", "arrays.npz")
    with open(arrays, "r+b") as f:
        f.truncate(os.path.getsize(arrays) // 2)
    assert tckpt.latest_verifiable_step(ck) == 2
    resumed = tcore.fit_stream(cfg, src, epochs=1, seed=8, ckpt_dir=ck, ckpt_every=2,
                               device=CPU)
    _bit_equal(ref, resumed)


def test_resume_at_an_epoch_boundary(tmp_path):
    x, y = _binary(n=200)
    cfg = _cfg(tcore, CONFIGS["cache-fused"])
    src = tdata.ArrayChunks(x, y, 40)                          # 5 chunks
    ref = tcore.fit_stream(cfg, src, epochs=2, seed=6, device=CPU)
    ck = str(tmp_path / "ck")
    tcore.fit_stream(cfg, src, epochs=1, seed=6, ckpt_dir=ck, ckpt_every=5, device=CPU)
    assert tckpt.load_metadata(ck, 5)["next_chunk"] == 5
    _bit_equal(ref, tcore.fit_stream(cfg, src, epochs=2, seed=6, ckpt_dir=ck, ckpt_every=5,
                                     device=CPU))


def test_resume_refuses_mismatched_seed_or_chunking(tmp_path):
    x, y = _binary(n=200)
    cfg = _cfg(tcore, {})
    src = tdata.ArrayChunks(x, y, 40)
    ck = str(tmp_path / "ck")
    tcore.fit_stream(cfg, src, seed=5, ckpt_dir=ck, ckpt_every=2, max_chunks=2, device=CPU)
    with pytest.raises(ValueError, match="seed"):
        tcore.fit_stream(cfg, src, seed=6, ckpt_dir=ck, device=CPU)
    with pytest.raises(ValueError, match="chunks"):
        tcore.fit_stream(cfg, tdata.ArrayChunks(x, y, 50), seed=5, ckpt_dir=ck, device=CPU)


def test_resume_refuses_a_reference_mid_epoch_cursor(tmp_path):
    """The JAX package's mid-epoch cursor names an order drawn from
    jax.random, which the port cannot replay: refused, naming why."""
    x, y = _binary(n=200)
    ck = str(tmp_path / "ck")
    jcfg = _cfg(jcore, {})
    jcore.fit_stream(jcfg, jdata.ArrayChunks(x, y, 40), seed=5, ckpt_dir=ck, ckpt_every=2,
                     max_chunks=3, impl="ref")
    assert "shuffle" not in jckpt.load_metadata(ck, 2)
    with pytest.raises(ValueError, match="jax.random"):
        tcore.fit_stream(_cfg(tcore, {}), tdata.ArrayChunks(x, y, 40), seed=5, ckpt_dir=ck,
                         device=CPU)


def test_reference_epoch_boundary_checkpoint_resumes_in_the_port(tmp_path):
    """An epoch-boundary checkpoint from the JAX package resumes: the port
    trains epoch 1 in ``EpochKey(seed, 1)`` order from the reference's state."""
    x, y = _multi(n=174)
    ck = str(tmp_path / "ck")
    jcfg, tcfg = _mcfg(jcore, {}), _mcfg(tcore, {})
    jcore.fit_multiclass_stream(jcfg, jdata.ArrayChunks(x, y, 29), seed=3, ckpt_dir=ck,
                                ckpt_every=6, impl="ref")
    assert tckpt.all_steps(ck) == [6]
    src = tdata.ArrayChunks(x, y, 29)
    got = tcore.fit_multiclass_stream(tcfg, src, epochs=2, seed=3, ckpt_dir=ck, device=CPU)
    start = tckpt.load(ck, 6, {"state": tcore.init_multiclass_state(tcfg, DIM, device=CPU)},
                       device=CPU)["state"]
    want, _, _ = tcore.train_epoch_multiclass_stream(tcfg, tcfg.table(), start, src,
                                                     key=tdata.EpochKey(3, 1))
    _bit_equal(got, want)


# ---------------------------------------------------------------------------
# resilience, against the reference
# ---------------------------------------------------------------------------

def _poison(state):
    """Every float leaf NaN, in either package's state."""
    def nan(t):
        if isinstance(t, torch.Tensor):
            return t * float("nan") if t.is_floating_point() else t
        return t * jnp.nan if jnp.issubdtype(t.dtype, jnp.inexact) else t

    return type(state)(*(None if t is None else nan(t) for t in state))


def test_guard_rolls_back_a_poisoned_chunk_as_the_reference():
    """A chunk program that poisons the state is rolled back wholesale: the
    guarded run equals one where that chunk program was the identity, with
    one rollback at its stream position, as in the reference."""
    x, y = _binary(n=200)

    def run(pkg, poison, guard, **kw):
        cfg = _cfg(pkg, {})
        table = cfg.table()
        calls = {"n": 0}

        def fn(st, xc, yc):
            calls["n"] += 1
            if calls["n"] == 3:
                return _poison(st) if poison == "nan" else st
            return pkg.train_chunk(cfg, table, st, xc, yc, **kw)

        dpkg = tdata if pkg is tcore else jdata
        rep = dpkg.ResilienceReport()
        dev = dict(device=CPU) if pkg is tcore else {}
        src = dpkg.ArrayChunks(x, y, 40)
        st = pkg.fit_stream(cfg, src, seed=7, chunk_fn=fn, guard_finite=guard, report=rep, **dev)
        return st, rep

    guarded, rep = run(tcore, "nan", True)
    skipped, _ = run(tcore, "skip", False)
    _, jrep = run(jcore, "nan", True, impl="ref")
    assert rep.rollbacks == jrep.rollbacks == [2]
    _bit_equal(guarded, skipped)
    assert all(bool(torch.isfinite(t).all()) for t in guarded if t is not None)
    # without the guard the poison persists
    assert not bool(torch.isfinite(run(tcore, "nan", False)[0].alpha).all())


def test_zero_fault_path_is_the_plain_run():
    x, y = _binary(n=230)
    cfg = _cfg(tcore, CONFIGS["cache-fused"])
    plain = tcore.fit_stream(cfg, tdata.ArrayChunks(x, y, 37), epochs=2, seed=5, device=CPU)
    rep = tdata.ResilienceReport()
    armed = tcore.fit_stream(cfg, tdata.FaultyChunks(tdata.ArrayChunks(x, y, 37),
                                                     tdata.FaultSchedule()),
                             epochs=2, seed=5, retry=tdata.RetryPolicy(**POLICY),
                             guard_finite=True, report=rep, device=CPU)
    _bit_equal(plain, armed)
    assert rep.as_dict() == {"retries": 0, "recovered": [], "quarantined": [], "rollbacks": [],
                             "restarts": 0}


@pytest.mark.parametrize("schedule", [
    dict(io_chunks=(1,), io_attempts=2, fatal_chunks=(4,)),
    dict(seed=0, p_io=0.2, p_truncate=0.1, fatal_chunks=(4,)),
    dict(io_chunks=(0, 3), io_attempts=1, fatal_chunks=(5,), nan_chunks=(2,)),
], ids=["io-fatal", "random-io-truncate", "io-fatal-nan"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_faulty_stream_matches_reference(schedule, prefetch, watchdog):
    """Retries, recoveries and quarantines as the reference's, the state as
    the reference's (integers exact, floats within tolerance), and bitwise
    the port's clean run over the surviving chunks."""
    watchdog(120)
    x, y = _binary(n=230)
    key = jax.random.PRNGKey(9)
    jcfg, tcfg = _cfg(jcore, {}), _cfg(tcore, {})
    jrep, trep = jdata.ResilienceReport(), tdata.ResilienceReport()
    js, _, _ = jcore.train_epoch_stream(
        jcfg, jcfg.table(), jcore.init_state(jcfg, DIM),
        jdata.FaultyChunks(jdata.ArrayChunks(x, y, 37), jdata.FaultSchedule(**schedule)),
        key=key, impl="ref", retry=jdata.RetryPolicy(**POLICY), report=jrep)
    ts, _, _ = tcore.train_epoch_stream(
        tcfg, tcfg.table(), tcore.init_state(tcfg, DIM, device=CPU),
        tdata.FaultyChunks(tdata.ArrayChunks(x, y, 37), tdata.FaultSchedule(**schedule)),
        key=JaxOrder(key), retry=tdata.RetryPolicy(**POLICY), report=trep, prefetch=prefetch)
    jd, td = jrep.as_dict(), trep.as_dict()
    assert (jd["retries"], sorted(jd["recovered"])) == (td["retries"], sorted(td["recovered"]))
    assert jrep.quarantined_chunks() == trep.quarantined_chunks() == [schedule["fatal_chunks"][0]]
    assert_state_parity(js, _as_jax(ts), atol_float=ATOL, rtol=RTOL)
    if "nan_chunks" not in schedule:
        clean, _, _ = tcore.train_epoch_stream(
            tcfg, tcfg.table(), tcore.init_state(tcfg, DIM, device=CPU),
            tdata.ArrayChunks(x, y, 37), key=JaxOrder(key),
            skip_chunks=schedule["fatal_chunks"])
        _bit_equal(ts, clean)


def test_quarantine_composes_with_kill_and_resume(tmp_path):
    x, y = _binary(n=230)
    cfg = _cfg(tcore, CONFIGS["cache-fused"])

    def src():   # a fresh wrapper a run: attempt counters are in-process state
        return tdata.FaultyChunks(tdata.ArrayChunks(x, y, 37),
                                  tdata.FaultSchedule(io_chunks=(0, 3), fatal_chunks=(5,)))

    pol = tdata.RetryPolicy(**POLICY)
    ref = tcore.fit_stream(cfg, src(), epochs=2, seed=5, retry=pol, device=CPU)
    ck = str(tmp_path / "ck")
    tcore.fit_stream(cfg, src(), epochs=2, seed=5, retry=pol, ckpt_dir=ck, ckpt_every=2,
                     max_chunks=9, device=CPU)
    _bit_equal(ref, tcore.fit_stream(cfg, src(), epochs=2, seed=5, retry=pol, ckpt_dir=ck,
                                     ckpt_every=2, device=CPU))


class _RecordingBank(tcore.ModelBank):
    def __init__(self):
        super().__init__()
        self.history = []

    def publish(self, model):
        self.history.append(model)
        return super().publish(model)


@pytest.mark.parametrize("kw", [dict(), dict(maintenance="removal", use_kernel_cache=True),
                                dict(use_kernel_cache=True, step_engine="pallas")],
                         ids=["merge", "removal-cache", "fused"])
def test_nan_rows_never_reach_a_published_model(kw):
    """NaN/Inf rows in any chunk never surface in a published ServeModel, and
    the guard rolls back exactly where the reference's does."""
    x, y = _multi(n=180)
    tcfg, jcfg = _mcfg(tcore, kw), _mcfg(jcore, kw)
    for nan_chunk in (0, 2, 4):
        bank, rep, jrep = _RecordingBank(), tdata.ResilienceReport(), jdata.ResilienceReport()
        st = tcore.fit_multiclass_stream(
            tcfg, tdata.FaultyChunks(tdata.ArrayChunks(x, y, 36),
                                     tdata.FaultSchedule(nan_chunks=(nan_chunk,), nan_rows=6)),
            seed=3, retry=tdata.RetryPolicy(**POLICY), guard_finite=True, bank=bank,
            publish_every=1, report=rep, device=CPU)
        jcore.fit_multiclass_stream(
            jcfg, jdata.FaultyChunks(jdata.ArrayChunks(x, y, 36),
                                     jdata.FaultSchedule(nan_chunks=(nan_chunk,), nan_rows=6)),
            seed=3, retry=jdata.RetryPolicy(**POLICY), guard_finite=True, report=jrep,
            impl="ref")
        assert len(rep.rollbacks) == len(jrep.rollbacks)
        assert len(bank.history) == 6                      # every chunk and the end
        for m in bank.history:
            assert bool(torch.isfinite(m.sv_x.float()).all() and torch.isfinite(m.alpha).all())
        assert all(bool(torch.isfinite(t).all()) for t in st if t is not None)


def test_debug_invariants_checks_every_accepted_state(monkeypatch):
    x, y = _binary(n=200)
    cfg = _cfg(tcore, dict(use_kernel_cache=True))
    seen = []
    real = tcore.kernel_cache.check_invariants

    def spy(*args, **kw):
        seen.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tcore.kernel_cache, "check_invariants", spy)
    tcore.fit_stream(cfg, tdata.ArrayChunks(x, y, 40), seed=2, guard_finite=True,
                     debug_invariants=True, device=CPU)
    assert len(seen) == 5


def test_stager_error_surfaces_on_the_caller(watchdog):
    watchdog(60)
    x, y = _binary(n=200)

    class Boom(tdata.ArrayChunks):
        def load(self, i):
            if i == 2:
                raise KeyError("chunk 2 is gone")
            return super().load(i)

    with pytest.raises(KeyError, match="chunk 2 is gone"):
        tcore.fit_stream(_cfg(tcore, {}), Boom(x, y, 40), seed=0, prefetch=2, device=CPU)
    assert not [t for t in threading.enumerate() if t.name == "chunk-stager"]


def test_multiclass_labels_are_checked_on_the_host(watchdog):
    watchdog(60)
    x, y = _multi(n=120)
    y = y.copy()
    y[70] = 7
    with pytest.raises(ValueError, match="class labels"):
        tcore.fit_multiclass_stream(_mcfg(tcore, {}), tdata.ArrayChunks(x, y, 40), seed=0,
                                    prefetch=1, device=CPU)


def test_prefetch_publishes_every_k_chunks(watchdog):
    watchdog(120)
    x, y = _multi(n=180)
    cfg = _mcfg(tcore, CONFIGS["cache-fused"])
    bank = _RecordingBank()
    st = tcore.fit_multiclass_stream(cfg, tdata.ArrayChunks(x, y, 36), epochs=1, seed=1,
                                     prefetch=2, bank=bank, publish_every=2, device=CPU)
    assert bank.version == len(bank.history) == 3           # chunks 2, 4 and the end
    final = bank.history[-1]
    want = tcore.export_model(st, cfg.binary.gamma)
    assert torch.equal(final.sv_x, want.sv_x) and torch.equal(final.alpha, want.alpha)
    # published snapshots own their tensors: training on does not move them
    snap = bank.history[0].sv_x.clone()
    tcore.fit_multiclass_stream(cfg, tdata.ArrayChunks(x, y, 36), seed=2, state=st, device=CPU)
    assert torch.equal(bank.history[0].sv_x, snap)


def test_entry_points_need_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is reachable")
    x, y = _binary(n=40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.fit_stream(_cfg(tcore, {}), tdata.ArrayChunks(x, y, 20))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.prequential_stream(_cfg(tcore, {}), tdata.ArrayChunks(x, y, 20))


def test_train_chunk_matches_reference_chunk():
    """One chunk program against the reference's, the same block."""
    x, y = _binary(n=64)
    xc, yc = x.reshape(16, 4, DIM), y.reshape(16, 4)
    jcfg, tcfg = _cfg(jcore, {}), _cfg(tcore, {})
    js = jcore.train_chunk(jcfg, jcfg.table(), jcore.init_state(jcfg, DIM), jnp.asarray(xc),
                           jnp.asarray(yc), impl="ref")
    ts = tcore.train_chunk(tcfg, tcfg.table(), tcore.init_state(tcfg, DIM, device=CPU), xc, yc)
    assert_state_parity(js, _as_jax(ts), atol_float=ATOL, rtol=RTOL)
