"""The port's data layer against the JAX package's (CPU): chunk sources,
LIBSVM parsing, drift schedules and fault injection, array for array.

The same numpy inputs go through ``repro.data`` and ``repro_torch.data``;
every loaded block, schedule and resolved fault plan must be equal (these
modules are numpy in both packages, so equal means bit for bit).  Then the
port's own contracts: ``EpochKey`` orders are permutations, pure in
``(seed, epoch, chunk_id)``; prefetch errors surface on the caller; no
``prefetch-*`` thread survives ``close``.
"""
import dataclasses
import os
import threading

import numpy as np
import pytest
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

import repro.data as jdata
import repro_torch.data as tdata


def _data(n=53, d=5, seed=0, classes=None):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, d)).astype(np.float32), 3)
    x[rng.random(x.shape) < 0.2] = 0.0
    if classes is None:
        y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    else:
        y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


def _blocks(source):
    return [source.load(i) for i in range(source.n_chunks)]


def _assert_same_blocks(a, b):
    assert a.n_chunks == b.n_chunks and a.chunk_lens == b.chunk_lens and a.dim == b.dim
    for (xa, ya), (xb, yb) in zip(_blocks(a), _blocks(b)):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("chunk_rows", [1, 7, 20, 53, 80])
def test_array_chunks_match_reference(chunk_rows):
    x, y = _data()
    _assert_same_blocks(jdata.ArrayChunks(x, y, chunk_rows), tdata.ArrayChunks(x, y, chunk_rows))


def test_file_chunks_npz_match_reference(tmp_path):
    x, y = _data()
    jp = jdata.write_npz_chunks(str(tmp_path / "j"), x, y, 16)
    tp = tdata.write_npz_chunks(str(tmp_path / "t"), x, y, 16)
    assert [os.path.basename(p) for p in jp] == [os.path.basename(p) for p in tp]
    _assert_same_blocks(jdata.FileChunks(jp), tdata.FileChunks(tp))
    # the writers write the same shards
    for a, b in zip(jp, tp):
        with np.load(a) as za, np.load(b) as zb:
            np.testing.assert_array_equal(za["x"], zb["x"])
            np.testing.assert_array_equal(za["y"], zb["y"])


def test_file_chunks_npy_pairs_match_reference(tmp_path):
    x, y = _data(n=24)
    pairs = []
    for i, s in enumerate(range(0, 24, 8)):
        xp, yp = os.path.join(tmp_path, f"x{i}.npy"), os.path.join(tmp_path, f"y{i}.npy")
        np.save(xp, x[s:s + 8])
        np.save(yp, y[s:s + 8])
        pairs.append((xp, yp))
    _assert_same_blocks(jdata.FileChunks(pairs), tdata.FileChunks(pairs))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("n_features", [None, 5, 8])
def test_libsvm_chunks_match_reference(tmp_path, binary, n_features):
    x, y = _data(classes=None if binary else 4)
    path = str(tmp_path / "d.libsvm")
    tdata.dump_libsvm(path, x, y)
    _assert_same_blocks(jdata.LibsvmChunks(path, 20, n_features, binary=binary),
                        tdata.LibsvmChunks(path, 20, n_features, binary=binary))


@pytest.mark.parametrize("binary", [True, False])
def test_parse_and_dump_round_trip_match_reference(tmp_path, binary):
    x, y = _data(n=41, d=6, seed=3, classes=None if binary else 5)
    jpath, tpath = str(tmp_path / "j.libsvm"), str(tmp_path / "t.libsvm")
    jdata.dump_libsvm(jpath, x[:20], y[:20])
    jdata.dump_libsvm(jpath, x[20:], y[20:], append=True)
    tdata.dump_libsvm(tpath, x[:20], y[:20])
    tdata.dump_libsvm(tpath, x[20:], y[20:], append=True)
    assert open(jpath).read() == open(tpath).read()
    jx, jy = jdata.parse_libsvm(jpath, n_features=6, binary=binary)
    tx, ty = tdata.parse_libsvm(tpath, n_features=6, binary=binary)
    np.testing.assert_array_equal(jx, tx)
    np.testing.assert_array_equal(jy, ty)
    np.testing.assert_allclose(tx, x, rtol=1e-5, atol=1e-6)
    if binary:
        np.testing.assert_array_equal(ty, np.sign(y))
    else:
        np.testing.assert_array_equal(ty, y.astype(np.float32))
    for (ja, jb), (ta, tb) in zip(jdata.iter_libsvm_chunks(tpath, 7, 6, binary=binary),
                                  tdata.iter_libsvm_chunks(tpath, 7, 6, binary=binary)):
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jb, tb)


@pytest.mark.parametrize("start,prob", [(0.5, 1.0), (0.0, 0.3), (0.75, 0.5)])
def test_label_flip_schedule_matches_reference(start, prob):
    np.testing.assert_array_equal(jdata.label_flip_schedule(9, start=start, prob=prob),
                                  tdata.label_flip_schedule(9, start=start, prob=prob))


@pytest.mark.parametrize("kind", ["step", "ramp"])
def test_mean_shift_schedule_matches_reference(kind):
    direction = np.arange(1.0, 6.0)
    for kw in (dict(), dict(direction=direction, magnitude=1.5, start=0.25)):
        a = jdata.mean_shift_schedule(7, 5, kind=kind, **kw)
        b = tdata.mean_shift_schedule(7, 5, kind=kind, **kw)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("classes", [None, 3])
@pytest.mark.parametrize("schedule", ["flip", "shift", "both"])
def test_drift_chunks_match_reference(classes, schedule):
    x, y = _data(n=70, classes=classes)
    kw = {}
    if schedule in ("flip", "both"):
        kw["flip"] = tdata.label_flip_schedule(7, start=0.4, prob=0.6)
    if schedule in ("shift", "both"):
        kw["shift"] = tdata.mean_shift_schedule(7, 5, kind="ramp")
    a = jdata.DriftChunks(jdata.ArrayChunks(x, y, 10), n_classes=classes, seed=4, **kw)
    b = tdata.DriftChunks(tdata.ArrayChunks(x, y, 10), n_classes=classes, seed=4, **kw)
    _assert_same_blocks(a, b)
    # pure in (seed, chunk id): a second, out-of-order load gives the same block
    for i in (5, 2, 5):
        np.testing.assert_array_equal(b.load(i)[1], a.load(i)[1])


def _fields(obj):
    return dataclasses.asdict(obj)


SCHEDULES = [
    dict(seed=0, p_io=0.2, p_truncate=0.1, fatal_chunks=(4,)),
    dict(seed=3, p_io=0.5, io_attempts=2, p_stall=0.3, p_nan=0.2, nan_rows=3),
    dict(seed=1, io_chunks=(0, 3), truncate_chunks=(2,), nan_chunks=(5,), crash_chunks=(6,)),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_fault_schedule_resolves_as_reference(kw):
    a, b = jdata.FaultSchedule(**kw), tdata.FaultSchedule(**kw)
    for i in range(40):
        assert _fields(a.for_chunk(i)) == _fields(b.for_chunk(i))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_chaos_schedule_matches_reference(seed):
    kw = dict(nan_chunk=2, crash_chunk=3, fatal_chunk=5)
    a, b = jdata.FaultSchedule.chaos(seed, **kw), tdata.FaultSchedule.chaos(seed, **kw)
    assert _fields(a) == _fields(b)
    assert [_fields(a.for_chunk(i)) for i in range(16)] == \
        [_fields(b.for_chunk(i)) for i in range(16)]


@pytest.mark.parametrize("kw", SCHEDULES[1:])
def test_faulty_chunks_load_as_reference(kw):
    """Attempt by attempt, the same errors and the same blocks (NaN/Inf
    positions included)."""
    x, y = _data(n=80)
    a = jdata.FaultyChunks(jdata.ArrayChunks(x, y, 10), jdata.FaultSchedule(**kw))
    b = tdata.FaultyChunks(tdata.ArrayChunks(x, y, 10), tdata.FaultSchedule(**kw))
    for i in range(8):
        for _ in range(4):
            outs = []
            for src in (a, b):
                try:
                    outs.append(("ok", src.load(i)))
                except Exception as e:  # noqa: BLE001 — compared by kind
                    outs.append((type(e).__name__, None))
            assert outs[0][0] == outs[1][0], (i, outs[0][0], outs[1][0])
            if outs[0][0] == "ok":
                np.testing.assert_array_equal(outs[0][1][0], outs[1][1][0])
                np.testing.assert_array_equal(outs[0][1][1], outs[1][1][1])
        assert a.attempts(i) == b.attempts(i)


def test_retry_policy_matches_reference():
    for kw in (dict(), dict(base_delay_s=0.01, max_delay_s=0.05, max_attempts=6)):
        a, b = jdata.RetryPolicy(**kw), tdata.RetryPolicy(**kw)
        assert [a.delay_s(k) for k in range(8)] == [b.delay_s(k) for k in range(8)]
    a, b = jdata.RetryPolicy(), tdata.RetryPolicy()
    cases = [(jdata.TransientIOError("x"), tdata.TransientIOError("x")),
             (jdata.TruncatedChunkError("x"), tdata.TruncatedChunkError("x")),
             (jdata.CorruptChunkError("x"), tdata.CorruptChunkError("x")),
             (jdata.TrainerCrash("x"), tdata.TrainerCrash("x")),
             (TimeoutError(), TimeoutError()), (KeyError(), KeyError())]
    assert [a.classify(e) for e, _ in cases] == [b.classify(e) for _, e in cases]
    assert [b.classify(e) for _, e in cases] == ["transient", "transient", "quarantine",
                                                 "propagate", "transient", "propagate"]
    with pytest.raises(ValueError):
        tdata.RetryPolicy(max_attempts=0)


def test_load_chunk_with_retry_matches_reference():
    x, y = _data(n=80)
    kw = dict(seed=1, io_chunks=(1,), io_attempts=2, truncate_chunks=(3,), fatal_chunks=(5,))
    pol = dict(max_attempts=3, base_delay_s=0.0)
    results = []
    for mod in (jdata, tdata):
        src = mod.FaultyChunks(mod.ArrayChunks(x, y, 10), mod.FaultSchedule(**kw))
        rep = mod.ResilienceReport()
        got = []
        for i in range(8):
            try:
                xb, _ = mod.load_chunk_with_retry(src, i, mod.RetryPolicy(**pol), report=rep,
                                                  expected_rows=src.chunk_lens[i], dim=src.dim)
                got.append(xb.shape)
            except mod.ChunkQuarantined as q:
                rep.note_quarantine(q)
                got.append(("quarantined", q.chunk_id, q.attempts))
        results.append((got, rep.retries, rep.recovered, rep.quarantined_chunks()))
    assert results[0] == results[1]
    assert results[1][3] == [5] and results[1][2] == [(1, 2), (3, 1)]


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (5, 0), (123, 9)])
def test_epoch_key_orders_are_pure_permutations(seed, epoch):
    key = tdata.EpochKey(seed, epoch)
    order = tdata.chunk_order(key, 11)
    np.testing.assert_array_equal(np.sort(order), np.arange(11))
    np.testing.assert_array_equal(order, tdata.chunk_order(tdata.EpochKey(seed, epoch), 11))
    for c in (0, 4, 10):
        p = tdata.intra_perm(key, c, 17)
        np.testing.assert_array_equal(np.sort(p), np.arange(17))
        np.testing.assert_array_equal(p, tdata.EpochKey(seed, epoch).intra_perm(c, 17))
        np.testing.assert_array_equal(
            p, np.random.default_rng((seed, epoch, 1 + c)).permutation(17))
    # a different epoch, seed or chunk id draws another order
    assert not np.array_equal(order, tdata.chunk_order(tdata.EpochKey(seed, epoch + 1), 11))
    assert not np.array_equal(order, tdata.chunk_order(tdata.EpochKey(seed + 1, epoch), 11))
    assert not np.array_equal(tdata.intra_perm(key, 1, 17), tdata.intra_perm(key, 2, 17))


def test_epoch_permutation_and_iter_epoch_realize_one_order():
    x, y = _data(n=97)
    src = tdata.ArrayChunks(x, y, 13)
    key = tdata.EpochKey(2, 3)
    perm = tdata.epoch_permutation(src, key)
    np.testing.assert_array_equal(np.sort(perm), np.arange(97))
    got = np.concatenate([xb for _, xb, _ in tdata.iter_epoch(src, key)])
    np.testing.assert_array_equal(got, x[perm])
    np.testing.assert_array_equal(tdata.epoch_permutation(src, None), np.arange(97))
    # resuming at a stream position yields the rest of the same order
    tail = [pos for pos, _, _ in tdata.iter_epoch(src, key, start_chunk=4)]
    assert tail == list(range(4, src.n_chunks))


class _JaxOrder:
    """The reference's ``jax.random`` orders as a key the port takes."""

    def __init__(self, key):
        self.key = key

    def chunk_order(self, n):
        return jdata.chunk_order(self.key, n)

    def intra_perm(self, chunk_id, n):
        return jdata.intra_perm(self.key, chunk_id, n)


def test_a_reference_order_passed_in_streams_as_the_reference():
    import jax
    x, y = _data(n=61)
    key = jax.random.PRNGKey(11)
    a = jdata.epoch_permutation(jdata.ArrayChunks(x, y, 9), key)
    b = tdata.epoch_permutation(tdata.ArrayChunks(x, y, 9), _JaxOrder(key))
    np.testing.assert_array_equal(a, b)
    ja = [(p, xb) for p, xb, _ in jdata.iter_epoch(jdata.ArrayChunks(x, y, 9), key)]
    tb = [(p, xb) for p, xb, _ in tdata.iter_epoch(tdata.ArrayChunks(x, y, 9), _JaxOrder(key),
                                                   prefetch=2)]
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (_, u), (_, v) in zip(ja, tb):
        np.testing.assert_array_equal(u, v)


class _Boom(tdata.ArrayChunks):
    def load(self, i):
        if i == 3:
            raise KeyError("boom on chunk 3")
        return super().load(i)


def test_prefetch_error_surfaces_on_the_caller(watchdog):
    watchdog(60)
    x, y = _data(n=60)
    got = []
    with pytest.raises(KeyError, match="boom on chunk 3"):
        for pos, _, _ in tdata.iter_epoch(_Boom(x, y, 10), None, prefetch=2):
            got.append(pos)
    assert got == [0, 1, 2]
    assert not [t for t in threading.enumerate() if t.name.startswith("prefetch")]


def test_no_prefetch_thread_survives_close(watchdog):
    watchdog(60)
    x, y = _data(n=60)
    pf = tdata.PrefetchChunks(tdata.ArrayChunks(x, y, 10), depth=2)
    pf.plan([0, 1, 2, 3])
    np.testing.assert_array_equal(pf.load(0)[0], x[:10])
    pf.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("prefetch")]
    # an abandoned epoch generator leaves no worker either
    gen = tdata.iter_epoch(tdata.ArrayChunks(x, y, 10), tdata.EpochKey(0, 0), prefetch=2)
    next(gen)
    gen.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("prefetch")]
    # and the prefetched stream equals the synchronous one
    sync = [xb for _, xb, _ in tdata.iter_epoch(tdata.ArrayChunks(x, y, 10),
                                                tdata.EpochKey(1, 0))]
    pre = [xb for _, xb, _ in tdata.iter_epoch(tdata.ArrayChunks(x, y, 10),
                                               tdata.EpochKey(1, 0), prefetch=3)]
    for a, b in zip(sync, pre):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_quarantine_skips_like_skip_chunks(prefetch, watchdog):
    watchdog(60)
    x, y = _data(n=80)
    key = tdata.EpochKey(4, 0)
    faulty = tdata.FaultyChunks(tdata.ArrayChunks(x, y, 10),
                                tdata.FaultSchedule(io_chunks=(1,), fatal_chunks=(3,)))
    rep = tdata.ResilienceReport()
    got = [(p, xb) for p, xb, _ in tdata.iter_epoch(
        faulty, key, prefetch=prefetch, retry=tdata.RetryPolicy(base_delay_s=0.0), report=rep)]
    want = [(p, xb) for p, xb, _ in tdata.iter_epoch(tdata.ArrayChunks(x, y, 10), key,
                                                     skip_chunks=(3,))]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert rep.quarantined_chunks() == [3] and rep.recovered == [(1, 1)]

