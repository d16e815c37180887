"""The port's continuous-batching queue and versioned model bank (CPU).

The behaviours ``tests/core/test_async_queue.py`` pins for the reference:

  * ``AsyncBatchQueue`` labels are bitwise one direct ``predict_labels``
    call for any arrival pattern (randomized sizes, interleaved takes),
    multiclass and binary, and at ``max_batch`` 1;
  * waiter-gated dispatch never launches more microbatches than the sync
    queue for the same trace; a blocked ``take`` un-gates a partial batch;
  * the warm-up runs every bucket, and live traffic adds no bucket shape;
  * ``ModelBank`` versions are monotone, reads are consistent pairs, and
    the queue hot-swaps a newly published model without draining;
  * a dispatcher failure, a timeout, a full queue and an expired deadline
    surface as typed errors on the caller's thread, never as a hang.

Every threaded test arms the ``watchdog`` fixture.
"""
import threading
import time

import numpy as np
import pytest
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro_torch.core import (AsyncBatchQueue, BatchQueue, ModelBank, MulticlassSVMConfig,
                              QueueFull, ServeDeadline, ServeTimeout, default_buckets,
                              drive_trace, export_model, fit_multiclass, pad_bucket,
                              predict_labels, ragged_trace_sizes)
from repro_torch.core import BSGDConfig, fit
from repro_torch.data import make_blobs, make_blobs_multiclass

CPU = "cpu"
N_CLASSES, DIM = 4, 8
X, Y = make_blobs_multiclass(np.random.default_rng(0), 640, DIM, N_CLASSES, sep=2.5)
CFG = MulticlassSVMConfig.create(N_CLASSES, budget=16, lambda_=1e-3, gamma=0.5, batch_size=8)
MODEL = export_model(fit_multiclass(CFG, X, Y, epochs=1, seed=0, device=CPU), 0.5)


def _direct(model, rows):
    return predict_labels(model, rows).numpy()


def test_pad_bucket_is_the_shared_rule(watchdog):
    watchdog(120)
    buckets = (8, 16, 32, 64)
    assert [pad_bucket(n, buckets) for n in (1, 8, 9, 16, 33, 64, 99)] == \
        [8, 8, 16, 16, 64, 64, 64]
    assert default_buckets(64, 8) == buckets
    assert default_buckets(48, 8) == (8, 16, 32, 48)
    assert BatchQueue(MODEL, max_batch=64)._bucket_for(9) == 16
    with AsyncBatchQueue(MODEL, max_batch=64) as q:
        assert q.buckets == buckets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_async_queue_bitwise_any_arrivals(seed, watchdog):
    """Randomized ragged arrivals (empty and > max_batch requests too), takes
    interleaved with submits: labels bitwise one direct call."""
    watchdog(300)
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(0, 97, size=24)]
    with AsyncBatchQueue(MODEL, max_batch=64, min_bucket=8) as q:
        q.warmup()
        tickets, got, off = [], {}, 0
        for i, s in enumerate(sizes):
            tickets.append(q.submit(X[off % 512:off % 512 + s]))
            off += s
            if i % 5 == 4:
                tk = tickets[len(got)]
                got[tk] = q.take(tk, timeout=60.0)
        q.drain(timeout=60.0)
        for t in tickets:
            if t not in got:
                got[t] = q.take(t, timeout=60.0)
        versions = dict(q.stats["versions"])
    starts = np.cumsum([0] + sizes[:-1])
    rows = np.concatenate([X[o % 512:o % 512 + s] for o, s in zip(starts, sizes)])
    np.testing.assert_array_equal(np.concatenate([got[t] for t in tickets]), _direct(MODEL, rows))
    assert not versions                       # fixed model: no bank versions


@pytest.mark.parametrize("max_batch,min_bucket", [(1, 1), (32, 4)])
def test_async_queue_binary_and_single_row_batches(max_batch, min_bucket, watchdog):
    watchdog(300)
    bcfg = BSGDConfig(budget=16, lambda_=1e-3, gamma=0.5, batch_size=8)
    xb, yb = make_blobs(np.random.default_rng(1), 200, 6, sep=2.0)
    model = export_model(fit(bcfg, xb, yb, epochs=1, seed=0, device=CPU), 0.5)
    sizes = ragged_trace_sizes(100, max(max_batch, 3), np.random.default_rng(4))
    stats = drive_trace(model, xb[:100], sizes, max_batch=max_batch, min_bucket=min_bucket,
                        queue="async")                # asserts queue == direct inside
    assert stats["rows"] == 100 and stats["queue"] == "async"
    if max_batch == 1:
        assert stats["microbatches"] == 100


@pytest.mark.parametrize("seed", [0, 1])
def test_async_never_more_dispatches_than_sync(seed, watchdog):
    """Waiter-gated dispatch coalesces at least as well as the sync queue for
    a submit-all-then-drain trace."""
    watchdog(300)
    sizes = ragged_trace_sizes(512, 64, np.random.default_rng(seed))
    sync = drive_trace(MODEL, X[:512], sizes, max_batch=64, queue="sync")
    asyn = drive_trace(MODEL, X[:512], sizes, max_batch=64, queue="async")
    assert asyn["microbatches"] <= sync["microbatches"], (asyn, sync)


def test_take_ungates_partial_batch(watchdog):
    watchdog(120)
    with AsyncBatchQueue(MODEL, max_batch=64) as q:
        q.warmup()
        t1 = q.submit(X[:5])                  # far below max_batch
        labels = q.take(t1, timeout=30.0)     # must dispatch, not hang
    np.testing.assert_array_equal(labels, _direct(MODEL, X[:5]))


def test_async_warmup_covers_every_bucket_and_live_adds_none(watchdog):
    watchdog(120)
    with AsyncBatchQueue(MODEL, max_batch=64, min_bucket=8) as q:
        q.warmup()
        assert q.warmed == set(q.buckets)
        for s in (3, 9, 17, 64, 130):         # every bucket and a wrap-around
            q.submit(X[:s])
        q.drain(timeout=60.0)
        assert set(q.stats["bucket_counts"]) <= q.warmed
        assert q.stats["padded_rows"] == sum(
            b * n for b, n in q.stats["bucket_counts"].items()) - q.stats["rows"]


def test_model_bank_versioning_and_atomicity(watchdog):
    watchdog(120)
    bank = ModelBank()
    with pytest.raises(LookupError):
        bank.current()
    assert bank.version == 0
    with pytest.raises(TimeoutError):
        bank.wait(1, timeout=0.05)
    assert bank.publish(MODEL) == 1
    v, m = bank.current()
    assert v == 1 and m is MODEL
    models = {v: export_model(fit_multiclass(CFG, X[:160], Y[:160], epochs=1, seed=v,
                                             device=CPU), 0.5) for v in range(2, 6)}
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(bank.current())

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    for m in models.values():
        bank.publish(m)
    stop.set()
    t.join(5.0)
    assert bank.version == 5
    by_version = {1: MODEL, **models}
    last = 0
    for v, m in seen:
        assert v >= last, "version went backwards"
        assert m is by_version[v], f"torn read at version {v}"
        last = v
    assert bank.wait(5, timeout=1.0)[0] == 5


def test_hot_swap_mid_stream_without_drain(watchdog):
    watchdog(300)
    model_b = export_model(fit_multiclass(CFG, X, Y, epochs=1, seed=99, device=CPU), 0.5)
    assert not np.array_equal(model_b.alpha.numpy(), MODEL.alpha.numpy())
    bank = ModelBank(MODEL)
    with AsyncBatchQueue(bank, max_batch=64) as q:
        q.warmup()
        t1 = q.submit(X[:100])
        q.drain(timeout=60.0)                 # all of phase 1 scored by v1
        bank.publish(model_b)                 # hot swap, queue stays open
        t2 = q.submit(X[100:200])
        q.drain(timeout=60.0)
        l1, l2 = q.take(t1), q.take(t2)
        versions = dict(q.stats["versions"])
    np.testing.assert_array_equal(l1, _direct(MODEL, X[:100]))
    np.testing.assert_array_equal(l2, _direct(model_b, X[100:200]))
    assert set(versions) == {1, 2}, versions


def test_bank_queue_rejects_predict_fn_and_sync_drive():
    with pytest.raises(ValueError, match="ModelBank"):
        AsyncBatchQueue(ModelBank(MODEL), predict_fn=lambda xb: xb)
    with pytest.raises(ValueError, match="fixed ServeModel"):
        drive_trace(ModelBank(MODEL), X[:8], [8], queue="sync")
    with pytest.raises(ValueError, match="expected 'sync' or 'async'"):
        drive_trace(MODEL, X[:8], [8], queue="other")


def test_dispatcher_error_surfaces_no_hang(watchdog):
    watchdog(120)

    def boom(xb):
        raise RuntimeError("device lost")

    q = AsyncBatchQueue(MODEL, max_batch=64, predict_fn=boom)
    t1 = q.submit(X[:10])
    with pytest.raises(RuntimeError, match="dispatcher failed"):
        q.drain(timeout=60.0)
    with pytest.raises(RuntimeError, match="dispatcher failed"):
        q.take(t1, timeout=60.0)
    with pytest.raises(RuntimeError, match="dispatcher failed"):
        q.submit(X[:5])
    q.close()


def test_async_queue_edge_requests(watchdog):
    watchdog(120)
    with AsyncBatchQueue(MODEL, max_batch=64) as q:
        t_empty = q.submit(X[:0])
        assert q.take(t_empty, timeout=10.0).shape == (0,)
        with pytest.raises(ValueError, match=r"\(n, dim\)"):
            q.submit(X[0])
        with pytest.raises(TimeoutError):
            q.take(999, timeout=0.05)
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(X[:1])
    with pytest.raises(ValueError):
        AsyncBatchQueue(MODEL, max_batch=0)


def test_submit_validates_rows(watchdog):
    watchdog(120)
    with AsyncBatchQueue(MODEL, max_batch=64) as q:
        with pytest.raises(ValueError, match=r"\(n, dim\)"):
            q.submit(X[0])
        with pytest.raises(ValueError, match="numeric"):
            q.submit(np.zeros((3, DIM), np.bool_))
        with pytest.raises(ValueError, match="numeric"):
            q.submit(np.array([["a"] * DIM]))
        with pytest.raises(ValueError, match="request dim"):
            q.submit(np.zeros((3, DIM + 1), np.float32))
        bad = X[:3].copy()
        for v in (np.nan, np.inf):
            bad[1, 2] = v
            with pytest.raises(ValueError, match="non-finite"):
                q.submit(bad)
        t = q.submit(X[:3])                   # the queue is still healthy
        np.testing.assert_array_equal(q.take(t, timeout=30.0), _direct(MODEL, X[:3]))


def test_serve_timeout_is_typed_and_names_the_ticket(watchdog):
    watchdog(120)
    with AsyncBatchQueue(MODEL, max_batch=64) as q:
        with pytest.raises(ServeTimeout, match="ticket 999") as ei:
            q.take(999, timeout=0.05)
        assert isinstance(ei.value, TimeoutError)
        assert "in flight" in str(ei.value)
        q.take(q.submit(X[:4]), timeout=30.0)

    def slow(xb):
        time.sleep(0.5)
        return _direct(MODEL, xb)

    with AsyncBatchQueue(MODEL, max_batch=64, predict_fn=slow) as q:
        q.submit(X[:4])
        with pytest.raises(ServeTimeout, match="unresolved"):
            q.drain(timeout=0.05)
        q.drain(timeout=30.0)                 # still completes after


def test_queue_full_sheds_at_submit(watchdog):
    watchdog(120)
    with AsyncBatchQueue(MODEL, max_batch=64, max_pending=64) as q:
        t1 = q.submit(X[:40])                 # gate closed: stays pending
        with pytest.raises(QueueFull, match="max_pending=64"):
            q.submit(X[40:75])                # 40 + 35 > 64
        t2 = q.submit(X[40:60])
        got = np.concatenate([q.take(t1, timeout=30.0), q.take(t2, timeout=30.0)])
        np.testing.assert_array_equal(got, _direct(MODEL, X[:60]))
        q.take(q.submit(X[:30]), timeout=30.0)   # buffer drained: open again
    with pytest.raises(ValueError, match="max_pending"):
        AsyncBatchQueue(MODEL, max_batch=64, max_pending=8)


def test_deadline_sheds_undispatched_request(watchdog):
    watchdog(120)
    with AsyncBatchQueue(MODEL, max_batch=64) as q:
        q.warmup()
        t_live = q.submit(X[:8])
        t_dead = q.submit(X[8:16], deadline_s=0.01)
        time.sleep(0.05)                      # expires while gated
        with pytest.raises(ServeDeadline, match=f"ticket {t_dead}") as ei:
            q.take(t_dead, timeout=30.0)
        assert isinstance(ei.value, TimeoutError)
        np.testing.assert_array_equal(q.take(t_live, timeout=30.0), _direct(MODEL, X[:8]))
        q.drain(timeout=30.0)                 # shed rows never wedge it
        t_ok = q.submit(X[:16], deadline_s=60.0)
        np.testing.assert_array_equal(q.take(t_ok, timeout=30.0), _direct(MODEL, X[:16]))


def test_close_flushes_pending_rows(watchdog):
    watchdog(120)
    q = AsyncBatchQueue(MODEL, max_batch=64)
    t = q.submit(X[:10])                      # gated: below max_batch, nobody waiting
    q.close()                                 # closing opens the gate
    np.testing.assert_array_equal(q._done.pop(t), _direct(MODEL, X[:10]))
    assert q.stats["microbatches"] == 1
