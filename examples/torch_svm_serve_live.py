"""Train-while-serve on the PyTorch/CUDA port: a background trainer streams
chunks with ``prefetch`` and publishes versioned model snapshots into a
``ModelBank`` while an ``AsyncBatchQueue`` serves ragged requests over it the
whole time.

    PYTHONPATH=src python examples/torch_svm_serve_live.py [--n 4096] [--classes 4]

What it shows:
  1. ``fit_multiclass_stream(bank=, publish_every=K, prefetch=2)`` publishes
     an immutable snapshot every K chunks plus the final model: the serve
     side never waits for training to finish;
  2. the queue hot-swaps to each new version at the next microbatch, with
     no drain and no pause: the served-version histogram spans the run;
  3. once the trainer exits, a final pass through the same live queue is
     bit for bit one direct ``predict_labels`` call on the bank's last version.

``--faults SEED`` turns the run into a chaos drill: the chunk source is
wrapped in ``FaultyChunks`` with a seeded chaos schedule (transient IO
errors, stalls, one NaN chunk, one fatal chunk) and training runs with
retries, quarantine and the non-finite guard; the same checks must hold and
every published snapshot stay finite.  Runs on the card; ``--device cpu``
runs it on the host.
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core import (AsyncBatchQueue, ModelBank, MulticlassSVMConfig,
                              fit_multiclass_stream, predict_labels, resolve_device)
from repro_torch.data import (ArrayChunks, FaultSchedule, FaultyChunks, ResilienceReport,
                              RetryPolicy, make_blobs_multiclass, train_test_split)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--chunk-rows", type=int, default=256)
    ap.add_argument("--budget", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--publish-every", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="inject FaultSchedule.chaos(SEED) and train with the full recovery "
                         "stack")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = make_blobs_multiclass(np.random.default_rng(0), args.n, 16,
                                 n_classes=args.classes, sep=2.5)
    (xtr, ytr), (xte, yte) = train_test_split(x, y)
    xtr, ytr = np.asarray(xtr, np.float32), np.asarray(ytr, np.int32)
    xte = np.asarray(xte, np.float32)
    cfg = MulticlassSVMConfig.create(args.classes, budget=args.budget, lambda_=1e-3, gamma=0.5,
                                     batch_size=64)
    source = ArrayChunks(xtr, ytr, args.chunk_rows)
    report = ResilienceReport()
    retry = None
    if args.faults is not None:
        source = FaultyChunks(source, FaultSchedule.chaos(args.faults, nan_chunk=2,
                                                          fatal_chunk=5))
        retry = RetryPolicy()
    print(f"blobs: {source.n_rows} train rows in {source.n_chunks} chunks, C={args.classes}, "
          f"publish every {args.publish_every} chunks on {dev}"
          + (f", chaos faults seed={args.faults}" if args.faults is not None else ""))

    # -- 1. trainer publishes into the bank from a background thread -----
    bank = ModelBank()
    fail: list[BaseException] = []

    def trainer():
        try:
            fit_multiclass_stream(cfg, source, epochs=args.epochs, seed=0, prefetch=2,
                                  bank=bank, publish_every=args.publish_every, retry=retry,
                                  report=report, guard_finite=args.faults is not None,
                                  device=dev)
        except BaseException as e:            # noqa: BLE001 — re-raised on the main thread
            fail.append(e)

    t = threading.Thread(target=trainer, name="live-trainer", daemon=True)
    t.start()
    bank.wait(1, timeout=300.0)               # first snapshot is up

    # -- 2. serve ragged requests the whole time the trainer runs --------
    rng = np.random.default_rng(7)
    served = 0
    t0 = time.perf_counter()
    with AsyncBatchQueue(bank, max_batch=args.max_batch) as q:
        q.warmup()
        passes = 0
        while t.is_alive() or passes == 0:    # at least one pass, even if the trainer wins
            sizes = [int(s) for s in rng.integers(1, args.max_batch, size=8)]
            tickets, off = [], 0
            for s in sizes:
                tickets.append(q.submit(xte[off:off + s]))
                off += s
            for tk in tickets:
                q.take(tk, timeout=120.0)
            served += off
            passes += 1
        t.join()
        if fail:
            raise fail[0]
        dt = time.perf_counter() - t0
        versions = dict(q.stats["versions"])
        print(f"  served {served} rows in {dt:.2f}s ({served / dt:,.0f} rows/s) while training")
        print(f"  versions served: {versions}")
        if not versions:
            raise SystemExit("the queue never read a bank version")
        if bank.version < 2:
            raise SystemExit("the trainer never published a mid-run snapshot")

        # -- 3. final pass through the same queue: bit for bit the last model
        final_v, final_model = bank.current()
        tk = q.submit(xte)
        live = q.take(tk, timeout=120.0)
    direct = predict_labels(final_model, xte).cpu().numpy()
    if not (live == direct).all():
        raise SystemExit("the live queue's labels differ from a direct predict_labels call")
    acc = float(np.mean(direct == np.asarray(yte)))
    print(f"  final version v{final_v}: queue == direct predict (bitwise), test acc={acc:.4f}")
    if args.faults is not None:
        for name in ("sv_x", "alpha"):
            if not bool(torch.isfinite(getattr(final_model, name).float()).all()):
                raise SystemExit(f"published ServeModel.{name} went non-finite under faults")
        print(f"  chaos drill survived: {report!r}; published snapshots stayed finite")


if __name__ == "__main__":
    main()
