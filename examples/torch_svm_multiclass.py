"""One-vs-rest multi-class BSGD on the PyTorch/CUDA port: C budgeted binary
problems trained in lockstep (one kernel call for all classes' margins a
step, per-class budget maintenance through the shared lookup table).

    PYTHONPATH=src python examples/torch_svm_multiclass.py [--classes 10] [--n 6000]

Runs on the card; ``--device cpu`` runs it on the host.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (MulticlassSVMConfig, accuracy_multiclass, fit_multiclass,
                              fit_multiclass_loop, fit_multiclass_stream, resolve_device)
from repro_torch.data import ArrayChunks, make_blobs_multiclass, train_test_split


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--budget", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--skip-loop-baseline", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="train through the chunked streaming engine "
                         "(out-of-core path) instead of the resident arrays")
    ap.add_argument("--chunk-rows", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = make_blobs_multiclass(np.random.default_rng(0), args.n, args.dim, args.classes,
                                 sep=1.0)
    (xtr, ytr), (xte, yte) = train_test_split(x, y)
    cfg = MulticlassSVMConfig.create(args.classes, budget=args.budget, lambda_=1e-4, gamma=0.1,
                                     method="lookup-wd", batch_size=args.batch_size)
    print(f"blobs: n={xtr.shape[0]} d={args.dim} classes={args.classes} "
          f"budget={args.budget}/class on {dev} (single pass, one-vs-rest"
          f"{', streamed' if args.stream else ''})")
    source = ArrayChunks(xtr, ytr, args.chunk_rows) if args.stream else None

    def timed(fit_fn):
        """Best of 3 after a warm-up run (one run's wall clock on a shared
        machine swings either way)."""
        fit_fn(cfg, xtr, ytr, epochs=1, seed=0, device=dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            st = fit_fn(cfg, xtr, ytr, epochs=1, seed=0, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        return min(times), st

    def fit_streamed(cfg, xtr, ytr, *, epochs, seed, device):
        return fit_multiclass_stream(cfg, source, epochs=epochs, seed=seed, device=device)

    t_batched, st = timed(fit_streamed if args.stream else fit_multiclass)

    acc = float(accuracy_multiclass(st, xte, yte, cfg.binary.gamma, device=dev))
    merges = st.n_merges.cpu().numpy()
    print(f"  batched OVR: time={t_batched:6.2f}s  test_acc={acc:.4f}")
    print(f"  per-class merges: {merges.tolist()}  (total {int(merges.sum())})")
    print(f"  per-class SV counts: {st.count.cpu().numpy().tolist()}")
    if acc < 0.9:
        raise SystemExit(f"expected >= 90% one-pass accuracy, got {acc:.4f}")

    if not args.skip_loop_baseline:
        t_loop, _ = timed(fit_multiclass_loop)
        print(f"  loop-over-classes baseline: time={t_loop:6.2f}s "
              f"(batched is {t_loop / t_batched:.2f}x)")


if __name__ == "__main__":
    main()
