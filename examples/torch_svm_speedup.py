"""Paper reproduction driver on the PyTorch/CUDA port: Lookup-WD against GSS
training time on a large synthetic stream (the SUSY-like setting, single
pass; paper section 4 and Fig. 3).

    PYTHONPATH=src python examples/torch_svm_speedup.py [--n 40000] [--budget 100]

Prints, as the reference's ``examples/svm_speedup.py`` does, each method's
time, accuracy and merge-time share, the total-training-time improvement of
Lookup-WD over GSS, and on one line both of the paper's figures: that
improvement and the reduction of merging time (paper: 44% and 65%).  It
reports what it measures and asserts nothing about their sign.  Runs on the
card; ``--device cpu`` runs it on the host.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (BSGDConfig, accuracy, fit, fit_stream, resolve_device,
                              run_maintenance)
from repro_torch.data import ArrayChunks, make_susy_like, train_test_split


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def merge_seconds_per_event(cfg, table, st, events: int = 64):
    """Seconds per budget-maintenance event: ``events`` merges on SV rows of the
    trained model in one ``run_maintenance`` call (the drain form: one host
    read of ``count``, then ``events`` masked events), bracketed by
    synchronizations on the card; the median of 3 after a warm-up call.
    The cost of an event grows about linearly with the array width (the
    kappa row and the candidate sweep are O(slots)), so it is rescaled from
    ``budget + events`` rows to the ``budget + batch`` rows training carries."""
    dev = st.alpha.device
    slots = cfg.budget + events
    reps = -(-slots // cfg.budget)                       # ceil division
    sv = st.sv_x[: cfg.budget].repeat(reps, 1)[:slots].contiguous()
    # strictly positive alphas: every event is a genuine same-sign merge
    alpha = (st.alpha[: cfg.budget].abs() + 1e-3).repeat(reps)[:slots].contiguous()
    count = torch.tensor(slots, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    tbl = None if table is None else table.to(dev)

    def go():
        return run_maintenance(sv, alpha, None, count, zero, cfg.gamma, tbl,
                               budget=cfg.budget, method=cfg.method)[1]

    go()                                                 # warm-up: kernels loaded
    times = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        go()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    per_event = sorted(times)[len(times) // 2] / events
    return per_event * cfg.slots / slots


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=40_000)
    ap.add_argument("--budget", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--stream", action="store_true",
                    help="train through the chunked streaming engine "
                         "(out-of-core path) instead of the resident arrays")
    ap.add_argument("--chunk-rows", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = make_susy_like(np.random.default_rng(1), args.n)
    (xtr, ytr), (xte, yte) = train_test_split(x, y)
    print(f"SUSY-like stream: n={xtr.shape[0]} d={x.shape[1]} budget={args.budget} on {dev} "
          f"(single pass{f', streamed in {args.chunk_rows}-row chunks' if args.stream else ''})")
    source = ArrayChunks(xtr, ytr, args.chunk_rows) if args.stream else None

    results, per_event = {}, {}
    for method in ("gss", "lookup-wd"):
        cfg = BSGDConfig(budget=args.budget, lambda_=2e-5, gamma=2.0**-7, method=method,
                         batch_size=args.batch_size)
        table = cfg.table()
        _sync(dev)
        t0 = time.time()
        if args.stream:
            st = fit_stream(cfg, source, epochs=1, seed=0, device=dev)
        else:
            st = fit(cfg, xtr, ytr, epochs=1, seed=0, device=dev)
        _sync(dev)
        dt = time.time() - t0
        acc = float(accuracy(st, xte, yte, cfg.gamma, device=dev))
        merges = int(st.n_merges)
        freq = merges / max(int(st.step) - 1, 1)
        # paper Fig. 3: share of training time spent on budget maintenance,
        # estimated as (events x per-event cost on the trained SV set) / total
        per_event[method] = merge_seconds_per_event(cfg, table, st)
        results[method] = dt
        print(f"  {method:10s} time={dt:7.2f}s acc={acc:.4f} merge_freq={freq:.1%} "
              f"merges={merges} merge_time={100 * merges * per_event[method] / dt:.0f}% "
              f"of total (est)")
    imp = 100 * (results["gss"] - results["lookup-wd"]) / results["gss"]
    merge_cut = 100 * (per_event["gss"] - per_event["lookup-wd"]) / per_event["gss"]
    print(f"total-training-time improvement (Lookup-WD vs GSS): {imp:.1f}% "
          f"(paper: up to 44% on SUSY)")
    print(f"paper figures on {dev}: total-training-time improvement {imp:.1f}% (paper 44%), "
          f"merging-time reduction {merge_cut:.1f}% (paper 65%)")


if __name__ == "__main__":
    main()
