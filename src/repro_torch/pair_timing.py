"""Paired host timing of training steps and kernel calls across two source trees.

    python3 src/repro_torch/pair_timing.py --tree build/parent/src --tree src \
        [--pairs 10] [--steps 1000] [--class-steps 50] [--calls 2000] \
        [--out pair_timing.json]

Each ``--tree`` is a ``src`` directory holding a ``repro_torch`` package (for
example the parent commit unpacked beside the working tree).  One worker
process per tree imports the package from that tree only, builds its kernels
and trains the binary main path of ``chip_smoke.py`` on the card (ADULT
stand-in, 32,561 x 123 from numpy seed 0, gamma 2^-7, lambda 1e-5, budget
500, batch 1) until the budget is full.  Then the workers take turns, in
the order A B B A for each two pairs, to run the same ``--steps`` steps
from that same warm state, once per method (``lookup-wd`` and ``gss``); a
run's time is the host's wall clock around its steps, with the card
synchronised at both ends.  The step is host-bound (a few hundred small
launches), so both workers keep their process warm across runs and only
one of them runs at a time.  In the same turns each worker also runs
``--class-steps`` steps of ``chip_smoke.py``'s class-axis run (b) (the
MNIST-width stand-in, C = 10, 780 features, budget 500, batch 8, the kernel
cache, ``multi-merge`` with merge_batch 4) from a state trained until every
class is at its budget, and ``--calls`` back-to-back calls of
``ops.merge_scores`` (s = 501) and ``ops.multi_merge_scores`` (C = 10, P =
4, s = 508) on the card, timed on the host clock.

Prints each run and, per method, each tree's median, quartiles, mean and
range, the same of the paired differences (second tree minus first) and in
how many pairs the second tree was slower; ``--out`` also writes them as
JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

METHODS = ("lookup-wd", "gss")
CLASS_RUN = "multi-merge (b)"
OPS = ("op merge_scores", "op multi_merge_scores")
N_ROWS, DIM, BUDGET, GAMMA, LAMBDA = 32_561, 123, 500, 2.0 ** -7, 1e-5
WARM_STEPS = 4_000
# run (b) of chip_smoke.py: LIBSVM mnist's widths, budget 500 a class, batch 8
MC_CLASSES, MC_DIM, MC_TRAIN, MC_TEST, MC_BATCH = 10, 780, 60_000, 10_000, 8
MC_WARM_STEPS = 700


def worker(tree: str) -> None:
    """Serve ``run <method> <steps>`` and ``op <name> <calls>`` requests on
    stdin, one JSON line each."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from repro_torch.core import bsgd
    from repro_torch.data import make_blobs, train_test_split
    from repro_torch.kernels import _build

    _build.build()
    dev = torch.device("cuda")
    x, y = make_blobs(np.random.default_rng(0), N_ROWS, DIM, sep=0.25, noise=1.3)
    (xtr, ytr), _ = train_test_split(x, y, test_frac=0.2)
    perm = torch.randperm(xtr.shape[0], generator=torch.Generator().manual_seed(0))
    xs = torch.as_tensor(xtr)[perm].to(dev)
    ys = torch.as_tensor(ytr)[perm].to(dev)
    warm = {}
    for method in METHODS:
        cfg = bsgd.BSGDConfig(budget=BUDGET, lambda_=LAMBDA, gamma=GAMMA, batch_size=1,
                              method=method)
        table = cfg.table()
        table = None if table is None else table.to(dev)
        st = bsgd.init_state(cfg, DIM, device=dev)
        for i in range(WARM_STEPS):
            st = bsgd.train_step(cfg, table, st, xs[i:i + 1], ys[i:i + 1])
        torch.cuda.synchronize()
        warm[method] = (cfg, table, st)
    warm[CLASS_RUN] = _warm_class_run(dev)
    op_inputs = _op_inputs(dev)
    print(json.dumps({"ready": tree, "count": {m: w[2].count.tolist() for m, w in warm.items()}}),
          flush=True)
    from repro_torch.core import multiclass as mc
    from repro_torch.kernels import ops
    for line in sys.stdin:
        head, n = line.rsplit(" ", 1)
        kind, n = head.removeprefix("run "), int(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind in OPS:
            name = kind.split()[1]
            fn, args = getattr(ops, name), op_inputs[name]
            for _ in range(n):
                fn(*args, impl="cuda")
            res = {}
        elif kind == CLASS_RUN:
            cfg, table, st, xm, ym = warm[kind]
            for i in range(MC_WARM_STEPS, MC_WARM_STEPS + n):
                sl = slice(i * MC_BATCH, (i + 1) * MC_BATCH)
                st = mc.train_step_multiclass(cfg, table, st, xm[sl], ym[sl])
            torch.cuda.synchronize()
            res = {"n_merges": int(st.n_merges.sum()), "count": st.count.tolist()}
        else:
            cfg, table, st = warm[kind]
            for i in range(WARM_STEPS, WARM_STEPS + n):
                st = bsgd.train_step(cfg, table, st, xs[i:i + 1], ys[i:i + 1])
            torch.cuda.synchronize()
            res = {"n_merges": int(st.n_merges), "count": int(st.count)}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(json.dumps({"us_per_step": secs / n * 1e6, **res}), flush=True)


def _warm_class_run(dev):
    """Run (b) trained from a fresh state until every class is at its budget."""
    import numpy as np
    import torch
    from repro_torch.core import multiclass as mc
    from repro_torch.data import make_blobs_multiclass

    cfg = mc.MulticlassSVMConfig.create(MC_CLASSES, budget=BUDGET, lambda_=LAMBDA,
                                        gamma=2.0 ** -11, batch_size=MC_BATCH,
                                        method="lookup-wd", use_kernel_cache=True,
                                        maintenance="multi-merge", merge_batch=4)
    x, y = make_blobs_multiclass(np.random.default_rng(0), MC_TRAIN + MC_TEST, MC_DIM,
                                 MC_CLASSES, sep=0.12, noise=1.0)
    perm = torch.randperm(MC_TRAIN, generator=torch.Generator().manual_seed(0))
    xs = torch.as_tensor(x[MC_TEST:])[perm].to(dev)
    ys = torch.as_tensor(y[MC_TEST:]).long()[perm].to(dev)
    table = cfg.table().to(dev)
    st = mc.init_multiclass_state(cfg, MC_DIM, device=dev)
    for i in range(MC_WARM_STEPS):
        sl = slice(i * MC_BATCH, (i + 1) * MC_BATCH)
        st = mc.train_step_multiclass(cfg, table, st, xs[sl], ys[sl])
    torch.cuda.synchronize()
    return cfg, table, st, xs, ys


def _op_inputs(dev):
    """The arguments of ``ops.merge_scores`` (one partner, s = 501) and
    ``ops.multi_merge_scores`` (C = 10, P = 4, s = 508), from a seed."""
    import torch
    from repro_torch.core.lookup import default_table

    gen = torch.Generator().manual_seed(0)
    tab = default_table().to(dev)
    s = 501
    alpha = (torch.randn(s, generator=gen).abs() * 0.2 + 0.01).to(dev)
    single = (alpha, torch.rand(s, generator=gen).to(dev),
              (torch.rand(s, generator=gen) < 0.8).to(dev), torch.tensor([0.05], device=dev),
              tab.wd_table)
    c, p, s = MC_CLASSES, 4, BUDGET + MC_BATCH
    alpha = (torch.randn(c, s, generator=gen).abs() * 0.2 + 0.01).to(dev)
    multi = (alpha, torch.rand(c, p, s, generator=gen).to(dev),
             (torch.rand(c, p, s, generator=gen) < 0.8).to(dev),
             (alpha[:, :p] * 0.5).contiguous(), tab)
    return {"merge_scores": single, "multi_merge_scores": multi}


def _reply(proc) -> str:
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"worker {proc.args[-1]} ended with exit code {proc.wait()}")
    return line.strip()


def _summary(xs):
    q1, _, q3 = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else (xs[0],) * 3
    return dict(median=statistics.median(xs), q1=q1, q3=q3, mean=statistics.fmean(xs),
                min=min(xs), max=max(xs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a src directory holding repro_torch (give exactly two)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=1_000)
    ap.add_argument("--class-steps", type=int, default=50)
    ap.add_argument("--calls", type=int, default=2_000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    if len(args.tree) != 2:
        ap.error("give exactly two --tree")
    procs = [subprocess.Popen([sys.executable, __file__, "--tree", t, "--worker", t],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for t in args.tree]
    try:
        for t, p in zip(args.tree, procs):
            print(f"worker {t}: {_reply(p)}", flush=True)
        kinds = {**{m: args.steps for m in METHODS}, CLASS_RUN: args.class_steps,
                 **{o: args.calls for o in OPS}}
        runs = {m: {t: [] for t in args.tree} for m in kinds}
        for k in range(args.pairs):
            order = (0, 1) if k % 2 == 0 else (1, 0)          # A B, B A, A B, ...
            for method, n in kinds.items():
                for w in order:
                    procs[w].stdin.write(f"{method} {n}\n" if method in OPS
                                         else f"run {method} {n}\n")
                    procs[w].stdin.flush()
                    res = json.loads(_reply(procs[w]))
                    runs[method][args.tree[w]].append(res["us_per_step"])
                    print(f"pair {k} {method} {args.tree[w]}: {json.dumps(res)}", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.stdin.close()
            p.wait(timeout=120)
    report = {}
    for method in kinds:
        a, b = (runs[method][t] for t in args.tree)
        diffs = [y - x for x, y in zip(a, b)]
        report[method] = dict(runs=runs[method], summary={t: _summary(runs[method][t])
                                                          for t in args.tree},
                              paired_diff_us=_summary(diffs),
                              second_slower_in=sum(d > 0 for d in diffs), pairs=len(diffs))
        print(f"{method}: {json.dumps({t: report[method]['summary'][t] for t in args.tree})}")
        print(f"{method}: second minus first, per pair: {json.dumps(_summary(diffs))}; "
              f"second slower in {report[method]['second_slower_in']} of {len(diffs)} pairs")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(steps=kinds, trees=args.tree, methods=report),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
