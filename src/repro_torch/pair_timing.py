"""Paired host timing of the binary training step across two source trees.

    python3 src/repro_torch/pair_timing.py --tree build/parent/src --tree src \
        [--pairs 10] [--steps 1000] [--out pair_timing.json]

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
one of them runs at a time.

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
N_ROWS, DIM, BUDGET, GAMMA, LAMBDA = 32_561, 123, 500, 2.0 ** -7, 1e-5
WARM_STEPS = 4_000


def worker(tree: str) -> None:
    """Serve ``run <method> <steps>`` requests on stdin, one JSON line each."""
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
    print(json.dumps({"ready": tree, "count": {m: int(w[2].count) for m, w in warm.items()}}),
          flush=True)
    for line in sys.stdin:
        _, method, steps = line.split()
        cfg, table, st = warm[method]
        steps = int(steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WARM_STEPS, WARM_STEPS + steps):
            st = bsgd.train_step(cfg, table, st, xs[i:i + 1], ys[i:i + 1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(json.dumps({"us_per_step": secs / steps * 1e6, "n_merges": int(st.n_merges),
                          "count": int(st.count)}), flush=True)


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
        runs = {m: {t: [] for t in args.tree} for m in METHODS}
        for k in range(args.pairs):
            order = (0, 1) if k % 2 == 0 else (1, 0)          # A B, B A, A B, ...
            for method in METHODS:
                for w in order:
                    procs[w].stdin.write(f"run {method} {args.steps}\n")
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
    for method in METHODS:
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
        Path(args.out).write_text(json.dumps(dict(steps=args.steps, trees=args.tree,
                                                  methods=report), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
