"""Paired host timing of training steps and kernel calls across two source trees.

    python3 src/repro_torch/pair_timing.py --tree build/parent/src --tree src \
        [--pairs 10] [--steps 1000] [--class-steps 50] [--fused-steps 500] \
        [--calls 2000] [--kernels-only | --serve [--serve-calls 500]] \
        [--out pair_timing.json]

Each ``--tree`` is a ``src`` directory holding a ``repro_torch`` package (for
example the parent commit unpacked beside the working tree).  One worker
process per tree imports the package from that tree only, builds its kernels
and trains the binary main path of ``chip_smoke.py`` on the card (ADULT
stand-in, 32,561 x 123 from numpy seed 0, gamma 2^-7, lambda 1e-5, budget
500, batch 1) until the budget is full, once per configuration: ``lookup-wd``,
``gss`` and the fused step (``lookup-wd`` with the kernel cache and
``step_engine="pallas"``).  It does the same for ``chip_smoke.py``'s
class-axis runs (the MNIST-width stand-in, C = 10, 780 features, budget 500,
batch 8, the kernel cache, Lookup-WD), trained until every class is at its
budget: run (a) (the fused event engine, ``maintenance_engine="pallas"``),
run (b) (``multi-merge``, merge_batch 4), run (c) (the fused step) and run
(d) (the fused step under ``multi-merge``).  Then the workers take turns,
in the order A B B A for each two pairs, to run the same steps from that
same warm state, through the epoch loop (``train_epoch`` and
``train_epoch_multiclass``, as ``chip_smoke.py`` trains): ``--steps`` of
each binary configuration, ``--class-steps`` of run (b) and
``--fused-steps`` of runs (a), (c) and (d); a run's time is the host's wall
clock around its steps, with the card synchronised at both ends.
The steps are host-bound (a few to a few hundred small launches each), so
both workers keep their process warm across runs and only one of them runs
at a time.  In the same turns each worker also runs ``--calls`` back-to-back
calls of ``ops.merge_scores`` (s = 501) and ``ops.multi_merge_scores`` (C =
10, P = 4, s = 508) on the card, timed on the host clock.

Each tree's decisions are held to the other's: the integer state (count,
n_inserts, n_merges) of every warm state and after every run must be equal.
So are the bits of ``rbf_matrix`` at ``RBF_SHAPES`` (the binary path's
margin row, run (a)'s margin rows, a minibatch of 32 against that bank,
decision values), fp32 and bf16, on inputs from one seed: each worker
reports, once both are ready and one at a time, the SHA-256 of every
output and its device time a launch (``torch.profiler``).
The same holds for ``bdca_ascent`` at ``BDCA_SHAPES`` (the binary bdca
step's shape, C = 1, S = 501, count 501, and the class axis's, C = 10, S =
508), at 0, 1 and 2 rounds (0 runs only the initial ``f = b @ k`` and the
write-back), on inputs from one seed: SHA-256 of alpha after the call, and
device time a launch.  ``--kernels-only`` runs these kernel checks alone:
no training, no split, no pairs.
Before the pairs, each worker in turn (the other waiting) also splits the
fused step (``train_step``) of each fused configuration: its device time a
launch (``torch.profiler``, ``SPLIT_STEPS`` steps, each from the warm
state, so that every step keeps its shape) at the budget, where each step that inserts runs event rounds,
and with every count lowered by one batch, so that no round runs (the
margin rows and the insert alone).

``--serve`` compares the trees' serve cell (``kernels.ops.serve_cell``)
alone: no training.  On one model from a seed at ``chip_smoke.py``'s serve
shape (C = 10, s = 508, d = 780, 500 active slots a class) with an fp32 and
a bf16 bank, each worker reports, once both are ready and one at a time,
the SHA-256 of the scores and of the labels at ``SERVE_ROWS`` rows and the
device µs of the whole cell a call (every kernel it launches, from
``torch.profiler``); then the workers take turns, A B B A, each running
``--serve-calls`` back-to-back cells of each shape, timed on the host clock
(µs a call).

Prints each run and, per configuration, each tree's median, quartiles, mean
and range, the same of the paired differences (second tree minus first) and
in how many pairs the second tree was slower; ``--out`` also writes them as
JSON.  Exits 1 if the two trees' decisions, rbf_matrix bits,
bdca_ascent bits or serve cell bits differ anywhere.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the binary configurations and the class-axis runs, by name
BINARY = {"lookup-wd": dict(method="lookup-wd"), "gss": dict(method="gss"),
          "fused lookup-wd": dict(method="lookup-wd", use_kernel_cache=True,
                                  step_engine="pallas")}
CLASS_RUNS = {"merge_event engine (a)": dict(maintenance_engine="pallas"),
              "multi-merge (b)": dict(maintenance="multi-merge", merge_batch=4),
              "fused merge (c)": dict(step_engine="pallas"),
              "fused multi-merge (d)": dict(step_engine="pallas", maintenance="multi-merge",
                                            merge_batch=4)}
OPS = ("op merge_scores", "op multi_merge_scores")
N_ROWS, DIM, BUDGET, GAMMA, LAMBDA = 32_561, 123, 500, 2.0 ** -7, 1e-5
WARM_STEPS = 4_000
# run (b) of chip_smoke.py: LIBSVM mnist's widths, budget 500 a class, batch 8
MC_CLASSES, MC_DIM, MC_TRAIN, MC_TEST, MC_BATCH = 10, 780, 60_000, 10_000, 8
MC_WARM_STEPS = 700
SPLIT_STEPS = 50
# rbf_matrix's shapes (n, m, d) held bit for bit across the trees
RBF_SHAPES = [(1, 501, 123), (8, 5_080, 780), (32, 5_080, 780), (6_512, 501, 123)]
# bdca_ascent's shapes (C, S, counts) and rounds, held bit for bit across the
# trees; the box is the binary bdca run's (box_from_lambda(26,049, 1e-5))
BDCA_SHAPES = [(1, 501, [501]), (10, 508, [500 + q % 9 for q in range(10)])]
BDCA_ROUNDS = (0, 1, 2)
BDCA_BOX = 3.8389
# --serve: the serve cell's row counts (a small, a middle and a full
# microbatch of chip_smoke.py's queues) and banks
SERVE_ROWS = (8, 64, 256)
SERVE_BANKS = ("fp32", "bf16")
SERVE_SLOTS, SERVE_ACTIVE, SERVE_GAMMA = BUDGET + MC_BATCH, BUDGET, 2.0 ** -11


def worker(tree: str, kernels_only: bool, serve: bool = False) -> None:
    """Serve ``run <method> <steps>`` and ``op <name> <calls>`` requests on
    stdin, one JSON line each (with ``kernels_only``, only the kernel
    checks; with ``serve``, only ``serve`` and ``serve <n> <bank> <calls>``)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from repro_torch.core import bsgd
    from repro_torch.data import make_blobs, train_test_split
    from repro_torch.kernels import _build

    _build.build()
    dev = torch.device("cuda")
    if serve:
        _serve_worker(tree, dev)
        return
    checks = {"rbf": _rbf_checks, "bdca": _bdca_checks}
    if kernels_only:
        print(json.dumps({"ready": tree, "decisions": {}}), flush=True)
        for line in sys.stdin:
            print(json.dumps(checks[line.strip()](dev)), flush=True)
        return
    x, y = make_blobs(np.random.default_rng(0), N_ROWS, DIM, sep=0.25, noise=1.3)
    (xtr, ytr), _ = train_test_split(x, y, test_frac=0.2)
    perm = torch.randperm(xtr.shape[0], generator=torch.Generator().manual_seed(0))
    xs = torch.as_tensor(xtr)[perm].to(dev)
    ys = torch.as_tensor(ytr)[perm].to(dev)
    warm = {}
    for name, knobs in BINARY.items():
        cfg = bsgd.BSGDConfig(budget=BUDGET, lambda_=LAMBDA, gamma=GAMMA, batch_size=1, **knobs)
        table = cfg.table()
        table = None if table is None else table.to(dev)
        st = bsgd.train_epoch(cfg, table, bsgd.init_state(cfg, DIM, device=dev), xs, ys,
                              torch.arange(WARM_STEPS, device=dev), device=dev)
        torch.cuda.synchronize()
        warm[name] = (cfg, table, st)
    class_data = _class_data(dev)
    for name, knobs in CLASS_RUNS.items():
        warm[name] = _warm_class_run(dev, knobs, class_data)
    op_inputs = _op_inputs(dev)
    from repro_torch.core import multiclass as mc
    from repro_torch.kernels import ops

    def split():
        out = {}
        for name in ("fused lookup-wd", "fused merge (c)", "fused multi-merge (d)"):
            if name in BINARY:
                cfg, table, st = warm[name]
                rows, step_fn, data = 1, bsgd.train_step, (xs, ys)
                start = WARM_STEPS
            else:
                cfg, table, st, *data = warm[name]
                rows, step_fn = MC_BATCH, mc.train_step_multiclass
                start = MC_WARM_STEPS * MC_BATCH
            below = st._replace(count=st.count - rows)
            out[name] = {case: _step_device_us(step_fn, cfg, table, state, data, start, rows)
                         for case, state in (("at budget", st), ("below budget", below))}
        return out

    print(json.dumps({"ready": tree, "decisions": {m: _decisions(w[2]) for m, w in warm.items()}}),
          flush=True)
    for line in sys.stdin:
        if line.strip() in ("rbf", "bdca", "split"):   # device times, while the other waits
            what = line.strip()
            print(json.dumps(split() if what == "split" else checks[what](dev)), flush=True)
            continue
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
        elif kind in CLASS_RUNS:   # the epoch loop, as chip_smoke.py's runs train
            cfg, table, st, xm, ym = warm[kind]
            order = torch.arange(MC_WARM_STEPS * MC_BATCH, (MC_WARM_STEPS + n) * MC_BATCH,
                                 device=dev)
            st = mc.train_epoch_multiclass(cfg, table, st, xm, ym, order, device=dev)
            torch.cuda.synchronize()
            res = _decisions(st)
        else:
            cfg, table, st = warm[kind]
            order = torch.arange(WARM_STEPS, WARM_STEPS + n, device=dev)
            st = bsgd.train_epoch(cfg, table, st, xs, ys, order, device=dev)
            torch.cuda.synchronize()
            res = _decisions(st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(json.dumps({"us_per_step": secs / n * 1e6, **res}), flush=True)


def _rbf_checks(dev) -> dict:
    """``{"n x m x d dtype": {"sha256": ..., "device_us": ...}}`` of
    ``ops.rbf_matrix`` at each of ``RBF_SHAPES``, fp32 and bf16 operands made
    from one seed a shape; the device time a launch from ``torch.profiler``
    over 50 launches (None if it reports no such kernel)."""
    import hashlib

    import torch
    from repro_torch.kernels import ops

    out = {}
    for n, m, d in RBF_SHAPES:
        gen = torch.Generator().manual_seed(n * 7 + m + d)
        x32, y32 = torch.randn(n, d, generator=gen), torch.randn(m, d, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, y = x32.to(dev, dtype), y32.to(dev, dtype)
            k = ops.rbf_matrix(x, y, 2.0 ** -7, impl="cuda")
            digest = hashlib.sha256(k.cpu().numpy().tobytes()).hexdigest()
            out[f"{n}x{m}x{d} {str(dtype)[6:]}"] = dict(sha256=digest, device_us=_device_us(
                lambda: ops.rbf_matrix(x, y, 2.0 ** -7, impl="cuda"), 50, "rbf_"))
    return out


def _device_us(call, calls: int, kernel: str):
    """Mean device µs a launch of the kernels whose name holds ``kernel``
    over ``calls`` calls of ``call``, from ``torch.profiler`` (None if it
    reports no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            count += ev.count
    return total / count if count and total > 0 else None


def _bdca_checks(dev) -> dict:
    """``{"C=c S=s rN": {"sha256": ..., "device_us": ...}}`` of
    ``ops.bdca_ascent`` at each of ``BDCA_SHAPES`` and ``BDCA_ROUNDS``: a
    unit-diagonal RBF Gram matrix of random points (exactly symmetric) and
    coefficients inside the box, from one seed a shape; alpha's SHA-256
    after one call, and the device time a launch from ``torch.profiler``
    over 20 launches, each on a fresh copy of alpha (None if it reports no
    such kernel)."""
    import hashlib

    import torch
    from repro_torch.kernels import ops

    out = {}
    for c, s, counts in BDCA_SHAPES:
        gen = torch.Generator().manual_seed(c * 1_000 + s)
        x = torch.randn(c, s, 8, generator=gen)
        k = torch.exp(-0.3 * ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1))
        k[:, torch.arange(s), torch.arange(s)] = 1.0
        sign = torch.where(torch.rand(c, s, generator=gen) < 0.5, -1.0, 1.0)
        a0 = (torch.rand(c, s, generator=gen) * BDCA_BOX * sign).to(dev)
        k, n = k.to(dev), torch.tensor(counts, dtype=torch.int32, device=dev)
        for rounds in BDCA_ROUNDS:
            a = a0.clone()
            ops.bdca_ascent(a, k, n, BDCA_BOX, rounds, impl="cuda")
            digest = hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()

            def call():
                a.copy_(a0)
                ops.bdca_ascent(a, k, n, BDCA_BOX, rounds, impl="cuda")

            out[f"C={c} S={s} r{rounds}"] = dict(sha256=digest,
                                                  device_us=_device_us(call, 20, "bdca_ascent"))
    return out


def _serve_worker(tree: str, dev) -> None:
    """``--serve``'s worker: the cell's bits and device time (``serve``), and
    ``serve <n> <bank> <calls>``: µs a call on the host clock."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(21)
    sv_x = torch.randn(MC_CLASSES, SERVE_SLOTS, MC_DIM, generator=gen)
    alpha = torch.randn(MC_CLASSES, SERVE_SLOTS, generator=gen) * 0.3
    alpha[:, SERVE_ACTIVE:] = 0.0                  # export_model zeroes the inactive slots
    banks = {"fp32": sv_x.to(dev), "bf16": sv_x.to(dev, torch.bfloat16)}
    alpha = alpha.to(dev)
    x = torch.randn(max(SERVE_ROWS), MC_DIM, generator=gen).to(dev)
    cell = lambda n, bank: ops.serve_cell(x[:n], banks[bank], alpha, SERVE_GAMMA, impl="cuda")
    for n in SERVE_ROWS:                           # warm: builds, allocations, tickets
        for bank in SERVE_BANKS:
            cell(n, bank)
    torch.cuda.synchronize()
    print(json.dumps({"ready": tree, "decisions": {}}), flush=True)
    for line in sys.stdin:
        words = line.split()
        if words == ["serve"]:
            print(json.dumps(_serve_checks(cell)), flush=True)
            continue
        n, bank, calls = int(words[1]), words[2], int(words[3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            cell(n, bank)
        torch.cuda.synchronize()
        print(json.dumps({"us_per_step": (time.perf_counter() - t0) / calls * 1e6}), flush=True)


def _serve_checks(cell) -> dict:
    """``{"n rows bank": {"scores_sha256", "labels_sha256", "device_us"}}`` of
    the serve cell at each of ``SERVE_ROWS`` and ``SERVE_BANKS``; device µs a
    call: every kernel of 50 calls from ``torch.profiler`` (None if it
    reports none)."""
    import hashlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for n in SERVE_ROWS:
        for bank in SERVE_BANKS:
            scores, labels = cell(n, bank)
            sha = {f"{k}_sha256": hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                   for k, v in (("scores", scores), ("labels", labels))}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    cell(n, bank)
                torch.cuda.synchronize()
            busy = sum(ev.self_device_time_total for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA)
            kernels = sorted({ev.key[:60] for ev in prof.key_averages()
                              if ev.device_type == DeviceType.CUDA})
            out[f"{n} rows {bank}"] = dict(**sha, device_us=busy / 50 if busy > 0 else None,
                                           kernels=kernels)
    return out


def _decisions(st) -> dict:
    """A state's integer decisions: count, n_inserts and n_merges."""
    return {f: getattr(st, f).tolist() for f in ("count", "n_inserts", "n_merges")}


def _step_device_us(step_fn, cfg, table, state, data, start, rows):
    """Mean device µs a ``train_step`` launch over ``SPLIT_STEPS`` steps from
    ``state`` (the step function leaves its input as it was), each on the
    next minibatch of ``rows`` rows from row ``start`` of ``data``; None if
    the profiler reports no such kernel."""
    import torch

    x, y = data

    def steps():
        for i in range(SPLIT_STEPS):
            lo = start + i * rows
            step_fn(cfg, table, state, x[lo:lo + rows], y[lo:lo + rows])
        torch.cuda.synchronize()

    steps()                                   # warm: allocations, the profiler's first window
    return _device_us(steps, 1, "train_step_kernel")


def _class_data(dev):
    """The MNIST-width stand-in's training rows on the card, in run order."""
    import numpy as np
    import torch
    from repro_torch.data import make_blobs_multiclass

    x, y = make_blobs_multiclass(np.random.default_rng(0), MC_TRAIN + MC_TEST, MC_DIM,
                                 MC_CLASSES, sep=0.12, noise=1.0)
    perm = torch.randperm(MC_TRAIN, generator=torch.Generator().manual_seed(0))
    return (torch.as_tensor(x[MC_TEST:])[perm].to(dev),
            torch.as_tensor(y[MC_TEST:]).long()[perm].to(dev))


def _warm_class_run(dev, knobs, data):
    """A class-axis run's configuration trained from a fresh state until every
    class is at its budget."""
    import torch
    from repro_torch.core import multiclass as mc

    cfg = mc.MulticlassSVMConfig.create(MC_CLASSES, budget=BUDGET, lambda_=LAMBDA,
                                        gamma=2.0 ** -11, batch_size=MC_BATCH,
                                        method="lookup-wd", use_kernel_cache=True, **knobs)
    xs, ys = data
    table = cfg.table().to(dev)
    st = mc.train_epoch_multiclass(cfg, table, mc.init_multiclass_state(cfg, MC_DIM, device=dev),
                                   xs, ys, torch.arange(MC_WARM_STEPS * MC_BATCH, device=dev),
                                   device=dev)
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
    ap.add_argument("--fused-steps", type=int, default=500)
    ap.add_argument("--calls", type=int, default=2_000)
    ap.add_argument("--kernels-only", action="store_true",
                    help="only the rbf_matrix and bdca_ascent checks: no training, no pairs")
    ap.add_argument("--serve", action="store_true",
                    help="only the serve cell: its bits, device time and µs a call in pairs")
    ap.add_argument("--serve-calls", type=int, default=500)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.kernels_only, args.serve)
        return 0
    if len(args.tree) != 2:
        ap.error("give exactly two --tree")
    if args.serve and args.kernels_only:
        ap.error("--serve and --kernels-only are two different runs")
    extra = ["--kernels-only"] if args.kernels_only else ["--serve"] if args.serve else []
    procs = [subprocess.Popen([sys.executable, __file__, "--tree", t, "--worker", t, *extra],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for t in args.tree]
    checks = [("rbf", "rbf_matrix"), ("bdca", "bdca_ascent")]
    if args.serve:
        checks = [("serve", "serve_cell")]
    elif not args.kernels_only:
        checks.append(("split", "split_device_us"))
    same = {}
    try:
        ready = []
        for t, p in zip(args.tree, procs):
            ready.append(json.loads(_reply(p)))
            print(f"worker {t}: {json.dumps(ready[-1])}", flush=True)
        same["warm states"] = ready[0]["decisions"] == ready[1]["decisions"]
        for r, p in zip(ready, procs):   # one worker at a time: the card is quiet
            for what, key in checks:
                p.stdin.write(f"{what}\n")
                p.stdin.flush()
                r[key] = json.loads(_reply(p))
            if "split_device_us" in r:
                print(f"worker {r['ready']}: fused-step device us a launch "
                      f"{json.dumps(r['split_device_us'])}", flush=True)
        for _, kernel in checks:
            if kernel == "split_device_us":
                continue
            for shape, first in ready[0][kernel].items():
                second = ready[1][kernel][shape]
                key = f"{kernel} {shape} bits"
                same[key] = all(first[h] == second[h] for h in first if h.endswith("sha256"))
                print(f"{kernel} {shape}: device us a launch {first['device_us']} (first tree) "
                      f"{second['device_us']} (second); bit-equal {same[key]}"
                      + (f"; kernels {first['kernels']} / {second['kernels']}"
                         if "kernels" in first else ""), flush=True)
        if args.serve:
            kinds = {f"serve {n} {b}": args.serve_calls for n in SERVE_ROWS for b in SERVE_BANKS}
        else:
            kinds = {} if args.kernels_only else {
                **{m: args.steps for m in BINARY},
                **{r: args.class_steps if r == "multi-merge (b)" else args.fused_steps
                   for r in CLASS_RUNS},
                **{o: args.calls for o in OPS}}
        runs = {m: {t: [] for t in args.tree} for m in kinds}
        for k in range(args.pairs):
            order = (0, 1) if k % 2 == 0 else (1, 0)          # A B, B A, A B, ...
            for method, n in kinds.items():
                ends = []
                for w in order:
                    procs[w].stdin.write(f"{method} {n}\n" if method in OPS or args.serve
                                         else f"run {method} {n}\n")
                    procs[w].stdin.flush()
                    res = json.loads(_reply(procs[w]))
                    runs[method][args.tree[w]].append(res.pop("us_per_step"))
                    ends.append(res)
                    print(f"pair {k} {method} {args.tree[w]}: {runs[method][args.tree[w]][-1]} "
                          f"us/step {json.dumps(res)}", flush=True)
                same[method] = same.get(method, True) and ends[0] == ends[1]
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
    print(f"decisions (count, n_inserts, n_merges), rbf_matrix, bdca_ascent and serve cell "
          f"bits equal between the trees: {json.dumps(same)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            steps=kinds, trees=args.tree, methods=report, decisions_equal=same,
            **{key: {t: r[key] for t, r in zip(args.tree, ready)} for _, key in checks}),
            indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
