#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each with its seconds; any failure ends the run with a
non-zero exit code:

  1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` each,
     all at once);
  3. each kernel against its plain PyTorch version on the card, at the
     training path's shapes and at ragged ones: max error against the stated
     tolerance, and the time per call of the kernel, the plain version and,
     where one exists, one PyTorch library call;
  4. the main path: ``fit`` for one epoch and ``accuracy`` on an ADULT
     stand-in at the LIBSVM a9a training set's size (32,561 x 123, two
     Gaussian blobs from a numpy seed, 20% test split), gamma 2^-7,
     lambda 1e-5, budget 500, batch 1, once with ``method="lookup-wd"`` and
     once with ``"gss"``.  Every kernel's launch counter is 0 before and
     read after;
  5. the first 2,000 steps of the same epoch again on the card and on the CPU
     (plain versions), with their integer state compared step by step;
  6. a profiled window of training steps: device busy time per step.

It prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
It imports nothing from the JAX package.  Without a CUDA device, or without
the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
N_ROWS, DIM, BUDGET = 32_561, 123, 500
REPLAY_STEPS = 2_000
PROFILE_STEPS = 300


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"[{self.name}] ...", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        secs = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[{self.name}] {status} in {secs:.3f} s", flush=True)
        return False


def time_call(fn, *, calls: int = 100, repeats: int = 7) -> float:
    """Median over ``repeats`` of the mean milliseconds per call of ``fn``,
    from CUDA events around ``calls`` back-to-back calls (after a warm-up)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / calls)
    return statistics.median(means)


def device_ms(fn, kernel_substr: str, calls: int = 50):
    """Mean device time per launch (ms) of kernels whose name contains
    ``kernel_substr``, from ``torch.profiler``; None if it reports none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_substr in ev.key:
            total += getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            count += ev.count
    return (total / count / 1e3) if count and total > 0 else None


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(out.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build(_build):
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"built {sorted(reports) or 'nothing (already built)'} in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernels(ops, ref, table):
    """Each kernel against its plain version; returns the main-shape records."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    gamma = 2.0 ** -7
    records = {}

    # rbf_matrix: margin / kappa rows (1 x 501) and decision values (6512 x 501)
    rbf_tol = 1e-5   # fp32 sums of d products in another order, times gamma
    for (n, m, d) in [(1, 501, 123), (6512, 501, 123), (3, 77, 5), (33, 17, 300)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, d, generator=gen).to(dev, dtype)
            y = torch.randn(m, d, generator=gen).to(dev, dtype)
            got = ops.rbf_matrix(x, y, gamma, impl="cuda")
            want = ref.rbf_matrix(x, y, gamma)
            err = (got - want).abs().max().item()
            k_ms = time_call(lambda: ops.rbf_matrix(x, y, gamma, impl="cuda"))
            p_ms = time_call(lambda: ref.rbf_matrix(x, y, gamma))
            nb = x.element_size() * (n + m) * d + 4 * n * m
            b_ms, b_by = bound_ms(nb, 2.0 * n * m * d + 2.0 * (n + m) * d + 5.0 * n * m)
            print(f"rbf_matrix {n}x{m}x{d} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {rbf_tol}) "
                  f"kernel {k_ms * 1e3:.2f} us plain {p_ms * 1e3:.2f} us bound {b_ms * 1e3:.4f} us "
                  f"({b_by})")
            check(err <= rbf_tol, f"rbf_matrix {n}x{m}x{d} {dtype} error {err}")
            if (n, m, d) == (1, 501, 123) and dtype == torch.float32:
                records["rbf_matrix"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None,
                    device_ms=device_ms(lambda: ops.rbf_matrix(x, y, gamma, impl="cuda"),
                                        "rbf_thin"))
            if (n, m, d) == (6512, 501, 123) and dtype == torch.float32:
                dm = device_ms(lambda: ops.rbf_matrix(x, y, gamma, impl="cuda"), "rbf_tiled")
                print(f"  rbf_tiled device time {dm and dm * 1e3} us")

    # merge_scores: 501 candidates against the 400 x 400 table
    wd_table = table.wd_table.to(dev)
    s = 501
    alpha = (torch.randn(s, generator=gen).abs() * 0.2 + 0.01).to(dev)
    kappa = torch.rand(s, generator=gen).to(dev)
    valid = (torch.rand(s, generator=gen) < 0.8).to(dev)
    a_min = torch.tensor([0.05], device=dev)
    wd, interp = ops.merge_scores(alpha, kappa, valid, a_min, wd_table, impl="cuda")
    wd_p, interp_p = ops.merge_scores(alpha, kappa, valid, a_min, wd_table, impl="ref")
    err = max((wd - wd_p)[valid].abs().max().item(), (interp - interp_p).abs().max().item())
    same_argmin = int(wd.argmin()) == int(wd_p.argmin())
    invalid_ok = bool((wd[~valid] >= ref.NO_PARTNER).all())
    k_ms = time_call(lambda: ops.merge_scores(alpha, kappa, valid, a_min, wd_table, impl="cuda"))
    p_ms = time_call(lambda: ops.merge_scores(alpha, kappa, valid, a_min, wd_table, impl="ref"))
    # one library call for the bilinear lookup alone (timed, never used by the port)
    import torch.nn.functional as F
    m_coord, k_coord = ref.merge_coords(a_min, alpha, kappa)
    grid = torch.stack([2 * k_coord - 1, 2 * m_coord - 1], dim=-1).view(1, 1, s, 2)
    img = wd_table.view(1, 1, *wd_table.shape)
    lib = F.grid_sample(img, grid, mode="bilinear", align_corners=True).view(s)
    lib_err = (lib - interp_p).abs().max().item()
    l_ms = time_call(lambda: F.grid_sample(img, grid, mode="bilinear", align_corners=True))
    # bytes: the candidate vectors, a_min, the table cells this run touches, both outputs
    g0, g1 = wd_table.shape
    i0 = torch.clamp(torch.floor(m_coord * (g0 - 1)).long(), 0, g0 - 2)
    j0 = torch.clamp(torch.floor(k_coord * (g1 - 1)).long(), 0, g1 - 2)
    cells = torch.cat([i0 * g1 + j0, i0 * g1 + j0 + 1, (i0 + 1) * g1 + j0,
                       (i0 + 1) * g1 + j0 + 1]).unique().numel()
    b_ms, b_by = bound_ms(s * (4 + 4 + 1) + 4 + 4 * cells + 2 * 4 * s, 25.0 * s)
    print(f"merge_scores s={s} G={g0}: max_abs_err {err:.3e} (tol 1e-6) argmin_equal {same_argmin} "
          f"invalid>=NO_PARTNER {invalid_ok} kernel {k_ms * 1e3:.2f} us plain {p_ms * 1e3:.2f} us "
          f"grid_sample {l_ms * 1e3:.2f} us (its err vs plain {lib_err:.2e}) "
          f"bound {b_ms * 1e3:.4f} us ({b_by}, {cells} table cells)")
    check(err <= 1e-6 and same_argmin and invalid_ok, "merge_scores against its plain version")
    records["merge_scores"] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
        device_ms=device_ms(lambda: ops.merge_scores(alpha, kappa, valid, a_min, wd_table,
                                                     impl="cuda"), "merge_scores_kernel"))

    # gss: 501 problems, 10 (eps 1e-2) and 48 (eps 1e-10) bracket steps
    m_in = torch.rand(s, generator=gen).to(dev)
    k_in = torch.rand(s, generator=gen).to(dev)
    for n_iters in (10, 48):
        h = ops.gss_solve(m_in, k_in, n_iters=n_iters, impl="cuda")
        h_p = ref.gss(m_in, k_in, n_iters)
        err = (h - h_p).abs().max().item()
        flips = int((h != h_p).sum())
        k_ms = time_call(lambda: ops.gss_solve(m_in, k_in, n_iters=n_iters, impl="cuda"))
        p_ms = time_call(lambda: ref.gss(m_in, k_in, n_iters), calls=20)
        b_ms, b_by = bound_ms(12.0 * s, s * (6.0 + 30.0 * n_iters))
        print(f"gss s={s} n_iters={n_iters}: max_abs_err {err:.3e} (tol 1e-6) differing {flips} "
              f"kernel {k_ms * 1e3:.2f} us plain {p_ms * 1e3:.2f} us bound {b_ms * 1e3:.4f} us "
              f"({b_by})")
        check(err <= 1e-6, f"gss n_iters={n_iters} error {err}")
        if n_iters == 10:
            records["gss"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                device_ms=device_ms(lambda: ops.gss_solve(m_in, k_in, n_iters=10, impl="cuda"),
                                    "gss_kernel"))
    return records


def adult_standin(make_blobs, train_test_split):
    # benchmarks/common.py's ADULT blobs use sep 0.6, which in 123 dimensions
    # is 99.5% separable (Bayes accuracy Phi(sep * sqrt(123) / (2 * noise)));
    # few rows then violate the margin and the budget barely fills.  sep 0.25
    # puts the Bayes accuracy at 85.7%, near the RBF-SVM accuracy on ADULT.
    x, y = make_blobs(np.random.default_rng(SEED), N_ROWS, DIM, sep=0.25, noise=1.3)
    return train_test_split(x, y, test_frac=0.2)


def phase_main(core, ops, data):
    (xtr, ytr), (xte, yte) = data
    runs = {}
    ops.reset_launch_counts()
    for method in ("lookup-wd", "gss"):
        cfg = core.BSGDConfig(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1,
                              method=method)
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = core.fit(cfg, xtr, ytr, epochs=1, seed=SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        acc = float(core.accuracy(st, xte, yte, cfg.gamma))
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        steps = int(st.step) - 1
        run = dict(count=int(st.count), n_inserts=int(st.n_inserts), n_merges=int(st.n_merges),
                   accuracy=acc, seconds=secs, us_per_step=secs / steps * 1e6, steps=steps,
                   launches=launches)
        print(f"fit {method}: {json.dumps(run)}")
        check(st.sv_x.is_cuda, "the state lives on the card")
        check(run["count"] <= BUDGET, f"{method}: count {run['count']} > budget")
        check(run["n_merges"] > 0, f"{method}: no merge events")
        check(launches["rbf_matrix"] > 0, f"{method}: rbf_matrix never launched")
        scorer = "merge_scores" if method == "lookup-wd" else "gss"
        check(launches[scorer] > 0, f"{method}: {scorer} never launched")
        runs[method] = (run, st, cfg)
    counts = ops.launch_counts()
    gap = abs(runs["lookup-wd"][0]["accuracy"] - runs["gss"][0]["accuracy"])
    print(f"accuracy lookup-wd vs gss: gap {gap:.4f} (limit 0.01)")
    check(gap <= 0.01, f"lookup-wd and gss accuracies differ by {gap}")
    return runs, counts


def phase_replay(core, data):
    """The first REPLAY_STEPS steps of the lookup-wd epoch on the card and on the CPU."""
    (xtr, ytr), (xte, yte) = data
    cfg = core.BSGDConfig(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1)
    perm = torch.randperm(xtr.shape[0], generator=torch.Generator().manual_seed(SEED))
    order = perm[:REPLAY_STEPS]
    results = {}
    for dev in ("cuda", "cpu"):
        table = cfg.table().to(dev)
        st = core.init_state(cfg, DIM, device=dev)
        xs = torch.as_tensor(xtr).to(dev).index_select(0, order.to(dev))
        ys = torch.as_tensor(ytr).to(dev).index_select(0, order.to(dev))
        trace = []
        t0 = time.perf_counter()
        for i in range(REPLAY_STEPS):
            st = core.train_step(cfg, table, st, xs[i:i + 1], ys[i:i + 1])
            trace.append(torch.stack([st.count, st.n_inserts, st.n_merges]))
        trace = torch.stack(trace).cpu().numpy()
        secs = time.perf_counter() - t0
        acc = float(core.accuracy(st, xte, yte, cfg.gamma, device=dev))
        results[dev] = (trace, acc)
        print(f"replay {dev}: {REPLAY_STEPS} steps in {secs:.3f} s, count {trace[-1, 0]} "
              f"n_inserts {trace[-1, 1]} n_merges {trace[-1, 2]} accuracy {acc:.4f}")
    diff = np.nonzero((results["cuda"][0] != results["cpu"][0]).any(axis=1))[0]
    first = int(diff[0]) if diff.size else None
    print(f"replay: first step whose integer state differs: {first}")
    gap = abs(results["cuda"][1] - results["cpu"][1])
    print(f"replay accuracy gap {gap:.4f} (limit 0.01)")
    check(gap <= 0.01, f"card and CPU replays differ in accuracy by {gap}")


def phase_profile(core, run):
    """Device busy time per step over PROFILE_STEPS lookup-wd steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, st, cfg = run
    rng = np.random.default_rng(SEED + 1)
    xs = torch.as_tensor(rng.standard_normal((PROFILE_STEPS, DIM)).astype(np.float32)).cuda()
    ys = torch.as_tensor(np.where(rng.random(PROFILE_STEPS) < 0.5, 1.0, -1.0)
                         .astype(np.float32)).cuda()
    table = cfg.table().to("cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            st = core.train_step(cfg, table, st, xs[i:i + 1], ys[i:i + 1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only: key_averages() also lists the aten ops that launched them
    rows = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    check(launches > 0, "the profiler saw no kernel on the card")
    print(f"profile: {PROFILE_STEPS} steps, wall {wall / PROFILE_STEPS * 1e6:.1f} us/step "
          f"(profiler on), device busy {busy_us / PROFILE_STEPS:.2f} us/step, "
          f"idle share {1 - busy_us / (wall * 1e6):.4f}, "
          f"kernels {launches / PROFILE_STEPS:.1f} per step")
    for dt, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dt / PROFILE_STEPS:8.3f} us/step  {count / PROFILE_STEPS:5.2f}/step  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script ({src})", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch import core
    from repro_torch.core.lookup import default_table
    from repro_torch.data import make_blobs, train_test_split
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("1 card"):
        phase_card()
    with Phase("2 build"):
        phase_build(_build)
    with Phase("3 kernels vs plain"):
        records = phase_kernels(ops, ref, default_table())
    with Phase("data"):
        data = adult_standin(make_blobs, train_test_split)
        print(f"ADULT stand-in: train {data[0][0].shape} test {data[1][0].shape}")
    with Phase("4 main path"):
        runs, counts = phase_main(core, ops, data)
    with Phase("5 card vs CPU replay"):
        phase_replay(core, data)
    with Phase("6 profile"):
        phase_profile(core, runs["lookup-wd"])

    meta = {
        "rbf_matrix": ("src/repro_torch/csrc/rbf_kernel.cu", "src/repro/kernels/rbf_kernel.py:57"),
        "merge_scores": ("src/repro_torch/csrc/merge_lookup.cu",
                         "src/repro/kernels/merge_lookup.py:65"),
        "gss": ("src/repro_torch/csrc/gss.cu", "src/repro/kernels/gss.py:48"),
    }
    kernels = [dict(name=name, route="cuda", source=src_path, replaces=replaces,
                    launches=counts[name], **records[name])
               for name, (src_path, replaces) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
