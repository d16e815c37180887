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
     where one exists, one PyTorch library call; ``merge_pick`` bit for bit
     at the binary path's shape, on rows, ragged, with exact score ties and
     with rows that have no valid candidate; the wrappers' raw stream against
     ``torch.cuda.current_stream()``; the host time of one ``merge_scores``
     call part by part, each part as it was before the lean launch path and
     as it is now; and ``rbf_thin``/``rbf_tiled`` on rows holding a NaN or
     an Inf, NaN exactly where the plain version has NaN;
  4. the main path: ``fit`` for one epoch over the first ``MAIN_STEPS``
     training rows (a ``CUT:`` line) and ``accuracy`` on an ADULT
     stand-in at the LIBSVM a9a training set's size (32,561 x 123, two
     Gaussian blobs from a numpy seed, 20% test split), gamma 2^-7,
     lambda 1e-5, budget 500, batch 1, once with ``method="lookup-wd"``
     (one ``merge_pick`` launch a step, no ``merge_scores``) and once with
     ``"gss"``.  Every kernel's launch counter is 0 before and read after;
  5. the first 2,000 steps of the same epoch again on the card and on the CPU
     (plain versions), with their integer state compared step by step;
  6. a profiled window of training steps: device busy time per step;
  7. the class-axis kernels (``multi_merge_scores``, ``multi_merge_choose``,
     ``merge_event``, ``merge_event_rounds``) against their plain versions on
     the card, at the class-axis runs' shapes and at ragged ones, fp32 and
     bf16 banks, with a forced removal fallback; ``multi_merge_choose`` bit
     for bit also at P = 1 and P = 8, with exact score ties and a class below
     its budget; ``merge_event_rounds`` bit for bit also against batch-size
     single-round ``merge_event`` launches; the two event kernels' device
     time at their fixed cluster size (``merge_event.CLUSTER``) and at
     K = 16 and 1;
  8. the one-vs-rest class axis at the widths of LIBSVM's multi-class
     ``mnist`` (10 classes, 780 features, 60,000 training and 10,000 test
     rows; a numpy stand-in, ``make_blobs_multiclass`` seed 0, sep 0.12,
     noise 1.0), gamma 2^-11, lambda 1e-5, budget 500 per class, batch 8,
     the kernel cache and Lookup-WD: run (a), one epoch with the fused
     event engine (``maintenance_engine="pallas"``, one
     ``merge_event_rounds`` launch a step and no ``merge_event``), and run
     (b), ``MC_STEPS["b"]`` steps of the epoch with
     ``maintenance="multi-merge"``, merge_batch 4 (one ``multi_merge_choose``
     launch a maintenance round, 8 a step, and no ``multi_merge_scores``);
     a ``CUT:`` line says how many steps each run trains.  Every launch
     counter is 0 before each run and read after it;
  9. the first 300 steps of run (a) on the card and on the CPU in lockstep,
     integer state compared step by step (where it first differs, the cause
     must be a near-tie: a margin on either side of 1, or tied event
     scores), then the cache invariants I1-I3 of both;
 10. a short profiled window of each class-axis run;
 11. the fused ``train_step`` kernel against its plain version on the card,
     from the same state, at the cluster size the launch chooses (printed as
     ``K=``) and at K = 1, 2 and 8 (and 16 on the ragged shape), every K bit
     for bit equal to K = 1: the class axis (C = 10, S = 508, D = 780, batch
     8) under ``merge`` and ``multi-merge``, a bf16 bank, a state below the
     budget, one class below its budget beside classes over it with a
     removal fallback, a ragged shape (S = 37, fewer slots than warps in a
     cluster) and the binary shape (C = 1, S = 501, D = 123, batch 1) with
     and without its one round; the device time of the class-axis, binary
     and below-budget cases at the chosen K and at K = 1; then, with
     ``step_engine="pallas"`` (one ``train_step``
     launch a step), run (c) (``merge``) and run (d) (``multi-merge``,
     merge_batch 4), one whole class-axis epoch each, and the binary fused
     run, one epoch of the ADULT stand-in with the cache at batch 1;
 12. the first 1,000 steps of run (c) on the card twice in lockstep, through
     the fused kernel and through run (a)'s composed engine, integer state
     compared step by step (where they first differ, the cause must be a
     near-tie), then the cache invariants of both;
 13. a profiled window of runs (c) and (d) and of the binary fused run;
 14. 100 more steps of run (b)'s configuration from where run (b) stopped,
     on the card, with every maintenance round run twice from the same state,
     through the ``multi_merge_choose`` kernel and through the plain scoring
     and choice (``impl="ref"``): count, sv_x, alpha and kmat equal bit for
     bit at every round;
 15. serving (run after phase 11's runs), from run (c)'s state exported with
     an fp32 and a bf16 bank: the serve cell (one ``class_scores`` launch)
     over the 10,000 test rows in one direct call bit-equal, scores and
     labels, to today's cell (``rbf_tiled``'s K contracted by the plain
     version), and as microbatches at every bucket of
     ``default_buckets(256)`` and at the ragged trace's offsets bit-equal to
     the direct call; the same against today's cell at 8, 16, 100 and 200
     rows (each of the kernel's row tiles) on a ragged C = 3, s = 37 with an
     exact tie, a binary model with exact zero scores, rows holding NaN and
     Inf (multiclass and binary) and C = 40, s = 1,008, d = 5; over the
     10,000 rows and at 8, 64 and 256 rows, each bank, the cell against the
     plain version (``rbf_matrix_rows`` then ``class_scores_labels``: scores
     within 1e-5 of the products' size, labels equal off near-ties) and
     ``rbf_tiled`` against ``rbf_matrix_rows`` within 1e-5; its device time
     at 8, 64 and 256 rows, each bank, beside its bound, the plain version
     and the contraction's einsum;
     ``drive_trace`` over the ragged trace with the sync and the async
     queue, each bank (every launch counter 0 before and read after: one
     ``class_scores`` launch a serve cell, no ``rbf_matrix``), with no kernel
     library loaded and no device memory reserved after the warm-up; a
     profiled window of each queue beside the launch counters; labels equal
     ``predict_multiclass`` and accuracy run (c)'s; a checkpoint written and
     served back bit-equal;
 16. streaming (after phase 14), every time and byte count beside the card's
     name and power limit: (a) run (c)'s configuration streamed from the
     60,000 training rows written as 15 npz chunks of 4,100 rows (rows carry
     across every boundary) by ``fit_multiclass_stream`` with ``prefetch=2``
     and ``0``, bit-equal to each other and to ``train_epoch_multiclass`` on
     ``epoch_permutation``, and replayed from CUDA graphs (``cuda_graph``)
     bit-equal too; µs a step, peak device bytes, a profiled window of two
     chunks; (b) killed after 7 chunks and resumed, then resumed past a torn
     newest step, bit-equal to (a); (c) a faulty source (transient IO
     errors, truncated reads, chunk 4 fatal) bit-equal to the clean run
     without chunk 4, and a NaN/Inf chunk under ``guard_finite`` rolled back
     exactly where the plain version (``impl="ref"``) rolls it back, with
     the guard's cost a chunk; (d) the binary
     paper path (``lookup-wd``, batch 1, no cache) streamed over the ADULT
     stand-in in 2,048-row chunks (a ``CUT:`` line: 2 chunks) bit-equal to
     ``train_epoch``, the binary fused epoch streamed whole bit-equal to its
     in-memory twin, and ``LibsvmChunks`` bit-equal to ``ArrayChunks`` of the
     same rows; (e) ``prequential_stream`` on the ADULT stand-in with a label
     flip from the middle chunk, twice, identical; (f) the ``--live``
     trainer's CUDA-graph chunk programs bit-equal to the eager ones over two
     chunks, with equal launch counts, then ``serve_svm_live`` at MNIST width
     over the 60,000 rows with its trace submitted at once, as the CLI does,
     and more than one version served, then its chaos drill (a ``CUT:`` line)
     with a trainer restart.  Every
     launch counter is 0 before each streamed run and read after it;
 17. the second solver (``solver="bdca"``, dual coordinate ascent on the
     kernel cache): (a) ``bdca_ascent`` bit for bit against its plain
     version at the binary shape (C = 1, S = 501) and the class shape (C =
     10, S = 508), each also at 0 rounds, ragged shapes (S = 37, classes
     below their count, frozen slots, slots at the box, rounds 1 and 4),
     the chain's block edges (S = 70: counts 31, 32, 33 and 65 at rounds 1
     and 3; counts 1 and 0) and S = 1,100, with µs a call, device µs a
     launch, the plain version's µs and the bound; at the binary and class
     shapes the launch split into its initial pass (rounds 0) and its
     sweep's ns a coordinate, the chain warp alone (clock64 cycles a
     coordinate) and the chain floor (the dependent instructions of a link
     read from the kernel's SASS, their latencies measured on the card);
     (b) 8,192 steps of a bdca epoch of phase 4's ADULT stand-in (a ``CUT:`` line; the cache,
     ``bdca_C = box_from_lambda(n, 1e-5)``, 2 rounds; ``bdca_ascent`` once a
     step, its gap to the binary fused bsgd run); (c) run (a)'s class axis
     under bdca for one epoch (``bdca_C`` from the 60,000 rows; its gap to
     run (a)); each held to an accuracy floor above chance
     (``BDCA_ACC_FLOOR``: BDCA stays below the bsgd runs' 0.80 here, in the
     reference too); profiled windows of both;
     (d) the first 600 steps of (b) on the card and on the CPU in
     lockstep, integer state and SV rows compared every step (where they
     part, the cause must be a near-tie: a margin at 1, a coordinate
     clipped at 0, tied event scores), then the cache invariants; (e) two
     chunks of (c)'s rows through ``fit_multiclass_stream``, eager and from
     CUDA graphs, bit-equal with equal launches (a ``CUT:`` line).  Every
     launch counter is 0 before each bdca run and read after it;
 18. the distributed layer (``core.distributed``), two ranks sharing the card
     (a ``torch.multiprocessing`` spawn; gloo, since NCCL refuses two ranks
     on one device; the kernels built in phase 2 and only loaded there),
     each run against the same steps in one process on the card: the
     ``replicated`` and ``slots`` layouts on phase 4's ADULT stand-in at
     batch 8 (508 slots, 254 a rank), the ``class`` layout at the
     mnist-width stand-in (5 classes a rank) under run (a)'s engine
     (``merge_event_rounds``) and run (c)'s fused step (``train_step``), a
     ``CUT:`` line each; run (c)'s fp32 model served over the 10,000 test
     rows split over the ranks; and ``replicated`` once more on a world of 1
     under NCCL.  Each prints its backend (the ranks go through
     ``launch.dist.pick_backend``, and the phase fails unless they ran the
     rule's pick) and that ``core.distributed`` stages nothing (gloo copies
     CUDA tensors through host memory inside its collectives), µs a step on
     the ranks and in one process, the first step whose integer state parts
     (checked every 100 steps and at the end; a parting must be a diagnosed
     near-tie), the largest float difference and whether the bits are equal
     (every layout's state must be bit-equal while the integers agree;
     serve: scores and labels bit-equal).  Every child's launches count in
     the ``kernels`` line.
     Before the runs, ``rbf_matrix`` over the class bank against its two
     halves: a column's bits do not depend on the bank's width;
 19. the port's five SVM examples (``examples/torch_*.py``) as subprocesses
     on ``cuda`` (a ``CUT:`` line where the arguments cut the defaults): four
     at once, sharing the card, then ``torch_svm_speedup.py`` alone, whose
     two paper figures (timings) go on a line of their own;
 20. the language-model serving path (``launch.serve``, ``models``,
     ``core.budgeted_kv``; no kernel of the port lies on it, as no Pallas
     kernel lies on the reference's), every time and byte count beside the
     card's name and power limit: (a) ``serve`` on ``smollm_360m`` as
     published (32 layers, d 960, bf16, seeded random weights) at batch 4,
     prompt 32 and prompt 4,096 (the chunked online-softmax prefill), 64
     tokens generated each, under ``torch.cuda.set_sync_debug_mode("error")``
     (no host read in the decode loop): prefill ms, decode ms a token,
     tokens/s, peak device bytes, then a profiled decode window (device busy
     µs, idle share and launches a token; a ``CUT:`` line); (b) float32
     decode step by step against one full forward within 2e-2 (the
     reference's tolerance): ``smollm_360m`` and ``mamba2_130m`` whole,
     ``h2o_danube3_4b`` at depth 2 prefilling its 4,096 window and decoding
     past it, ``deepseek_v2_236b`` at depth 2 and ``jamba_v01_52b`` at 8
     (the MoE configs at the reference test's no-drop capacity; a ``CUT:``
     line each); (c) ``smollm_360m`` at full width and depth 2, float32, the
     card's prefill and decode logits against the port's CPU path on the
     same weights within 1e-3 of the logits' scale, greedy tokens equal off a
     near-tie; (d) every other family once in bf16 at its published width,
     prompt 32 and 16 decode steps at batch 4 (``h2o_danube3_4b`` also prompt
     4,096 with 64 steps), whole where it fits (``mamba2_130m``,
     ``h2o_danube3_4b``, ``yi_9b``, ``hubert_xlarge`` through
     ``encode_step``) and else at the smallest depth that holds every layer
     kind (a ``CUT:`` line each): logits finite with the reference's shapes,
     tokens in ``[0, vocab_padded)``, prefill ms, decode ms a token, peak
     bytes; (e) the budgeted KV cache at (a)'s KV width (batch 4, 5 heads of
     64, budget 512, 4,096 appends of a drifting stream, sync debug mode
     "error"), merge and evict side by side against the exact cache (merge's
     relative attention error no larger), µs an append below and at the
     budget, then ``examples/torch_budgeted_kv_serve.py`` on ``cuda``;
 21. the language-model training path (``launch.train``'s LM arm,
     ``launch.steps``, ``train/``, ``launch.elastic``; no kernel of the port
     lies on it, as no Pallas kernel lies on the reference's), every time
     and byte count beside the card's name and power limit: (a)
     ``train_loop`` on ``smollm_360m`` as published (bf16, remat on, seeded
     random weights) at batch 4 x 4,096 (``train_4k``'s length; its global
     batch of 256 is a pod's, a ``CUT:`` line) for 4 AdamW steps at the
     CLI's defaults with a checkpoint at the end: ms a step after the
     first, tokens/s, model TFLOP/s beside the dense bf16 peak, peak device
     bytes, the losses, every loss and parameter finite and every parameter
     moved; one more step under sync debug mode "error", then profiled
     (device busy µs, idle share, kernels a step); peak bytes of a step at
     seq 1,024 with remat on and off (on must be lower); (b) full width at
     depth 2, fp32, batch 2 x 128: the card's loss and every gradient
     against the port's CPU path on the same weights (1e-5 relative, 1e-4
     of each leaf's scale), then one AdamW update on both from the same
     gradients (1e-6); (c) ``examples/torch_train_lm.py`` on ``cuda`` for 150
     of its 300 steps (a ``CUT:`` line; its own check: the loss drops by
     0.5); (d) ``launch.elastic``
     with a fault at step 12 of 24 (``restarts 1``, the resumed losses
     within 2e-3 of an uninterrupted run's) and ``--deadline`` below a
     step's time (exit 75, a checkpoint on disk); (e) two ranks sharing the
     card under gloo: one data-parallel step of (b)'s model at batch 8 split
     4/4 against one process (1e-5), ``compressed_psum`` of the ranks'
     gradients within one quantization step of their mean, and
     ``pipeline_forward`` over 2 stages against the sequential loop (1e-4);
 22. the language models on a ``DeviceMesh`` (``launch.mesh``,
     ``sharding.specs``, ``make_train_step(mesh=)``, the checkpointer's
     ``shardings=``; no kernel lies on it, as none lies on the reference's
     GSPMD sharding): (a) a (1, 1) mesh under NCCL in this process (world
     1), ``smollm_360m`` as published (bf16, remat) at batch 4 x 1,024: one
     tp and one fsdp step, each bit-equal to the unsharded step in the loss
     and every updated parameter, and ms a warm step of all three; (b) two
     gloo ranks: first one DTensor all-gather of a CUDA tensor on the card
     (its exit codes printed: it ends the ranks with a signal on torch 2.11),
     then, on the host's CPU mesh, ``smollm_360m`` at its published widths,
     ``MESH_CPU_DEPTH`` of its layers, in fp32, batch 2 x 64 (a ``CUT:``
     line), tp on 1 x 2 and fsdp on 2 x 1, one step each: loss and
     gradients against one process (1e-5 of scale) and each rank's resident
     bytes of parameters and AdamW moments against one process's, equal to
     the share the specs give; (c) the checkpoint written
     on (b)'s 1 x 2 mesh restored onto the card's (1, 1) mesh, array-equal;
     (d) ``seq_shard_attn=("data",)`` on (b)'s 1 x 2 mesh: the loss within
     1e-4 of the step without it;
 23. the planner against the card (``launch.roofline``, ``launch.steps.
     lower_cell``, ``core.distributed.lower_svm_cell``, ``launch.dryrun``):
     (a) the card's ``nvidia-smi`` name has a ``DeviceSpec`` whose bytes are
     the card's ``total_memory``; (b) phase 22 (a)'s unsharded step planned
     on a cuda-typed (1, 1) fake mesh in a child process, then run for
     real: planned FLOPs equal ``FlopCounterMode``'s count exactly, planned
     resident bytes equal ``memory_allocated`` within ``PLAN_RESIDENT_TOL``,
     the planned peak over ``max_memory_allocated`` inside ``PLAN_PEAK_BAND``,
     and the roofline's ``step_s`` at most ``PLAN_BOUND_SHARE`` of the
     measured warm step; (c) phase 4's binary lookup-wd step and run (c)'s
     fused class-axis step with the budget full: planned launches equal the
     counters' delta of one real step, and each kernel on them returns fake
     outputs of its real outputs' shapes, dtypes and strides; (d)
     ``python -m repro_torch.launch.dryrun`` for ``smollm_360m`` x
     ``train_4k`` and for ``svm_bsgd`` on the 16 x 16 production mesh, each
     under its own timeout, printing its record.  (b)'s plan and (d)'s two
     dry runs run as children beside (b)'s and (c)'s work on the card.

It prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
It imports nothing from the JAX package.  Without a CUDA device, or without
the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed

ROOT = Path(__file__).resolve().parent
SEED = 0
sys.path.insert(0, str(ROOT / "src"))    # the port beside this script (main checks it)
from repro_torch.kernels import work as kernel_work  # noqa: E402  the kernels' work formulas
from repro_torch.launch import roofline as rl  # noqa: E402  the card's rates and their sources
from repro_torch.launch.roofline import H100  # noqa: E402
N_ROWS, DIM, BUDGET = 32_561, 123, 500
REPLAY_STEPS = 2_000
# phase 4's steps a method: cut from the epoch (26,049) for phase 23 (a CUT: line);
# the CPU path's lookup-wd against gss gap is 0.0006 here (0.0026 at 13,025)
MAIN_STEPS = 8_192
PROFILE_STEPS = 100               # cut from 300 for phases 18 and 19 (a CUT: line)
# the class axis: LIBSVM multi-class mnist's widths and split
MC_CLASSES, MC_DIM, MC_TRAIN, MC_TEST = 10, 780, 60_000, 10_000
MC_GAMMA, MC_LAMBDA, MC_BUDGET, MC_BATCH = 2.0 ** -11, 1e-5, 500, 8
MC_REPLAY_STEPS = 300            # cut from 1,000 for phases 18 to 21 (a CUT: line)
# profiled steps per class-axis run: run (b) launches ~1,500 kernels a step,
# which the profiler's bookkeeping makes slow to read back
MC_PROFILE_STEPS = {"a": 40, "b": 8, "c": 200, "d": 200}
# steps of each class-axis run; None is one whole epoch (MC_TRAIN // MC_BATCH).
# Run (b) is cut to keep the script within ~800 s (at 750 steps its
# accuracy stays below the 0.80 floor): with one
# multi_merge_choose launch a round its whole epoch took 253 s of a ~580 s
# script on one H100 (PERF.md); phase 14 goes on from where it stops
MC_STEPS = {"a": None, "b": 1_500, "c": None, "d": None}
MC_RUNS = {"a": "merge_event engine", "b": "multi-merge", "c": "fused step, merge",
           "d": "fused step, multi-merge"}
LOCKSTEP_STEPS = 1_000
FUSED_PROFILE_STEPS = 1_000
CHOOSE_LOCKSTEP_STEPS = 100      # cut from 300 for phases 18 to 21 (a CUT: line)
# rbf_matrix's checked shapes (n, m, d): the binary path's margin and kappa
# rows, decision values, run (a)'s margin rows (a minibatch of 8 against the
# 10 x 508 class bank) and a minibatch of 32 against it, and three ragged
# ones (3 and 12 rows pad rbf_thin's row count to 4 and 16)
RBF_SHAPES = [(1, 501, 123), (6512, 501, 123), (8, 5080, 780), (32, 5080, 780), (3, 77, 5),
              (12, 301, 50), (33, 17, 300)]
# steps of phase 6's gss-precise window, from the gss epoch's state
PRECISE_PROFILE_STEPS = 100       # cut from 300 with PROFILE_STEPS


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


def time_call(fn, *, calls: int = 100, repeats: int = 7, warmup: int = 10) -> float:
    """Median over ``repeats`` of the mean milliseconds per call of ``fn``,
    from CUDA events around ``calls`` back-to-back calls (after ``warmup``
    calls)."""
    for _ in range(warmup):
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


def device_ms(fn, kernel_substr: str, calls: int = 50, windows: int = 3):
    """Mean device time per launch (ms) of kernels whose name contains
    ``kernel_substr``, from ``torch.profiler``; None if it reports none.  A
    profiler window now and then returns no kernel events at all, so up to
    ``windows`` windows are tried."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel_substr in ev.key:
                total += (getattr(ev, "device_time_total", 0.0)
                          or getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        if count and total > 0:
            return total / count / 1e3
    return None


def us(ms) -> str:
    """Milliseconds as microseconds for a line, or "not measured"."""
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def bound_ms(work):
    """``roofline.bound_s`` on the H100 of a kernel's ``(bytes, operations)``
    (``kernels.work``), in milliseconds, and what bounds it."""
    t, by = rl.bound_s(work, H100)
    return t * 1e3, by


def phase_card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = out.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build(_build):
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"built {sorted(reports) or 'nothing (already built)'} in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def check_rbf(ops, ref, shapes, gen):
    """rbf_matrix against its plain version at each (n, m, d) of ``shapes``, fp32
    and bf16 operands, with the time a call of the kernel and of the plain
    version, the device time a launch (fp32) and the bound; returns the
    record of the binary path's shape (1 x 501 x 123 fp32) when it is one of
    them."""
    dev = torch.device("cuda")
    gamma = 2.0 ** -7
    records = {}
    tol = 1e-5   # fp32 sums of d products in another order, times gamma
    for (n, m, d) in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, d, generator=gen).to(dev, dtype)
            y = torch.randn(m, d, generator=gen).to(dev, dtype)
            got = ops.rbf_matrix(x, y, gamma, impl="cuda")
            want = ref.rbf_matrix(x, y, gamma)
            err = (got - want).abs().max().item()
            k_ms = time_call(lambda: ops.rbf_matrix(x, y, gamma, impl="cuda"))
            p_ms = time_call(lambda: ref.rbf_matrix(x, y, gamma))
            b_ms, b_by = bound_ms(kernel_work.rbf_matrix_work(n, m, d, x.element_size()))
            line = (f"rbf_matrix {n}x{m}x{d} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {tol}) "
                    f"kernel {k_ms * 1e3:.2f} us plain {p_ms * 1e3:.2f} us bound "
                    f"{b_ms * 1e3:.4f} us ({b_by})")
            dm = None
            if dtype == torch.float32:
                dm = device_ms(lambda: ops.rbf_matrix(x, y, gamma, impl="cuda"), "rbf_")
                line += f" device {us(dm)}"
            print(line)
            check(err <= tol, f"rbf_matrix {n}x{m}x{d} {dtype} error {err}")
            if (n, m, d) == (1, 501, 123) and dtype == torch.float32:
                records["rbf_matrix"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                             device_ms=dm)
    return records


def rbf_cutover(ref, gen):
    """Device time of rbf_matrix's two kernels at n = 8, 16 and 32 rows
    against run (a)'s class bank (m = 5,080, d = 780, fp32), each forced
    (``path=``) and held to the plain version; the rule sends n <= THIN_ROWS
    to rbf_thin.  The two sum in different orders, so moving the cutover
    moves the bits of the rows it moves."""
    from repro_torch.kernels import rbf_kernel
    dev = torch.device("cuda")
    m, d, gamma = MC_CLASSES * (MC_BUDGET + MC_BATCH), MC_DIM, MC_GAMMA
    y = torch.randn(m, d, generator=gen).to(dev)
    for n in (8, 16, 32):
        x = torch.randn(n, d, generator=gen).to(dev)
        want = ref.rbf_matrix(x, y, gamma)
        line = f"rbf_matrix cutover n={n} m={m} d={d}:"
        for path in ("thin", "tiled"):
            call = lambda: rbf_kernel.rbf_matrix_cuda(x, y, gamma, path=path)
            err = (call() - want).abs().max().item()
            check(err <= 1e-5, f"rbf_matrix path={path} n={n} error {err}")
            line += f" {path} device {us(device_ms(call, 'rbf_'))} (err {err:.1e});"
        b_ms, b_by = bound_ms(kernel_work.rbf_matrix_work(n, m, d, 4))
        print(f"{line} bound {b_ms * 1e3:.4f} us ({b_by}); the rule takes "
              f"{'thin' if n <= rbf_kernel.THIN_ROWS else 'tiled'}")


def rbf_nonfinite(ref, gen):
    """rbf_thin and rbf_tiled on rows holding a NaN, an Inf or a -Inf, against
    the plain version on the same card tensors: NaN exactly where the plain
    version has NaN (a NaN distance stays NaN through the clamp), every other
    value within 1e-5."""
    from repro_torch.kernels import rbf_kernel
    dev = torch.device("cuda")
    d, gamma = 123, 2.0 ** -7
    y = torch.randn(301, d, generator=gen)
    y[5, 7], y[9, 0] = float("nan"), float("inf")
    for n, path in ((8, "thin"), (48, "tiled")):
        x = torch.randn(n, d, generator=gen)
        x[1, 3], x[2, 4], x[3, 5] = float("nan"), float("inf"), -float("inf")
        xd, yd = x.to(dev), y.to(dev)
        got = rbf_kernel.rbf_matrix_cuda(xd, yd, gamma, path=path)
        want = ref.rbf_matrix(xd, yd, gamma)
        nan_same = bool(torch.equal(got.isnan(), want.isnan()))
        rest = ~want.isnan()
        err = (got[rest] - want[rest]).abs().max().item()
        print(f"rbf_matrix {path} {n}x301x{d} with NaN/Inf rows: NaN where the plain version "
              f"has NaN {nan_same} ({int(want.isnan().sum())} entries), max_abs_err elsewhere "
              f"{err:.3e} (tol 1e-5)")
        check(nan_same and err <= 1e-5, f"rbf_matrix {path} on non-finite rows: NaN pattern "
              f"equal {nan_same}, error {err}")


def phase_kernels(ops, ref, _build, table):
    """Each kernel against its plain version; returns the main-shape records."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    records = check_rbf(ops, ref, RBF_SHAPES, gen)
    rbf_cutover(ref, gen)
    rbf_nonfinite(ref, gen)

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
    cells = _table_cells(wd_table, m_coord, k_coord)
    b_ms, b_by = bound_ms(kernel_work.merge_scores_work(1, s, cells))
    print(f"merge_scores s={s} G={g0}: max_abs_err {err:.3e} (tol 1e-6) argmin_equal {same_argmin} "
          f"invalid>=NO_PARTNER {invalid_ok} kernel {k_ms * 1e3:.2f} us plain {p_ms * 1e3:.2f} us "
          f"grid_sample {l_ms * 1e3:.2f} us (its err vs plain {lib_err:.2e}) "
          f"bound {b_ms * 1e3:.4f} us ({b_by}, {cells} table cells)")
    check(err <= 1e-6 and same_argmin and invalid_ok, "merge_scores against its plain version")
    records["merge_scores"] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
        device_ms=device_ms(lambda: ops.merge_scores(alpha, kappa, valid, a_min, wd_table,
                                                     impl="cuda"), "merge_scores_kernel"))
    raw = _build.stream(torch.cuda.current_device())
    print(f"raw stream {raw} equals torch.cuda.current_stream().cuda_stream "
          f"{raw == torch.cuda.current_stream().cuda_stream}")
    check(raw == torch.cuda.current_stream().cuda_stream, "the wrappers' raw stream")
    from repro_torch.kernels import merge_lookup
    host_breakdown(
        "merge_scores", (alpha, kappa, valid, a_min, wd_table), (alpha, kappa, a_min, wd_table),
        alpha.shape, ("merge_lookup", "merge_scores_launch", "pppppiiiippp"),
        lambda wd_o, in_o: [t.data_ptr() for t in (alpha, kappa, valid, a_min, wd_table)]
        + [g0, g1, s, s, wd_o.data_ptr(), in_o.data_ptr(), raw],
        lambda: ops._use_kernel("auto", alpha) and (a_min if a_min.dim() == 1
                                                    else a_min.reshape(-1)),
        lambda: ops._use_kernel("auto", alpha),
        {"whole call (ops.merge_scores)": lambda: ops.merge_scores(
            alpha, kappa, valid, a_min, wd_table, impl="cuda"),
         "whole call (wrapper alone)": lambda: merge_lookup.merge_scores_cuda(
             alpha, kappa, valid, a_min, wd_table)}, k_ms, l_ms)
    records["merge_pick"] = phase_pick(ops, ref, table, gen)

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
        b_ms, b_by = bound_ms(kernel_work.gss_work(s, n_iters))
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
    records["gss_pick"] = phase_gss_pick(ops, ref, gen)
    return records


def _table_cells(table, m, k):
    """The distinct cells of ``table`` that bilinear lookups at (m, k) read."""
    g0, g1 = table.shape
    i0 = torch.clamp(torch.floor(m * (g0 - 1)).long(), 0, g0 - 2)
    j0 = torch.clamp(torch.floor(k * (g1 - 1)).long(), 0, g1 - 2)
    return torch.cat([i0 * g1 + j0, i0 * g1 + j0 + 1, (i0 + 1) * g1 + j0,
                      (i0 + 1) * g1 + j0 + 1]).unique().numel()


def _pick_state(gen, r, s, dev, case="random"):
    """(alpha, kappa, count, i_min, a_min) of R rows for one merge_pick call:
    mixed signs, counts below s; ``ties``: two slots of equal alpha and kappa
    that score best; ``all-invalid``: the fixed partner is the row's only
    positive alpha, so no candidate is valid."""
    alpha = (torch.randn(r, s, generator=gen).abs() * 0.2 + 0.01)
    alpha = alpha * torch.where(torch.rand(r, s, generator=gen) < 0.4, -1.0, 1.0)
    kappa = torch.rand(r, s, generator=gen)
    count = torch.randint(max(s // 2, 1), s + 1, (r,), generator=gen).to(torch.int32)
    if case == "ties" and s > 10:
        alpha, kappa = alpha.abs() + 0.3, kappa * 0.9
        alpha[:, 2], alpha[:, [5, 9]], kappa[:, [5, 9]] = 0.05, 0.06, 0.999
        count[:] = s
    if case == "all-invalid":
        alpha = -alpha.abs()
        alpha[:, 0] = 0.001
    alpha = torch.where(torch.arange(s) < count[:, None], alpha, 0.0)
    i_min = torch.argmin(torch.where(torch.arange(s) < count[:, None], alpha.abs(), torch.inf),
                         dim=1)
    a_min = alpha.gather(1, i_min[:, None])[:, 0]
    return [t.to(dev).contiguous() for t in (alpha, kappa, count, i_min, a_min)]


def _pick_bound(alpha, kappa, count, i_min, a_min, table):
    """Least time of one merge_pick call on these inputs: every input once, the
    WD-table cells the valid candidates read, four h-table cells a row, the
    three outputs; ~25 operations a valid candidate (coordinates, bilinear
    mix, score) and 4 a candidate (mask, argmin)."""
    from repro_torch.kernels import ref
    r, s = alpha.shape
    idx = torch.arange(s, device=alpha.device)
    valid = (idx < count[:, None]) & (alpha * a_min[:, None] > 0) & (idx != i_min[:, None])
    m, k = ref.merge_coords(a_min[:, None], alpha, kappa)
    cells = _table_cells(table.wd_table, m[valid], k[valid])
    return bound_ms(kernel_work.merge_pick_work(r, s, int(valid.sum()), cells)) + (cells,)


def phase_pick(ops, ref, table, gen):
    """merge_pick against its plain version on the card, bit for bit: the binary
    path's shape (one row of 501 without a row axis), the class axis's rows,
    a ragged shape, exact score ties and rows with no valid candidate; then
    its timing at the binary path's shape."""
    dev = torch.device("cuda")
    tab = table.to(dev)
    record = None
    for label, r, s, case in [("binary path", 1, 501, "random"), ("class rows", MC_CLASSES, 508,
                              "random"), ("ragged", 3, 37, "random"), ("ties", 4, 64, "ties"),
                              ("all-invalid", 2, 40, "all-invalid"), ("s=1", 2, 1, "random")]:
        alpha, kappa, count, i_min, a_min = _pick_state(gen, r, s, dev, case)
        if label == "binary path":       # the binary event's form: no row axis
            alpha, kappa, count = alpha[0], kappa[0], count[0]
        got = ops.merge_pick(alpha, kappa, count, i_min, a_min, tab, impl="cuda")
        want = ops.merge_pick(alpha, kappa, count, i_min, a_min, tab, impl="ref")
        j, wd, h = got
        none = want[1] >= ref.NO_PARTNER
        equal = (bool(torch.equal(j, want[0])) and bool(torch.equal(wd[~none], want[1][~none]))
                 and bool(torch.equal(h, want[2])) and bool((wd[none] >= ref.NO_PARTNER).all()))
        err = max((wd - want[1])[~none].abs().max().item() if bool((~none).any()) else 0.0,
                  (h - want[2]).abs().max().item())
        line = (f"merge_pick {label} R={r} s={s}: bit-equal {equal} (j_star, wd_j where a "
                f"partner exists, h_j; removal rows {int(none.sum())}/{none.numel()}) "
                f"j_star {j[:4].tolist()}")
        if case == "ties":
            line += f" ties to the lower slot {bool((j == 5).all())}"
            check(bool((j == 5).all()), "merge_pick: an exact tie not broken to the lower slot")
        if case == "all-invalid" or s == 1:
            check(bool(none.all()) and bool((j == 0).all()),
                  f"merge_pick {label}: a row without candidates must pick slot 0 and remove")
        if label == "binary path":
            k_ms = time_call(lambda: ops.merge_pick(alpha, kappa, count, i_min, a_min, tab,
                                                    impl="cuda"))
            p_ms = time_call(lambda: ops.merge_pick(alpha, kappa, count, i_min, a_min, tab,
                                                    impl="ref"))
            dm = device_ms(lambda: ops.merge_pick(alpha, kappa, count, i_min, a_min, tab,
                                                  impl="cuda"), "merge_pick_kernel")
            b_ms, b_by, cells = _pick_bound(alpha[None], kappa[None], count.reshape(1), i_min,
                                            a_min, tab)
            line += (f" kernel {k_ms * 1e3:.2f} us (device {us(dm)}) plain {p_ms * 1e3:.2f} us "
                     f"bound {b_ms * 1e3:.4f} us ({b_by}, {cells} table cells); library call: none")
            record = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=dm)
        print(line)
        check(equal, f"merge_pick {label} against its plain version")
    return record


def _gss_pick_bound(alpha, kappa, count, i_min, a_min, n_iters):
    """Least time of one gss_pick call on these inputs: every input once and
    the three outputs; per valid candidate its coordinates (~6 operations),
    ``n_iters`` bracket steps of two objectives (~30, as ``gss``'s bound
    counts them) and its alpha_z and WD (~25), and 4 a candidate (mask,
    argmin)."""
    r, s = alpha.shape
    idx = torch.arange(s, device=alpha.device)
    valid = (idx < count[:, None]) & (alpha * a_min[:, None] > 0) & (idx != i_min[:, None])
    return bound_ms(kernel_work.gss_pick_work(r, s, int(valid.sum()), n_iters))


def phase_gss_pick(ops, ref, gen):
    """gss_pick against its plain version on the card, bit for bit, at 10
    (gss) and 48 (gss-precise) bracket steps: the binary path's shape (one
    row of 501 without a row axis), the class axis's rows (C = 10, S = 508),
    a ragged shape, exact WD ties and rows with no valid candidate; then its
    timing at the binary path's shape, beside merge_pick's."""
    dev = torch.device("cuda")
    record = None
    for n_iters in (10, 48):
        for label, r, s, case in [("binary path", 1, 501, "random"),
                                  ("class rows", MC_CLASSES, MC_BUDGET + MC_BATCH, "random"),
                                  ("ragged", 3, 37, "random"), ("ties", 4, 64, "ties"),
                                  ("all-invalid", 2, 40, "all-invalid"), ("s=1", 2, 1, "random")]:
            alpha, kappa, count, i_min, a_min = _pick_state(gen, r, s, dev, case)
            if label == "binary path":       # the binary event's form: no row axis
                alpha, kappa, count = alpha[0], kappa[0], count[0]
            got = ops.gss_pick(alpha, kappa, count, i_min, a_min, n_iters=n_iters, impl="cuda")
            want = ops.gss_pick(alpha, kappa, count, i_min, a_min, n_iters=n_iters, impl="ref")
            j, wd, h = got
            none = want[1] >= ref.NO_PARTNER
            equal = (bool(torch.equal(j, want[0])) and bool(torch.equal(wd[~none], want[1][~none]))
                     and bool(torch.equal(h, want[2])) and bool((wd[none] >= ref.NO_PARTNER).all()))
            err = max((wd - want[1])[~none].abs().max().item() if bool((~none).any()) else 0.0,
                      (h - want[2]).abs().max().item())
            line = (f"gss_pick n_iters={n_iters} {label} R={r} s={s}: bit-equal {equal} (j_star, "
                    f"wd_j where a partner exists, h_j; removal rows {int(none.sum())}/"
                    f"{none.numel()}) j_star {j[:4].tolist()}")
            if case == "ties":
                line += f" ties to the lower slot {bool((j == 5).all())}"
                check(bool((j == 5).all()), "gss_pick: an exact tie not broken to the lower slot")
            if case == "all-invalid" or s == 1:
                check(bool(none.all()) and bool((j == 0).all()),
                      f"gss_pick {label}: a row without candidates must pick slot 0 and remove")
            if label == "binary path":
                call = lambda: ops.gss_pick(alpha, kappa, count, i_min, a_min, n_iters=n_iters,
                                            impl="cuda")
                k_ms = time_call(call)
                p_ms = time_call(lambda: ops.gss_pick(alpha, kappa, count, i_min, a_min,
                                                      n_iters=n_iters, impl="ref"), calls=20)
                dm = device_ms(call, "gss_pick_kernel")
                b_ms, b_by = _gss_pick_bound(alpha[None], kappa[None], count.reshape(1), i_min,
                                             a_min, n_iters)
                line += (f" kernel {k_ms * 1e3:.2f} us (device {us(dm)}) plain "
                         f"{p_ms * 1e3:.2f} us bound {b_ms * 1e3:.4f} us ({b_by}); library "
                         "call: none")
                if n_iters == 10:
                    record = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None, device_ms=dm)
            print(line)
            check(equal, f"gss_pick n_iters={n_iters} {label} against its plain version")
    return record


def _per_call_us(fn, calls: int = 2_000) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def host_breakdown(label, ins, floats, out_shape, entry, launch_args, old_ops, new_ops,
                   whole, call_ms, grid_ms):
    """Host microseconds of one ``label`` call, part by part: each part of the
    wrapper as it was before the lean launch path (the earlier wrapper's
    steps, restated here) and as it is now, timed in turns (old, new, new, old) over 2,000
    calls each, no part waiting for the card; then the parts both share.

    ins: the tensor inputs, the first one's device and shape leading;
    floats: those that must be fp32; out_shape: the shape of each of the two
    outputs; entry: ``(library, symbol, argtypes)`` of the C entry point;
    launch_args(out0, out1): the C call's arguments; old_ops/new_ops: the
    ops layer's own work before and now; whole: ``{name: call}``."""
    from repro_torch.kernels import _build
    first, rest = ins[0], ins[1:]
    dev, idx = first.device, first.get_device()
    f32 = torch.float32
    lib, sym, argtypes = entry
    parts = {
        "device checks": (
            lambda: not first.is_cuda or any(t.device != dev for t in rest),
            lambda: idx < 0 or any(t.get_device() != idx for t in rest)),
        "dtype checks": (
            lambda: any(t.dtype != f32 for t in floats),
            lambda: all(t.dtype == f32 for t in floats)),
        "contiguous inputs": (
            lambda: [t.contiguous() for t in ins],
            lambda: [t if t.is_contiguous() else t.contiguous() for t in ins]),
        "output allocation": (
            lambda: (torch.empty(out_shape, dtype=f32, device=dev),
                     torch.empty(out_shape, dtype=f32, device=dev)),
            lambda: first.new_empty((2, *out_shape)).unbind(0)),
        "entry point lookup": (
            lambda: getattr(_build.load(lib), sym).argtypes is None,
            lambda: _build.function(lib, sym, argtypes)),
        "stream": (
            lambda: torch.cuda.current_stream(dev).cuda_stream,
            lambda: _build.stream(idx)),
        "ops layer": (old_ops, new_ops),
    }
    outs = first.new_empty((2, *out_shape)).unbind(0)
    fn = _build.function(lib, sym, argtypes)
    args = launch_args(*outs)
    shared = {f"data_ptr of {len(ins) + 2} tensors": lambda: [t.data_ptr() for t in (*ins, *outs)],
              "ctypes call and launch": lambda: fn(*args), **whole}
    old_sum = new_sum = 0.0
    for name, (old, new) in parts.items():
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(_per_call_us(old if which == "old" else new))
        o, w = statistics.mean(times["old"]), statistics.mean(times["new"])
        old_sum, new_sum = old_sum + o, new_sum + w
        print(f"  {label} host part {name}: before {o:.2f} us, now {w:.2f} us")
    for name, fn_ in shared.items():
        t = statistics.mean(_per_call_us(fn_) for _ in range(2))
        print(f"  {label} host part {name}: {t:.2f} us")
    torch.cuda.synchronize()
    print(f"  {label} host parts that changed: before {old_sum:.2f} us, now {new_sum:.2f} us; "
          f"{label} {call_ms * 1e3:.2f} us a call (CUDA events) against grid_sample "
          f"{grid_ms * 1e3:.2f} us")


def adult_standin(make_blobs, train_test_split):
    # benchmarks/common.py's ADULT blobs use sep 0.6, which in 123 dimensions
    # is 99.5% separable (Bayes accuracy Phi(sep * sqrt(123) / (2 * noise)));
    # few rows then violate the margin and the budget barely fills.  sep 0.25
    # puts the Bayes accuracy at 85.7%, near the RBF-SVM accuracy on ADULT.
    x, y = make_blobs(np.random.default_rng(SEED), N_ROWS, DIM, sep=0.25, noise=1.3)
    return train_test_split(x, y, test_frac=0.2)


def phase_main(core, ops, data):
    (xtr, ytr), (xte, yte) = data
    print(f"CUT: phase 4 trains {MAIN_STEPS} of the epoch's {len(xtr)} steps (each method; "
          f"phase 11's fused binary run the same rows)")
    xtr, ytr = xtr[:MAIN_STEPS], ytr[:MAIN_STEPS]
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
        if method == "lookup-wd":
            # one event a step (batch 1), its whole choice one merge_pick launch
            check(launches["merge_pick"] == steps, f"lookup-wd: merge_pick launched "
                  f"{launches['merge_pick']} times in {steps} steps")
        else:
            # one event a step, its whole choice one gss_pick launch
            check(launches["gss_pick"] == steps, f"gss: gss_pick launched "
                  f"{launches['gss_pick']} times in {steps} steps")
            check(launches["gss"] == 0, f"gss: gss launched {launches['gss']} times; the path "
                  "now runs gss_pick")
        # the lookup-wd event's choice is merge_pick: merge_scores runs on neither path
        check(launches["merge_scores"] == 0, f"{method}: merge_scores launched "
              f"{launches['merge_scores']} times; the path now runs merge_pick")
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


def phase_profile(core, run, label, steps: int = PROFILE_STEPS, **knobs):
    """Device busy time per step over ``steps`` binary steps from the state of
    ``run`` (a phase-4 epoch), its configuration changed by ``knobs``."""
    _, st, cfg = run
    cfg = dataclasses.replace(cfg, **knobs)
    rng = np.random.default_rng(SEED + 1)
    xs = torch.as_tensor(rng.standard_normal((steps, DIM)).astype(np.float32)).cuda()
    ys = torch.as_tensor(np.where(rng.random(steps) < 0.5, 1.0, -1.0)
                         .astype(np.float32)).cuda()
    table = cfg.table()
    table = None if table is None else table.to("cuda")
    box = [st]

    def step(i):
        box[0] = core.train_step(cfg, table, box[0], xs[i:i + 1], ys[i:i + 1])

    _profile(step, steps, label)


def _event_state(gen, c, s, d, sv_dtype, dev, budget, removal_class=None):
    """Random class states for one event round: a consistent cache, mixed signs,
    counts on both sides of ``budget``; ``removal_class`` has one positive SV
    (its min-|alpha| slot) among negatives, so its event falls back to removal."""
    from repro_torch.core import kernel_cache
    sv = torch.randn(c, s, d, generator=gen).to(dev, sv_dtype)
    kmat = kernel_cache.exact_cache(sv, MC_GAMMA)
    kmat = torch.where(torch.eye(s, dtype=torch.bool, device=dev), 1.0,
                       0.5 * (kmat + kmat.transpose(1, 2))).contiguous()
    alpha = (torch.randn(c, s, generator=gen).abs() * 0.1 + 0.01).to(dev)
    alpha = alpha * torch.where(torch.rand(c, s, generator=gen) < 0.4, -1.0, 1.0).to(dev)
    count = torch.randint(max(budget - 3, 2), s + 1, (c,), generator=gen).to(dev, torch.int32)
    count[0] = s                                      # one class full and over budget
    if removal_class is not None:
        alpha[removal_class] = -alpha[removal_class].abs()
        alpha[removal_class, 1] = 0.001
        count[removal_class] = s
    alpha = torch.where(torch.arange(s, device=dev) < count[:, None], alpha, 0.0).contiguous()
    return sv.contiguous(), alpha, kmat, count, count > budget


def _multi_merge_bound(alpha, kappa, a_min, table):
    """Least time of one multi_merge_scores call on these inputs: each input
    and output once, the table cells the coordinates touch, ~38 operations a
    candidate (coordinates, two bilinear mixes, the score)."""
    from repro_torch.kernels import ref
    rows, s = kappa.reshape(-1, kappa.shape[-1]).shape
    a_rows = alpha.reshape(-1, s).repeat_interleave(rows // alpha.reshape(-1, s).shape[0], 0)
    m, k = ref.merge_coords(a_min.reshape(rows, 1), a_rows, kappa.reshape(rows, s))
    cells = _table_cells(table.wd_table, m, k)
    return bound_ms(kernel_work.multi_merge_scores_work(alpha.numel(), rows, s, cells)) + (cells,)


def phase_class_kernels(ops, ref, table):
    """multi_merge_scores and merge_event against their plain versions on the card."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 7)
    tab = table.to(dev)
    records = {}

    # kernel 4: (C, P, s) rows, bit-equal to the plain version at every shape
    for (c, p, s) in [(MC_CLASSES, 4, MC_BUDGET + MC_BATCH), (3, 4, 37), (1, 5, 129), (2, 1, 1000)]:
        alpha = (torch.randn(c, s, generator=gen).abs() * 0.2 + 0.01).to(dev)
        alpha = alpha * torch.where(torch.rand(c, s, generator=gen) < 0.3, -1.0, 1.0).to(dev)
        kappa = torch.rand(c, p, s, generator=gen).to(dev)
        valid = (torch.rand(c, p, s, generator=gen) < 0.8).to(dev)
        a_min = (alpha[:, :p] * 0.5).contiguous()
        wd, h = ops.multi_merge_scores(alpha, kappa, valid, a_min, tab, impl="cuda")
        wd_p, h_p = ops.multi_merge_scores(alpha, kappa, valid, a_min, tab, impl="ref")
        wd_f, h_f = ops.multi_merge_scores(alpha[0], kappa[0], valid[0], a_min[0], tab,
                                           impl="cuda")
        equal = (bool(torch.equal(wd[valid], wd_p[valid])) and bool(torch.equal(h, h_p))
                 and bool(torch.equal(wd_f, wd[0])) and bool(torch.equal(h_f, h[0])))
        invalid_ok = bool((wd[~valid] >= ref.NO_PARTNER).all() and (wd_p[~valid] >= ref.NO_PARTNER).all())
        err = max((wd - wd_p)[valid].abs().max().item(), (h - h_p).abs().max().item())
        line = (f"multi_merge_scores C={c} P={p} s={s}: bit-equal {equal} (wd at valid slots, h) "
                f"invalid>=NO_PARTNER {invalid_ok} max_abs_err {err:.3e} (tol 0)")
        if (c, p, s) == (MC_CLASSES, 4, MC_BUDGET + MC_BATCH):
            k_ms = time_call(lambda: ops.multi_merge_scores(alpha, kappa, valid, a_min, tab,
                                                            impl="cuda"))
            p_ms = time_call(lambda: ops.multi_merge_scores(alpha, kappa, valid, a_min, tab,
                                                            impl="ref"))
            # one library call for the two bilinear lookups alone (timed, never used)
            m_c, k_c = ref.merge_coords(a_min[..., None], alpha[:, None, :], kappa)
            grid = torch.stack([2 * k_c - 1, 2 * m_c - 1], dim=-1).view(1, 1, -1, 2)
            img = torch.stack([tab.wd_table, tab.h_table]).view(1, 2, *tab.wd_table.shape)
            lib = F.grid_sample(img, grid, mode="bilinear", align_corners=True).view(2, c, p, s)
            lib_err = (lib[1] - h_p).abs().max().item()
            l_ms = time_call(lambda: F.grid_sample(img, grid, mode="bilinear",
                                                   align_corners=True))
            b_ms, b_by, cells = _multi_merge_bound(alpha, kappa, a_min, tab)
            dm = device_ms(lambda: ops.multi_merge_scores(alpha, kappa, valid, a_min, tab,
                                                          impl="cuda"), "multi_merge_scores_kernel")
            line += (f" kernel {k_ms * 1e3:.2f} us (device {us(dm)}) plain "
                     f"{p_ms * 1e3:.2f} us grid_sample (2 channels) {l_ms * 1e3:.2f} us "
                     f"(its err vs plain h {lib_err:.2e}) bound {b_ms * 1e3:.4f} us ({b_by}, "
                     f"{cells} table cells)")
            records["multi_merge_scores"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                                 bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                                                 device_ms=dm)
        print(line)
        check(equal and invalid_ok, f"multi_merge_scores C={c} P={p} s={s} against its plain version")
        if (c, p, s) == (MC_CLASSES, 4, MC_BUDGET + MC_BATCH):
            _multi_scores_breakdown(ops, tab, alpha, kappa, valid, a_min, k_ms, l_ms)

    records["multi_merge_choose"] = phase_choose(ops, ref, tab, gen)

    # merge_scores with one fixed partner per row (the class axis's layout)
    c, s = MC_CLASSES, MC_BUDGET + MC_BATCH
    alpha = (torch.randn(c, s, generator=gen).abs() * 0.2 + 0.01).to(dev)
    kappa = torch.rand(c, s, generator=gen).to(dev)
    valid = (torch.rand(c, s, generator=gen) < 0.8).to(dev)
    a_min = alpha[:, 0] * 0.5
    wd, interp = ops.merge_scores(alpha, kappa, valid, a_min, tab.wd_table, impl="cuda")
    wd_p, interp_p = ops.merge_scores(alpha, kappa, valid, a_min, tab.wd_table, impl="ref")
    equal = bool(torch.equal(wd[valid], wd_p[valid])) and bool(torch.equal(interp, interp_p))
    print(f"merge_scores rows C={c} s={s}: bit-equal {equal} (wd at valid slots, interp)")
    check(equal and bool((wd[~valid] >= ref.NO_PARTNER).all()),
          "merge_scores with one fixed partner per row against its plain version")

    # kernel 5: one event round, fp32 and bf16 banks, mixed over, a removal class
    tol = {"kmat": 1e-6, "alpha": 1e-6}
    for sv_dtype in (torch.float32, torch.bfloat16):
        for (c, s, d, budget) in [(MC_CLASSES, MC_BUDGET + MC_BATCH, MC_DIM, MC_BUDGET),
                                  (3, 37, 5, 33), (4, 129, 33, 120)]:
            st = _event_state(gen, c, s, d, sv_dtype, dev, budget, removal_class=c - 1)
            sv0, al0, km0, count, over = st
            got = [t.clone() for t in (sv0, al0, km0)]
            want = [t.clone() for t in (sv0, al0, km0)]
            dec = torch.full((c, 3), -1, dtype=torch.int32, device=dev)
            dec_p = dec.clone()
            ops.merge_event(*got, count, over, tab, decisions=dec, impl="cuda")
            ops.merge_event(*want, count, over, tab, decisions=dec_p, impl="ref")
            torch.cuda.synchronize()
            same_dec = bool(torch.equal(dec, dec_p))
            removal_ok = int(dec[c - 1, 2]) == 0
            untouched = all(bool(torch.equal(g[~over], t[~over])) for g, t in zip(got, (sv0, al0, km0)))
            e_km = (got[2] - want[2]).abs().max().item()
            e_al = ((got[1] - want[1]).abs() / want[1].abs().clamp(min=1e-30)).max().item()
            e_sv = (got[0].float() - want[0].float()).abs().max().item()
            # one bf16 rounding of a z whose fp32 value differs in its last bit
            sv_tol = 1e-6 if sv_dtype == torch.float32 else 2.0 ** -7 * want[0].float().abs().max().item()
            inv_ok = True
            km = got[2]
            for q in range(c):
                n = int(count[q]) - int(over[q])
                blk = km[q, :n, :n]
                inv_ok &= bool(torch.equal(blk, blk.T)) and bool((torch.diagonal(blk) == 1).all())
            print(f"merge_event C={c} S={s} D={d} {str(sv_dtype)[6:]} over {int(over.sum())}/{c}: "
                  f"decisions equal {same_dec} (removal fallback {removal_ok}) non-over classes "
                  f"bitwise unchanged {untouched} max err kmat {e_km:.3e} (tol {tol['kmat']}) "
                  f"alpha rel {e_al:.3e} (tol {tol['alpha']}) sv_x {e_sv:.3e} (tol {sv_tol:.3e}) "
                  f"I2/I3 exact {inv_ok}")
            check(same_dec and removal_ok and untouched and inv_ok and e_km <= tol["kmat"]
                  and e_al <= tol["alpha"] and e_sv <= sv_tol,
                  f"merge_event C={c} S={s} D={d} {sv_dtype} against its plain version")
            if (c, s, d) == (MC_CLASSES, MC_BUDGET + MC_BATCH, MC_DIM) and sv_dtype == torch.float32:
                records["merge_event"] = dict(max_abs_err=max(e_km, e_sv),
                                              **_time_event(ops, tab, st))
                r = records["merge_event"]
                by_k = r.pop("device_ms_by_k")
                print(f"  merge_event timing: kernel {r['ms'] * 1e3:.2f} us per round (device "
                      f"per launch " + ", ".join(f"{us(v)} at K={k}" for k, v in by_k.items())
                      + f") plain "
                      f"{r['plain_ms'] * 1e3:.2f} us bound {r['bound_ms'] * 1e3:.4f} us "
                      f"({r['bound_by']}); library call: none")
    records["merge_event_rounds"] = phase_event_rounds(ops, tab, gen)
    return records


def _multi_scores_breakdown(ops, tab, alpha, kappa, valid, a_min, call_ms, grid_ms):
    """``host_breakdown`` of one class-batched multi_merge_scores call."""
    from repro_torch.kernels import _build, merge_multi
    c, p, s = kappa.shape
    g0, g1 = tab.wd_table.shape
    raw = _build.stream(alpha.get_device())
    shape = kappa.shape

    def old_ops():   # the earlier ops layer: the four inputs folded to rows, two output views
        rows = (alpha.reshape(-1, s), kappa.reshape(-1, s), valid.reshape(-1, s),
                a_min.reshape(-1))
        out = kappa.reshape(-1, s)
        return rows, out.view(shape), out.view(shape)

    host_breakdown(
        "multi_merge_scores", (alpha, kappa, valid, a_min, tab.h_table, tab.wd_table),
        (alpha, kappa, a_min, tab.h_table, tab.wd_table), shape,
        ("merge_multi", "multi_merge_scores_launch", "pipppppiiiippp"),
        lambda wd_o, h_o: [alpha.data_ptr(), p, kappa.data_ptr(), valid.data_ptr(),
                           a_min.data_ptr(), tab.h_table.data_ptr(), tab.wd_table.data_ptr(),
                           g0, g1, c * p, s, wd_o.data_ptr(), h_o.data_ptr(), raw],
        old_ops, lambda: ops._use_kernel("auto", alpha),
        {"whole call (ops.multi_merge_scores)": lambda: ops.multi_merge_scores(
            alpha, kappa, valid, a_min, tab, impl="cuda"),
         "whole call (wrapper alone)": lambda: merge_multi.multi_merge_scores_cuda(
             alpha, kappa, valid, a_min, tab.h_table, tab.wd_table)}, call_ms, grid_ms)


def _choose_state(gen, c, p, s, budget, dev, case="random"):
    """One multi_merge_choose call's inputs, as ``_multi_merge_once`` forms them:
    classes over and under ``budget`` (class 1 below it), the P smallest
    active |alpha| as fixed partners (a stable sort), random kernel rows.
    ``ties``: every pair's best candidates are two slots of equal alpha and
    kappa; ``removal``: class 0's cheapest SV is its only positive one, so
    its first pair falls back to removal."""
    alpha = (torch.randn(c, s, generator=gen).abs() * 0.2 + 0.01)
    alpha = alpha * torch.where(torch.rand(c, s, generator=gen) < 0.4, -1.0, 1.0)
    kappa = torch.rand(c, p, s, generator=gen)
    count = torch.randint(budget + 1, s + 1, (c,), generator=gen).to(torch.int32)
    count[1] = budget - 2
    if case == "ties":
        alpha, kappa = alpha.abs() + 0.3, kappa * 0.9
        alpha[:, :p] = 0.01 * torch.arange(1, p + 1)
        alpha[:, [20, 30]], kappa[:, :, [20, 30]] = 0.05, 0.999
    if case == "removal":
        alpha[0] = -alpha[0].abs()
        alpha[0, 1] = 0.001
    idx = torch.arange(s)
    alpha = torch.where(idx < count[:, None], alpha, 0.0)
    a_idx = torch.sort(torch.where(idx < count[:, None], alpha.abs(), torch.inf), dim=1,
                       stable=True).indices[:, :p]
    a_min = alpha.gather(1, a_idx)
    return [t.to(dev).contiguous() for t in (alpha, kappa, a_idx, a_min, count)] + [budget]


def _choose_bound(alpha, kappa, a_idx, a_min, count, budget, tab):
    """Least time of one multi_merge_choose call on these inputs: every input
    once, the WD-table cells the valid pairs read, four h-table cells a pair,
    the outputs; ~25 operations a valid (pair, candidate), 4 a (pair,
    candidate) (mask and the greedy argmins)."""
    from repro_torch.kernels import ref
    c, p, s = kappa.shape
    idx = torch.arange(s, device=alpha.device)
    valid = ((idx < count[:, None])[:, None, :] & (a_min[:, :, None] * alpha[:, None, :] > 0)
             & (idx[None, None, :] != a_idx[:, :, None]))
    m, k = ref.merge_coords(a_min[:, :, None], alpha[:, None, :], kappa)
    cells = _table_cells(tab.wd_table, m[valid], k[valid])
    work = kernel_work.multi_merge_choose_work(c, p, s, int(valid.sum()), cells)
    return bound_ms(work) + (cells,)


def phase_choose(ops, ref, tab, gen):
    """multi_merge_choose against its plain version on the card, bit for bit:
    run (b)'s shape (C = 10, P = 4, s = 508), a ragged shape, P = 1, P = 8
    and P = 64 (merge_batch 64, above the 32 pairs the kernel once held, at
    an excess of up to 68), exact score ties and a removal fallback, each
    with a class below the budget (which executes nothing); then its timing
    at run (b)'s shape."""
    s_mc = MC_BUDGET + MC_BATCH
    record = None
    for label, c, p, s, budget, case in [
            ("run (b)", MC_CLASSES, 4, s_mc, MC_BUDGET, "random"),
            ("ragged", 3, 4, 37, 30, "random"), ("P=1", 2, 1, 129, 120, "random"),
            ("P=8", 4, 8, 200, 190, "random"), ("ties", 3, 4, 64, 56, "ties"),
            ("removal", 3, 4, 64, 56, "removal"),
            ("merge_batch 64", MC_CLASSES, 64, s_mc, MC_BUDGET - 60, "random")]:
        args = _choose_state(gen, c, p, s, budget, "cuda", case)
        got = ops.multi_merge_choose(*args, tab, impl="cuda")
        want = ops.multi_merge_choose(*args, tab, impl="ref")
        equal = all(g.dtype == w.dtype and bool(torch.equal(g, w)) for g, w in zip(got, want))
        b_idx, merged, execute, h_star = got
        below = not bool(execute[1].any())
        line = (f"multi_merge_choose {label} C={c} P={p} s={s}: bit-equal {equal} (b_idx, "
                f"merged, execute, h_star) pairs executed {int(execute.sum())} merged "
                f"{int(merged.sum())}; class below budget executes nothing {below}")
        check(below, f"multi_merge_choose {label}: a class below its budget executed")
        if case == "ties":
            over = args[4] > budget
            ok = bool((b_idx[over, 0] == 20).all() and (b_idx[over, 1] == 30).all())
            line += f"; ties to the lower slot, then the next {ok}"
            check(ok, "multi_merge_choose: an exact tie not broken to the lower slot")
        if case == "removal":
            ok = bool(execute[0, 0]) and not bool(merged[0, 0])
            line += f"; class 0's first pair falls back to removal {ok}"
            check(ok, "multi_merge_choose: the removal fallback did not occur")
        if label == "run (b)":
            k_ms = time_call(lambda: ops.multi_merge_choose(*args, tab, impl="cuda"))
            p_ms = time_call(lambda: ops.multi_merge_choose(*args, tab, impl="ref"), calls=20,
                             repeats=3)
            dm = device_ms(lambda: ops.multi_merge_choose(*args, tab, impl="cuda"),
                           "multi_merge_choose_kernel")
            b_ms, b_by, cells = _choose_bound(*args, tab)
            line += (f" kernel {k_ms * 1e3:.2f} us (device {us(dm)}) plain {p_ms * 1e3:.2f} us "
                     f"bound {b_ms * 1e3:.4f} us ({b_by}, {cells} table cells); library call: none")
            record = dict(max_abs_err=(h_star - want[3]).abs().max().item(), ms=k_ms,
                          plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          device_ms=dm)
        print(line)
        check(equal, f"multi_merge_choose {label} against its plain version")
    return record


def _time_event(ops, tab, st, rounds: int = 50, repeats: int = 7):
    """Median over ``repeats`` of the mean ms per event round (one merge_event
    launch and the ``count -= over`` the engine pairs with it), each repeat
    from the same starting state; the device time per launch; the bound."""
    sv0, al0, km0, count0, _ = st
    work = [t.clone() for t in (sv0, al0, km0)]
    budget = int(count0.min()) - rounds - 2

    def reset():
        for w, t in zip(work, (sv0, al0, km0)):
            w.copy_(t)
        return count0.clone()

    def timed(impl):
        means = []
        for rep in range(repeats + 1):
            count = reset()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(rounds):
                over = count > budget
                ops.merge_event(*work, count, over, tab, impl=impl)
                count = count - over.to(count.dtype)
            end.record()
            torch.cuda.synchronize()
            if rep:                                   # the first repeat warms up
                means.append(start.elapsed_time(end) / rounds)
        return statistics.median(means)

    k_ms, p_ms = timed("cuda"), timed("ref")
    box = [reset()]

    def one_round():
        over = box[0] > budget
        ops.merge_event(*work, box[0], over, tab, impl="cuda")
        box[0] = box[0] - over.to(box[0].dtype)

    fixed = ops.merge_event_kernel.CLUSTER
    by_k = {fixed: device_ms(one_round, "merge_event_kernel", calls=rounds)}

    def round_at(k):
        over = box[0] > budget
        ops.merge_event_kernel.merge_event_cuda(*work, box[0], over, tab.h_table, tab.wd_table,
                                                cluster=k)
        box[0] = box[0] - over.to(box[0].dtype)

    for k in (16, 1):
        box[0] = reset()
        by_k[k] = device_ms(lambda: round_at(k), "merge_event_kernel", calls=rounds)
    b_ms, b_by = _event_bound(sv0, al0, km0, count0, count0 > budget, tab)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                device_ms=by_k[fixed], device_ms_by_k=by_k)


def _event_bound(sv_x, alpha, kmat, count, over, tab):
    """Least time of one merge_event round on these inputs:
    ``kernel_work.merge_event_work`` of ``_event_parts``."""
    c, s, d = sv_x.shape
    cells, n_act, n_over, valid = _event_parts(sv_x, alpha, kmat, count, over, tab)
    return bound_ms(kernel_work.merge_event_work(c, d, sv_x.element_size(), n_act, n_over, valid,
                                        cells.numel()))


def _event_parts(sv_x, alpha, kmat, count, over, tab):
    """What one merge_event round on these inputs must touch: the unique
    WD-table cells that the valid candidates of all executing classes read
    (a tensor of cell indices), the active slots of the executing classes,
    the number of executing classes and of valid candidates."""
    from repro_torch.kernels import ref
    c, s, d = sv_x.shape
    dev = alpha.device
    idx = torch.arange(s, device=dev)
    ar = torch.arange(c, device=dev)
    active = idx < count[:, None]
    i_min = torch.where(active, alpha.abs(), torch.inf).argmin(dim=1)
    a_min = alpha[ar, i_min]
    valid = (active & (alpha * a_min[:, None] > 0) & (idx != i_min[:, None])) & over[:, None]
    m, k = ref.merge_coords(a_min[:, None], alpha, kmat[ar, i_min])
    g0, g1 = tab.wd_table.shape
    i0 = torch.clamp(torch.floor(m[valid] * (g0 - 1)).long(), 0, g0 - 2)
    j0 = torch.clamp(torch.floor(k[valid] * (g1 - 1)).long(), 0, g1 - 2)
    cells = torch.cat([i0 * g1 + j0, i0 * g1 + j0 + 1, (i0 + 1) * g1 + j0,
                       (i0 + 1) * g1 + j0 + 1]).unique()
    n_over = int(over.sum())
    n_act = int(torch.where(over, count, 0).sum())
    return cells, n_act, n_over, int(valid.sum())


def _rounds_work(st, tab, rounds, budget):
    """``kernel_work.merge_event_rounds_work`` of one merge_event_rounds call on state
    ``st`` (sv_x, alpha, kmat, count, stepped IN PLACE by the plain rounds):
    the active slots of the classes over budget at the start, the union of
    the WD-table cells that all its rounds read, and each round that runs,
    by ``_event_parts`` of the state before it."""
    from repro_torch.kernels import ref
    sv, al, km, count = st
    c, s, d = sv.shape
    n_act = int(torch.where(count > budget, count, 0).sum())
    per_round, cells = [], []
    for _ in range(rounds):
        over = count > budget
        if not bool(over.any()):
            break
        round_cells, act, n_over, valid = _event_parts(sv, al, km, count, over, tab)
        per_round.append((act, n_over, valid))
        cells.append(round_cells)
        ref.merge_event(sv, al, km, count, over, tab.h_table, tab.wd_table)
        count -= over.to(count.dtype)
    n_cells = torch.cat(cells).unique().numel() if cells else 0
    return kernel_work.merge_event_rounds_work(c, d, sv.element_size(), n_act, per_round, n_cells)


def phase_event_rounds(ops, tab, gen):
    """merge_event_rounds against its plain version and against MC_BATCH
    single-round merge_event launches on the card, bit for bit (sv_x, alpha,
    kmat, count, n_events), at the class-axis shape with fp32 and bf16 banks
    and a class that falls back to removal, and at a ragged shape; then its
    time at the class-axis shape."""
    record = None
    for sv_dtype in (torch.float32, torch.bfloat16):
        for (c, s, d, budget) in [(MC_CLASSES, MC_BUDGET + MC_BATCH, MC_DIM, MC_BUDGET),
                                  (3, 37, 5, 30)]:
            st = _event_state(gen, c, s, d, sv_dtype, "cuda", budget, removal_class=c - 1)
            n0 = torch.randint(0, 50, (c,), generator=gen).to("cuda", torch.int32)
            outs = {}
            for how in ("kernel", "plain", "rounds of merge_event"):
                sv, al, km, count = (t.clone() for t in st[:4])
                n = n0.clone()
                if how == "rounds of merge_event":
                    for _ in range(MC_BATCH):
                        over = count > budget
                        ops.merge_event(sv, al, km, count, over, tab, impl="cuda")
                        count = count - over.to(count.dtype)
                        n = n + over.to(n.dtype)
                else:
                    ops.merge_event_rounds(sv, al, km, count, n, tab, rounds=MC_BATCH,
                                           budget=budget,
                                           impl="cuda" if how == "kernel" else "ref")
                outs[how] = (sv, al, km, count, n)
            torch.cuda.synchronize()
            got = outs["kernel"]
            equal = {how: all(bool(torch.equal(g, w)) for g, w in zip(got, o))
                     for how, o in outs.items() if how != "kernel"}
            under = st[3] <= budget
            untouched = all(bool(torch.equal(g[under], w[under])) for g, w in zip(got[:3], st[:3]))
            events = int((got[4] - n0).sum())
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got[:3], outs["plain"][:3]))
            line = (f"merge_event_rounds C={c} S={s} D={d} {str(sv_dtype)[6:]} rounds {MC_BATCH}: "
                    f"bit-equal to the plain rounds {equal['plain']} and to {MC_BATCH} merge_event "
                    f"launches {equal['rounds of merge_event']} (sv_x, alpha, kmat, count, "
                    f"n_events); {events} events, counts {got[3].tolist()} (budget {budget}); "
                    f"classes at or under budget bitwise unchanged {untouched}; max_abs_err "
                    f"{err:.3e} (tol 0)")
            if (c, sv_dtype) == (MC_CLASSES, torch.float32):
                line += f"; K={ops.merge_event_kernel.CLUSTER}"
                record = _time_rounds(ops, tab, st, n0, budget, err)
                line += (f"; timing over 40 calls, the budget {MC_BATCH} lower each call: kernel "
                         f"{record['ms'] * 1e3:.2f} us per call (device "
                         f"{us(record['device_ms'])}) plain {record['plain_ms'] * 1e3:.2f} us "
                         f"bound {record['bound_ms'] * 1e3:.4f} us ({record['bound_by']}); "
                         "library call: none")
            print(line)
            check(all(equal.values()) and untouched and err == 0.0,
                  f"merge_event_rounds C={c} S={s} {sv_dtype} against its plain version")
    return record


def _time_rounds(ops, tab, st, n0, budget, err, calls: int = 40, repeats: int = 7):
    """ms per merge_event_rounds call, kernel and plain: ``calls`` calls in a
    row from state ``st``, the i-th with budget ``budget - MC_BATCH * i``, so
    that from the third call on every class runs all MC_BATCH rounds (CUDA
    events around the calls; each repeat from a fresh copy, made outside the
    events); the median over ``repeats``.  Also the kernel's device time per
    launch and the bound of the same calls, per call."""
    work = [t.clone() for t in st[:4]] + [n0.clone()]
    init = list(st[:4]) + [n0]

    def timed(impl, calls, repeats):
        means = []
        for rep in range(repeats + 1):
            for w, t in zip(work, init):
                w.copy_(t)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(calls):
                ops.merge_event_rounds(*work, tab, rounds=MC_BATCH, budget=budget - MC_BATCH * i,
                                       impl=impl)
            end.record()
            torch.cuda.synchronize()
            if rep:                                   # the first repeat warms up
                means.append(start.elapsed_time(end) / calls)
        return statistics.median(means)

    k_ms, p_ms = timed("cuda", calls, repeats), timed("ref", 10, 3)
    box = [calls]

    def one_call(k):
        if box[0] == calls:                           # a fresh copy (other kernels)
            for w, t in zip(work, init):
                w.copy_(t)
            box[0] = 0
        ops.merge_event_kernel.merge_event_rounds_cuda(
            *work, tab.h_table, tab.wd_table, rounds=MC_BATCH,
            budget=budget - MC_BATCH * box[0], cluster=k)
        box[0] += 1

    fixed = ops.merge_event_kernel.CLUSTER
    dms = {}
    for k in dict.fromkeys((fixed, 16, 1)):
        box[0] = calls
        dms[k] = device_ms(lambda: one_call(k), "merge_event_rounds_kernel", calls=calls)
    dm = dms[fixed]
    sv, al, km, count = (t.clone() for t in st[:4])
    n_bytes = n_ops = 0.0
    for i in range(calls):
        b, o = _rounds_work([sv, al, km, count], tab, MC_BATCH, budget - MC_BATCH * i)
        n_bytes, n_ops = n_bytes + b, n_ops + o
    b_ms, b_by = bound_ms((n_bytes / calls, n_ops / calls))
    print(f"  merge_event_rounds device time by cluster size: "
          + ", ".join(f"K={k} {us(v)}" for k, v in dms.items()))
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dm)


def mnist_standin(make_blobs_multiclass):
    """The class-axis data at LIBSVM multi-class mnist's widths; the first
    MC_TEST rows are the test set.  Also prints the nearest-class-mean accuracy
    and the median squared distance that the gamma follows."""
    x, y = make_blobs_multiclass(np.random.default_rng(SEED), MC_TRAIN + MC_TEST, MC_DIM,
                                 MC_CLASSES, sep=0.12, noise=1.0)
    xte, yte, xtr, ytr = x[:MC_TEST], y[:MC_TEST], x[MC_TEST:], y[MC_TEST:]
    dev = torch.device("cuda")
    xt, yt = torch.as_tensor(xtr, device=dev), torch.as_tensor(ytr, device=dev).long()
    means = torch.zeros(MC_CLASSES, MC_DIM, device=dev).index_add_(0, yt, xt)
    means /= torch.bincount(yt, minlength=MC_CLASSES)[:, None]
    pred = torch.cdist(torch.as_tensor(xte, device=dev), means).argmin(dim=1).cpu().numpy()
    pairs = np.random.default_rng(SEED + 1).integers(0, MC_TRAIN, (2, 4000))
    med = float(np.median(((xtr[pairs[0]] - xtr[pairs[1]]) ** 2).sum(axis=1)))
    print(f"mnist-width stand-in: train {xtr.shape} test {xte.shape}, nearest-class-mean "
          f"accuracy {float((pred == yte).mean()):.4f}, median squared distance {med:.1f} "
          f"(gamma 2^-11 = 1/{2 ** 11})")
    return (xtr, ytr), (xte, yte)


def _mc_config(mc, run: str):
    knobs = {"a": dict(maintenance_engine="pallas"),
             "b": dict(maintenance="multi-merge", merge_batch=4),
             "c": dict(step_engine="pallas"),
             "d": dict(step_engine="pallas", maintenance="multi-merge", merge_batch=4)}[run]
    return mc.MulticlassSVMConfig.create(MC_CLASSES, budget=MC_BUDGET, lambda_=MC_LAMBDA,
                                         gamma=MC_GAMMA, batch_size=MC_BATCH, method="lookup-wd",
                                         use_kernel_cache=True, **knobs)



def _mc_order(steps: int):
    perm = torch.randperm(MC_TRAIN, generator=torch.Generator().manual_seed(SEED))
    return perm[: steps * MC_BATCH]


def phase_class_run(mc, ops, kernel_cache, data, run: str):
    """One class-axis run (a: merge_event engine, b: multi-merge), the launch
    counters set to 0 just before it and read just after."""
    (xtr, ytr), (xte, yte) = data
    dev = torch.device("cuda")
    cfg = _mc_config(mc, run)
    steps = MC_STEPS[run] or MC_TRAIN // MC_BATCH
    cut = "" if steps == MC_TRAIN // MC_BATCH else " (cut)"
    print(f"CUT: run ({run}) trains {steps} of the epoch's {MC_TRAIN // MC_BATCH} steps{cut}")
    table = cfg.table().to(dev)
    st = mc.init_multiclass_state(cfg, MC_DIM, device=dev)
    x, y = torch.as_tensor(xtr, device=dev), torch.as_tensor(ytr, device=dev)
    order = _mc_order(steps)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = mc.train_epoch_multiclass(cfg, table, st, x, y, order, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acc = float(mc.accuracy_multiclass(st, xte, yte, MC_GAMMA, device=dev))
    launches = ops.launch_counts()
    res = dict(steps=steps, seconds=secs, us_per_step=secs / steps * 1e6, accuracy=acc,
               count=st.count.tolist(), n_merges=st.n_merges.tolist(),
               n_inserts=st.n_inserts.tolist(), launches=launches)
    print(f"class-axis run ({run}) {MC_RUNS[run]}: {json.dumps(res)}")
    kernel = {"a": "merge_event_rounds", "b": "multi_merge_choose"}.get(run, "train_step")
    check(st.sv_x.is_cuda and st.kmat.is_cuda, "the class-axis state lives on the card")
    check(max(res["count"]) <= MC_BUDGET, f"run ({run}): a count above the budget")
    check(min(res["n_merges"]) > 0, f"run ({run}): a class with no merge event")
    check(launches[kernel] > 0, f"run ({run}): {kernel} never launched")
    if kernel in ("train_step", "merge_event_rounds"):
        check(launches[kernel] == steps, f"run ({run}): {kernel} launched "
              f"{launches[kernel]} times in {steps} steps")
    if kernel == "merge_event_rounds":
        # a step's rounds are one launch: no single-round launch on the path
        check(launches["merge_event"] == 0, f"run ({run}): merge_event launched "
              f"{launches['merge_event']} times; the path now runs merge_event_rounds")
    if kernel == "multi_merge_choose":
        # batch_size masked rounds a step, each one multi_merge_choose launch
        # and no launch of the scoring kernels
        check(launches[kernel] == MC_BATCH * steps, f"run ({run}): multi_merge_choose "
              f"launched {launches[kernel]} times in {steps} steps (expected {MC_BATCH} a step)")
        check(launches["multi_merge_scores"] == 0 and launches["merge_scores"] == 0,
              f"run ({run}): multi_merge_scores or merge_scores launched; the path now runs "
              "multi_merge_choose")
    check(launches["rbf_matrix"] > 0, f"run ({run}): rbf_matrix never launched")
    check(acc >= 0.80, f"run ({run}): accuracy {acc} below the 0.80 sanity floor")
    if run != "b":
        worst = kernel_cache.invariant_errors(st.kmat, st.sv_x, st.count, MC_GAMMA)
        print(f"run ({run}) end of epoch: worst I1 error per class "
              f"{[float(f'{e:.3e}') for e in worst]}")
    return res, st, cfg


def _near_tie(mc, cfg, tabs, prev, xs, ys):
    """Why the card and CPU steps part, from the states before the step: a
    batch row whose margin lies on either side of 1 on the two devices, or
    an event round whose decisions differ where the two smallest |alpha| or
    the two smallest WD scores tie to 1e-5.  Returns ``(explained, text)``."""
    from repro_torch.core import bsgd
    from repro_torch.kernels import ops, ref

    b = cfg.binary
    margins, rounds = {}, {}
    for dev, st in prev.items():
        k_b = mc.class_kernel_rows(st.sv_x, xs[dev], b.gamma)
        y_ovr = mc.ovr_targets(ys[dev], cfg.n_classes)
        act = torch.arange(st.alpha.shape[1], device=dev) < st.count[:, None]
        margins[dev] = (y_ovr * (k_b @ torch.where(act, st.alpha, 0.0)[..., None])[..., 0]).cpu()
        mid = bsgd.insert_from_rows(b, st, xs[dev], y_ovr, k_b,
                                    ops.rbf_matrix(xs[dev], xs[dev], b.gamma))
        sv, al, km, count = mid.sv_x.clone(), mid.alpha.clone(), mid.kmat.clone(), mid.count
        rounds[dev] = []
        for _ in range(b.batch_size):
            over = count > b.budget
            snap = (al.cpu(), km.cpu(), count.cpu())
            dec = torch.full((cfg.n_classes, 3), -1, dtype=torch.int32, device=dev)
            ops.merge_event(sv, al, km, count, over, tabs[dev], decisions=dec)
            rounds[dev].append((dec.cpu(), snap))
            count = count - over.to(count.dtype)
    m_c, m_p = margins["cuda"], margins["cpu"]
    split = torch.nonzero((m_c < 1) != (m_p < 1))
    if split.numel():
        q, r = split[0].tolist()
        gap = abs(float(m_c[q, r]) - float(m_p[q, r]))
        return gap < 1e-3, (f"margin near-tie: class {q} batch row {r} margin card "
                            f"{float(m_c[q, r])!r} cpu {float(m_p[q, r])!r}")
    for k, ((d_c, snap), (d_p, _)) in enumerate(zip(rounds["cuda"], rounds["cpu"])):
        differ = torch.nonzero((d_c != d_p).any(dim=1)).flatten().tolist()
        if not differ:
            continue
        q = differ[0]
        al, km, cnt = snap[0][q], snap[1][q], int(snap[2][q])
        a_abs = torch.where(torch.arange(al.shape[0]) < cnt, al.abs(), torch.inf)
        a2 = torch.sort(a_abs).values[:2]
        i_min = int(torch.argmin(a_abs))
        m, kap = ref.merge_coords(al[i_min], al, km[i_min])
        valid = (a_abs < torch.inf) & (al * al[i_min] > 0) & (torch.arange(al.shape[0]) != i_min)
        wd = torch.where(valid, (al[i_min] + al) ** 2 * ref.bilinear_lookup(
            tabs["cpu"].wd_table, m, kap), torch.inf)
        w2 = torch.sort(wd).values[:2]
        tie = bool(a2[1] - a2[0] <= 1e-5 * a2[0]) or bool(w2[1] - w2[0] <= 1e-5 * w2[0])
        return tie, (f"event near-tie: round {k} class {q} decisions card {d_c[q].tolist()} cpu "
                     f"{d_p[q].tolist()}; two smallest |alpha| {a2.tolist()}, WD {w2.tolist()}")
    return False, "no margin or event decision differs"


def phase_class_replay(mc, kernel_cache, data):
    """The first MC_REPLAY_STEPS steps of run (a) on the card and on the CPU in
    lockstep; where their integer state first differs, the cause must be a
    near-tie (``_near_tie``).  Then the cache invariants of both."""
    (xtr, ytr), _ = data
    cfg = _mc_config(mc, "a")
    order = _mc_order(MC_REPLAY_STEPS)
    print(f"CUT: class replay runs the first {MC_REPLAY_STEPS} of run (a)'s steps (cut from "
          "1,000)")
    devs = ("cuda", "cpu")
    tabs = {dev: cfg.table().to(dev) for dev in devs}
    st = {dev: mc.init_multiclass_state(cfg, MC_DIM, device=dev) for dev in devs}
    xs = {dev: torch.as_tensor(xtr).index_select(0, order).to(dev) for dev in devs}
    ys = {dev: torch.as_tensor(ytr).long().index_select(0, order).to(dev) for dev in devs}
    ints = lambda s: torch.stack([s.count, s.n_inserts, s.n_merges]).cpu()
    first = None
    t0 = time.perf_counter()
    for i in range(MC_REPLAY_STEPS):
        sl = slice(i * MC_BATCH, (i + 1) * MC_BATCH)
        prev = dict(st)
        for dev in devs:
            st[dev] = mc.train_step_multiclass(cfg, tabs[dev], st[dev], xs[dev][sl], ys[dev][sl])
        if first is None and not torch.equal(ints(st["cuda"]), ints(st["cpu"])):
            first = i
            explained, why = _near_tie(mc, cfg, tabs, prev, {d: xs[d][sl] for d in devs},
                                       {d: ys[d][sl] for d in devs})
            print(f"class replay: first step whose integer state differs: {i}; {why}")
            check(explained, f"class replay parts at step {i} without a near-tie: {why}")
    if first is None:
        print("class replay: first step whose integer state differs: None")
    print(f"class replay: {MC_REPLAY_STEPS} steps on both in {time.perf_counter() - t0:.3f} s; "
          f"n_merges card {st['cuda'].n_merges.tolist()} cpu {st['cpu'].n_merges.tolist()}")
    for dev, s in st.items():
        kernel_cache.check_invariants(s.kmat, s.sv_x, s.count, MC_GAMMA, tol=5e-5,
                                      context=f"replay {dev}")
        worst = kernel_cache.invariant_errors(s.kmat, s.sv_x, s.count, MC_GAMMA)
        print(f"class replay {dev}: cache invariants I1 (tol 5e-5, worst {worst.max():.3e}), "
              f"I2, I3 hold")


def _profile(step, steps: int, label: str, steps_per_call: int = 1):
    """Device busy time per step over ``steps`` calls of ``step(i)``, each
    call ``steps_per_call`` training steps.  Returns how many windows it
    ran and the last one's (device µs, count, name) rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for window in range(3):      # a window now and then returns no kernel events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                step(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernel rows only: key_averages() also lists the aten ops that launched them
        rows = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        busy_us = sum(r[0] for r in rows)
        launches = sum(r[1] for r in rows)
        if launches:
            break
    check(launches > 0, "the profiler saw no kernel on the card in three windows")
    steps *= steps_per_call
    print(f"profile {label}: {steps} steps, wall {wall / steps * 1e6:.1f} us/step "
          f"(profiler on), device busy {busy_us / steps:.2f} us/step, "
          f"idle share {1 - busy_us / (wall * 1e6):.4f}, "
          f"kernels {launches / steps:.1f} per step")
    for dt, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dt / steps:8.3f} us/step  {count / steps:5.2f}/step  {key[:90]}")
    return {"windows": window + 1, "rows": rows}


def phase_class_profile(mc, runs, data):
    (xtr, ytr), _ = data
    n = max(MC_PROFILE_STEPS.values()) * MC_BATCH
    xs = torch.as_tensor(xtr[:n]).cuda()
    ys = torch.as_tensor(ytr[:n]).long().cuda()
    for run, (_, st, cfg) in runs.items():
        table = cfg.table().to("cuda")
        box = [st]

        def step(i, cfg=cfg, table=table, box=box):
            sl = slice(i * MC_BATCH, (i + 1) * MC_BATCH)
            box[0] = mc.train_step_multiclass(cfg, table, box[0], xs[sl], ys[sl])

        _profile(step, MC_PROFILE_STEPS[run], f"class-axis run ({run})")


def _step_state(gen, c, s, d, b, budget, count, gamma, sv_dtype, dev, removal_class=None):
    """A class-axis state with an exact cache and one minibatch for one fused
    step: ``count`` active slots a class (one int, or one a class), alphas of
    both signs scaled so that most batch rows (not all) violate the margin,
    and ``k_bb`` from the plain RBF.  ``removal_class`` is full, has negative
    alphas of at least 0.01 but one positive 0.001 (its fixed partner, which
    has no same-sign candidate) and negative targets, so its first event
    falls back to removal."""
    from repro_torch.core import kernel_cache
    from repro_torch.kernels import ref
    counts = torch.as_tensor(count if isinstance(count, list) else [count] * c)
    sv = torch.randn(c, s, d, generator=gen).to(dev, sv_dtype).contiguous()
    kmat = kernel_cache.exact_cache(sv, gamma).contiguous()
    scale = (2.0 / count ** 0.5 if isinstance(count, int)
             else (2.0 / counts.float() ** 0.5)[:, None])
    alpha = torch.randn(c, s, generator=gen) * scale
    xb = torch.randn(b, d, generator=gen).to(dev)
    yb = torch.where(torch.rand(c, b, generator=gen) < 0.5, -1.0, 1.0)
    if removal_class is not None:
        alpha[removal_class] = -(alpha[removal_class].abs() + 0.01)
        alpha[removal_class, 1] = 0.001
        yb[removal_class] = -1.0
        counts[removal_class] = s
    alpha = torch.where(torch.arange(s) < counts[:, None], alpha, 0.0).to(dev).contiguous()
    ints = lambda v: torch.full((c,), v, dtype=torch.int32, device=dev)
    return [sv, alpha, kmat, counts.to(dev, torch.int32), ints(5_000), ints(0), ints(0), xb,
            yb.to(dev), ref.rbf_matrix(xb, xb, gamma)]


def _step_ties(ref, tab, args, kw):
    """How near the plain step on ``args`` comes to a tie that two correct
    implementations may break differently: the least |margin - 1| over every
    class and batch row, and the least nonzero relative gap between
    neighbours among the P + 1 smallest |alpha| (the fixed partners) or
    between the two best WD scores of a fixed partner, over every round that
    runs.  Exact ties do not count: both sides break them by slot (the SVs
    of one insert share one |alpha|).  Returns ``(margin_gap, tie_gap)``."""
    sv, alpha, kmat, count, step, nin, nmg, xb, yb, k_bb = args
    c, s, d = sv.shape
    idx = torch.arange(s, device=sv.device)
    k_b = ref.rbf_matrix(xb, sv.reshape(c * s, d), kw["gamma"]).view(-1, c, s).transpose(0, 1)
    f = (k_b @ torch.where(idx < count[:, None], alpha, 0.0)[..., None])[..., 0]
    margin_gap = float((yb * f - 1.0).abs().min())
    # the insert alone (no class is over a budget of 2^30), then the rounds
    st = [t.clone() for t in args[:7]]
    ref.train_step_fused(*st, xb, yb, k_bb, tab.h_table, tab.wd_table,
                         **{**kw, "budget": 2 ** 30})
    sv, alpha, kmat, count = st[:4]
    p = kw["merge_batch"] if kw["maintenance"] == "multi-merge" else 1
    tie_gap = float("inf")
    for _ in range(kw["batch_size"]):
        over = count > kw["budget"]
        for q in torch.nonzero(over).flatten().tolist():
            act = idx < count[q]
            a_abs, order = torch.sort(torch.where(act, alpha[q].abs(), torch.inf), stable=True)
            rel = (a_abs[1:p + 1] - a_abs[:p]) / a_abs[:p].clamp(min=1e-30)
            tie_gap = min([tie_gap] + rel[rel > 0].tolist())
            for i in order[:p].tolist():
                a_i = alpha[q, i]
                valid = act & (alpha[q] * a_i > 0) & (idx != i)
                m, kap = ref.merge_coords(a_i, alpha[q], kmat[q, i])
                wd = torch.where(valid, (a_i + alpha[q]) ** 2
                                 * ref.bilinear_lookup(tab.wd_table, m, kap), torch.inf)
                w2 = torch.sort(wd).values[:2]
                rel = float((w2[1] - w2[0]) / w2[0].abs().clamp(min=1e-30))
                if bool(torch.isfinite(w2).all()) and rel > 0:
                    tie_gap = min(tie_gap, rel)
        if kw["maintenance"] == "merge":
            ref.merge_event(sv, alpha, kmat, count, over, tab.h_table, tab.wd_table)
            count = count - over.to(count.dtype)
        else:
            sv, alpha, kmat, count = ref.multi_merge_event(
                sv, alpha, kmat, count, over, tab.h_table, tab.wd_table, budget=kw["budget"],
                merge_batch=kw["merge_batch"])
    return margin_gap, tie_gap


def _explained(gaps) -> bool:
    """A near-tie: a margin within 1e-3 of 1, or a tie within 1e-5 relative."""
    return any(mg < 1e-3 or tg <= 1e-5 for mg, tg in gaps)


def _step_bound(args, out, kw):
    """Least time of one fused step on these inputs.  Bytes: the bank, alpha
    (read and written), the minibatch, targets, k_bb and the counters once;
    per class the cache rows and columns its inserts write (two of count
    entries each) and, per SV an event retires, the seven cache rows and
    five SV rows the event reads or writes (merge: rows i_min, j, last read,
    two rows and two columns written; multi-merge: the pair's two rows read,
    z's row and column written, one moved row read and written with its
    column).  Operations: two a multiply-add of the margin (B x S x D a
    class, and the norms), ~25 a scored candidate and ~10 an active slot of
    every event."""
    sv, alpha, kmat, count, step, nin, nmg, xb, yb, k_bb = args
    c, s, d = sv.shape
    b = xb.shape[0]
    n_new = (out[5] - nin).double()
    retired = (count + out[5] - nin - out[3]).double()
    rounds = (out[6] - nmg).double()
    mid = (count + out[5] - nin).double()
    p = kw["merge_batch"] if kw["maintenance"] == "multi-merge" else 1
    return bound_ms(kernel_work.train_step_work(c, s, d, b, sv.element_size(), *(
        v.cpu().numpy() for v in (n_new, retired, rounds, mid)), p))


def _step_device_ms(ops, tab, args, kw, k, reset_count: bool):
    """Device ms per launch of train_step with ``k`` blocks a class on an
    evolving copy of ``args``; with ``reset_count`` the counters are reset
    before every call, so a state below its budget stays below it."""
    work = [t.clone() for t in args[:7]]

    def call():
        if reset_count:
            for i in (3, 5, 6):
                work[i].copy_(args[i])
        ops.train_step_kernel.train_step_cuda(*work, *args[7:], tab.h_table, tab.wd_table,
                                              cluster=k, **kw)

    return device_ms(call, "train_step_kernel")


def phase_step_kernel(ops, ref, table):
    """train_step against its plain version on the card, from the same state,
    at the cluster size the launch chooses and at the sizes of its ``Ks``
    column, every one bit-equal to one block a class; its times at the
    class-axis and binary shapes."""
    from repro_torch.kernels import train_step as ts
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 11)
    tab = table.to(dev)
    s_mc = MC_BUDGET + MC_BATCH
    half = MC_BUDGET // 2
    mixed = [MC_BUDGET - 2, half, MC_BUDGET - 1, MC_BUDGET, MC_BUDGET - 5, MC_BUDGET - 2,
             MC_BUDGET - 8, MC_BUDGET - 2, MC_BUDGET - 3, MC_BUDGET]
    ks = (1, 2, 8)
    cases = [  # (label, C, budget, D, B, count, gamma, lambda, sv dtype, maintenance, Ks, removal)
        ("class axis", MC_CLASSES, MC_BUDGET, MC_DIM, MC_BATCH, MC_BUDGET - 2, MC_GAMMA,
         MC_LAMBDA, torch.float32, "merge", ks, None),
        ("class axis", MC_CLASSES, MC_BUDGET, MC_DIM, MC_BATCH, MC_BUDGET - 2, MC_GAMMA,
         MC_LAMBDA, torch.float32, "multi-merge", ks, None),
        ("bf16 bank", MC_CLASSES, MC_BUDGET, MC_DIM, MC_BATCH, MC_BUDGET - 2, MC_GAMMA,
         MC_LAMBDA, torch.bfloat16, "multi-merge", (1,), None),
        ("below budget", MC_CLASSES, MC_BUDGET, MC_DIM, MC_BATCH, half, MC_GAMMA, MC_LAMBDA,
         torch.float32, "merge", (1,), None),
        ("mixed + removal", MC_CLASSES, MC_BUDGET, MC_DIM, MC_BATCH, mixed, MC_GAMMA, MC_LAMBDA,
         torch.float32, "merge", ks, MC_CLASSES - 1),
        ("mixed + removal", MC_CLASSES, MC_BUDGET, MC_DIM, MC_BATCH, mixed, MC_GAMMA, MC_LAMBDA,
         torch.float32, "multi-merge", ks, MC_CLASSES - 1),
        ("ragged", 3, 33, 5, 4, 31, 0.5, 1e-3, torch.float32, "multi-merge", (1, 2, 8, 16), None),
        ("ragged", 3, 33, 5, 4, 31, 0.5, 1e-3, torch.float32, "merge", (1, 2, 8, 16), None),
        ("binary", 1, BUDGET, DIM, 1, BUDGET, 2.0 ** -7, 1e-5, torch.float32, "merge", ks, None),
        ("binary below", 1, BUDGET, DIM, 1, BUDGET - 100, 2.0 ** -7, 1e-5, torch.float32,
         "merge", (1,), None),
        # merge_batch 64: a budget 60 below the class axis's, so that a round
        # executes more than 32 pairs (K = 1 cannot hold 64 pairs' rows)
        ("merge_batch 64", MC_CLASSES, MC_BUDGET - 60, MC_DIM, MC_BATCH, MC_BUDGET - 2, MC_GAMMA,
         MC_LAMBDA, torch.float32, "multi-merge", (2, 8, 16), None),
        # a minibatch of 128 rows at d = 780: staged eight rows at a time
        # (K = 1 cannot hold its 128 x 628 margin rows)
        ("batch 128", MC_CLASSES, MC_BUDGET, MC_DIM, 128, MC_BUDGET - 2, MC_GAMMA, MC_LAMBDA,
         torch.float32, "merge", (2, 8, 16), None),
    ]
    # slots a class, where a case's budget is not the class axis's
    slots = {"merge_batch 64": MC_BUDGET + MC_BATCH}
    records = {}
    for label, c, budget, d, b, count, gamma, lam, sv_dtype, maint, case_ks, removal in cases:
        s = slots.get(label, budget + b)
        p = 64 if label == "merge_batch 64" else 4
        kw = dict(budget=budget, lambda_=lam, gamma=gamma, batch_size=b, maintenance=maint,
                  merge_batch=p)
        args = _step_state(gen, c, s, d, b, budget, count, gamma, sv_dtype, dev, removal)
        multi = maint == "multi-merge"
        chosen = ts.cluster_size(sv_dtype == torch.bfloat16, c, s, d, b, multi, p if multi else 1)
        want = [t.clone() for t in args[:7]]
        w_out = ops.train_step(*want, *args[7:], tab, impl="ref", **kw)
        outs = {}
        for k in dict.fromkeys((chosen, *case_ks)):
            got = [t.clone() for t in args[:7]]
            outs[k] = ts.train_step_cuda(*got, *args[7:], tab.h_table, tab.wd_table, cluster=k,
                                         **kw)
        torch.cuda.synchronize()
        g_out = outs[chosen]
        base = min(outs)    # K = 1 where one block holds the case
        same_k = {k: all(bool(torch.equal(x, y)) for x, y in zip(o, outs[base]))
                  for k, o in outs.items() if k != base}
        ints_equal = all(bool(torch.equal(g_out[i], w_out[i])) for i in (3, 4, 5, 6))
        e_sv = (g_out[0].float() - w_out[0].float()).abs().max().item()
        e_al = (g_out[1] - w_out[1]).abs().max().item()
        e_km = (g_out[2] - w_out[2]).abs().max().item()
        # floats: the reference's kernel-vs-oracle tolerance (rtol 1e-5, atol
        # 5e-5); a bf16 bank within one bf16 rounding of the plain version
        sv_tol = 5e-5 if sv_dtype == torch.float32 else 2.0 ** -7 * w_out[0].float().abs().max().item()
        floats_ok = (e_sv <= sv_tol and e_km <= 5e-5
                     and bool(torch.allclose(g_out[1], w_out[1], rtol=1e-5, atol=5e-5)))
        events = int((w_out[6] - args[6]).sum())
        line = (f"train_step {label} {maint} C={c} S={s} D={d} B={b} {str(sv_dtype)[6:]} "
                f"K={chosen}: "
                f"integer state equal {ints_equal} (events {events}, inserts "
                f"{int(w_out[5].sum())}) max err sv_x {e_sv:.3e} (tol {sv_tol:.3e}) alpha "
                f"{e_al:.3e} kmat {e_km:.3e} (rtol 1e-5, atol 5e-5); bit-equal to K={base} at K "
                f"{same_k}")
        check(all(same_k.values()), f"train_step {label} {maint}: a cluster size parts from "
              f"K={base}")
        if label == "merge_batch 64":
            pairs = int((args[3] + w_out[5] - args[5] - budget).max())
            line += f"; largest excess {pairs} (pairs a first round may execute)"
            check(pairs > 32, "train_step merge_batch 64: no round can execute more than 32 pairs")
        if label.startswith("below") or label == "binary below":
            check(events == 0, f"train_step {label}: an event ran below the budget")
        else:
            check(events > 0, f"train_step {label} {maint}: no event ran")
        if label == "below budget":
            # the rounds are bitwise no-ops: merge and multi-merge rounds give one state
            other = [t.clone() for t in args[:7]]
            o_out = ops.train_step(*other, *args[7:], tab, impl="cuda",
                                   **{**kw, "maintenance": "multi-merge"})
            noop = all(bool(torch.equal(x, y)) for x, y in zip(g_out, o_out))
            line += f"; no events, merge and multi-merge rounds bitwise equal {noop}"
            check(noop, "train_step below the budget: the rounds are not bitwise no-ops")
        if removal is not None:
            under = [q for q, n in enumerate(count) if n + b <= budget]
            line += f"; classes that cannot exceed the budget {under}"
        if not ints_equal:
            gaps = _step_ties(ref, tab, args, kw)
            line += f"; parts: least |margin - 1| {gaps[0]:.3e}, least tie gap {gaps[1]:.3e}"
            check(_explained([gaps]), f"train_step {label} {maint}: integer state differs "
                  "without a near-tie")
        print(line)
        check(floats_ok or not ints_equal, f"train_step {label} {maint} against its plain version")
        if label in ("class axis", "binary", "below budget", "binary below"):
            below = "below" in label
            times = {k: _step_device_ms(ops, tab, args, kw, k, below)
                     for k in dict.fromkeys((chosen, 1))}
            b_ms, b_by = _step_bound(args, w_out, kw)
            line = (f"  train_step timing ({label} {maint}): device {us(times[chosen])} at "
                    f"K={chosen}, {us(times[1])} at K=1; bound {b_ms * 1e3:.4f} us ({b_by})")
            if not below:
                work = [t.clone() for t in args[:7]]
                plain = [t.clone() for t in args[:7]]
                k_ms = time_call(lambda: ops.train_step(*work, *args[7:], tab, impl="cuda", **kw))
                p_ms = time_call(lambda: ops.train_step(*plain, *args[7:], tab, impl="ref", **kw),
                                 calls=10, repeats=3)
                line += (f"; kernel {k_ms * 1e3:.2f} us per call, plain {p_ms * 1e3:.2f} us; "
                         "library call: none")
                if label == "class axis" and maint == "merge":
                    records["train_step"] = dict(max_abs_err=max(e_sv, e_al, e_km), ms=k_ms,
                                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                                 library_ms=None, device_ms=times[chosen],
                                                 cluster=chosen)
            print(line)
    return records


def phase_binary_fused(core, ops, data, composed_acc: float):
    """The binary main path with the fused step (cache, batch 1), one epoch, the
    launch counters set to 0 just before it and read just after."""
    (xtr, ytr), (xte, yte) = data
    xtr, ytr = xtr[:MAIN_STEPS], ytr[:MAIN_STEPS]     # phase 4's rows, for the gap
    cfg = core.BSGDConfig(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1,
                          use_kernel_cache=True, step_engine="pallas")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = core.fit(cfg, xtr, ytr, epochs=1, seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    acc = float(core.accuracy(st, xte, yte, cfg.gamma))
    steps = int(st.step) - 1
    run = dict(count=int(st.count), n_inserts=int(st.n_inserts), n_merges=int(st.n_merges),
               accuracy=acc, seconds=secs, us_per_step=secs / steps * 1e6, steps=steps,
               launches=launches)
    print(f"fit lookup-wd fused step (cache): {json.dumps(run)}")
    gap = abs(acc - composed_acc)
    print(f"accuracy fused vs composed lookup-wd: gap {gap:.4f} (limit 0.01)")
    check(st.sv_x.is_cuda and st.kmat.is_cuda, "the fused binary state lives on the card")
    check(run["count"] <= BUDGET, f"fused binary: count {run['count']} > budget")
    check(run["n_merges"] > 0, "fused binary: no merge events")
    check(launches["train_step"] == steps, f"fused binary: train_step launched "
          f"{launches['train_step']} times in {steps} steps")
    check(gap <= 0.01, f"fused and composed binary accuracies differ by {gap}")
    return run, st, cfg


def phase_lockstep(mc, kernel_cache, ref, data):
    """The first LOCKSTEP_STEPS steps of run (c) on the card through the fused
    kernel and through run (a)'s composed engine, integer state compared step
    by step; where they first part, the step must be a near-tie."""
    (xtr, ytr), _ = data
    dev = torch.device("cuda")
    cfgs = {"fused": _mc_config(mc, "c"), "composed": _mc_config(mc, "a")}
    tab = cfgs["fused"].table().to(dev)
    order = _mc_order(LOCKSTEP_STEPS)
    xs = torch.as_tensor(xtr).index_select(0, order).to(dev)
    ys = torch.as_tensor(ytr).long().index_select(0, order).to(dev)
    st = {k: mc.init_multiclass_state(cfgs["fused"], MC_DIM, device=dev) for k in cfgs}
    ints = lambda s: torch.stack([s.count, s.n_inserts, s.n_merges]).cpu()
    b = cfgs["fused"].binary
    kw = dict(budget=b.budget, lambda_=b.lambda_, gamma=b.gamma, batch_size=b.batch_size,
              maintenance="merge", merge_batch=b.merge_batch)
    first = None
    t0 = time.perf_counter()
    for i in range(LOCKSTEP_STEPS):
        sl = slice(i * MC_BATCH, (i + 1) * MC_BATCH)
        prev = dict(st)
        for k, cfg in cfgs.items():
            st[k] = mc.train_step_multiclass(cfg, tab, st[k], xs[sl], ys[sl])
        if first is None and not torch.equal(ints(st["fused"]), ints(st["composed"])):
            first = i
            y_ovr = mc.ovr_targets(ys[sl], MC_CLASSES)
            k_bb = ref.rbf_matrix(xs[sl], xs[sl], b.gamma)
            gaps = [_step_ties(ref, tab, [p.sv_x, p.alpha, p.kmat, p.count, p.step, p.n_inserts,
                                          p.n_merges, xs[sl], y_ovr, k_bb], kw)
                    for p in prev.values()]
            print(f"lockstep: first step whose integer state differs: {i}; least |margin - 1| "
                  f"{min(g[0] for g in gaps):.3e}, least tie gap {min(g[1] for g in gaps):.3e}")
            check(_explained(gaps), f"fused and composed part at step {i} without a near-tie")
    if first is None:
        print("lockstep: first step whose integer state differs: None")
    print(f"lockstep: {LOCKSTEP_STEPS} steps on both in {time.perf_counter() - t0:.3f} s; "
          f"n_merges fused {st['fused'].n_merges.tolist()} composed "
          f"{st['composed'].n_merges.tolist()}")
    for k, s in st.items():
        kernel_cache.check_invariants(s.kmat, s.sv_x, s.count, MC_GAMMA, tol=5e-5,
                                      context=f"lockstep {k}")
        worst = kernel_cache.invariant_errors(s.kmat, s.sv_x, s.count, MC_GAMMA)
        print(f"lockstep {k}: cache invariants I1 (tol 5e-5, worst {worst.max():.3e}), "
              "I2, I3 hold")


def phase_fused_profile(core, mc, runs, binary, data, mc_data):
    """Profiled windows of the fused runs: the epoch loops themselves, chunk by
    chunk (each chunk one ``train_epoch`` call, which updates one copy of the
    state in place)."""
    chunk = 50
    (xtr, ytr), _ = mc_data
    n = FUSED_PROFILE_STEPS * MC_BATCH
    xs = torch.as_tensor(xtr[:n]).cuda()
    ys = torch.as_tensor(ytr[:n]).long().cuda()
    for run, (_, st, cfg) in runs.items():
        table = cfg.table().to("cuda")
        box = [st]
        steps = MC_PROFILE_STEPS[run]

        def step(i, cfg=cfg, table=table, box=box):
            order = torch.arange(i * chunk * MC_BATCH, (i + 1) * chunk * MC_BATCH)
            box[0] = mc.train_epoch_multiclass(cfg, table, box[0], xs, ys, order)

        _profile(step, steps // chunk, f"class-axis run ({run})", steps_per_call=chunk)
    (xtr, ytr), _ = data
    _, st, cfg = binary
    table = cfg.table().to("cuda")
    xb = torch.as_tensor(xtr[:FUSED_PROFILE_STEPS]).cuda()
    yb = torch.as_tensor(ytr[:FUSED_PROFILE_STEPS]).cuda()
    box = [st]

    def bstep(i):
        box[0] = core.train_epoch(cfg, table, box[0], xb, yb,
                                  torch.arange(i * chunk, (i + 1) * chunk))

    _profile(bstep, FUSED_PROFILE_STEPS // chunk, "binary lookup-wd fused step",
             steps_per_call=chunk)


def phase_choose_lockstep(mc, budget_mod, data, run_b):
    """Run (b)'s configuration for CHOOSE_LOCKSTEP_STEPS more steps, from the
    state where run (b) stopped (each class is at its budget there, so every
    round has events; from a fresh state the budget of 500 fills only after
    ~450 steps): the rest of its epoch's rows, then a second epoch's.  At every maintenance round
    ``budget._multi_merge_once`` runs twice on the same state: as the path
    runs it (the multi_merge_choose kernel) and, from a clone, with
    ``impl="ref"`` (the plain scoring and greedy choice).  The two results
    must be equal bit for bit: count, sv_x, alpha and kmat."""
    (xtr, ytr), _ = data
    dev = torch.device("cuda")
    res, st, cfg = run_b
    st = st._replace(**{f: getattr(st, f).clone() for f in st._fields
                        if getattr(st, f) is not None})
    table = cfg.table().to(dev)
    # the rows after run (b)'s last step: the rest of its epoch, then the
    # start of a second epoch in another order
    rows = torch.cat([_mc_order(MC_TRAIN // MC_BATCH),
                      torch.randperm(MC_TRAIN, generator=torch.Generator().manual_seed(SEED + 1))])
    order = rows[res["steps"] * MC_BATCH:(res["steps"] + CHOOSE_LOCKSTEP_STEPS) * MC_BATCH]
    print(f"CUT: choose lockstep runs {CHOOSE_LOCKSTEP_STEPS} steps (cut from 300)")
    x, y = torch.as_tensor(xtr, device=dev), torch.as_tensor(ytr, device=dev)
    orig = budget_mod._multi_merge_once
    seen = {"rounds": 0, "events": 0, "differ": []}

    def both(sv_x, alpha, kmat, count, gamma, method, tab, budget, merge_batch, *,
             impl="auto"):
        got = orig(sv_x, alpha, kmat, count, gamma, method, tab, budget, merge_batch, impl=impl)
        want = orig(*(t.clone() for t in (sv_x, alpha, kmat, count)), gamma, method, tab, budget,
                    merge_batch, impl="ref")
        seen["rounds"] += 1
        seen["events"] += int((count > budget).sum())
        if not all(bool(torch.equal(g, w)) for g, w in zip(got, want)):
            seen["differ"].append(seen["rounds"])
        return got

    t0 = time.perf_counter()
    budget_mod._multi_merge_once = both
    try:
        st = mc.train_epoch_multiclass(cfg, table, st, x, y, order, device=dev)
    finally:
        budget_mod._multi_merge_once = orig
    print(f"choose lockstep: steps {res['steps']} to {res['steps'] + CHOOSE_LOCKSTEP_STEPS} of run "
          f"(b)'s training, {seen['rounds']} maintenance rounds "
          f"({seen['events']} class events) in {time.perf_counter() - t0:.3f} s; rounds whose "
          f"kernel and plain results differ: {seen['differ'][:10]} (count, sv_x, alpha, kmat "
          f"bit for bit); n_merges {st.n_merges.tolist()}")
    check(seen["rounds"] == MC_BATCH * CHOOSE_LOCKSTEP_STEPS,
          f"choose lockstep: {seen['rounds']} rounds in {CHOOSE_LOCKSTEP_STEPS} steps")
    check(seen["events"] > 0, "choose lockstep: no class went over budget")
    check(not seen["differ"], f"choose lockstep: the kernel and plain rounds part at round "
          f"{seen['differ'][:1]}")

# phase 15: the serving configuration's queue geometry and the kernel shapes
SERVE_MAX_BATCH = 256
SERVE_TIMED_ROWS = (8, 64, 256)
# row counts at which the serve cell's rule (csrc/class_scores.cu CELL_RULE)
# takes its 8-, 16-, 32- and 64-row tile
SERVE_CASE_ROWS = (8, 16, 100, 200)
# the serve cell against its plain version (ref.rbf_matrix_rows, then
# ref.class_scores_labels): K within SERVE_K_TOL; scores within SERVE_K_TOL
# times the largest sum of the products' sizes, sum_j |K[i, c s + j]
# alpha[c, j]| (at least 1), the scale of a sum's rounding; labels equal
# wherever the plain version's two best classes are more than twice that
# apart
SERVE_K_TOL = 1e-5


def _serve_cell_want(ref, rbf_kernel, x, bank, alpha, gamma, binary=False):
    """Today's cell on the card: rbf_tiled's K contracted by the plain version."""
    k = rbf_kernel.rbf_matrix_cuda(x, bank, gamma, path="tiled")
    return ref.class_scores_labels(k, alpha, binary=binary)


def _bit_equal(got, want) -> bool:
    """Scores and labels equal bit for bit (a NaN equal to the same NaN)."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32
               else torch.equal(g, w) for g, w in zip(got, want))


def _serve_cell_plain(ref, rbf_kernel, got, x, bank, alpha, gamma):
    """The serve cell's scores and labels ``got`` and ``rbf_tiled``'s K
    against the plain version on the same inputs (multiclass): returns
    (K error, scores error, scores tolerance, rows whose labels the
    comparison skips as near-ties) and fails past SERVE_K_TOL."""
    k_plain = ref.rbf_matrix_rows(x, bank, gamma)
    k_err = (rbf_kernel.rbf_matrix_cuda(x, bank, gamma, path="tiled") - k_plain).abs().max().item()
    scores, labels = ref.class_scores_labels(k_plain, alpha)
    err = (got[0] - scores).abs().max().item()
    tol = SERVE_K_TOL * max(1.0, ref.class_scores_labels(k_plain.abs(), alpha.abs())[0]
                            .max().item())
    top = scores.topk(2, dim=0).values if scores.shape[0] > 1 else None
    clear = (top[0] - top[1] > 2 * tol) if top is not None else torch.ones_like(labels, dtype=bool)
    check(k_err <= SERVE_K_TOL, f"rbf_tiled {tuple(x.shape)} against rbf_matrix_rows: {k_err}")
    check(err <= tol, f"serve cell {tuple(x.shape)} scores against the plain version: {err} "
          f"(tol {tol})")
    check(bool((got[1] == labels)[clear].all()),
          f"serve cell {tuple(x.shape)} labels differ from the plain version's off near-ties")
    return k_err, err, tol, int((~clear).sum())


def _serve_kernel_cases(ref, cs_kernel, rbf_kernel, gen):
    """The one-launch serve cell against today's cell (rbf_tiled's K and the
    plain contraction), bit for bit at each row count of SERVE_CASE_ROWS (one
    for each of the kernel's row tiles), on inputs built to meet its edge
    cases: a ragged C = 3, s = 37 with an exact tie; a binary
    C = 1 model whose scores are exactly 0; rows holding a NaN, an Inf and a
    -Inf, multiclass and binary; C = 40, s = 1,008, d = 5 (16-block
    clusters, features not a multiple of 4); bf16 rows and bank; a bf16 bank
    at d = 30 (no 8-byte copies)."""
    dev = torch.device("cuda")
    r = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    b3, a3 = r(3 * 37, 50), r(3, 37)
    b3[74:], a3[2] = b3[:37], a3[0]                       # classes 0 and 2 tie exactly
    bz, az = r(64, 20), r(1, 64)
    bz[32:], az[0, 32:] = bz[:32], -az[0, :32]            # slots j and j + 32 cancel
    rows = SERVE_CASE_ROWS[-1]
    xn = r(rows, MC_DIM)
    xn[1, 3], xn[2, 4], xn[3, 5] = float("nan"), float("inf"), -float("inf")
    cases = [("ragged C=3 s=37 d=50 with a tie", r(rows, 50), b3, a3, 0.05, False),
             ("binary C=1 with zero scores", r(rows, 20), bz, az, 0.1, True),
             ("NaN/Inf rows, C=10 s=508", xn, r(MC_CLASSES * 508, MC_DIM), r(MC_CLASSES, 508),
              MC_GAMMA, False),
             ("NaN/Inf rows, binary s=501 d=123", xn[:, :123].contiguous(), r(501, 123),
              r(1, 501), 2.0 ** -7, True),
             ("C=40 s=1008 d=5", r(rows, 5), r(40 * 1008, 5), r(40, 1008), 0.5, False),
             ("bf16 rows and bank, C=10 s=508", r(rows, MC_DIM).bfloat16(),
              r(MC_CLASSES * 508, MC_DIM).bfloat16(), r(MC_CLASSES, 508), MC_GAMMA, False),
             ("bf16 bank d=30 (copied through registers)", r(rows, 30),
              r(MC_CLASSES * 37, 30).bfloat16(), r(MC_CLASSES, 37), 0.1, False)]
    for label, x, bank, alpha, gamma, binary in cases:
        equal = {n: _bit_equal(cs_kernel.serve_cell_cuda(x[:n], bank, alpha, gamma,
                                                         binary=binary),
                               _serve_cell_want(ref, rbf_kernel, x[:n], bank, alpha, gamma,
                                                binary))
                 for n in SERVE_CASE_ROWS}
        got = cs_kernel.serve_cell_cuda(x, bank, alpha, gamma, binary=binary)
        print(f"class_scores {label}: bit-equal to rbf_tiled + the plain contraction at "
              f"{list(SERVE_CASE_ROWS)} rows (the rule's four row tiles) {equal}; labels "
              f"{got[1][:6].tolist()}")
        check(all(equal.values()), f"class_scores {label} against today's cell: {equal}")
        if binary and "zero" in label:
            check(bool((got[1] == 0).all()) and bool((got[0] == 0).all()),
                  "class_scores: a zero score's sign is not 0")
        if "tie" in label:
            check(not bool((got[1] == 2).any()), "class_scores: a tie went to the higher class")
        if "NaN" in label:
            check(bool(got[0][:, 1].isnan().all()), "class_scores: a NaN row scored a number")


def phase_serve(core, ops, ref, mc, data, run_c):
    """Serving at the full MNIST width from run (c)'s state, exported fp32 and
    bf16: row independence bit for bit, the one-launch cell against today's
    cell (rbf_tiled's K contracted by the plain version), the two queues
    over a ragged trace of the test rows (the launch counters set to 0 just
    before and read just after: one class_scores launch a microbatch, no
    rbf_matrix), no kernel build or new reserved memory after the warm-up,
    a checkpoint round trip, and the kernel's device time beside its bound.
    Returns the class_scores record and the serve runs' launch counts."""
    import tempfile
    from repro_torch import checkpoint
    from repro_torch.kernels import _build, class_scores as cs_kernel, rbf_kernel
    (_, _), (xte, yte) = data
    res, st, _ = run_c
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 15)
    models = {"fp32": core.export_model(st, MC_GAMMA),
              "bf16": core.export_model(st, MC_GAMMA, bank_dtype="bfloat16")}
    xt = torch.as_tensor(xte, device=dev)
    buckets = core.default_buckets(SERVE_MAX_BATCH)
    sizes = core.ragged_trace_sizes(MC_TEST, SERVE_MAX_BATCH, np.random.default_rng(SEED))

    # a row's scores: one direct call, held to today's cell (rbf_tiled's K
    # and the plain contraction) bit for bit; then every bucket and the
    # ragged trace's requests, each padded to its bucket as the queue pads
    for name, model in models.items():
        direct = ops.serve_cell(xt, model.sv_x, model.alpha, model.gamma)
        want = _serve_cell_want(ref, rbf_kernel, xt, model.sv_x.reshape(-1, MC_DIM),
                                model.alpha, MC_GAMMA)
        today = _bit_equal(direct, want)
        k_err, err, tol, ties = _serve_cell_plain(ref, rbf_kernel, direct, xt,
                                                  model.sv_x.reshape(-1, MC_DIM), model.alpha,
                                                  MC_GAMMA)
        equal = {}
        for b in buckets + ("ragged",):
            got = torch.empty_like(direct[0])
            spans = ([(o, min(b, MC_TEST - o)) for o in range(0, MC_TEST, b)] if b != "ragged"
                     else list(zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes)))
            for off, n in spans:
                rows = torch.zeros(core.pad_bucket(n, buckets), MC_DIM, device=dev)
                rows[:n] = xt[off:off + n]
                got[:, off:off + n] = core.serve_scores(model, rows)[:, :n]
            equal[b] = bool(torch.equal(got, direct[0]))
        print(f"serve scores {name} bank: {MC_TEST} rows in one call bit-equal to rbf_tiled + "
              f"the plain contraction (scores and labels) {today}; bit-equal to the direct call "
              f"at every bucket and ragged offsets {equal}; against the plain version "
              f"(rbf_matrix_rows + class_scores_labels) scores max_abs_err {err:.3e} (tol "
              f"{tol:.3e}), labels equal off {ties} near-tie rows, rbf_tiled's K err "
              f"{k_err:.3e} (tol {SERVE_K_TOL:.0e})")
        check(today, f"serve cell ({name}) differs from rbf_tiled + the plain contraction")
        check(all(equal.values()), f"serve scores ({name}) depend on the batch: {equal}")
    _serve_kernel_cases(ref, cs_kernel, rbf_kernel, gen)

    # device time beside the bound, the plain version and the contraction's einsum
    c, s = models["fp32"].alpha.shape
    record = None
    for n in SERVE_TIMED_ROWS:
        for name, model in models.items():
            bank, alpha, x = model.sv_x.reshape(-1, MC_DIM), model.alpha, xt[:n]
            call = lambda: cs_kernel.serve_cell_cuda(x, bank, alpha, MC_GAMMA)
            want = _serve_cell_want(ref, rbf_kernel, x, bank, alpha, MC_GAMMA)
            got = call()
            check(_bit_equal(got, want), f"class_scores {n} rows {name} against today's cell")
            k_err, err, tol, ties = _serve_cell_plain(ref, rbf_kernel, got, x, bank, alpha,
                                                      MC_GAMMA)
            kv = rbf_kernel.rbf_matrix_cuda(x, bank, MC_GAMMA, path="tiled").view(n, c, s)
            rec = dict(max_abs_err=err, ms=time_call(call),
                       plain_ms=time_call(lambda: ref.class_scores_labels(
                           ref.rbf_matrix_rows(x, bank, MC_GAMMA), alpha), calls=2, repeats=3),
                       library_ms=time_call(lambda: torch.einsum("ncs,cs->cn", kv, alpha)),
                       device_ms=device_ms(call, "class_scores"))
            rec["bound_ms"], rec["bound_by"] = bound_ms(kernel_work.serve_cell_work(
                n, c, s, MC_DIM, 4, bank.element_size()))
            print(f"class_scores serve cell {n}x({c}, {s})x{MC_DIM} {name} bank: device "
                  f"{us(rec['device_ms'])}, {rec['ms'] * 1e3:.2f} us per call, plain "
                  f"(rbf_matrix_rows + class_scores_labels) {rec['plain_ms'] * 1e3:.2f} us, "
                  f"library (einsum of the contraction alone) {rec['library_ms'] * 1e3:.2f} us, "
                  f"bound {rec['bound_ms'] * 1e3:.4f} us ({rec['bound_by']}); bit-equal to "
                  f"today's cell (rbf_tiled's K, the plain contraction); against the plain "
                  f"version (rbf_matrix_rows + class_scores_labels): scores max_abs_err "
                  f"{err:.3e} (tol {tol:.3e}), labels equal off {ties} near-tie rows, "
                  f"rbf_tiled's K err {k_err:.3e} (tol {SERVE_K_TOL:.0e})")
            if n == SERVE_MAX_BATCH and name == "fp32":
                record = rec

    # the queues over the ragged trace: the serve path's runs
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    runs, cells = {}, 0
    for name, model in models.items():
        for queue in ("sync", "async"):
            stats = core.drive_trace(model, xte, sizes, max_batch=SERVE_MAX_BATCH, queue=queue)
            runs[(name, queue)] = stats
            # the warm-up runs each bucket once (the async queue twice), the
            # trace its microbatches, then one direct call checks the labels
            cells += len(buckets) * (1 if queue == "sync" else 2) + stats["microbatches"] + 1
            print(f"serve {queue} queue, {name} bank: rows/s {stats['rows_per_s']} p50 "
                  f"{stats['p50_ms']} ms p99 {stats['p99_ms']} ms pad waste "
                  f"{stats['pad_waste_frac']} microbatches {stats['microbatches']} buckets "
                  f"{stats['bucket_counts']}; after the warm-up: libraries loaded "
                  f"{stats['live_library_loads']}, reserved bytes "
                  f"{stats['live_reserved_bytes']}; queue == direct (bitwise)")
            check(stats["live_library_loads"] == 0, f"serve {queue} {name}: a kernel was built "
                  "after the warm-up")
            check(stats["live_reserved_bytes"] == 0, f"serve {queue} {name}: "
                  f"{stats['live_reserved_bytes']} bytes reserved after the warm-up")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"serve runs' launches: {json.dumps(counts)}; serve cells run {cells} (warm-ups, "
          f"microbatches and direct calls): class_scores once a cell "
          f"{counts['class_scores'] == cells}, rbf_matrix {counts['rbf_matrix']}")
    check(counts["class_scores"] == cells and counts["rbf_matrix"] == 0
          and sum(counts.values()) == cells, f"the serve runs launched {counts} for {cells} cells")

    # where a microbatch's time goes: one full 256-row microbatch a step; the
    # launch counters over the same windows say what the profiler should see
    n_steps = MC_TEST // SERVE_MAX_BATCH
    for queue in ("sync", "async"):
        q = (core.BatchQueue if queue == "sync" else core.AsyncBatchQueue)(
            models["fp32"], max_batch=SERVE_MAX_BATCH)
        q.warmup()

        def step(i, q=q):
            q.take(q.submit(xte[i * SERVE_MAX_BATCH:(i + 1) * SERVE_MAX_BATCH]))

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        seen = _profile(step, n_steps, f"serve {queue} queue, fp32 bank, one "
                        f"{SERVE_MAX_BATCH}-row microbatch a step")
        launched = ops.launch_counts()["class_scores"] / (n_steps * seen["windows"])
        profiled = sum(c for _, c, key in seen["rows"] if "class_scores" in key) / n_steps
        others = {key[:40]: round(c / n_steps, 2) for _, c, key in seen["rows"]
                  if "class_scores" not in key}
        print(f"serve {queue} queue profile: class_scores a microbatch by the launch counters "
              f"{launched:.2f}, in the profiler's window {profiled:.2f}; the window's other "
              f"device rows a microbatch {json.dumps(others)}")
        check(launched == 1.0, f"serve {queue} profile: class_scores {launched} a microbatch")
        if queue == "async":
            q.close()

    labels = {name: core.predict_labels(m, xte).cpu().numpy() for name, m in models.items()}
    train_side = mc.predict_multiclass(st, xte, MC_GAMMA).cpu().numpy()
    acc = {name: float((lab == yte).mean()) for name, lab in labels.items()}
    print(f"serve labels equal predict_multiclass {bool((labels['fp32'] == train_side).all())}; "
          f"accuracy fp32 {acc['fp32']:.4f} (run (c)'s accuracy_multiclass {res['accuracy']:.4f}) "
          f"bf16 {acc['bf16']:.4f}; bf16 labels agree with fp32 on "
          f"{float((labels['bf16'] == labels['fp32']).mean()):.4f} of the rows")
    check(bool((labels["fp32"] == train_side).all()), "serve labels differ from predict_multiclass")
    check(abs(acc["fp32"] - res["accuracy"]) < 0.5 / MC_TEST,
          f"serve accuracy {acc['fp32']} != run (c)'s {res['accuracy']}")
    check(acc["fp32"] >= 0.80, f"serve accuracy {acc['fp32']} below the 0.80 sanity floor")

    # a checkpoint round trip through the port's writer and the serve loader
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        checkpoint.save(d, 1, {"state": st})
        for name, bank_dtype in (("fp32", None), ("bf16", "bfloat16")):
            back = core.load_serve_model(d, MC_GAMMA, bank_dtype=bank_dtype)
            same = all(bool(torch.equal(getattr(back, f), getattr(models[name], f)))
                       for f in ("sv_x", "alpha", "count"))
            print(f"checkpoint round trip ({name} bank): bank, alpha and count bit-equal {same}")
            check(same, f"checkpoint round trip ({name}) differs from export_model")
    return {"class_scores": record}, counts


# ---------------------------------------------------------------------------
# phase 16: streaming
# ---------------------------------------------------------------------------

STREAM_CHUNK_ROWS = 4_100              # = 512 * 8 + 4: rows carry across every boundary
BINARY_CHUNK_ROWS = 2_048
BINARY_MAX_CHUNKS = 2                  # leg (d)'s composed stream: 4,096 of 26,049 steps
LIBSVM_ROWS = 4_096
# leg (f): serve_svm_live at MNIST width over the whole 60,000 rows, one
# snapshot a chunk, its trace of LIVE_ROWS rows submitted at once as the CLI
# does; the arm's CUDA-graph chunk programs are first held to the eager ones
# over LIVE_EQ_CHUNKS chunks (the eager trainer, 64 merge events a step,
# took ~70 s for the whole epoch on one H100, PERF.md)
LIVE_TRAIN_ROWS = MC_TRAIN
LIVE_ROWS = 400_000
LIVE_PUBLISH_EVERY = 1
LIVE_EQ_CHUNKS = 2
LIVE_DRILL_TRAIN_ROWS = 6 * STREAM_CHUNK_ROWS
LIVE_DRILL_ROWS = 50_000


def _states_equal(a, b) -> bool:
    return all((u is None and v is None) or (u is not None and v is not None and u.dtype == v.dtype
                                             and torch.equal(u, v)) for u, v in zip(a, b))


def _timed(fn):
    """``(result, seconds)`` of ``fn()`` on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _peak_bytes(fn):
    """``(result, seconds, peak bytes above what was allocated before)``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, secs = _timed(fn)
    return out, secs, torch.cuda.max_memory_allocated() - base


def _launched(ops, fn):
    """``(result, seconds, launches)`` of one main-path run, the launch
    counters set to 0 just before it and read just after."""
    ops.reset_launch_counts()
    out, secs = _timed(fn)
    return out, secs, ops.launch_counts()


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _finite(state) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in state if t is not None and
               t.is_floating_point())


def stream_leg_a(core, mc, ops, sd, mc_data, src, card, counts):
    """(a) the class axis streamed from npz shards against in-memory, the
    same chunk programs over blocks staged on the card beforehand (the chunk
    loops without the host pipeline), and the stream replayed from CUDA
    graphs (``cuda_graph=True``); the five runs in the order p2, mem, p0,
    staged, graph, graph, staged, p0, mem, p2 (host time drifts within a
    call)."""
    (xtr, ytr), (xte, yte) = mc_data
    cfg = _mc_config(mc, "c")
    dev = torch.device("cuda")
    steps = MC_TRAIN // MC_BATCH
    perm = sd.epoch_permutation(src, sd.EpochKey(SEED, 0))
    table = cfg.table().to(dev)
    stage = core.bsgd._device_stage(dev, torch.int64)
    blocks = [b for _, b, _ in core.bsgd._assemble_chunks(
        src, sd.EpochKey(SEED, 0), batch_size=MC_BATCH, start_chunk=0, end=src.n_chunks,
        carry=None, stage=stage)]

    def staged():
        st = mc.init_multiclass_state(cfg, MC_DIM, device=dev)
        for b in blocks:
            st = mc.train_chunk_multiclass(cfg, table, st, *b)
        return st

    fits = {2: lambda: mc.fit_multiclass_stream(cfg, src, epochs=1, seed=SEED, prefetch=2),
            0: lambda: mc.fit_multiclass_stream(cfg, src, epochs=1, seed=SEED, prefetch=0),
            "mem": lambda: mc.train_epoch_multiclass(cfg, table, mc.init_multiclass_state(
                cfg, MC_DIM, device=dev), xtr, ytr, perm, device=dev),
            "staged": staged,
            "graph": lambda: mc.fit_multiclass_stream(cfg, src, epochs=1, seed=SEED, prefetch=2,
                                                      cuda_graph=True)}
    runs, secs = {}, {k: [] for k in fits}
    for kind in (2, "mem", 0, "staged", "graph", "graph", "staged", 0, "mem", 2):
        ops.reset_launch_counts()
        st, t, peak = _peak_bytes(fits[kind])
        launches = ops.launch_counts()
        secs[kind].append(t)
        runs.setdefault(kind, (st, peak))
        if kind in (0, 2, "graph"):
            _add(counts, launches)
            check(launches["train_step"] == steps, f"stream (a) {kind}: train_step "
                  f"launched {launches['train_step']} times in {steps} steps")
    us_step = {k: statistics.mean(v) / steps * 1e6 for k, v in secs.items()}
    runs = {k: (st, us_step[k], peak) for k, (st, peak) in runs.items()}
    mem, mem_us, mem_peak = runs["mem"]
    acc = float(mc.accuracy_multiclass(runs[2][0], xte, yte, MC_GAMMA))
    eq_mem = _states_equal(runs[2][0], mem)
    eq_pre = _states_equal(runs[2][0], runs[0][0])
    eq_staged = _states_equal(runs[2][0], runs["staged"][0])
    eq_graph = _states_equal(runs[2][0], runs["graph"][0])
    del blocks
    load_ms = []
    for cid in (0, src.n_chunks // 2, src.n_chunks - 1):
        t0 = time.perf_counter()
        src.load(cid)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"stream (a) {card}: fit_multiclass_stream over {src.n_chunks} npz chunks "
          f"({src.chunk_lens[0]} rows, last {src.chunk_lens[-1]}), {steps} steps, mean of two "
          f"runs each: prefetch=2 {runs[2][1]:.1f} us/step, prefetch=0 {runs[0][1]:.1f} us/step, "
          f"in-memory train_epoch_multiclass {mem_us:.1f} us/step, the chunk programs over "
          f"blocks staged beforehand {runs['staged'][1]:.1f} us/step, replayed from CUDA graphs "
          f"(prefetch=2) {runs['graph'][1]:.1f} us/step (as p2 p2 mem mem p0 p0 staged staged "
          f"graph graph: {[round(t / steps * 1e6, 1) for k in (2, 'mem', 0, 'staged', 'graph') for t in secs[k]]}"
          f"); chunk load (FileChunks.load) "
          f"{statistics.mean(load_ms):.1f} ms; test accuracy {acc:.4f}")
    print(f"stream (a) {card}: peak device bytes above the resting state: streamed "
          f"(prefetch=2) {runs[2][2]}, prefetch=0 {runs[0][2]}, in-memory {mem_peak} "
          f"(a chunk {src.chunk_lens[0] * MC_DIM * 4} bytes of rows, the set "
          f"{MC_TRAIN * MC_DIM * 4})")
    print(f"stream (a): bit-equal to in-memory on epoch_permutation {eq_mem}; prefetch=0 "
          f"bit-equal to prefetch=2 {eq_pre}; staged blocks bit-equal {eq_staged}; CUDA graphs "
          f"bit-equal {eq_graph}")
    check(eq_mem, "stream (a): the streamed epoch differs from the in-memory epoch")
    check(eq_graph, "stream (a): the stream replayed from CUDA graphs differs from the eager one")
    check(eq_pre, "stream (a): prefetch=0 differs from prefetch=2")
    check(eq_staged, "stream (a): the staged chunk programs differ from the stream")
    check(acc >= 0.80, f"stream (a): accuracy {acc} below the 0.80 sanity floor")

    # a profiled window of two chunks, from the streamed state
    box = [runs[2][0]]

    def two_chunks(_):
        st = core.bsgd._owned(box[0])
        box[0], _, _ = mc.train_epoch_multiclass_stream(cfg, table, st, src,
                                                        key=sd.EpochKey(SEED, 1), max_chunks=2,
                                                        prefetch=2)

    order = sd.chunk_order(sd.EpochKey(SEED, 1), src.n_chunks)
    n_steps = (src.chunk_lens[order[0]] + src.chunk_lens[order[1]]) // MC_BATCH
    _profile(two_chunks, 1, f"stream (a) two chunks, prefetch=2 ({card})",
             steps_per_call=n_steps)
    return runs[2][0], runs[2][1], mem_us


def stream_leg_b(mc, sd, src, want, ckpt_root, card, counts, ops):
    """(b) kill after 7 chunks, resume; then resume past a torn newest step."""
    from repro_torch import checkpoint
    cfg = _mc_config(mc, "c")
    ck = str(ckpt_root / "ck")
    fit = lambda **kw: mc.fit_multiclass_stream(cfg, src, epochs=1, seed=SEED, prefetch=2,
                                                ckpt_dir=ck, ckpt_every=3, **kw)
    _, secs1, l1 = _launched(ops, lambda: fit(max_chunks=7))
    steps_after_kill = checkpoint.all_steps(ck)
    resumed, secs2, l2 = _launched(ops, fit)
    _add(counts, l1)
    _add(counts, l2)
    eq = _states_equal(resumed, want)
    steps = checkpoint.all_steps(ck)
    newest = steps[-1]
    arrays = Path(ck) / f"step_{newest:08d}" / "arrays.npz"
    with open(arrays, "r+b") as f:
        f.truncate(arrays.stat().st_size // 2)
    walked = checkpoint.latest_verifiable_step(ck)
    again, secs3, l3 = _launched(ops, fit)
    _add(counts, l3)
    eq2 = _states_equal(again, want)
    print(f"stream (b) {card}: killed after 7 chunks (checkpoints {steps_after_kill}), resumed "
          f"bit-equal to (a) {eq} ({secs1:.3f} s + {secs2:.3f} s); newest step {newest} torn, "
          f"resume walked back to step {walked} and ended bit-equal {eq2} ({secs3:.3f} s)")
    check(steps_after_kill == [3, 6], f"stream (b): checkpoints {steps_after_kill} after the kill")
    check(eq, "stream (b): kill and resume differs from the uninterrupted run")
    check(walked == steps[-2], f"stream (b): walked back to {walked}, not {steps[-2]}")
    check(eq2, "stream (b): resume past a torn step differs from the uninterrupted run")


def stream_leg_c(core, mc, sd, src, want, card, counts, ops):
    """(c) faults: retries and a quarantine against skip_chunks; a NaN chunk
    under the finite guard."""
    cfg = _mc_config(mc, "c")
    rep = sd.ResilienceReport()
    faulty = sd.FaultyChunks(src, sd.FaultSchedule(seed=0, p_io=0.2, p_truncate=0.1,
                                                   fatal_chunks=(4,)))
    got, secs, l1 = _launched(ops, lambda: mc.fit_multiclass_stream(
        cfg, faulty, epochs=1, seed=SEED, prefetch=2, retry=sd.RetryPolicy(base_delay_s=0.0),
        report=rep))
    clean, _, l2 = _launched(ops, lambda: mc.fit_multiclass_stream(
        cfg, src, epochs=1, seed=SEED, prefetch=2, skip_chunks=(4,)))
    _add(counts, l1)
    _add(counts, l2)
    eq = _states_equal(got, clean)
    print(f"stream (c) {card}: faulty source {rep!r}, quarantined {rep.quarantined_chunks()}; "
          f"bit-equal to the clean run with skip_chunks=(4,) {eq} ({secs:.3f} s)")
    check(eq, "stream (c): the faulty run differs from the clean run over the same chunks")
    check(rep.quarantined_chunks() == [4], f"stream (c): quarantined {rep.quarantined_chunks()}")
    check(rep.retries > 0, "stream (c): no retry happened")

    rep = sd.ResilienceReport()
    nan_src = sd.FaultyChunks(src, sd.FaultSchedule(nan_chunks=(2,)))
    guarded, secs, l3 = _launched(ops, lambda: mc.fit_multiclass_stream(
        cfg, nan_src, epochs=1, seed=SEED, prefetch=2, guard_finite=True, report=rep))
    _add(counts, l3)
    # the stream positions whose minibatches hold a NaN/Inf row: chunk 2's,
    # and the next chunk's where a poisoned row lands in the carried rows
    pos = int(np.nonzero(sd.chunk_order(sd.EpochKey(SEED, 0), src.n_chunks) == 2)[0][0])
    poisoned = [p for p, block, _ in core.bsgd._assemble_chunks(
        nan_src, sd.EpochKey(SEED, 0), batch_size=MC_BATCH, start_chunk=0, end=src.n_chunks,
        carry=None) if block is not None and not np.isfinite(block.x).all()]
    # what the plain version decides on the same rows: the guarded stream
    # with impl="ref" on the same card, through the last poisoned position
    # (no later position holds a NaN/Inf row)
    plain_rep = sd.ResilienceReport()
    _, plain_secs = _timed(lambda: mc.fit_multiclass_stream(
        cfg, nan_src, epochs=1, seed=SEED, guard_finite=True, report=plain_rep, impl="ref",
        max_chunks=max(poisoned) + 1))
    print(f"stream (c) {card}: NaN/Inf rows in chunk 2 (stream position {pos}; minibatches with a "
          f"NaN/Inf row at positions {poisoned}) under guard_finite: rollbacks {rep.rollbacks}, "
          f"the plain version's (impl='ref', positions 0 to {max(poisoned)}, {plain_secs:.3f} s) "
          f"{plain_rep.rollbacks}; every float leaf finite {_finite(guarded)} ({secs:.3f} s)")
    check(rep.rollbacks == plain_rep.rollbacks,
          f"stream (c): rollbacks {rep.rollbacks}, the plain version's {plain_rep.rollbacks}")
    check(_finite(guarded), "stream (c): a float leaf is not finite after the guarded run")

    # the guard's cost a chunk: one clone of every leaf and one scalar read
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        snap = core.bsgd._owned(want)
        core.bsgd._all_finite(snap)
    secs = (time.perf_counter() - t0) / reps
    n_bytes = sum(t.numel() * t.element_size() for t in want if t is not None)
    print(f"stream (c) {card}: guard cost a chunk {secs * 1e6:.1f} us (clone of {n_bytes} bytes "
          f"and one all-finite read), against a chunk of {STREAM_CHUNK_ROWS // MC_BATCH} steps")


def stream_leg_d(core, ops, sd, data, tmp, card, counts):
    """(d) the binary paper path streamed; the fused binary epoch; LibsvmChunks."""
    (xtr, ytr), (xte, yte) = data
    dev = torch.device("cuda")
    src = sd.ArrayChunks(xtr, ytr, BINARY_CHUNK_ROWS)
    perm = sd.epoch_permutation(src, sd.EpochKey(SEED, 0))
    cfg = core.BSGDConfig(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1)
    n = BINARY_MAX_CHUNKS * BINARY_CHUNK_ROWS
    print(f"CUT: stream (d) composed lookup-wd streams {BINARY_MAX_CHUNKS} of {src.n_chunks} "
          f"chunks ({n} of {xtr.shape[0]} steps)")
    st, secs, launches = _launched(ops, lambda: core.fit_stream(
        cfg, src, epochs=1, seed=SEED, max_chunks=BINARY_MAX_CHUNKS, prefetch=2))
    _add(counts, launches)
    table = cfg.table().to(dev)
    mem, mem_secs = _timed(lambda: core.train_epoch(cfg, table, core.init_state(cfg, DIM),
                                                    xtr, ytr, perm[:n]))
    eq = _states_equal(st, mem)
    print(f"stream (d) {card}: composed lookup-wd, {n} steps streamed {secs / n * 1e6:.1f} "
          f"us/step, in-memory {mem_secs / n * 1e6:.1f} us/step; bit-equal {eq}; count "
          f"{int(st.count)} n_merges {int(st.n_merges)}; launches {json.dumps(launches)}")
    check(eq, "stream (d): the composed stream differs from train_epoch on the same order")
    check(launches["merge_pick"] == n and launches["rbf_matrix"] > 0,
          f"stream (d): merge_pick {launches['merge_pick']} in {n} steps")

    fcfg = core.BSGDConfig(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1,
                           use_kernel_cache=True, step_engine="pallas")
    steps = xtr.shape[0]
    fst, fsecs, flaunch = _launched(ops, lambda: core.fit_stream(fcfg, src, epochs=1, seed=SEED,
                                                                 prefetch=2))
    _add(counts, flaunch)
    ftable = fcfg.table().to(dev)
    fmem, fmem_secs = _timed(lambda: core.train_epoch(fcfg, ftable, core.init_state(fcfg, DIM),
                                                      xtr, ytr, perm))
    feq = _states_equal(fst, fmem)
    acc = float(core.accuracy(fst, xte, yte, fcfg.gamma))
    print(f"stream (d) {card}: binary fused step, whole epoch ({steps} steps) streamed "
          f"{fsecs / steps * 1e6:.1f} us/step, in-memory {fmem_secs / steps * 1e6:.1f} us/step; "
          f"bit-equal {feq}; accuracy {acc:.4f}")
    check(feq, "stream (d): the fused binary stream differs from its in-memory twin")
    check(flaunch["train_step"] == steps, f"stream (d): train_step {flaunch['train_step']}")

    path = str(tmp / "adult.libsvm")
    t0 = time.perf_counter()
    sd.dump_libsvm(path, xtr[:LIBSVM_ROWS], ytr[:LIBSVM_ROWS])
    dump_s = time.perf_counter() - t0
    lsrc = sd.LibsvmChunks(path, BINARY_CHUNK_ROWS, DIM)
    t0 = time.perf_counter()
    xp, yp = zip(*[lsrc.load(i) for i in range(lsrc.n_chunks)])
    parse_ms = (time.perf_counter() - t0) / lsrc.n_chunks * 1e3
    arr = sd.ArrayChunks(np.concatenate(xp), np.concatenate(yp), BINARY_CHUNK_ROWS)
    lst, _, l1 = _launched(ops, lambda: core.fit_stream(fcfg, lsrc, epochs=1, seed=SEED,
                                                        prefetch=2))
    ast, _, l2 = _launched(ops, lambda: core.fit_stream(fcfg, arr, epochs=1, seed=SEED))
    _add(counts, l1)
    _add(counts, l2)
    leq = _states_equal(lst, ast)
    print(f"stream (d) {card}: LibsvmChunks of {LIBSVM_ROWS} rows ({lsrc.n_chunks} chunks, dump "
          f"{dump_s:.3f} s): parse {parse_ms:.1f} ms a chunk; bit-equal to the ArrayChunks "
          f"stream of the same rows {leq}")
    check(leq, "stream (d): the LibsvmChunks stream differs from ArrayChunks")
    return fsecs / steps * 1e6, fmem_secs / steps * 1e6


def stream_leg_e(core, ops, sd, data, card, counts):
    """(e) prequential on the drifted ADULT stand-in, twice."""
    (xtr, ytr), _ = data
    cfg = core.BSGDConfig(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1,
                          use_kernel_cache=True, step_engine="pallas")
    base = sd.ArrayChunks(xtr, ytr, BINARY_CHUNK_ROWS)
    flip = sd.label_flip_schedule(base.n_chunks, start=0.5)
    passes = []
    for _ in range(2):
        r, secs, launches = _launched(ops, lambda: core.prequential_stream(
            cfg, sd.DriftChunks(base, flip=flip, seed=SEED)))
        _add(counts, launches)
        passes.append((r, secs, launches))
    a, b = passes[0][0], passes[1][0]
    same = (a["mistakes"] == b["mistakes"] and a["chunk_acc"] == b["chunk_acc"]
            and _states_equal(a["state"], b["state"]))
    mid = int(0.5 * base.n_chunks)
    pre, post = np.mean(a["chunk_acc"][1:mid]), np.mean(a["chunk_acc"][mid:])
    print(f"stream (e) {card}: prequential over {base.n_chunks} chunks, label flip from chunk "
          f"{mid}: mistake rate {a['mistake_rate']}, mean chunk accuracy before {pre:.4f} after "
          f"{post:.4f}; {passes[0][1]:.3f} s a pass; two passes identical {same}; launches "
          f"{json.dumps(passes[0][2])}")
    check(same, "stream (e): two prequential passes differ")
    check(post < pre, "stream (e): accuracy after the drift point is not below before")
    check(passes[0][2]["train_step"] > 0 and passes[0][2]["rbf_matrix"] > 0,
          "stream (e): train_step or rbf_matrix never launched")


def stream_leg_f(mc, ops, sd, card, counts):
    """(f) serve_svm_live at MNIST width: the live trainer's chunk programs
    replayed from CUDA graphs against the eager ones, the arm with its trace
    submitted at once, then the chaos drill."""
    from repro_torch.launch.serve import live_problem, serve_svm_live
    shape = dict(n_classes=MC_CLASSES, dim=MC_DIM, budget=MC_BUDGET, gamma=MC_GAMMA,
                 chunk_rows=STREAM_CHUNK_ROWS, seed=SEED)
    live = dict(epochs=1, publish_every=LIVE_PUBLISH_EVERY, verbose=False, **shape)

    cfg, source = live_problem(train_rows=LIVE_EQ_CHUNKS * STREAM_CHUNK_ROWS, **shape)
    eager, esecs, el = _launched(ops, lambda: mc.fit_multiclass_stream(
        cfg, source, epochs=1, seed=SEED, prefetch=2))
    graphed, gsecs, gl = _launched(ops, lambda: mc.fit_multiclass_stream(
        cfg, source, epochs=1, seed=SEED, prefetch=2, cuda_graph=True))
    _add(counts, el)
    _add(counts, gl)
    eq = _states_equal(eager, graphed)
    print(f"stream (f) {card}: the live trainer over {LIVE_EQ_CHUNKS} chunks: eager {esecs:.3f} "
          f"s, CUDA graphs {gsecs:.3f} s (captures included); bit-equal {eq}; launches equal "
          f"{el == gl} ({json.dumps(gl)})")
    check(eq, "stream (f): the live trainer's CUDA-graph chunk programs differ from the eager ones")
    check(el == gl, f"stream (f): launches eager {el}, CUDA graphs {gl}")

    res, secs, launches = _launched(ops, lambda: serve_svm_live(
        train_rows=LIVE_TRAIN_ROWS, rows=LIVE_ROWS, **live))
    _add(counts, launches)
    print(f"stream (f) {card}: serve_svm_live, {LIVE_TRAIN_ROWS} training rows, {res['rows']} "
          f"request rows submitted at once, whole run {secs:.3f} s: versions served "
          f"{res.get('versions')} ({res['published_during_trace']} published during the trace, "
          f"final v{res['final_version']}), {res['rows_per_s']} rows/s, p50 {res['p50_ms']} ms "
          f"p99 {res['p99_ms']} ms, pad waste {res['pad_waste_frac']}; final snapshot finite, "
          f"queue == direct on {res['final_check_rows']} rows; launches {json.dumps(launches)}")
    check(len(res.get("versions", {})) > 1,
          f"stream (f): one version served: {res.get('versions')}")
    for k in ("rbf_matrix", "merge_pick", "class_scores"):
        check(launches[k] > 0, f"stream (f): {k} never launched")

    print(f"CUT: stream (f) chaos drill trains {LIVE_DRILL_TRAIN_ROWS} rows and serves "
          f"{LIVE_DRILL_ROWS}")
    faults = sd.FaultSchedule.chaos(SEED, nan_chunk=2, crash_chunk=3, fatal_chunk=5)
    drill, secs, launches = _launched(ops, lambda: serve_svm_live(
        train_rows=LIVE_DRILL_TRAIN_ROWS, rows=LIVE_DRILL_ROWS, faults=faults, **live))
    _add(counts, launches)
    print(f"stream (f) {card}: chaos drill in {secs:.3f} s: restarts {drill['restarts']}, retries "
          f"{drill['retries']}, quarantined {drill['quarantined']}, rollbacks "
          f"{drill['rollbacks']}; versions served {drill.get('versions')} (final "
          f"v{drill['final_version']}), {drill['rows']} rows, {drill['rows_per_s']} rows/s")
    check(drill["restarts"] >= 1, "stream (f): the drill's trainer never restarted")
    check(drill["rows"] == LIVE_DRILL_ROWS, "stream (f): the drill did not serve every row")
    check(5 in drill["quarantined"], f"stream (f): quarantined {drill['quarantined']}")


def phase_stream(core, mc, ops, data, mc_data, card):
    """Phase 16: streaming at full width; returns its launches by kernel."""
    import tempfile
    from repro_torch import data as sd
    from repro_torch.kernels import _build
    counts = {}
    (xtr, ytr), _ = mc_data
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        paths = sd.write_npz_chunks(str(tmp / "mnist"), xtr, ytr, STREAM_CHUNK_ROWS)
        size = sum(Path(p).stat().st_size for p in paths)
        print(f"stream {card}: wrote {len(paths)} npz chunks, {size} bytes, in "
              f"{time.perf_counter() - t0:.3f} s")
        src = sd.FileChunks(paths)
        want, mc_us, mc_mem_us = stream_leg_a(core, mc, ops, sd, mc_data, src, card, counts)
        stream_leg_b(mc, sd, src, want, tmp, card, counts, ops)
        stream_leg_c(core, mc, sd, src, want, card, counts, ops)
        b_us, b_mem_us = stream_leg_d(core, ops, sd, data, tmp, card, counts)
        stream_leg_e(core, ops, sd, data, card, counts)
    stream_leg_f(mc, ops, sd, card, counts)
    print(f"stream {card}: streamed against in-memory us/step: class axis run (c) {mc_us:.1f} "
          f"vs {mc_mem_us:.1f}, binary fused {b_us:.1f} vs {b_mem_us:.1f}")
    print(f"stream runs' launches: {json.dumps(counts)}")
    return counts


# ---------------------------------------------------------------------------
# Phase 17: the second solver (BDCA dual coordinate ascent)
# ---------------------------------------------------------------------------

BDCA_ROUNDS = 2
BDCA_PROFILE_STEPS = {"b": 300, "c": 40}
# bdca's accuracy floors, (b) binary and (c) over 10 classes: well above
# chance (0.5, 0.1).  At these configurations (lambda 1e-5, the box clamped
# by box_from_lambda) every row violates the margin and BDCA stays below the
# bsgd runs' 0.80 floor in the reference too: on 1,000 rows of the ADULT
# stand-in the port and the reference reach the same accuracy, well below
# the reference's bsgd (tests/test_torch_bdca.py
# test_adult_standin_accuracy_equals_reference).  Each run prints its gap to
# the bsgd run.
BDCA_ACC_FLOOR = {"b": 0.60, "c": 0.50}
BDCA_LOCKSTEP_STEPS = 600        # cut from 1,000 for phases 18 and 19 (a CUT: line);
                                 # its first merge event comes near step 500
# (b)'s steps: cut from the whole epoch (26,049) for phases 18 to 21 (a CUT:
# line); on the card its accuracy is 0.7024 at 13,025 steps against 0.6594 at
# the end; the port's CPU path reaches 0.6956 at 8,192 (0.6660 at 6,144)
BDCA_BINARY_STEPS = 8_192
BDCA_ROW_GAP = 0.1        # (d): SV rows further apart than this hold other points
BDCA_STREAM_ROWS = 2 * STREAM_CHUNK_ROWS     # (e): two chunks of run (c)'s rows


def _bdca_state(gen, c, s, counts, dev, C, case="random"):
    """A working set per class: a symmetric unit-diagonal RBF Gram matrix of
    random points (exactly symmetric: I2), signed coefficients inside the box
    below each count and garbage past it (the kernel must zero it).
    ``case="ragged"`` also freezes every fifth slot (alpha = 0) and puts
    every seventh at the box (+-C)."""
    x = torch.randn(c, s, 8, generator=gen)
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    k = torch.exp(-0.3 * d2)
    k[:, torch.arange(s), torch.arange(s)] = 1.0
    a = torch.rand(c, s, generator=gen) * C * torch.where(torch.rand(c, s, generator=gen) < 0.5,
                                                         -1.0, 1.0)
    if case == "ragged":
        a[:, ::5] = 0.0
        a[:, 3::7] = C * torch.sign(a[:, 3::7] + 0.5)
    n = torch.tensor(counts, dtype=torch.int32)
    return a.to(dev), k.to(dev), n.to(dev)


# SASS opcodes with no destination, and those with two (a predicate first)
_SASS_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "BSYNC", "BSSY", "EXIT", "NOP",
                 "WARPSYNC", "CALL", "RET", "MEMBAR", "DEPBAR", "YIELD", "JMP", "BREAK")
_SASS_TWO_DESTS = ("FSETP", "ISETP", "DSETP", "HSETP2", "SHFL")


def _sass_chain_link(sass: str, function: str):
    """The dependent instructions of one link of the chain in ``function``'s
    SASS (``cuobjdump -sass``): from one ``SHFL`` of the unrolled chain (a
    delta handed out) along register dependences to the value the next
    ``SHFL`` hands out, the longest such path by instruction count.  Returns
    the opcodes in path order, the first being the ``SHFL``: the path most
    consecutive shuffle pairs share (the unrolled chain's), or None if no
    shuffle feeds the next."""
    import re

    body = next((part for part in sass.split("Function : ")[1:]
                 if function in part.split("\n", 1)[0]), None)
    if body is None:
        return None
    instrs = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        text = m.group(1)
        guard = re.match(r"@!?(U?P\d+)\s+", text)
        if guard:
            text = text[guard.end():]
        op, _, rest = text.partition(" ")
        regs = [re.findall(r"(?<![\w.])(U?R\d+|U?P\d+)", o) for o in rest.split(",")]
        base = op.split(".")[0]
        n_dest = 0 if base in _SASS_NO_DEST else 2 if base in _SASS_TWO_DESTS else 1
        dests = [r for o in regs[:n_dest] for r in o]
        srcs = [r for o in regs[n_dest:] for r in o] + ([guard.group(1)] if guard else [])
        instrs.append((op, dests, srcs))
    shfl = [i for i, (op, _, _) in enumerate(instrs) if op.startswith("SHFL")]
    paths = []
    for a, b in zip(shfl, shfl[1:]):      # consecutive shuffles: a link where one feeds the next
        path = {r: [instrs[a][0]] for r in instrs[a][1]}
        for op, dests, srcs in instrs[a + 1:b]:
            came = [path[r] for r in srcs if r in path]
            for r in dests:
                if came:
                    path[r] = max(came, key=len) + [op]
                else:
                    path.pop(r, None)
        value = instrs[b][2][0] if instrs[b][2] else None
        if value in path:
            paths.append(tuple(path[value]))
    if not paths:
        return None
    return list(max(set(paths), key=paths.count))    # the unrolled chain's link, the most common


def _bdca_chain_floor(_build, counts, rounds):
    """The chain's floor at one shape: the dependent instructions of a link
    read from the kernel's SASS, the latencies of an fp32 add, a shuffle and
    the clip's max.NaN measured on this card (``latency_probe_cuda``,
    clock64 cycles; any other instruction counted as an add), and the
    longest chain of coordinates (max count x rounds) at the card's
    ``clocks.max.sm``.  Returns a line for the log."""
    from repro_torch.kernels import bdca as bdca_kernel

    add, shfl, clip = bdca_kernel.latency_probe_cuda()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    try:
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("bdca_ascent"))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True, timeout=60).stdout.split(",")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"chain floor not measured ({exc})"
    link = _sass_chain_link(sass, "bdca_ascent_staged")
    if link is None:
        return "chain floor not measured (no chain link found in the SASS)"
    n_shfl = sum(op.startswith("SHFL") for op in link)
    n_clip = sum(op.startswith("FMNMX") for op in link)
    n_add = len(link) - n_shfl - n_clip
    cycles = n_shfl * shfl + n_clip * clip + n_add * add
    max_mhz, now_mhz = float(clock[0]), float(clock[1])
    coords = max(counts) * rounds
    floor_us = coords * cycles / max_mhz
    return (f"chain floor {floor_us:.2f} us = {coords} coordinates x {cycles:.1f} "
                   f"cycles a link at {max_mhz:.0f} MHz (clocks.max.sm; clocks.sm {now_mhz:.0f} "
                   f"MHz now): SASS link {' > '.join(link)} ({n_shfl} shuffle at {shfl:.2f} "
                   f"cycles, {n_clip} max/min.NaN at {clip:.2f}, {n_add} other fp32 at "
                   f"{add:.2f}: clock64 on this card)")


def phase_bdca_kernel(ops, ref, _build, card):
    """(a) bdca_ascent against its plain version, bit for bit, at the binary
    shape (C = 1, S = 501), the class shape (C = 10, S = 508), both also at
    0 rounds (only f = b @ k and the write-back), ragged ones (C = 3, S =
    37: classes below their count, frozen slots, slots at the box, rounds 1
    and 4), the chain's block edges (C = 4, S = 70, counts 31, 32, 33 and
    65, ragged, rounds 1 and 3; C = 2, counts 1 and 0) and at S = 1,100.
    At the binary and class shapes it also splits the launch (the initial
    pass from rounds 0, the sweep's ns a coordinate from rounds 2 less 0),
    times the chain warp alone (``chain_probe_cuda``) and gives the chain
    floor from the SASS beside the bytes bound.  Returns the binary shape's
    record."""
    from repro_torch.kernels import bdca as bdca_kernel

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 17)
    C = 3.8389
    class_counts = [500 + q % 9 for q in range(10)]
    edges = [31, 32, 33, 65]
    cases = [("binary", 1, 501, [501], BDCA_ROUNDS, "random"),
             ("class", 10, 508, class_counts, BDCA_ROUNDS, "random"),
             ("ragged r1", 3, 37, [37, 20, 0], 1, "ragged"),
             ("ragged r4", 3, 37, [36, 1, 2], 4, "ragged"),
             ("block edges r1", 4, 70, edges, 1, "ragged"),
             ("block edges r3", 4, 70, edges, 3, "ragged"),
             ("counts 1 and 0", 2, 70, [1, 0], BDCA_ROUNDS, "ragged"),
             ("two columns a thread", 2, 1100, [1100, 640], 1, "random")]
    record = None
    for label, c, s, counts, rounds, case in cases:
        a0, k, n = _bdca_state(gen, c, s, counts, dev, C, case)
        if c == 1:
            a0, k, n = a0[0], k[0], n.reshape(())
        timed, split = label in ("binary", "class"), {}
        for r in ((0, rounds) if timed else (rounds,)):
            got = ops.bdca_ascent(a0.clone(), k, n, C, r, impl="cuda")
            want = ref.bdca_ascent(a0.clone(), k, n, C, r)
            err = (got - want).abs().max().item()
            equal = torch.equal(got, want)
            box = bool((got.abs() <= float(np.float32(C))).all())
            stale = bool((got.reshape(c, s)[torch.arange(s, device=dev)[None, :]
                                            >= n.reshape(c, 1)] == 0).all())
            a = a0.clone()

            def call():
                a.copy_(a0)
                ops.bdca_ascent(a, k, n, C, r, impl="cuda")

            k_ms = time_call(call)
            d_ms = device_ms(call, "bdca_ascent")
            p_ms = time_call(lambda: ref.bdca_ascent(a0.clone(), k, n, C, r), calls=1,
                             repeats=3, warmup=1)
            b_ms, b_by = bound_ms(kernel_work.bdca_ascent_work(c, s, counts, r))
            chain = max(counts) * r
            per = ("not measured" if d_ms is None or chain == 0
                   else f"{d_ms * 1e6 / chain:.1f} ns")
            print(f"bdca_ascent {label} C={c} S={s} counts {counts[:4]}"
                  f"{'...' if c > 4 else ''} rounds {r} ({card}): max_abs_err {err:.3e} (tol 0, "
                  f"bit for bit) equal {equal}; box holds {box}; stale slots zero {stale}; "
                  f"kernel {k_ms * 1e3:.2f} us a call (with a {c * s * 4}-byte copy of alpha), "
                  f"device {us(d_ms)} a launch ({per} a coordinate of the chain), plain "
                  f"{p_ms * 1e3:.2f} us; bound {b_ms * 1e3:.4f} us ({b_by}: the active blocks "
                  f"read once); serial chain {chain} coordinates ({max(counts)} x {r} rounds)")
            check(equal and err == 0.0, f"bdca_ascent {label} rounds {r}: differs from its "
                                        f"plain version")
            check(box and stale, f"bdca_ascent {label} rounds {r}: box or stale slots")
            if timed:
                split[r] = d_ms
            if label == "binary" and r == rounds:
                record = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None, device_ms=d_ms)
        if timed:
            chain = max(counts) * rounds
            sweep = ("not measured" if None in split.values()
                     else f"{(split[rounds] - split[0]) * 1e6 / chain:.1f} ns")
            cycles = bdca_kernel.chain_probe_cuda(a0.clone(), k, n, C, rounds)
            p_ms = device_ms(lambda: bdca_kernel.chain_probe_cuda(a0.clone(), k, n, C, rounds),
                             "bdca_chain_probe")
            per_coord = cycles[0].max().item() / chain
            in_loop = cycles[1].max().item() / chain
            floor = _bdca_chain_floor(_build, counts, rounds)
            print(f"bdca_ascent {label} split ({card}): initial pass f = b @ k and write-back "
                  f"{us(split[0])} a launch (rounds 0); the sweep {sweep} a coordinate "
                  f"(rounds {rounds} less 0, {chain} coordinates); the chain warp alone "
                  f"(no bulk) {us(p_ms)} a launch, {per_coord:.1f} clock64 cycles a coordinate, "
                  f"{in_loop:.1f} of them in the chain loop (the rest gathers and copies); "
                  f"{floor}; beside the bound {b_ms * 1e3:.4f} us ({b_by})")
    return record


def _bdca_binary_cfg(core, n_train: int):
    """Phase 4's ADULT configuration (lookup-wd, batch 1) with the cache under
    the dual solver, its box from ``box_from_lambda`` at the training size."""
    return core.BSGDConfig(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=1,
                           method="lookup-wd", use_kernel_cache=True, solver="bdca",
                           bdca_C=core.box_from_lambda(n_train, 1e-5), bdca_rounds=BDCA_ROUNDS)


def phase_bdca_binary(core, ops, data, fused_acc: float, card):
    """(b) BDCA_BINARY_STEPS bdca steps of the ADULT stand-in in ``fit``'s
    order, the launch counters set to 0 just before and read just after."""
    (xtr, ytr), (xte, yte) = data
    cfg = _bdca_binary_cfg(core, xtr.shape[0])
    print(f"CUT: bdca (b) trains {BDCA_BINARY_STEPS} of the epoch's {xtr.shape[0]} steps")
    # fit's order (a torch.Generator seeded with SEED), cut
    order = torch.randperm(xtr.shape[0], generator=torch.Generator().manual_seed(SEED))
    st0 = core.init_state(cfg, xtr.shape[1])
    st, secs, launches = _launched(ops, lambda: core.train_epoch(
        cfg, cfg.table(), st0, xtr, ytr, order[:BDCA_BINARY_STEPS]))
    acc = float(core.accuracy(st, xte, yte, cfg.gamma))
    steps = int(st.step) - 1
    run = dict(count=int(st.count), n_inserts=int(st.n_inserts), n_merges=int(st.n_merges),
               accuracy=acc, seconds=secs, us_per_step=secs / steps * 1e6, steps=steps,
               launches=launches)
    gap = acc - fused_acc
    print(f"bdca (b) {card}: fit solver=bdca, bdca_C {cfg.bdca_C:.4f} (box_from_lambda("
          f"{xtr.shape[0]}, 1e-5)), bdca_rounds {cfg.bdca_rounds}: {json.dumps(run)}")
    print(f"bdca (b): accuracy {acc:.4f} against the binary fused bsgd run's {fused_acc:.4f} "
          f"(the same configuration under bsgd): gap {gap:+.4f} (reported, not gated); at or "
          f"above the bsgd runs' 0.80 floor {acc >= 0.80}; floor {BDCA_ACC_FLOOR['b']}")
    check(st.sv_x.is_cuda and st.kmat.is_cuda, "bdca (b): the state lives on the card")
    check(run["count"] <= BUDGET and run["n_merges"] > 0, "bdca (b): count or merges")
    check(launches["bdca_ascent"] == steps, f"bdca (b): bdca_ascent launched "
          f"{launches['bdca_ascent']} times in {steps} steps")
    check(launches["merge_pick"] == steps, f"bdca (b): merge_pick launched "
          f"{launches['merge_pick']} times in {steps} steps")
    check(acc >= BDCA_ACC_FLOOR["b"], f"bdca (b): accuracy {acc} below {BDCA_ACC_FLOOR['b']}")
    return run, st, cfg


def phase_bdca_class(mc, core, ops, kernel_cache, mc_data, run_a_acc: float, card):
    """(c) run (a)'s class-axis configuration under the dual solver, one
    epoch, the launch counters set to 0 just before it and read just after."""
    (xtr, ytr), (xte, yte) = mc_data
    dev = torch.device("cuda")
    cfg = _bdca_mc_config(mc, core)
    steps = MC_TRAIN // MC_BATCH
    table = cfg.table().to(dev)
    x, y = torch.as_tensor(xtr, device=dev), torch.as_tensor(ytr, device=dev)
    st, secs, launches = _launched(ops, lambda: mc.train_epoch_multiclass(
        cfg, table, mc.init_multiclass_state(cfg, MC_DIM, device=dev), x, y, _mc_order(steps),
        device=dev))
    acc = float(mc.accuracy_multiclass(st, xte, yte, MC_GAMMA))
    res = dict(steps=steps, seconds=secs, us_per_step=secs / steps * 1e6, accuracy=acc,
               count=st.count.tolist(), n_merges=st.n_merges.tolist(),
               n_inserts=st.n_inserts.tolist(), launches=launches)
    print(f"bdca (c) {card}: class axis, solver=bdca, bdca_C {cfg.binary.bdca_C:.4f} "
          f"(box_from_lambda({MC_TRAIN}, 1e-5)), maintenance_engine=pallas: {json.dumps(res)}")
    print(f"bdca (c): accuracy {acc:.4f} against run (a)'s {run_a_acc:.4f}: gap "
          f"{acc - run_a_acc:+.4f} (reported, not gated); at or above the class-axis runs' "
          f"0.80 floor {acc >= 0.80}; floor {BDCA_ACC_FLOOR['c']}")
    check(max(res["count"]) <= MC_BUDGET and min(res["n_merges"]) > 0, "bdca (c): counts")
    for name in ("bdca_ascent", "merge_event_rounds"):
        check(launches[name] == steps, f"bdca (c): {name} launched {launches[name]} times in "
              f"{steps} steps")
    check(acc >= BDCA_ACC_FLOOR["c"], f"bdca (c): accuracy {acc} below {BDCA_ACC_FLOOR['c']}")
    worst = kernel_cache.invariant_errors(st.kmat, st.sv_x, st.count, MC_GAMMA)
    print(f"bdca (c) end of epoch: worst I1 error per class {[float(f'{e:.3e}') for e in worst]}")
    return res, st


def phase_bdca_class_profile(mc, core, st, mc_data):
    """A profiled window of (c)'s steps from its trained state."""
    (xtr, ytr), _ = mc_data
    cfg = _bdca_mc_config(mc, core)
    n = BDCA_PROFILE_STEPS["c"] * MC_BATCH
    xs, ys = torch.as_tensor(xtr[:n]).cuda(), torch.as_tensor(ytr[:n]).long().cuda()
    table = cfg.table().to("cuda")
    box = [st]

    def step(i):
        sl = slice(i * MC_BATCH, (i + 1) * MC_BATCH)
        box[0] = mc.train_step_multiclass(cfg, table, box[0], xs[sl], ys[sl])

    _profile(step, BDCA_PROFILE_STEPS["c"], "bdca (c), class axis")


def _bdca_mc_config(mc, core):
    base = _mc_config(mc, "a").binary
    return mc.MulticlassSVMConfig(n_classes=MC_CLASSES, binary=dataclasses.replace(
        base, solver="bdca", bdca_C=core.box_from_lambda(MC_TRAIN, 1e-5),
        bdca_rounds=BDCA_ROUNDS))


def _bdca_near_tie(ops, cfg, tabs, prev, xs, ys):
    """Why the card and CPU bdca steps part, from the states before the step:
    a minibatch row whose margin lies on either side of 1 on the two devices;
    an event round whose decisions differ where the two smallest |alpha| or
    the two smallest WD scores tie to 1e-5, or where a coordinate sits at 0
    (frozen) on one device and within 1e-4 of it on the other (clipped at
    0 on one only).  Returns ``(explained, text)``."""
    from repro_torch.core import bdca
    from repro_torch.kernels import ref

    margins, rounds, mids = {}, {}, {}
    for key, st in prev.items():
        dev = st.alpha.device
        k_b = ops.rbf_matrix(xs[key], st.sv_x, cfg.gamma)
        act = torch.arange(st.alpha.shape[0], device=dev) < st.count
        margins[key] = (ys[key] * (k_b @ torch.where(act, st.alpha, 0.0))).cpu()
        mid = bdca.insert_from_rows(cfg, st, xs[key], ys[key], k_b,
                                    ops.rbf_matrix(xs[key], xs[key], cfg.gamma))
        mids[key] = mid.alpha.cpu()
        sv, al, km = (t[None].clone() for t in (mid.sv_x, mid.alpha, mid.kmat))
        count = mid.count.reshape(1).clone()
        rounds[key] = []
        for _ in range(cfg.batch_size):
            over = count > cfg.budget
            snap = (al[0].cpu(), km[0].cpu(), int(count[0]))
            dec = torch.full((1, 3), -1, dtype=torch.int32, device=dev)
            ops.merge_event(sv, al, km, count, over, tabs[key], decisions=dec)
            rounds[key].append((dec[0].cpu(), snap))
            count = count - over.to(count.dtype)
    m_c, m_p = margins["cuda"], margins["cpu"]
    split = torch.nonzero((m_c < 1) != (m_p < 1)).flatten()
    if split.numel():
        r = int(split[0])
        gap = abs(float(m_c[r]) - float(m_p[r]))
        return gap < 1e-3, (f"margin near-tie: batch row {r} margin card {float(m_c[r])!r} "
                            f"cpu {float(m_p[r])!r}")
    for k, ((d_c, snap), (d_p, snap_p)) in enumerate(zip(rounds["cuda"], rounds["cpu"])):
        if torch.equal(d_c, d_p):
            continue
        al, km, cnt = snap
        al_p = snap_p[0]
        live = torch.arange(al.shape[0]) < cnt
        frozen = live & ((al == 0) != (al_p == 0))
        if frozen.any():
            q = int(torch.nonzero(frozen)[0])
            near = max(abs(float(al[q])), abs(float(al_p[q])))
            return near < 1e-4, (f"clip near-tie: round {k}, slot {q} frozen on one device only "
                                 f"(card {float(al[q])!r}, cpu {float(al_p[q])!r}); decisions "
                                 f"card {d_c.tolist()} cpu {d_p.tolist()}")
        a_abs = torch.where(live, al.abs(), torch.inf)
        a2 = torch.sort(a_abs).values[:2]
        i_min = int(torch.argmin(a_abs))
        m, kap = ref.merge_coords(al[i_min], al, km[i_min])
        valid = live & (al * al[i_min] > 0) & (torch.arange(al.shape[0]) != i_min)
        wd = torch.where(valid, (al[i_min] + al) ** 2 * ref.bilinear_lookup(tabs["cpu"].wd_table, m, kap),
                         torch.inf)
        w2 = torch.sort(wd).values[:2]
        tie = bool(a2[1] - a2[0] <= 1e-5 * a2[0]) or bool(w2[1] - w2[0] <= 1e-5 * w2[0])
        return tie, (f"event near-tie: round {k} decisions card {d_c.tolist()} cpu "
                     f"{d_p.tolist()}; two smallest |alpha| {a2.tolist()}, WD {w2.tolist()}")
    at_box = ((mids["cuda"].abs() == np.float32(cfg.bdca_C))
              != (mids["cpu"].abs() == np.float32(cfg.bdca_C))).nonzero().flatten().tolist()
    return False, (f"no margin or event decision differs (slots at the box on one device only "
                   f"after the ascent: {at_box[:8]})")


def phase_bdca_lockstep(core, ops, data, card):
    """(d) the first BDCA_LOCKSTEP_STEPS steps of (b) on the card and on the
    CPU (plain versions) in lockstep: count, n_inserts and n_merges compared
    every step, and the SV rows: a merge with another partner moves a row
    by the distance between two points (~1 a coordinate on this data), the
    float drift of the merge coefficients by ~1e-3 after hundreds of merges
    (1.27e-3 at step 834 on an H100), so rows part beyond ``BDCA_ROW_GAP``.
    Where they first part, the cause must be a near-tie
    (``_bdca_near_tie``); then the cache invariants of both."""
    from repro_torch.core import kernel_cache

    (xtr, ytr), _ = data
    cfg = _bdca_binary_cfg(core, xtr.shape[0])
    order = torch.randperm(xtr.shape[0], generator=torch.Generator().manual_seed(SEED))
    order = order[:BDCA_LOCKSTEP_STEPS]
    print(f"CUT: bdca (d) runs the first {BDCA_LOCKSTEP_STEPS} of (b)'s steps (cut from 1,000)")
    devs = {"cuda": torch.device("cuda"), "cpu": torch.device("cpu")}
    tabs = {k: cfg.table().to(dev) for k, dev in devs.items()}
    st = {k: core.init_state(cfg, DIM, device=dev) for k, dev in devs.items()}
    xs = {k: torch.as_tensor(xtr).index_select(0, order).to(dev) for k, dev in devs.items()}
    ys = {k: torch.as_tensor(ytr).index_select(0, order).to(dev) for k, dev in devs.items()}
    ints = lambda s: torch.stack([s.count, s.n_inserts, s.n_merges]).cpu()
    first, worst_row = None, 0.0
    t0 = time.perf_counter()
    for i in range(BDCA_LOCKSTEP_STEPS):
        prev = dict(st)
        for k in devs:
            st[k] = core.train_step(cfg, tabs[k], st[k], xs[k][i:i + 1], ys[k][i:i + 1])
        if first is not None:
            continue
        rows = float((st["cuda"].sv_x.cpu() - st["cpu"].sv_x).abs().max())
        if torch.equal(ints(st["cuda"]), ints(st["cpu"])) and rows <= BDCA_ROW_GAP:
            worst_row = max(worst_row, rows)
            continue
        first = i
        explained, why = _bdca_near_tie(ops, cfg, tabs, prev, {d: xs[d][i:i + 1] for d in devs},
                                        {d: ys[d][i:i + 1] for d in devs})
        print(f"bdca (d) lockstep: first step that parts: {i} (SV rows max diff {rows:.3e}); "
              f"{why}")
        check(explained, f"bdca (d): the card and CPU part at step {i} without a near-tie: "
              f"{why}")
    secs = time.perf_counter() - t0
    if first is None:
        print("bdca (d) lockstep: first step that parts: None")
    print(f"bdca (d) {card}: {BDCA_LOCKSTEP_STEPS} steps on both in {secs:.3f} s; SV rows max "
          f"diff before any parting {worst_row:.3e}; ints card {ints(st['cuda']).tolist()} cpu "
          f"{ints(st['cpu']).tolist()}")
    for k, s in st.items():
        kernel_cache.check_invariants(s.kmat, s.sv_x, s.count, cfg.gamma, tol=5e-5,
                                      context=f"bdca lockstep {k}")
    print("bdca (d): cache invariants I1 (tol 5e-5), I2, I3 hold on both")


def phase_bdca_stream(mc, core, ops, mc_data, card):
    """(e) part of (c)'s rows streamed through ``fit_multiclass_stream``,
    eager and replayed from CUDA graphs, bit-equal with equal launches;
    returns the launches of both runs."""
    from repro_torch import data as sd

    (xtr, ytr), _ = mc_data
    cfg = _bdca_mc_config(mc, core)
    src = sd.ArrayChunks(xtr[:BDCA_STREAM_ROWS], ytr[:BDCA_STREAM_ROWS], STREAM_CHUNK_ROWS)
    steps = BDCA_STREAM_ROWS // MC_BATCH
    print(f"CUT: bdca (e) streams {BDCA_STREAM_ROWS} of run (c)'s {MC_TRAIN} rows "
          f"({src.n_chunks} chunks)")
    eager, esecs, el = _launched(ops, lambda: mc.fit_multiclass_stream(
        cfg, src, epochs=1, seed=SEED, prefetch=2))
    graphed, gsecs, gl = _launched(ops, lambda: mc.fit_multiclass_stream(
        cfg, src, epochs=1, seed=SEED, prefetch=2, cuda_graph=True))
    eq = _states_equal(eager, graphed)
    print(f"bdca (e) {card}: {steps} steps streamed: eager {esecs / steps * 1e6:.1f} us/step, "
          f"CUDA graphs {gsecs / steps * 1e6:.1f} us/step (captures included); bit-equal {eq}; "
          f"launches equal {el == gl} ({json.dumps(gl)})")
    check(eq, "bdca (e): the CUDA-graph stream differs from the eager one")
    check(el == gl, f"bdca (e): launches eager {el}, CUDA graphs {gl}")
    check(el["bdca_ascent"] == steps, f"bdca (e): bdca_ascent launched {el['bdca_ascent']} "
          f"times in {steps} steps")
    total = {}
    _add(total, el)
    _add(total, gl)
    return total


def phase_bdca(core, mc, ops, ref, data, mc_data, fused_acc, run_a_acc, card):
    """Phase 17: the second solver.  Returns the kernel record and the
    launches of its main paths (b), (c) and (e)."""
    from repro_torch.core import kernel_cache
    from repro_torch.kernels import _build

    record = phase_bdca_kernel(ops, ref, _build, card)
    counts = {}
    run_b = phase_bdca_binary(core, ops, data, fused_acc, card)
    _add(counts, run_b[0]["launches"])
    phase_profile(core, run_b, "bdca (b), binary", BDCA_PROFILE_STEPS["b"])
    run_c, st_c = phase_bdca_class(mc, core, ops, kernel_cache, mc_data, run_a_acc, card)
    _add(counts, run_c["launches"])
    phase_bdca_class_profile(mc, core, st_c, mc_data)
    phase_bdca_lockstep(core, ops, data, card)
    _add(counts, phase_bdca_stream(mc, core, ops, mc_data, card))
    print(f"bdca runs' launches: {json.dumps(counts)}")
    return record, counts


# ---------------------------------------------------------------------------
# Phase 18: the distributed layer, two ranks sharing the card
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_BATCH = 8                 # ADULT at batch 8: 508 slots, 254 a rank (batch 1 cannot split)
DIST_CHECK = 100               # integer state compared every DIST_CHECK steps and at the end
DIST_TIMEOUT_S = 300.0         # every collective of a child
DIST_JOIN_S = 900.0            # the children of one spawn, start to end
# steps of each distributed run (CUT lines say of how many)
DIST_STEPS = {"replicated": 200, "slots": 200, "class (a)": 600, "class (c)": 600,
              "nccl replicated": 200}


def _dist_runs():
    """The runs of phase 18: the ADULT stand-in's binary layouts, the mnist-width
    class axis under run (a)'s and run (c)'s engines (``cfg`` the run), and
    run (c)'s model served."""
    binary = dict(budget=BUDGET, lambda_=1e-5, gamma=2.0 ** -7, batch_size=DIST_BATCH,
                  method="lookup-wd")
    return [dict(name="replicated", kind="binary", layout="replicated", cfg=binary),
            dict(name="slots", kind="binary", layout="slots", cfg=binary),
            dict(name="class (a)", kind="class", layout="class", cfg="a"),
            dict(name="class (c)", kind="class", layout="class", cfg="c"),
            dict(name="serve", kind="serve")]


def _dist_config(core, mc, run):
    if run["kind"] == "class":
        return _mc_config(mc, run["cfg"])
    return core.BSGDConfig(**run["cfg"])


def _same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape equal bit for bit (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.reshape(-1).view(torch.int16 if a.element_size() == 2 else torch.int32),
                           b.reshape(-1).view(torch.int16 if b.element_size() == 2 else torch.int32))
    return torch.equal(a, b)


def _dist_ints(state):
    """count, n_inserts and n_merges of a state as one int row (every class's)."""
    return torch.cat([state.count.reshape(-1), state.n_inserts.reshape(-1),
                      state.n_merges.reshape(-1)])


def _file(tmp: Path, run: dict, what: str) -> Path:
    return tmp / f"{run['name'].replace(' ', '_').replace('(', '').replace(')', '')}-{what}"


def _dist_single(core, mc, ops, run, xs, ys):
    """The run's steps in one process on the card: ``(trace, checks, final,
    seconds, launches)``; ``trace`` (steps, k) integer state after each step,
    ``checks`` {step: state} every DIST_CHECK steps (the state before step
    0 included)."""
    cfg = _dist_config(core, mc, run)
    dev = torch.device("cuda")
    table = cfg.table().to(dev)
    steps = xs.shape[0] // DIST_BATCH
    if run["kind"] == "class":
        st, step_fn = mc.init_multiclass_state(cfg, xs.shape[1], device=dev), mc.train_step_multiclass
    else:
        st, step_fn = core.init_state(cfg, xs.shape[1], device=dev), core.train_step
    trace = torch.zeros((steps, _dist_ints(st).shape[0]), dtype=torch.int32, device=dev)
    checks = {0: st}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        sl = slice(i * DIST_BATCH, (i + 1) * DIST_BATCH)
        st = step_fn(cfg, table, st, xs[sl], ys[sl])
        trace[i] = _dist_ints(st)
        if (i + 1) % DIST_CHECK == 0 or i + 1 == steps:
            trace[i].cpu()                 # the children read their trace here too
            checks[i + 1] = st
    torch.cuda.synchronize()
    return trace.cpu().numpy(), checks, st, time.perf_counter() - t0, ops.launch_counts()


def _dist_child_run(core, mc, D, ops, group, tmp, run, dev):
    """One run on this rank: its part of the state through the layout's
    steps, the integer state held against the one-process trace every
    DIST_CHECK steps.  Where they part, the run stops, re-runs from the last
    check to the state before the parting step and keeps it."""
    rank, world = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
    cfg = _dist_config(core, mc, run)
    inputs = np.load(_file(tmp, run, "inputs.npz"))
    want = np.load(_file(tmp, run, "trace.npy"))
    xs = torch.as_tensor(inputs["x"], device=dev)
    ys = torch.as_tensor(inputs["y"], device=dev)
    if run["kind"] == "class":
        full = mc.init_multiclass_state(cfg, xs.shape[1], device=dev)
        lo, hi = D.owned_range(cfg.n_classes, rank, world) if (
            D.resolve_layout(cfg, run["layout"], world) == "class") else (0, cfg.n_classes)
        c = cfg.n_classes
        cols = [k * c + q for k in range(3) for q in range(lo, hi)]
    else:
        full = core.init_state(cfg, xs.shape[1], device=dev)
        cols = [0, 1, 2]
    step = D.make_distributed_step(cfg, group, layout=run["layout"])
    steps = xs.shape[0] // DIST_BATCH

    def batch(i):
        sl = slice(i * DIST_BATCH, (i + 1) * DIST_BATCH)
        return D.shard_rows(xs[sl], group), D.shard_rows(ys[sl], group)

    part = D.shard_state(cfg, full, group, run["layout"])
    trace = torch.zeros((steps, len(cols)), dtype=torch.int32, device=dev)
    check_at, check_part, parted = 0, part, None
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        part = step(part, *batch(i))
        trace[i] = _dist_ints(part)
        if (i + 1) % DIST_CHECK == 0 or i + 1 == steps:
            got = trace[check_at:i + 1].cpu().numpy()
            bad = np.nonzero((got != want[check_at:i + 1][:, cols]).any(axis=1))[0]
            # a rank sees only its classes' counters: the first parting of any rank
            first = torch.tensor([check_at + int(bad[0]) if bad.size else steps], device=dev)
            torch.distributed.all_reduce(first, op=torch.distributed.ReduceOp.MIN, group=group)
            if int(first) < steps:
                parted = int(first)
                break
            check_at, check_part = i + 1, part
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    out = dict(steps=steps if parted is None else parted + 1, seconds=secs, launches=launches,
               parted=parted, backend=str(torch.distributed.get_backend(group)))
    if parted is not None:                 # the state before the parting step, whole
        for i in range(check_at, parted):
            check_part = step(check_part, *batch(i))
        part = check_part
    whole = D.gather_state(cfg, part, group, run["layout"])
    if rank == 0:
        torch.save({k: None if v is None else v.cpu() for k, v in whole._asdict().items()},
                   _file(tmp, run, "state.pt"))
    return out


def _dist_child_serve(core, D, ops, group, tmp, run, dev):
    saved = torch.load(_file(tmp, run, "model.pt"))
    model = core.ServeModel(sv_x=saved["sv_x"].to(dev), alpha=saved["alpha"].to(dev),
                            count=saved["count"].to(dev), gamma=saved["gamma"],
                            binary=saved["binary"])
    x = torch.as_tensor(np.load(_file(tmp, run, "inputs.npz"))["x"], device=dev)
    predict = D.make_distributed_predict(group)
    rows = D.shard_rows(x, group)
    predict(model, rows)                   # warm-up
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, labels = predict(model, rows)
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, launches=ops.launch_counts(),
               backend=str(torch.distributed.get_backend(group)))
    if torch.distributed.get_rank(group) == 0:
        torch.save({"scores": scores.cpu(), "labels": labels.cpu()}, _file(tmp, run, "state.pt"))
    return out


def _dist_probe(group, dev) -> str:
    """The collectives ``core.distributed`` calls, on CUDA tensors, checked."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    t = torch.full((4,), float(dist.get_rank(group) + 1), device=dev)
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=group)
    s = t.clone()
    dist.all_reduce(s, group=group)
    ok = (all(bool((p == r + 1).all()) for r, p in enumerate(parts))
          and bool((s == world * (world + 1) / 2).all()))
    check(ok, "all_gather / all_reduce on CUDA tensors gave wrong values")
    return "all_gather and all_reduce on CUDA tensors ok"


def _dist_child(rank, world, store, tmp, runs):
    """A rank of phase 18 (a ``torch.multiprocessing`` spawn): the kernels
    were built by the parent and are only loaded here; ``launch.dist.init``
    picks the backend by its rule."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch import core
    from repro_torch.core import distributed as D
    from repro_torch.core import multiclass as mc
    from repro_torch.kernels import ops
    from repro_torch.launch import dist as dist_launch

    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    dev = dist_launch.init("cuda", rank=rank, world_size=world, init_method=f"file://{store}",
                           timeout_s=DIST_TIMEOUT_S)
    group = dist.group.WORLD
    try:
        probe = _dist_probe(group, dev)
        for run in runs:
            if run["kind"] == "serve":
                out = _dist_child_serve(core, D, ops, group, tmp, run, dev)
            else:
                out = _dist_child_run(core, mc, D, ops, group, tmp, run, dev)
            out["probe"] = probe
            _file(tmp, run, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _dist_spawn(tmp: Path, runs, world: int) -> None:
    import torch.multiprocessing as mp

    store = tmp / f"store-{world}"
    ctx = mp.start_processes(_dist_child, args=(world, str(store), str(tmp), runs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_JOIN_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"phase 18: the {world} ranks did not finish in {DIST_JOIN_S} s")


def _binary_near_tie(core, cfg, prev, xb, yb):
    """Why a one-process and a distributed binary step part, from the two
    states before it: a row whose margin lies on either side of 1 (within
    1e-3), or an event whose two smallest |alpha| tie to 1e-5."""
    from repro_torch.core.bsgd import decision_rows, insert_from_rows
    from repro_torch.kernels import ops

    margins, mins = {}, {}
    for key, st in prev.items():
        k_b = ops.rbf_matrix(xb, st.sv_x, cfg.gamma)
        margins[key] = (yb * decision_rows(st, k_b)).cpu()
        mid = insert_from_rows(cfg, st, xb, yb, k_b)
        act = torch.arange(mid.alpha.shape[0], device=xb.device) < mid.count
        mins[key] = torch.sort(torch.where(act, mid.alpha.abs(), torch.inf)).values[:2].cpu()
    m1, m2 = margins["one process"], margins["distributed"]
    split = torch.nonzero((m1 < 1) != (m2 < 1)).flatten()
    if split.numel():
        r = int(split[0])
        return (abs(float(m1[r]) - float(m2[r])) < 1e-3,
                f"margin near-tie: row {r} one process {float(m1[r])!r} distributed "
                f"{float(m2[r])!r}")
    a2 = mins["one process"]
    tie = bool(a2[1] - a2[0] <= 1e-5 * a2[0])
    return tie, f"event: two smallest |alpha| {a2.tolist()}"


def _bank_columns_check(ops, st):
    """The class layout's margin call scores C/W classes' columns of the bank:
    each column's bits must not depend on how many columns the bank has."""
    c, s, d = st.sv_x.shape
    bank = st.sv_x.reshape(c * s, d)
    xb = torch.as_tensor(np.random.default_rng(SEED + 7).standard_normal((DIST_BATCH, d))
                         .astype(np.float32), device="cuda")
    whole = ops.rbf_matrix(xb, bank, MC_GAMMA)
    half = (c // DIST_WORLD) * s
    parts = [ops.rbf_matrix(xb, bank[:half], MC_GAMMA), ops.rbf_matrix(xb, bank[half:], MC_GAMMA)]
    equal = _same_bits(torch.cat(parts, 1), whole)
    print(f"rbf_matrix columns: {DIST_BATCH} x {c * s} bank against its two {half}-column "
          f"halves, bit-equal {equal}")
    check(equal, "a column's bits depend on how many columns the bank has")


def phase_distributed(core, mc, ops, data, mc_data, run_c, card):
    """Phase 18: each layout on DIST_WORLD ranks sharing the card (gloo), and
    replicated on a world of 1 under NCCL, against the same steps in one
    process on the card."""
    import tempfile

    from repro_torch.core.predict import serve_cell
    from repro_torch.launch import dist as dist_launch

    print(card)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="dist-", dir=build))
    dev = torch.device("cuda")
    rule = {w: dist_launch.pick_backend(dev, w) for w in (DIST_WORLD, 1)}
    print(f"backend rule: {DIST_WORLD} ranks on {torch.cuda.device_count()} card(s) -> "
          f"{rule[DIST_WORLD]}; 1 rank -> {rule[1]}")
    _bank_columns_check(ops, run_c[1])
    (xtr, ytr), _ = data
    (mxtr, mytr), (mxte, _) = mc_data
    runs = _dist_runs()
    singles = {}
    for run in runs:
        if run["kind"] == "serve":
            model = core.export_model(run_c[1], MC_GAMMA)
            torch.save({"sv_x": model.sv_x.cpu(), "alpha": model.alpha.cpu(),
                        "count": model.count.cpu(), "gamma": model.gamma,
                        "binary": model.binary}, _file(tmp, run, "model.pt"))
            np.savez(_file(tmp, run, "inputs.npz"), x=mxte)
            continue
        steps = DIST_STEPS[run["name"]]
        if run["kind"] == "class":
            order = _mc_order(steps).numpy()
            x, y = mxtr[order], mytr[order].astype(np.int64)
            total = MC_TRAIN // DIST_BATCH
        else:
            order = torch.randperm(xtr.shape[0], generator=torch.Generator().manual_seed(SEED))
            order = order[: steps * DIST_BATCH].numpy()
            x, y = xtr[order], ytr[order]
            total = xtr.shape[0] // DIST_BATCH
        print(f"CUT: dist {run['name']} trains {steps} of the epoch's {total} steps")
        np.savez(_file(tmp, run, "inputs.npz"), x=x, y=y)
        xs, ys = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        singles[run["name"]] = _dist_single(core, mc, ops, run, xs, ys)
        np.save(_file(tmp, run, "trace.npy"), singles[run["name"]][0])
    nccl = dict(runs[0], name="nccl replicated")
    steps = DIST_STEPS[nccl["name"]]
    print(f"CUT: dist {nccl['name']} trains {steps} of the epoch's "
          f"{xtr.shape[0] // DIST_BATCH} steps")
    with np.load(_file(tmp, runs[0], "inputs.npz")) as z:
        x, y = z["x"][: steps * DIST_BATCH], z["y"][: steps * DIST_BATCH]
    np.savez(_file(tmp, nccl, "inputs.npz"), x=x, y=y)
    singles[nccl["name"]] = _dist_single(core, mc, ops, nccl, torch.as_tensor(x, device=dev),
                                         torch.as_tensor(y, device=dev))
    np.save(_file(tmp, nccl, "trace.npy"), singles[nccl["name"]][0])

    t0 = time.perf_counter()
    _dist_spawn(tmp, runs, DIST_WORLD)
    print(f"spawn of {DIST_WORLD} ranks: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    _dist_spawn(tmp, [nccl], 1)
    print(f"spawn of 1 rank: {time.perf_counter() - t0:.3f} s")

    counts = {}
    for run, world in [(r, DIST_WORLD) for r in runs] + [(nccl, 1)]:
        outs = [json.loads(_file(tmp, run, f"rank{r}.json").read_text()) for r in range(world)]
        for o in outs:
            _add(counts, o["launches"])
        got = torch.load(_file(tmp, run, "state.pt"))
        backend = outs[0]["backend"]
        check(all(o["backend"] == rule[world] for o in outs),
              f"dist {run['name']}: the ranks ran {[o['backend'] for o in outs]}, the rule "
              f"picks {rule[world]}")
        staging = ("gloo copies CUDA tensors through host memory inside the collective"
                   if backend == "gloo" else "NCCL works on the card")
        head = (f"dist {run['name']}: backend {backend}, ranks {world}, staging in "
                f"core.distributed none ({staging}; {outs[0]['probe']})")
        if run["kind"] == "serve":
            model = core.ServeModel(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                                       for k, v in torch.load(_file(tmp, run, "model.pt")).items()})
            scores, labels = serve_cell(model, mxte)
            equal = (_same_bits(got["scores"], scores.cpu())
                     and _same_bits(got["labels"], labels.cpu()))
            err = float((got["scores"] - scores.cpu()).abs().max())
            secs = max(o["seconds"] for o in outs)
            print(f"{head}; {mxte.shape[0]} rows split {mxte.shape[0] // world} a rank: "
                  f"{secs * 1e3:.3f} ms, class_scores {outs[0]['launches']['class_scores']} a rank; "
                  f"largest score difference {err!r}, labels and scores bit-equal {equal}")
            check(equal, "serve: the gathered scores and labels differ from one process's")
            check(all(o["launches"]["class_scores"] == 1 for o in outs),
                  "serve: not one class_scores launch a rank")
            continue
        trace, checks, final, secs1, launches1 = singles[run["name"]]
        parted = outs[0]["parted"]
        steps = outs[0]["steps"]
        secs = max(o["seconds"] for o in outs)
        kernel = ("merge_pick" if run["kind"] == "binary"
                  else {"a": "merge_event_rounds", "c": "train_step"}[run["cfg"]])
        check(all(o["launches"]["rbf_matrix"] > 0 for o in outs),
              f"dist {run['name']}: rbf_matrix never launched")
        check(all(o["launches"][kernel] > 0 for o in outs),
              f"dist {run['name']}: {kernel} never launched")
        if parted is None:
            fields = [n for n in final._fields if getattr(final, n) is not None]
            errs = {n: float((getattr(final, n).float().cpu() - got[n].float()).abs().max())
                    for n in fields}
            equal = all(_same_bits(getattr(final, n).cpu(), got[n]) for n in fields)
            print(f"{head}; steps {steps}, us/step {world} ranks {secs / steps * 1e6:.1f}, "
                  f"one process {secs1 / steps * 1e6:.1f}; first step whose integer state "
                  f"parts: None (checked every {DIST_CHECK} steps and at the end); largest float "
                  f"difference {max(errs.values())!r} ({max(errs, key=errs.get)}); bits equal "
                  f"{equal}; {kernel} {outs[0]['launches'][kernel]} a rank")
            # while the integers agree every layout's state is one process's bit
            # for bit: slots' summed margins reach the Pegasos state only through
            # which rows violate, and every other float is computed as one process does
            check(equal, f"dist {run['name']}: the integers agree but the floats are not "
                         f"bit-equal to one process (largest difference {max(errs.values())!r})")
            continue
        # parted at step `parted`: both states before it, then the diagnosis
        cfg = _dist_config(core, mc, run)
        base = max(k for k in checks if k <= parted)
        st = checks[base]
        with np.load(_file(tmp, run, "inputs.npz")) as z:
            xs = torch.as_tensor(z["x"], device=dev)
            ys = torch.as_tensor(z["y"], device=dev)
        table = cfg.table().to(dev)
        step_fn = mc.train_step_multiclass if run["kind"] == "class" else core.train_step
        for i in range(base, parted):
            st = step_fn(cfg, table, st, xs[i * DIST_BATCH:(i + 1) * DIST_BATCH],
                         ys[i * DIST_BATCH:(i + 1) * DIST_BATCH])
        other = core.SVMState(**{k: None if v is None else v.to(dev) for k, v in got.items()})
        sl = slice(parted * DIST_BATCH, (parted + 1) * DIST_BATCH)
        if run["kind"] == "class":
            cpu = core.SVMState(*(None if t is None else t.cpu() for t in other))
            explained, why = _near_tie(mc, cfg, {"cuda": st, "cpu": cpu},
                                       {"cuda": table, "cpu": cfg.table()},
                                       {"cuda": xs[sl], "cpu": xs[sl].cpu()},
                                       {"cuda": ys[sl], "cpu": ys[sl].cpu()})
        else:
            explained, why = _binary_near_tie(core, cfg, {"one process": st, "distributed": other},
                                              xs[sl], ys[sl])
        print(f"{head}; steps {steps}, us/step {world} ranks {secs / steps * 1e6:.1f}, one "
              f"process {secs1 / trace.shape[0] * 1e6:.1f}; first step whose integer state "
              f"parts: {parted}; {why}")
        check(explained, f"dist {run['name']} parts at step {parted} without a near-tie: {why}")
    return counts


# ---------------------------------------------------------------------------
# Phase 19: the port's examples on the card
# ---------------------------------------------------------------------------

# each script's arguments on the card, and what they cut (None: the script's defaults)
EXAMPLES = {
    "torch_quickstart": (["--n", "600", "--epochs", "1"],
                         "600 of its 3,000 rows and 1 of its 3 epochs a method"),
    "torch_svm_speedup": (["--n", "2000"], "2,000 of its 40,000 rows"),
    "torch_svm_multiclass": (["--n", "2000", "--skip-loop-baseline"],
                             "2,000 of its 6,000 rows and no loop-over-classes baseline"),
    "torch_svm_stream": (["--n", "3000", "--chunk-rows", "500"],
                         "3,000 of its 8,192 rows in chunks of 500 (of 1,024)"),
    "torch_svm_serve_live": (["--n", "2048", "--epochs", "1"],
                             "2,048 of its 4,096 rows and 1 of its 2 epochs"),
}
EXAMPLE_TIMEOUT_S = 300


def start_example(name: str, args):
    """``examples/<name>.py args --device cuda`` started as a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}.py"), *args,
                             "--device", "cuda"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    return proc, time.perf_counter()


def finish_example(name: str, started) -> list[str]:
    """Wait for a ``start_example`` subprocess (killed past
    ``EXAMPLE_TIMEOUT_S`` from its start); its output lines, printed; fails
    unless it exits 0."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S
                                                - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    secs = time.perf_counter() - t0
    lines = out.strip().splitlines()
    for line in lines:
        print(f"  {name}: {line}")
    if proc.returncode:
        print(err[-4000:])
    check(proc.returncode == 0, f"{name} exited {proc.returncode}")
    print(f"{name} ok in {secs:.3f} s")
    return lines


def run_example(name: str, args) -> list[str]:
    return finish_example(name, start_example(name, args))


EXAMPLE_ALONE = "torch_svm_speedup"   # its paper figures are timings: it runs by itself


def phase_examples(card):
    print(card)
    for name, (_, cut) in EXAMPLES.items():
        if cut:
            print(f"CUT: {name} runs {cut}")
    print(f"CUT: the examples but {EXAMPLE_ALONE} run at once, sharing the card")
    started = {name: start_example(name, args) for name, (args, _) in EXAMPLES.items()
               if name != EXAMPLE_ALONE}
    try:
        for name, proc in started.items():
            finish_example(name, proc)
    finally:
        for proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = run_example(EXAMPLE_ALONE, EXAMPLES[EXAMPLE_ALONE][0])
    figures = [ln for ln in lines if ln.startswith("paper figures")]
    check(len(figures) == 1, f"{EXAMPLE_ALONE} printed no paper figures line")
    print(figures[0])


# Phase 20: language-model serving
# ---------------------------------------------------------------------------

LM_DEVICE = "cuda"
LM_SERVE_ARCH = "smollm_360m"
LM_BATCH = 4
# (prompt, generated) of (a): the CLI's prompt, and train_4k's length (the
# chunked online-softmax prefill)
LM_SERVE_SHAPES = ((32, 64), (4096, 64))
LM_PROFILE_STEPS = 4               # cut from 16: the profiler's read-back of ~2,900 kernels a step
LM_DECODE_TOL = 2e-2             # the reference's decode-vs-full tolerance
LM_CPU_TOL = 1e-3
LM_CPU_STEPS = 8
# (b): depth (None: the whole model), tokens prefilled first, and tokens then
# decoded one by one, against one full forward over all of them; h2o
# prefills its 4,096 window and decodes 16 past it, so the ring wraps (the
# serve path's placement; decoding the whole window one by one took 19.7 s)
LM_DECODE_CHECKS = {"smollm_360m": (None, 0, 16), "mamba2_130m": (None, 0, 16),
                    "h2o_danube3_4b": (2, 4096, 16), "deepseek_v2_236b": (2, 0, 16),
                    "jamba_v01_52b": (8, 0, 16)}
# (d): every other family in bf16 at its published width; depth None is the
# whole model, else the smallest depth that holds every layer kind
LM_FAMILIES = {"mamba2_130m": None, "h2o_danube3_4b": None, "yi_9b": None, "hubert_xlarge": None,
               "deepseek_v2_236b": 2, "deepseek_v3_671b": 4, "jamba_v01_52b": 8,
               "chameleon_34b": 2, "deepseek_coder_33b": 2}
LM_FAMILY_SHAPES = {"h2o_danube3_4b": ((32, 16), (4096, 64))}   # else ((32, 16),)
# (e): the budgeted KV cache at (a)'s model's KV width
KV_HEADS, KV_HEAD_DIM, KV_BUDGET, KV_APPENDS = 5, 64, 512, 4096


class _NoSync:
    """Fail on any host synchronisation inside: the decode and append loops
    must read nothing from the card."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return False


def _free() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _lm_tokens(cfg, shape, seed: int = SEED, device=None):
    device = device or LM_DEVICE
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=device)


def _lm_cfg(configs, arch: str, depth=None, **kw):
    cfg = configs.get(arch)
    if depth is not None:
        print(f"CUT: {arch} runs {depth} of its {cfg.n_layers} layers "
              f"(layer plan {[k for k in dict.fromkeys(cfg.layer_plan())]})")
        kw["n_layers"] = depth
    return dataclasses.replace(cfg, **kw)


def _no_drop(cfg):
    """The reference test's MoE capacity (``test_archs_smoke.py:77-79``)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                                            min_capacity=64))


def lm_serve_full(configs, models, lm_serve, card):
    """(a) ``launch.serve.serve`` on smollm_360m as published, at both shapes,
    under sync debug mode "error", then a profiled decode window."""
    cfg = configs.get(LM_SERVE_ARCH)
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.vocab_padded}), tied {cfg.tie_embeddings}, {cfg.dtype}, "
          f"{cfg.param_count():,} parameters")
    # the libraries' first use (cuBLAS handles, allocator pools) before timing
    lm_serve.serve(cfg, batch=LM_BATCH, prompt_len=8, gen=2, seed=SEED, device=LM_DEVICE,
                   verbose=False)
    _free()
    for prompt, gen in LM_SERVE_SHAPES:
        stats = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()      # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        with _NoSync():
            toks = lm_serve.serve(cfg, batch=LM_BATCH, prompt_len=prompt, gen=gen, seed=SEED,
                                  device=LM_DEVICE, stats=stats)
        peak = torch.cuda.max_memory_allocated() - base
        check(tuple(toks.shape) == (LM_BATCH, gen + 1), f"serve tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()), "a token out of range")
        print(f"serve {cfg.name} batch {LM_BATCH} prompt {prompt} gen {gen}: prefill "
              f"{stats['prefill_ms']:.3f} ms, decode {stats['decode_ms_per_token']:.3f} ms a "
              f"token, {stats['tokens_per_s']:.1f} tokens/s, peak device bytes {peak:,} "
              f"(sync debug mode error; {card})")
        _free()
    # one short profiled decode window from a 32-token prompt
    model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
    toks = _lm_tokens(cfg, (LM_BATCH, 32))
    with torch.no_grad():
        _, pf_cache = models.prefill(cfg, model, toks)
        cache = models.init_cache(cfg, LM_BATCH, 32 + 4 * LM_PROFILE_STEPS + 1, device=LM_DEVICE)
        box = [toks[:, -1:], torch.full((), 32, dtype=torch.int32, device=LM_DEVICE),
               [{k: lm_serve._place(c[k], p[k]) for k in c} for c, p in zip(cache, pf_cache)]]

    def step(_):
        logits, box[2] = models.decode_step(cfg, model, box[2], box[0], box[1])
        box[0] = torch.argmax(logits, dim=-1)[:, None]
        box[1] = box[1] + 1

    print(f"CUT: the decode profile reads {LM_PROFILE_STEPS} steps a window (cut from 16)")
    _profile(step, LM_PROFILE_STEPS, f"{cfg.name} decode, batch {LM_BATCH} from prompt 32, a "
                                     f"step a token of every prompt ({card})")
    del model, box, cache, pf_cache
    _free()


def lm_decode_vs_full(configs, models, lm_serve, card):
    """(b) decode step by step against one full forward, float32."""
    for arch, (depth, n_pre, n) in LM_DECODE_CHECKS.items():
        cfg = _no_drop(_lm_cfg(configs, arch, depth, dtype="float32"))
        batch = 1 if n_pre else LM_BATCH
        model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
        toks = _lm_tokens(cfg, (batch, n_pre + n))
        cache = models.init_cache(cfg, batch, n_pre + n + 1, device=LM_DEVICE)
        steps = []
        with torch.no_grad():
            full, _ = models.forward(cfg, model, {"tokens": toks})
            if n_pre:
                last, pf_cache = models.prefill(cfg, model, toks[:, :n_pre])
                cache = [{k: lm_serve._place(c[k], p[k]) for k in c}
                         for c, p in zip(cache, pf_cache)]
                steps.append(last)
        pos = torch.full((), n_pre, dtype=torch.int32, device=LM_DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _NoSync():
            for t in range(n_pre, n_pre + n):
                logits, cache = models.decode_step(cfg, model, cache, toks[:, t:t + 1], pos)
                steps.append(logits)
                pos = pos + 1
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        full = full[:, max(n_pre - 1, 0):]
        err = float((full - torch.stack(steps, 1)).abs().max())
        scale = float(full.abs().max())
        what = f"{n} tokens decoded one by one"
        if n_pre:
            w = min(cfg.sliding_window or n_pre + n + 1, n_pre + n + 1)
            what = (f"{n_pre} tokens prefilled (the last position checked) into a ring of {w} "
                    f"slots, then {n} decoded past the window (the ring wrapped at every step)")
        print(f"decode vs full {arch} fp32, {cfg.n_layers} layers, batch {batch}, {what}: "
              f"max |err| {err:.3e} against tolerance {LM_DECODE_TOL} (logits up to "
              f"{scale:.3f}); {secs / n * 1e3:.3f} ms a decode step ({card})")
        check(err < LM_DECODE_TOL, f"{arch} decode parts from the full forward by {err}")
        del model, full, steps, cache
        _free()


def lm_card_vs_cpu(configs, models, convert, lm_serve, card):
    """(c) smollm_360m at full width, depth 2, fp32: the card against the
    port's CPU path on the same weights, prefill and decode."""
    cfg = _lm_cfg(configs, LM_SERVE_ARCH, 2, dtype="float32")
    model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
    cpu_model = convert.lm_params_from_numpy(cfg, convert.lm_params_to_numpy(model), device="cpu")
    toks = _lm_tokens(cfg, (LM_BATCH, 32))
    card_logits = []
    out = lm_serve.generate(cfg, model, toks, LM_CPU_STEPS, logits=card_logits).cpu()
    # the CPU decodes the card's tokens, so both see the same inputs
    with torch.no_grad():
        last, pf_cache = models.prefill(cfg, cpu_model, toks.cpu())
        cache = models.init_cache(cfg, LM_BATCH, 32 + LM_CPU_STEPS + 1, device="cpu")
        cache = [{k: lm_serve._place(c[k], p[k]) for k in c} for c, p in zip(cache, pf_cache)]
        cpu_logits = [last]
        for i in range(LM_CPU_STEPS):
            last, cache = models.decode_step(cfg, cpu_model, cache, out[:, i:i + 1], 32 + i)
            cpu_logits.append(last)
    card_l = torch.stack(card_logits, 1).cpu()
    cpu_l = torch.stack(cpu_logits, 1)
    scale = max(1.0, float(cpu_l.abs().max()))
    err = float((card_l - cpu_l).abs().max())
    cpu_tok = torch.argmax(cpu_l, dim=-1)
    parted = (cpu_tok != out.long()).nonzero().tolist()
    top2 = torch.topk(cpu_l, 2, dim=-1).values
    gaps = [float(top2[b, i, 0] - top2[b, i, 1]) for b, i in parted]
    print(f"card vs CPU {cfg.name} fp32, {cfg.n_layers} layers, batch {LM_BATCH}, prompt 32, "
          f"{LM_CPU_STEPS} decode steps: max |err| {err:.3e} against {LM_CPU_TOL} x logits' "
          f"scale {scale:.3f}; greedy tokens equal {not parted} (parted at {parted}, top-2 gaps "
          f"{gaps}) ({card})")
    check(err <= LM_CPU_TOL * scale, f"card against CPU {err}")
    check(all(g < LM_CPU_TOL * scale for g in gaps), "a greedy token parts off a near-tie")
    del model, cpu_model
    _free()


def lm_families(configs, models, lm_serve, card):
    """(d) every family once at its published width in bf16."""
    for arch, depth in LM_FAMILIES.items():
        cfg = _lm_cfg(configs, arch, depth)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        label = (f"family {arch} bf16, {cfg.n_layers} layers{' and the MTP block' * cfg.mtp_depth}"
                 f", d {cfg.d_model}, {n_params:,} parameters (drawn in {init_s:.3f} s)")
        if cfg.is_encoder:
            gen = torch.Generator(device=LM_DEVICE)
            gen.manual_seed(SEED)
            frames = torch.randn((LM_BATCH, 32, cfg.frame_dim), generator=gen, device=LM_DEVICE)
            models.encode_step(cfg, model, {"frames": frames})        # first use of the shapes
            logits, secs = _timed(lambda: models.encode_step(cfg, model, {"frames": frames}))
            check(tuple(logits.shape) == (LM_BATCH, 32, cfg.vocab_padded), "encoder shape")
            check(bool(torch.isfinite(logits.float()).all()), f"{arch} logits not finite")
            print(f"{label}: encode_step of {LM_BATCH}x32 frames of {cfg.frame_dim} "
                  f"{secs * 1e3:.3f} ms, logits {tuple(logits.shape)} finite, peak device bytes "
                  f"{torch.cuda.max_memory_allocated() - base:,} ({card})")
        shapes = () if cfg.is_encoder else LM_FAMILY_SHAPES.get(arch, ((32, 16),))
        for prompt, gen in shapes:
            toks = _lm_tokens(cfg, (LM_BATCH, prompt))
            logits, timings = [], {}
            with _NoSync():
                out = lm_serve.generate(cfg, model, toks, gen, timings=timings, logits=logits)
            logits = torch.stack(logits, 1)
            check(tuple(logits.shape) == (LM_BATCH, gen + 1, cfg.vocab_padded),
                  f"{arch} logits {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits.float()).all()), f"{arch} logits not finite")
            check(bool(((out >= 0) & (out < cfg.vocab_padded)).all()), f"{arch} token range")
            print(f"{label}: prompt {prompt} gen {gen} batch {LM_BATCH}: prefill "
                  f"{timings['prefill_s'] * 1e3:.3f} ms, decode "
                  f"{timings['decode_s'] / gen * 1e3:.3f} ms a token, logits "
                  f"{tuple(logits.shape)} finite, tokens in [0, {cfg.vocab_padded}), peak device "
                  f"bytes {torch.cuda.max_memory_allocated() - base:,} ({card})")
        del model
        _free()


def lm_budgeted_kv(kv, default_table, card):
    """(e) the budgeted KV cache at (a)'s KV width: merge and evict side by
    side against the exact cache, appends under sync debug mode "error"."""
    table = default_table().to(LM_DEVICE)
    b, h, d, w, n = LM_BATCH, KV_HEADS, KV_HEAD_DIM, KV_BUDGET, KV_APPENDS
    gamma, scale = 1.0 / (2.0 * d), 1.0 / d ** 0.5
    rng = np.random.default_rng(SEED)
    center = np.sin(np.arange(d) * 0.1 + np.arange(n)[:, None] * 0.02)          # drifting keys
    ks = torch.from_numpy((center[:, None, None, None, :]
                           + 0.3 * rng.standard_normal((n, b, 1, h, d))).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((n, b, 1, h, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32)).to(LM_DEVICE)
    ks, vs = ks.to(LM_DEVICE), vs.to(LM_DEVICE)
    fk, fv = ks[:, :, 0].transpose(0, 1), vs[:, :, 0].transpose(0, 1)           # (B, T, H, d)
    probs = torch.softmax(torch.einsum("bqhd,bwhd->bhqw", q, fk) * scale, dim=-1)
    exact = torch.einsum("bhqw,bwhd->bqhd", probs, fv)
    errs = {}
    for policy in ("merge", "evict"):
        st = kv.init_kv_state(b, w, h, d, torch.float32, device=LM_DEVICE)
        spans = []
        for lo, hi in ((0, w), (w, n)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _NoSync():
                for i in range(lo, hi):
                    st = kv.kv_append(st, ks[i], vs[i], gamma, table, policy=policy)
            torch.cuda.synchronize()
            spans.append((time.perf_counter() - t0) / (hi - lo) * 1e6)
        check(st.count == w, f"{policy}: count {st.count}")
        out = kv.kv_attend(st, q, scale)
        errs[policy] = float(torch.linalg.norm(out - exact) / torch.linalg.norm(exact))
        print(f"budgeted KV {policy}: batch {b}, {h} heads of {d}, budget {w}, {n} appends "
              f"(sync debug mode error): {spans[0]:.2f} us an append below the budget, "
              f"{spans[1]:.2f} at it; attention relative error {errs[policy]:.4f} against the "
              f"exact cache of {n} ({card})")
    print(f"budgeted KV merge {errs['merge']:.4f} <= evict {errs['evict']:.4f}: "
          f"{errs['merge'] <= errs['evict']}")
    check(errs["merge"] <= errs["evict"], f"merging lost to eviction: {errs}")
    run_example("torch_budgeted_kv_serve", [])


def phase_lm(card):
    from repro_torch import configs, convert, models
    from repro_torch.core import budgeted_kv
    from repro_torch.core.lookup import default_table
    from repro_torch.launch import serve as lm_serve

    print(card)
    t0 = time.perf_counter()
    lm_serve_full(configs, models, lm_serve, card)
    t1 = time.perf_counter()
    lm_decode_vs_full(configs, models, lm_serve, card)
    t2 = time.perf_counter()
    lm_card_vs_cpu(configs, models, convert, lm_serve, card)
    t3 = time.perf_counter()
    lm_families(configs, models, lm_serve, card)
    t4 = time.perf_counter()
    lm_budgeted_kv(budgeted_kv, default_table, card)
    t5 = time.perf_counter()
    print(f"phase 20 seconds: (a) {t1 - t0:.3f}, (b) {t2 - t1:.3f}, (c) {t3 - t2:.3f}, "
          f"(d) {t4 - t3:.3f}, (e) {t5 - t4:.3f}")


# Phase 21: language-model training
# ---------------------------------------------------------------------------

# train_4k's length; 4 steps, cut from 6 for phase 23 (the CUT: line of (a))
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 4096, 4
LM_REMAT_SEQ = 1024              # the remat on / off peak-bytes comparison
LM_GRAD_TOL, LM_LOSS_TOL, LM_UPDATE_TOL = 1e-4, 1e-5, 1e-6
LM_CHECK_BATCH, LM_CHECK_SEQ = 2, 128    # (b): card against CPU
LM_DP_BATCH, LM_DP_TOL = 8, 1e-5         # (e): two ranks, 4 rows each
LM_PIPE = dict(groups=8, micro=6, rows=4, d=960)   # (e): pipeline_forward
LM_TRAJ_TOL = 2e-3                       # (d): the reference's resume tolerance
LM_EXAMPLE_STEPS = 150                   # (c): cut from the example's 300 for phase 22
BF16_PEAK_FLOPS_PER_S = H100.bf16_flops  # H100 SXM dense bf16 (NVIDIA data sheet)


def _train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (the usual model-FLOPs count:
    6 N a token for the matmuls of every parameter, the tied head once,
    and 12 L H hd S a token for attention's two products, full and not
    causal; remat's second forward is not counted)."""
    tokens = batch * seq
    return tokens * (6 * cfg.param_count() + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim_ * seq)


def _lm_batch(cfg, batch: int, seq: int, device=None) -> dict:
    device = device or LM_DEVICE
    toks = _lm_tokens(cfg, (batch, seq), device=device)
    mask = torch.ones((batch, seq), dtype=torch.float32, device=device)
    mask[:, -1] = 0.0
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1), "mask": mask}


def _lm_grads(lm_models, cfg, model, batch):
    """``(loss, {name: gradient})`` of ``loss_fn`` by autograd."""
    params = dict(model.named_parameters())
    loss = lm_models.loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(params.items(), grads)}


def _leaf_err(got, want) -> float:
    """max |got - want| over the leaf's max |want|, on the host."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _remat_peak(models, steps_mod, optim, cfg, remat: bool) -> int:
    """Peak device bytes of one AdamW step at ``LM_REMAT_SEQ`` with remat on or off."""
    cfg = dataclasses.replace(cfg, remat=remat)
    model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
    opt = optim.AdamW(lr=3e-3)
    state = opt.init(dict(model.named_parameters()))
    batch = _lm_batch(cfg, LM_TRAIN_BATCH, LM_REMAT_SEQ)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps_mod.make_train_step(cfg, opt)(model, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del model, state, batch
    _free()
    return peak


def lm_train_full(configs, models, lm_train, steps_mod, optim, card, tmp: Path):
    """(a) ``train_loop`` on smollm_360m as published, at train_4k's length."""
    cfg = configs.get(LM_SERVE_ARCH)
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.dtype}, vocab "
          f"{cfg.vocab_size}, remat {cfg.remat}, {cfg.param_count():,} parameters")
    print(f"CUT: train_4k's global batch of 256 rows is a pod's; one card trains "
          f"{LM_TRAIN_BATCH} rows of {LM_TRAIN_SEQ} for {LM_TRAIN_STEPS} steps")
    model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = lm_train.train_loop(cfg, steps=LM_TRAIN_STEPS, batch_size=LM_TRAIN_BATCH,
                                  seq_len=LM_TRAIN_SEQ, ckpt_dir=str(tmp / "a"), log_every=1,
                                  seed=SEED, device=LM_DEVICE, model=model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    table = cfg.vocab_size ** 2 * 4             # the bigram stream's cumulative table
    losses = metrics["losses"]
    check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")
    moved = finite = 0
    for k, p in model.named_parameters():
        finite += bool(torch.isfinite(p.float()).all())
        moved += not torch.equal(p, before[k])
    n = len(before)
    check(finite == n and moved == n, f"{finite}/{n} parameters finite, {moved}/{n} moved")
    ms = metrics["ms_per_step"]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = _train_flops(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    print(f"train {cfg.name} batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, {LM_TRAIN_STEPS} AdamW "
          f"steps: {ms:.3f} ms a step after the first, {tokens / ms * 1e3:.1f} tokens/s, "
          f"model {flops / ms / 1e9:.2f} TFLOP/s ({flops / 1e12:.2f} TFLOP a step) against "
          f"the dense bf16 peak {BF16_PEAK_FLOPS_PER_S / 1e12:.0f} (share "
          f"{flops / (ms / 1e3) / BF16_PEAK_FLOPS_PER_S:.4f}); peak device bytes {peak:,} "
          f"(of them the bigram table {table:,}); losses {[round(x, 6) for x in losses]}; "
          f"{moved}/{n} parameters moved, all finite; the loop and its checkpoint "
          f"{wall:.3f} s ({card})")
    check(os.path.isdir(tmp / "a" / f"step_{LM_TRAIN_STEPS:08d}"), "no checkpoint at the end")
    shutil.rmtree(tmp / "a")
    t1 = time.perf_counter()
    # one more step with a fixed batch: under sync debug "error", then profiled
    opt = optim.AdamW(lr=3e-3)
    state = metrics["opt_state"]
    step_fn = steps_mod.make_train_step(cfg, opt)
    batch = _lm_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    with _NoSync():
        state, loss = step_fn(model, state, batch)
    check(bool(torch.isfinite(loss)), "the step under sync debug mode gave a non-finite loss")
    print("train step under sync debug mode error: no host read")
    box = [state]

    def step(_):
        box[0], _loss = step_fn(model, box[0], batch)

    _profile(step, 1, f"{cfg.name} train step, batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, "
                      f"remat ({card})")
    del model, before, box, state, batch, metrics
    _free()
    t2 = time.perf_counter()
    on = _remat_peak(models, steps_mod, optim, cfg, True)
    off = _remat_peak(models, steps_mod, optim, cfg, False)
    print(f"remat at batch {LM_TRAIN_BATCH} x {LM_REMAT_SEQ}: peak device bytes of a step "
          f"{on:,} on, {off:,} off ({off / on:.2f}x) ({card})")
    print(f"(a) seconds: the loop {wall:.3f}, the extra and profiled steps {t2 - t1:.3f}, remat "
          f"on and off {time.perf_counter() - t2:.3f}")
    check(on < off, f"remat did not lower peak bytes: {on} against {off}")


def lm_train_card_vs_cpu(configs, models, convert, optim, card):
    """(b) full width, depth 2, fp32: the card's loss, gradients and one AdamW
    update against the port's CPU path on the same weights."""
    cfg = _lm_cfg(configs, LM_SERVE_ARCH, 2, dtype="float32")
    model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
    cpu_model = convert.lm_params_from_numpy(cfg, convert.lm_params_to_numpy(model), device="cpu")
    batch = _lm_batch(cfg, LM_CHECK_BATCH, LM_CHECK_SEQ)
    loss, grads = _lm_grads(models, cfg, model, batch)
    cpu_loss, cpu_grads = _lm_grads(models, cfg, cpu_model, {k: v.cpu() for k, v in batch.items()})
    loss_err = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_err = max(_leaf_err(grads[k], cpu_grads[k]) for k in grads)
    worst = max(grads, key=lambda k: _leaf_err(grads[k], cpu_grads[k]))
    # one update on both from the CPU's gradients
    opt = optim.AdamW(lr=optim.cosine_schedule(3e-3, 2, 20))
    params, cpu_params = dict(model.named_parameters()), dict(cpu_model.named_parameters())
    state, cpu_state = opt.init(params), opt.init(cpu_params)
    state = opt.update({k: g.to(LM_DEVICE) for k, g in cpu_grads.items()}, state, params)
    cpu_state = opt.update(cpu_grads, cpu_state, cpu_params)
    errs = {f"{what} {k}": _leaf_err(a[k], b[k]) for k in params
            for what, a, b in (("param", params, cpu_params), ("m", state.m, cpu_state.m),
                               ("v", state.v, cpu_state.v))}
    upd = max(errs.values())
    print(f"train card vs CPU {cfg.name} fp32, {cfg.n_layers} layers, batch {LM_CHECK_BATCH} x "
          f"{LM_CHECK_SEQ}: loss {float(loss):.6f}, relative error {loss_err:.3e} against "
          f"{LM_LOSS_TOL}; gradients' worst error {grad_err:.3e} of the leaf's scale ({worst}) "
          f"against {LM_GRAD_TOL}; one AdamW update, params, m and v {upd:.3e} ({max(errs, key=errs.get)}) "
          f"against {LM_UPDATE_TOL} ({card})")
    check(loss_err <= LM_LOSS_TOL, f"loss parts by {loss_err}")
    check(grad_err <= LM_GRAD_TOL, f"gradient {worst} parts by {grad_err}")
    check(upd <= LM_UPDATE_TOL, f"the update parts by {upd}")
    del model, cpu_model, grads, cpu_grads, state, cpu_state
    _free()


def _train_losses(text: str) -> dict:
    """``{step: loss}`` of the ``[train] step N loss X`` lines (a later line of
    a step wins: the restarted child's)."""
    import re

    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"\[train\] step (\d+) loss ([-\d.]+)", text)}


def _module(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True, env=env,
                          timeout=EXAMPLE_TIMEOUT_S, cwd=ROOT)


def lm_train_drills(configs, lm_train, card, tmp: Path):
    """(d) the elastic drill and the watchdog on the card."""
    common = ["--arch", LM_SERVE_ARCH, "--steps", "24", "--ckpt-every", "8", "--log-every",
              "1", "--device", LM_DEVICE]
    t0 = time.perf_counter()
    out = _module("repro_torch.launch.elastic", *common, "--fault-at", "12",
                  "--ckpt-dir", str(tmp / "elastic"))
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"elastic exited {out.returncode}: {out.stderr[-2000:]}")
    check("[elastic] done: restarts 1" in out.stdout
          and "[train] resumed from step 8" in out.stdout, f"elastic: {out.stdout[-2000:]}")
    resumed = _train_losses(out.stdout)
    check(sorted(resumed) == list(range(24)), "a step's loss is missing")
    # the uninterrupted run in this process: the CLI's defaults on the smoke config
    want = lm_train.train_loop(configs.get_smoke(LM_SERVE_ARCH), steps=24, ckpt_every=8,
                               ckpt_dir=str(tmp / "whole"), device=LM_DEVICE,
                               verbose=False)["losses"]
    diff = max(abs(resumed[s] - want[s]) for s in range(8, 24))
    print(f"elastic drill on {LM_DEVICE}: {LM_SERVE_ARCH} smoke, 24 steps, checkpoints every 8, a "
          f"fault at step 12: restarts 1, resumed from step 8; the resumed steps' losses "
          f"against an uninterrupted run's: max |diff| {diff:.3e} against {LM_TRAJ_TOL} "
          f"({secs:.3f} s) ({card})")
    check(diff <= LM_TRAJ_TOL, f"the resumed losses part by {diff}")
    dog = _module("repro_torch.launch.train", "--arch", LM_SERVE_ARCH, "--smoke", "--steps",
                  "5", "--deadline", "1e-6", "--ckpt-dir", str(tmp / "dog"), "--device", LM_DEVICE)
    saved = sorted(p.name for p in (tmp / "dog").glob("step_*"))
    print(f"watchdog on {LM_DEVICE}: --deadline 1e-6 s: exit {dog.returncode}, checkpoints "
          f"{saved}, {dog.stdout.count('STRAGGLER')} straggler lines")
    check(dog.returncode == 75 and saved, f"watchdog: exit {dog.returncode}, {saved}")


def _lm_dist_child(rank, world, store, tmp, device):
    """A rank of phase 21 (e): two ranks on the card under gloo."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch import configs, models
    from repro_torch.launch import dist as dist_launch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.train import AdamW, compressed_psum, pipeline_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist_launch.init(device, rank=rank, world_size=world, init_method=f"file://{store}",
                           timeout_s=DIST_TIMEOUT_S)
    group = dist.group.WORLD
    out = {"backend": dist.get_backend(group)}
    try:
        cfg = dataclasses.replace(configs.get(LM_SERVE_ARCH), n_layers=2, dtype="float32")
        batch = _lm_batch(cfg, LM_DP_BATCH, LM_CHECK_SEQ, dev)
        runs = {}
        for name, g in (("ranks", group), ("one", None)):
            if name == "one" and rank:
                break
            model = models.init_lm(cfg, seed=SEED, device=dev)
            opt = AdamW(lr=3e-3)
            state = opt.init(dict(model.named_parameters()))
            fn = steps_mod.make_train_step(cfg, opt, group=g)
            state, loss = fn(model, state, batch)
            runs[name] = ({k: t.clone() for k, t in state.m.items()}, float(loss))
            _sync(dev)                       # a second step, warm, for its time
            t0 = time.perf_counter()
            fn(model, state, batch)
            _sync(dev)
            runs[name] += (time.perf_counter() - t0,)
        if rank == 0:
            (m2, l2, t2), (m1, l1, t1) = runs["ranks"], runs["one"]
            out.update(loss_err=abs(l2 - l1) / abs(l1), ms_ranks=t2 * 1e3, ms_one=t1 * 1e3,
                       grad_err=max(_leaf_err(m2[k], m1[k]) for k in m1))
        del runs
        # compressed_psum of this rank's own gradients against their exact mean
        part = {k: v[rank * LM_DP_BATCH // world:(rank + 1) * LM_DP_BATCH // world]
                for k, v in batch.items()}
        _, grads = _lm_grads(models, cfg, models.init_lm(cfg, seed=SEED, device=dev), part)
        mean, _ = compressed_psum(grads, None, group)
        worst = 0.0
        for k, g in grads.items():
            exact = g.float().clone()
            dist.all_reduce(exact, group=group)
            exact /= world
            step = g.float().abs().max().reshape(1)
            dist.all_reduce(step, op=dist.ReduceOp.MAX, group=group)
            step = max(float(step) / 127.0, 1e-12 / 127.0)
            worst = max(worst, float((mean[k] - exact).abs().max()) / step)
        out["psum_steps"] = worst
        # pipeline_forward over the ranks against the sequential loop
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        p = LM_PIPE
        ws = torch.randn((p["groups"], p["d"], p["d"]), generator=gen, device=dev) / p["d"] ** 0.5
        x = torch.randn((p["micro"], p["rows"], p["d"]), generator=gen, device=dev)
        body = lambda w, h: torch.tanh(h @ w)          # noqa: E731
        got = pipeline_forward(body, world, ws, x, group)
        want = x
        for i in range(p["groups"]):
            want = body(ws[i], want)
        out["pipe_err"] = float((got - want).abs().max())
    except Exception:
        import traceback

        out["error"] = traceback.format_exc()
    finally:
        (Path(tmp) / f"lm-rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def lm_train_two_ranks(card, tmp: Path):
    """(e) two ranks sharing the card under gloo: the data-parallel step,
    ``compressed_psum`` and ``pipeline_forward``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_lm_dist_child, args=(2, str(tmp / "lm-store"), str(tmp), LM_DEVICE),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_JOIN_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"phase 21 (e): the ranks did not finish in {DIST_JOIN_S} s")
    ranks = [json.loads((tmp / f"lm-rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        check("error" not in r, f"phase 21 (e): {r.get('error')}")
    r0 = ranks[0]
    print(f"two ranks on the card ({r0['backend']}): one data-parallel AdamW step of "
          f"{LM_SERVE_ARCH} at depth 2 (a CUT as in (b)), fp32, batch {LM_DP_BATCH} x "
          f"{LM_CHECK_SEQ} split 4/4: "
          f"{r0['ms_ranks']:.3f} ms a warm step on the ranks, {r0['ms_one']:.3f} ms in one "
          f"process; loss "
          f"{r0['loss_err']:.3e} and gradients {r0['grad_err']:.3e} of scale against one "
          f"process (tolerance {LM_DP_TOL}); compressed_psum within "
          f"{max(r['psum_steps'] for r in ranks):.3f} quantization steps of the exact mean; "
          f"pipeline_forward over 2 stages ({LM_PIPE}) against the sequential loop "
          f"{max(r['pipe_err'] for r in ranks):.3e} ({card})")
    check(r0["backend"] == "gloo", f"two ranks on one card ran {r0['backend']}")
    check(r0["loss_err"] <= LM_DP_TOL and r0["grad_err"] <= LM_DP_TOL, "the DP step parts")
    check(all(r["psum_steps"] <= 1.0 for r in ranks), "compressed_psum off by a step")
    check(all(r["pipe_err"] <= 1e-4 for r in ranks), "pipeline_forward parts")


def phase_lm_train(card, build_dir):
    import tempfile

    from repro_torch import configs, convert, models, train as optim
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as lm_train

    print(card)
    tmp = Path(tempfile.mkdtemp(prefix="lm-train-", dir=build_dir))
    try:
        t0 = time.perf_counter()
        lm_train_full(configs, models, lm_train, steps_mod, optim, card, tmp)
        t1 = time.perf_counter()
        lm_train_card_vs_cpu(configs, models, convert, optim, card)
        t2 = time.perf_counter()
        print(f"CUT: torch_train_lm runs {LM_EXAMPLE_STEPS} of its 300 steps (phase 22's time)")
        lines = run_example("torch_train_lm", ["--steps", str(LM_EXAMPLE_STEPS)])
        check(any(ln.startswith("OK: loss dropped") for ln in lines), "the example's loss")
        t3 = time.perf_counter()
        lm_train_drills(configs, lm_train, card, tmp)
        t4 = time.perf_counter()
        lm_train_two_ranks(card, tmp)
        t5 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 21 seconds: (a) {t1 - t0:.3f}, (b) {t2 - t1:.3f}, (c) {t3 - t2:.3f}, "
          f"(d) {t4 - t3:.3f}, (e) {t5 - t4:.3f}")

# phase 22: the language models on a DeviceMesh
MESH_BATCH, MESH_SEQ = 4, 1024          # (a): one card, bf16, remat on
MESH_CPU_BATCH, MESH_CPU_SEQ = 2, 64    # (b)-(d): two gloo ranks on the host, fp32
MESH_CPU_DEPTH = 2                       # (b)-(d): cut from 32 layers (a CUT: line)
MESH_TOL, MESH_SEQ_TOL = 1e-5, 1e-4     # (b) against one process; (d) the reference's gate


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _resident(params: dict, state) -> int:
    """Bytes a rank holds of the parameters and both AdamW moments."""
    from torch.distributed.tensor import DTensor

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    return sum(local(t).numel() * local(t).element_size()
               for t in [*params.values(), *state.m.values(), *state.v.values()])


def mesh_one_card(configs, models, specs, steps_mod, optim, mesh, card):
    """(a) the (1, 1) mesh under NCCL: a tp and an fsdp step of smollm_360m as
    published, each bit-equal to the unsharded step; ms a step of all three."""
    cfg = configs.get(LM_SERVE_ARCH)
    batch = _lm_batch(cfg, MESH_BATCH, MESH_SEQ)
    base = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
    weights = {k: p.detach().clone() for k, p in base.named_parameters()}
    del base
    runs = {}
    for name in ("unsharded", "tp", "fsdp"):
        model = models.LM(cfg, torch.device(LM_DEVICE))
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(weights[k])
        opt = optim.AdamW(lr=3e-3)
        if name == "unsharded":
            step = steps_mod.make_train_step(cfg, opt)
        else:
            specs.distribute_model(model, mesh, name)
            step = steps_mod.make_train_step(cfg, opt, mesh=mesh, strategy=name)
        params = dict(model.named_parameters())
        state, loss = step(model, opt.init(params), batch)
        whole = {k: (p.to_local() if name != "unsharded" else p).detach().clone()
                 for k, p in params.items()}
        loss = (loss if name == "unsharded" else loss.to_local()).clone()
        _sync(LM_DEVICE)
        t0 = time.perf_counter()
        state, _ = step(model, state, batch)
        _sync(LM_DEVICE)
        runs[name] = (loss, whole, (time.perf_counter() - t0) * 1e3)
        del model, params, state, step
        _free()
    loss0, p0, ms0 = runs["unsharded"]
    for name in ("tp", "fsdp"):
        loss, p, ms = runs[name]
        same = torch.equal(loss, loss0) and all(torch.equal(p[k], p0[k]) for k in p0)
        print(f"mesh (a) {name} on a (1, 1) mesh ({torch.distributed.get_backend()}, world 1), "
              f"{cfg.name} bf16, remat on, "
              f"batch {MESH_BATCH} x {MESH_SEQ}: loss {float(loss):.6f}, bit-equal to the "
              f"unsharded step in loss and all {len(p0)} updated parameters {same}; "
              f"{ms:.3f} ms a warm step against {ms0:.3f} unsharded ({card})")
        check(same, f"phase 22 (a): the {name} step parts from the unsharded one")
    del runs, weights
    _free()


def _gloo_cuda_child(rank, world, store):
    """Two gloo ranks on the card: one DTensor all-gather of a CUDA tensor."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    t = distribute_tensor(torch.ones(8, 8, device="cuda"), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    t.redistribute(mesh, [Replicate(), Replicate()])
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _mesh_cpu_cfg(configs):
    """(b)-(d)'s model: the served one at its widths, ``MESH_CPU_DEPTH`` layers, fp32."""
    return dataclasses.replace(configs.get(LM_SERVE_ARCH), dtype="float32",
                               n_layers=MESH_CPU_DEPTH)


def _mesh_child(rank, world, store, tmp, threads):
    """A rank of phase 22 (b)-(d): two gloo ranks on the host CPU."""
    sys.path.insert(0, str(ROOT / "src"))
    import math
    import zlib

    import torch.distributed as dist
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs, models
    from repro_torch.launch import dist as dist_launch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import specs
    from repro_torch.train import SGD

    torch.set_num_threads(threads)
    dist_launch.init("cpu", rank=rank, world_size=world, init_method=f"file://{store}",
                     timeout_s=DIST_TIMEOUT_S)
    out = {}
    try:
        cfg = _mesh_cpu_cfg(configs)
        batch = _lm_batch(cfg, MESH_CPU_BATCH, MESH_CPU_SEQ, "cpu")
        opt = SGD(lr=0.0)                        # leaves the weights, m is the gradient
        results = {}
        for name, shape, strategy, seq in (("tp", (1, 2), "tp", None),
                                           ("fsdp", (2, 1), "fsdp", None),
                                           ("seq", (1, 2), "tp", ("data",))):
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            c = dataclasses.replace(cfg, seq_shard_attn=seq)
            t0 = time.perf_counter()
            model = models.init_lm(c, seed=SEED, mesh=mesh, strategy=strategy)
            init_s = time.perf_counter() - t0
            params = dict(model.named_parameters())
            state = opt.init(params)
            t0 = time.perf_counter()
            state, loss = steps_mod.make_train_step(c, opt, mesh=mesh, strategy=strategy)(
                model, state, batch)
            step_s = time.perf_counter() - t0
            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            share = sum(p.numel() / math.prod(sizes[e] for e in spec if e is not None)
                        for p, spec in zip(params.values(),
                                           specs.param_specs(model, mesh, strategy).values()))
            results[name] = {"loss": float(loss.to_local()), "init_s": init_s,
                             "step_s": step_s, "bytes": _resident(params, state),
                             "spec_share": share / sum(p.numel() for p in params.values())}
            if name != "seq":
                results[name]["grads"] = {k: t.full_tensor() for k, t in state.m.items()}
            if name == "tp":                     # (c): written on this 1 x 2 mesh
                ckpt.save(str(Path(tmp) / "mesh-ckpt"), 1, {"params": params})
                crc = {k: zlib.crc32(p.full_tensor().detach().numpy().tobytes())
                       for k, p in params.items()}
            del model, params, state
        if rank == 0:
            model = models.init_lm(cfg, seed=SEED, device="cpu")
            params = dict(model.named_parameters())
            t0 = time.perf_counter()
            state, loss = steps_mod.make_train_step(cfg, opt)(model, opt.init(params), batch)
            one_s = time.perf_counter() - t0
            one_bytes = _resident(params, state)
            out.update(one_loss=float(loss), one_s=one_s, one_bytes=one_bytes, crc=crc,
                       n_params=sum(p.numel() for p in params.values()))
            for name in ("tp", "fsdp"):
                r = results[name]
                errs = {k: _leaf_err(r["grads"][k], state.m[k]) for k in state.m}
                worst = max(errs, key=errs.get)
                out[name] = {"loss_err": abs(r["loss"] - float(loss)) / abs(float(loss)),
                             "grad_err": errs[worst], "worst": worst,
                             "init_s": r["init_s"], "step_s": r["step_s"],
                             "bytes": r["bytes"], "spec_share": r["spec_share"]}
            out["seq"] = {"loss_diff": abs(results["seq"]["loss"] - results["tp"]["loss"]),
                          "step_s": results["seq"]["step_s"]}
        out["bytes"] = {name: results[name]["bytes"] for name in ("tp", "fsdp")}
    except Exception:
        import traceback

        out["error"] = traceback.format_exc()
    finally:
        (Path(tmp) / f"mesh-rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def _spawn_pair(fn, args, label: str):
    """Two ranks of ``fn``, started with one hash seed (``launch.mesh.make_mesh``
    refuses ranks that hash differently); their exit codes."""
    import torch.multiprocessing as mp

    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        ctx = mp.start_processes(fn, args=(2, *args), nprocs=2, join=False,
                                 start_method="spawn")
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = seed
    deadline = time.monotonic() + DIST_JOIN_S
    while True:
        try:
            if ctx.join(timeout=2.0):
                return [p.exitcode for p in ctx.processes]
        except Exception:                       # a child died: report its exit codes
            for p in ctx.processes:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
            return [p.exitcode for p in ctx.processes]
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"phase 22 {label}: the ranks did not finish in {DIST_JOIN_S} s")


def mesh_two_ranks(configs, card, tmp: Path):
    """(b) tp on 1 x 2 and fsdp on 2 x 1 against one process, with each rank's
    resident bytes against the specs' prediction; (d) seq_shard_attn."""
    codes = _spawn_pair(_gloo_cuda_child, (str(tmp / "probe-store"),), "(b) probe")
    print(f"mesh (b) two gloo ranks on the card, one DTensor all-gather of a CUDA tensor "
          f"(torch {torch.__version__}): exit codes {codes} (a negative code is the signal "
          f"that ended the rank); the ranks below lay the model out on the host's CPU mesh")
    cfg = configs.get(LM_SERVE_ARCH)
    print(f"CUT: phase 22 (b)-(d) run {cfg.name} at its published widths, {MESH_CPU_DEPTH} of "
          f"its {cfg.n_layers} layers, in fp32 on two gloo ranks of the host, batch "
          f"{MESH_CPU_BATCH} x {MESH_CPU_SEQ}")
    codes = _spawn_pair(_mesh_child, (str(tmp / "mesh-store"), str(tmp),
                                      max(1, (os.cpu_count() or 2) // 2)), "(b)")
    ranks = [json.loads((tmp / f"mesh-rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        check("error" not in r, f"phase 22 (b): {r.get('error')}")
    check(codes == [0, 0], f"phase 22 (b): exit codes {codes}")
    r0, one = ranks[0], ranks[0]["one_bytes"]
    for name, shape in (("tp", "1 x 2"), ("fsdp", "2 x 1")):
        r = r0[name]
        shares = [rk["bytes"][name] / one for rk in ranks]
        print(f"mesh (b) {name} on a {shape} mesh, {cfg.name} fp32 ({r0['n_params']:,} "
              f"parameters), batch {MESH_CPU_BATCH} x {MESH_CPU_SEQ}: loss {r['loss_err']:.3e} "
              f"and gradients {r['grad_err']:.3e} of scale ({r['worst']}) against one process "
              f"(tolerance "
              f"{MESH_TOL}); resident bytes of parameters and moments a rank "
              f"{[rk['bytes'][name] for rk in ranks]} against {one:,} in one process: share "
              f"{[round(x, 4) for x in shares]}, the specs' "
              f"{r['spec_share']:.4f}; the sharded draw {r['init_s']:.3f} s, the step "
              f"{r['step_s']:.3f} s on the host (its first DTensor call) against "
              f"{r0['one_s']:.3f} s in one process")
        check(r["loss_err"] <= MESH_TOL and r["grad_err"] <= MESH_TOL, f"phase 22 (b) {name}")
        check(all(abs(x - r["spec_share"]) <= 1e-9 for x in shares),
              f"phase 22 (b) {name}: resident share {shares}, the specs' {r['spec_share']}")
    d = r0["seq"]["loss_diff"]
    print(f"mesh (d) seq_shard_attn=('data',) on the 1 x 2 mesh: loss against the same step "
          f"without it {d:.3e} (tolerance {MESH_SEQ_TOL}); the step {r0['seq']['step_s']:.3f} s")
    check(d <= MESH_SEQ_TOL, "phase 22 (d): seq_shard_attn moves the loss")
    return r0["crc"]


def mesh_restore(configs, models, specs, ckpt, mesh, crc: dict, tmp: Path, card):
    """(c) the 1 x 2 mesh's checkpoint restored onto the card's (1, 1) mesh."""
    import zlib

    meta = models.LM(_mesh_cpu_cfg(configs), torch.device("meta"))
    shardings = specs.param_shardings(meta, mesh, "tp")
    target = {"params": {k: ckpt.ShapeDtype(tuple(p.shape), p.dtype)
                         for k, p in meta.named_parameters()}}
    t0 = time.perf_counter()
    step, tree = ckpt.restore_latest(str(tmp / "mesh-ckpt"), target,
                                     shardings={"params": shardings})
    secs = time.perf_counter() - t0
    got = {k: zlib.crc32(t.to_local().cpu().numpy().tobytes()) for k, t in tree["params"].items()}
    same = got == crc
    print(f"mesh (c) checkpoint written on the 1 x 2 mesh (step {step}), restored on the card's "
          f"(1, 1) mesh: {len(got)} leaves array-equal (crc32 of the bytes) {same}; the "
          f"restore {secs:.3f} s ({card})")
    check(same, "phase 22 (c): the restored checkpoint parts from the saved one")


def phase_lm_mesh(card, build_dir):
    import tempfile

    import torch.distributed as dist
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs, models, train as optim
    from repro_torch.launch import dist as dist_launch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import specs

    print(card)
    tmp = Path(tempfile.mkdtemp(prefix="lm-mesh-", dir=build_dir))
    dist_launch.init(LM_DEVICE, rank=0, world_size=1,
                     init_method=f"tcp://localhost:{_free_port()}", timeout_s=DIST_TIMEOUT_S)
    try:
        check(dist.get_backend() == ("nccl" if LM_DEVICE == "cuda" else "gloo"),
              f"phase 22 (a) ran {dist.get_backend()}")
        mesh = make_mesh((1, 1), ("data", "model"), device=LM_DEVICE)
        t0 = time.perf_counter()
        mesh_one_card(configs, models, specs, steps_mod, optim, mesh, card)
        t1 = time.perf_counter()
        crc = mesh_two_ranks(configs, card, tmp)
        t2 = time.perf_counter()
        mesh_restore(configs, models, specs, ckpt, mesh, crc, tmp, card)
        t3 = time.perf_counter()
    finally:
        dist_launch.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 22 seconds: (a) {t1 - t0:.3f}, (b) and (d) {t2 - t1:.3f}, (c) {t3 - t2:.3f}")

# phase 23: the planner against the card.  (b)'s cell is phase 22 (a)'s
# unsharded step; its tolerances and band are stated before the run (PERF.md)
PLAN_BATCH, PLAN_SEQ = MESH_BATCH, MESH_SEQ
PLAN_RESIDENT_TOL = 0.01          # planned resident bytes against memory_allocated, relative
PLAN_PEAK_BAND = (0.75, 1.10)     # planned peak / max_memory_allocated, both less the base
PLAN_BOUND_SHARE = 1.05           # the roofline's step_s / the measured warm step, at most
DRYRUN_TIMEOUT_S = 600
# (b)'s plan, in a child process of its own: a fake group of one rank and a
# cuda-typed (1, 1) mesh, the cell registered as a shape of PLAN_BATCH rows
_PLAN_CHILD = """
import json, sys, time
import torch
from repro_torch.configs import SHAPES, get
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh, start_fake_group
from repro_torch.launch.steps import lower_cell
arch, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
SHAPES["chip_smoke_train"] = dict(seq_len=seq, global_batch=batch, step="train")
start_fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
t0 = time.perf_counter()
cfg = get(arch)
rec, plan = lower_cell(cfg, "chip_smoke_train", mesh, strategy="tp")
roof = rl.analyze(rec, arch=arch, shape="chip_smoke_train", mesh=mesh, strategy="tp",
                  model_flops_global=rl.model_flops(cfg, "chip_smoke_train", SHAPES))
print("PLAN " + json.dumps(dict(flops=rec.flops, flops_fp32=rec.flops_fp32, arg=rec.arg_bytes,
                                 peak=rec.peak_bytes, proxy=rec.fused_bytes(), coll=rec.coll,
                                 step_s=roof.step_s, compute_s=roof.compute_s,
                                 memory_s=roof.memory_s, dominant=roof.dominant,
                                 allocated=torch.cuda.memory_allocated(),
                                 seconds=time.perf_counter() - t0)))
"""


def _tensor_meta(out) -> list:
    leaves = out if isinstance(out, (tuple, list)) else [out]
    return [(tuple(t.shape), t.dtype, tuple(t.stride())) for t in leaves
            if isinstance(t, torch.Tensor)]


def plan_card(card):
    """(a) the card's DeviceSpec."""
    name = card.split(",")[0].strip()
    spec = rl.device_spec(name)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"plan (a) {card}: DeviceSpec {spec}; total_memory {total:,}")
    check(total == spec.hbm_bytes, f"phase 23 (a): total_memory {total} is not the spec's "
          f"{spec.hbm_bytes}")
    return spec


def _child(args) -> subprocess.Popen:
    """A child process of the port (``python`` with ``args``), started now."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _finish(proc: subprocess.Popen, what: str):
    """A child's (exit code, stdout, stderr, seconds it took from now); killed
    past ``DRYRUN_TIMEOUT_S``."""
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        print(f"phase 23: {what} killed after {DRYRUN_TIMEOUT_S} s")
    return proc.returncode, out, err, time.perf_counter() - t0


def plan_lm_step(configs, models, steps_mod, optim, card, spec, child):
    """(b) smollm_360m's unsharded train step: planned on a cuda-typed (1, 1)
    fake mesh in ``child`` (started beforehand), then run for real."""
    from torch.utils.flop_counter import FlopCounterMode

    code, out, err, _ = _finish(child, "(b)'s plan")
    lines = [ln for ln in out.splitlines() if ln.startswith("PLAN ")]
    check(code == 0 and len(lines) == 1,
          f"phase 23 (b): the plan's child exited {code}: {err[-3000:]}")
    plan = json.loads(lines[0][5:])
    print(f"plan (b) {LM_SERVE_ARCH} batch {PLAN_BATCH} x {PLAN_SEQ} planned on a cuda (1, 1) fake "
          f"mesh in {plan['seconds']:.1f} s: flops {plan['flops']:.6e} (fp32 "
          f"{plan['flops_fp32']:.3e}), resident {plan['arg']:,} B, peak {plan['peak']:,} B, "
          f"bytes proxy {plan['proxy']:.4e}, collectives {plan['coll']}, step_s "
          f"{plan['step_s'] * 1e3:.3f} ms ({plan['dominant']}), device bytes the child "
          f"allocated {plan['allocated']}")
    check(plan["allocated"] == 0, "phase 23 (b): the plan allocated device memory")
    cfg = configs.get(LM_SERVE_ARCH)
    _free()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = models.init_lm(cfg, seed=SEED, device=LM_DEVICE)
    opt = optim.AdamW(lr=3e-3)
    params = dict(model.named_parameters())
    state = opt.init(params)
    toks = _lm_tokens(cfg, (PLAN_BATCH, PLAN_SEQ)).to(torch.int32)
    mask = torch.ones((PLAN_BATCH, PLAN_SEQ), dtype=torch.float32, device=LM_DEVICE)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1), "mask": mask}
    step = steps_mod.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    state, loss = step(model, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    with FlopCounterMode(display=False) as fc:
        state, loss = step(model, state, batch)
    torch.cuda.synchronize()
    flops = fc.get_total_flops()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, loss = step(model, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    rel = abs(plan["arg"] - resident) / resident
    ratio = plan["peak"] / peak
    share = plan["step_s"] * 1e3 / ms
    print(f"plan (b) against the card ({card}): FLOPs planned {plan['flops']:.6e} counted "
          f"{flops:.6e} equal {plan['flops'] == flops}; resident planned {plan['arg']:,} "
          f"allocated {resident:,} (rel {rel:.3e}, tol {PLAN_RESIDENT_TOL}); peak planned "
          f"{plan['peak']:,} max allocated {peak:,} (ratio {ratio:.4f}, band {PLAN_PEAK_BAND}); "
          f"step_s {plan['step_s'] * 1e3:.3f} ms against a warm step of {ms:.3f} ms (share "
          f"{share:.4f}, at most {PLAN_BOUND_SHARE}); loss {float(loss):.6f}")
    check(plan["flops"] == flops, "phase 23 (b): planned FLOPs differ from the real step's")
    check(rel <= PLAN_RESIDENT_TOL, f"phase 23 (b): resident bytes off by {rel}")
    check(PLAN_PEAK_BAND[0] <= ratio <= PLAN_PEAK_BAND[1],
          f"phase 23 (b): planned peak / real peak {ratio} outside {PLAN_PEAK_BAND}")
    check(share <= PLAN_BOUND_SHARE, f"phase 23 (b): the bound {plan['step_s']} s exceeds "
          f"the measured step {ms} ms: counts or constants are wrong")
    del model, params, state, batch, step
    _free()
    return dict(plan=plan, flops=flops, resident=resident, peak=peak, ms=ms)


def _planned_step(ops, fn, tensors):
    """Launch counts of ``fn(*fake copies of tensors)`` planned on fake tensors,
    and the fake outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import planned
    from repro_torch.launch.roofline import Counters

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = [fm.from_tensor(t) if isinstance(t, torch.Tensor) else t for t in tensors]
    planned.reset()
    counters = Counters(fm)
    with counters, fm:
        out = fn(*fakes)
    return {k: v for k, v in ops.planned_counts().items() if v}, counters.trace, out


def plan_svm(core, mc, ops, data, lookup_run, run_c, card):
    """(c) phase 4's binary lookup-wd step and run (c)'s fused class-axis step,
    each with the budget full: every kernel's fake outputs against its real
    ones, and the planned launches against the counters' delta."""
    from repro_torch.kernels import ref

    (xtr, ytr), _ = data
    dev = torch.device("cuda")
    run, st, cfg = lookup_run
    table = cfg.table().to(dev)
    xb = torch.as_tensor(xtr[:1], device=dev)
    yb = torch.as_tensor(ytr[:1], device=dev)
    check(int(st.count) == cfg.budget, "phase 23 (c): the binary state's budget is not full")
    mres, mst, mcfg = run_c
    mtab = mcfg.table().to(dev)
    check(int(mst.count.min()) == mcfg.binary.budget, "phase 23 (c): a class below budget")
    mx = torch.as_tensor(MC_XTR_PLAN[0], device=dev)
    my = torch.as_tensor(MC_XTR_PLAN[1], device=dev)
    cases = {
        "binary lookup-wd step (phase 4)": (
            lambda s, x, y: core.train_step(cfg, table, s, x, y), (st, xb, yb)),
        "fused class-axis step (run (c))": (
            lambda s, x, y: mc.train_step_multiclass(mcfg, mtab, s, x, y), (mst, mx, my)),
    }
    for label, (fn, (state, x, y)) in cases.items():
        leaves = [t for t in state if t is not None]
        names = [n for n, t in zip(state._fields, state) if t is not None]

        def rebuild(*ts, names=names, cls=type(state)):
            *ls, x, y = ts
            return cls(**dict(zip(names, ls)), **{n: None for n in cls._fields
                                                  if n not in names})

        planned_launches, trace, _ = _planned_step(
            ops, lambda *ts: fn(rebuild(*ts), *ts[-2:]), [*leaves, x, y])
        ops.reset_launch_counts()
        real = fn(state, x, y)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        print(f"plan (c) {label}, budget full: planned launches {planned_launches}, counted "
              f"{launched}, equal {planned_launches == launched}; planned flops "
              f"{trace.flops:.4e}, kernel work {trace.kernels} ({card})")
        check(planned_launches == launched, f"phase 23 (c): {label} planned {planned_launches} "
              f"launches, the card counted {launched}")
        del real
    # each kernel on these paths, its fake outputs against its real ones
    binary_pick = [st.alpha[None].contiguous(), st.kmat[0:1] if st.kmat is not None
                   else torch.rand(1, st.alpha.shape[0], device=dev),
                   st.count.reshape(1), torch.zeros(1, dtype=torch.int64, device=dev),
                   st.alpha[:1].contiguous()]
    kernels = {
        "rbf_matrix (thin, 1 x bank)": (lambda a, b: ops.rbf_matrix(a, b, cfg.gamma),
                                        [xb, st.sv_x]),
        "rbf_matrix (tiled, 8 x 8)": (lambda a: ops.rbf_matrix(a, a, MC_GAMMA), [mx]),
        "merge_pick": (lambda a, k, c, i, m: ops.merge_pick(a, k, c, i, m, table), binary_pick),
        "train_step": (lambda *t: ops.train_step(
            *t, mtab, budget=mcfg.binary.budget, lambda_=mcfg.binary.lambda_,
            gamma=mcfg.binary.gamma, batch_size=MC_BATCH),
            [mst.sv_x.clone(), mst.alpha.clone(), mst.kmat.clone(), mst.count.clone(),
             mst.step.clone(), mst.n_inserts.clone(), mst.n_merges.clone(), mx,
             torch.where(torch.arange(MC_CLASSES, device=dev)[:, None] == my[None, :], 1.0,
                         -1.0), ref.rbf_matrix(mx, mx, MC_GAMMA)]),
    }
    for name, (fn, ts) in kernels.items():
        _, _, fake_out = _planned_step(ops, fn, ts)
        real_out = fn(*ts)
        same = _tensor_meta(fake_out) == _tensor_meta(real_out)
        print(f"plan (c) {name}: fake outputs {_tensor_meta(fake_out)} equal the real ones' "
              f"shapes, dtypes and strides {same}")
        check(same, f"phase 23 (c): {name}'s fake outputs differ from its real ones")


DRYRUN_ARGS = (("--arch", LM_SERVE_ARCH, "--shape", "train_4k"), ("--arch", "svm_bsgd"))


def plan_dryrun(card, children, t_start):
    """(d) the dry-run CLI on the 16 x 16 production mesh: ``children``, one for
    each of ``DRYRUN_ARGS``, started at ``t_start``, each under its own timeout."""
    for args, child in zip(DRYRUN_ARGS, children):
        code, out, err, _ = _finish(child, f"dryrun {args}")
        lines = [ln for ln in out.splitlines() if ln.startswith(("[dryrun]", "  "))]
        print(f"plan (d) dryrun {' '.join(args)} ({card}): exit {code}, done "
              f"{time.perf_counter() - t_start:.1f} s after the phase's children started")
        for ln in lines:
            print(f"  {ln}")
        check(code == 0 and any(ln.startswith("[dryrun]") for ln in lines),
              f"phase 23 (d): dryrun {args} failed: {err[-3000:]}")


def phase_plan(card, core, mc, ops, data, lookup_run, run_c, mc_data):
    from repro_torch import configs, models, train as optim
    from repro_torch.launch import steps as steps_mod

    global MC_XTR_PLAN
    MC_XTR_PLAN = (mc_data[0][0][:MC_BATCH], mc_data[0][1][:MC_BATCH])
    # the three children (b's plan and d's two dry runs) run beside (b)'s and
    # (c)'s work on the card
    t0 = time.perf_counter()
    plan_child = _child(["-c", _PLAN_CHILD, LM_SERVE_ARCH, str(PLAN_BATCH), str(PLAN_SEQ)])
    dry = [_child(["-m", "repro_torch.launch.dryrun", *args]) for args in DRYRUN_ARGS]
    try:
        spec = plan_card(card)
        plan_lm_step(configs, models, steps_mod, optim, card, spec, plan_child)
        t1 = time.perf_counter()
        plan_svm(core, mc, ops, data, lookup_run, run_c, card)
        t2 = time.perf_counter()
        plan_dryrun(card, dry, t0)
        t3 = time.perf_counter()
    finally:
        for proc in (plan_child, *dry):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"phase 23 seconds: (a) and (b) {t1 - t0:.3f}, (c) {t2 - t1:.3f}, (d) {t3 - t2:.3f}, "
          f"whole {t3 - t0:.3f}")


MC_XTR_PLAN = None


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
    from repro_torch.core import budget as budget_mod
    from repro_torch.core import kernel_cache
    from repro_torch.core import multiclass as mc
    from repro_torch.core.lookup import default_table
    from repro_torch.data import make_blobs, make_blobs_multiclass, train_test_split
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("1 card"):
        card = phase_card()
    with Phase("2 build"):
        phase_build(_build)
    with Phase("3 kernels vs plain"):
        records = phase_kernels(ops, ref, _build, default_table())
    with Phase("7 class-axis kernels vs plain"):
        records.update(phase_class_kernels(ops, ref, default_table()))
    with Phase("11 train_step kernel vs plain"):
        records.update(phase_step_kernel(ops, ref, default_table()))
    with Phase("data"):
        data = adult_standin(make_blobs, train_test_split)
        print(f"ADULT stand-in: train {data[0][0].shape} test {data[1][0].shape}")
    with Phase("4 main path"):
        runs, counts = phase_main(core, ops, data)
    with Phase("5 card vs CPU replay"):
        phase_replay(core, data)
    with Phase("6 profile"):
        print(f"CUT: phase 6 profiles {PROFILE_STEPS} steps a window (cut from 300)")
        phase_profile(core, runs["lookup-wd"], "binary lookup-wd")
        phase_profile(core, runs["gss"], "binary gss")
        phase_profile(core, runs["gss"], "binary gss-precise (from the gss state)",
                      PRECISE_PROFILE_STEPS, method="gss-precise")
    with Phase("11 binary fused run"):
        binary_fused = phase_binary_fused(core, ops, data, runs["lookup-wd"][0]["accuracy"])
    with Phase("class-axis data"):
        mc_data = mnist_standin(make_blobs_multiclass)
    mc_runs = {}
    for run in ("a", "b"):
        with Phase(f"8 class-axis run ({run})"):
            mc_runs[run] = phase_class_run(mc, ops, kernel_cache, mc_data, run)
    with Phase("9 class-axis card vs CPU replay"):
        phase_class_replay(mc, kernel_cache, mc_data)
    with Phase("10 class-axis profile"):
        phase_class_profile(mc, mc_runs, mc_data)
    fused_runs = {}
    for run in ("c", "d"):
        with Phase(f"11 class-axis run ({run})"):
            fused_runs[run] = phase_class_run(mc, ops, kernel_cache, mc_data, run)
    with Phase("15 serving"):
        serve_records, serve_counts = phase_serve(core, ops, ref, mc, mc_data, fused_runs["c"])
        records.update(serve_records)
    with Phase("12 fused vs composed lockstep"):
        phase_lockstep(mc, kernel_cache, ref, mc_data)
    with Phase("13 fused step profile"):
        phase_fused_profile(core, mc, fused_runs, binary_fused, data, mc_data)
    with Phase("14 multi_merge_choose lockstep"):
        phase_choose_lockstep(mc, budget_mod, mc_data, mc_runs["b"])
    with Phase("16 streaming"):
        stream_counts = phase_stream(core, mc, ops, data, mc_data, card)
    with Phase("17 second solver"):
        records["bdca_ascent"], bdca_counts = phase_bdca(
            core, mc, ops, ref, data, mc_data, binary_fused[0]["accuracy"],
            mc_runs["a"][0]["accuracy"], card)
    with Phase("18 distributed"):
        dist_counts = phase_distributed(core, mc, ops, data, mc_data, fused_runs["c"], card)
    with Phase("19 examples"):
        phase_examples(card)
    with Phase("20 LM serving"):
        phase_lm(card)
    with Phase("21 LM training"):
        phase_lm_train(card, _build.BUILD_DIR)
    with Phase("22 LM on a device mesh"):
        phase_lm_mesh(card, _build.BUILD_DIR)
    with Phase("23 the planner against the card"):
        phase_plan(card, core, mc, ops, data, runs["lookup-wd"], fused_runs["c"], mc_data)

    # launches on the main paths: the binary runs of phase 4 (rbf_matrix,
    # merge_pick, gss_pick, and merge_scores and gss, now 0) and the
    # class-axis runs
    for name in ("merge_event", "merge_event_rounds"):
        counts[name] = mc_runs["a"][0]["launches"][name]
    for name in ("multi_merge_scores", "multi_merge_choose"):
        counts[name] = mc_runs["b"][0]["launches"][name]
    counts["train_step"] = (binary_fused[0]["launches"]["train_step"]
                            + sum(r[0]["launches"]["train_step"] for r in fused_runs.values()))
    counts["class_scores"] = serve_counts["class_scores"]
    counts["bdca_ascent"] = 0
    for name, n in stream_counts.items():     # phase 16's streamed paths
        counts[name] += n
    for name, n in bdca_counts.items():       # phase 17's bdca paths
        counts[name] += n
    for name, n in dist_counts.items():       # phase 18's ranks, every child's launches
        counts[name] += n
    meta = {
        "rbf_matrix": ("src/repro_torch/csrc/rbf_kernel.cu", "src/repro/kernels/rbf_kernel.py:57"),
        "merge_scores": ("src/repro_torch/csrc/merge_lookup.cu",
                         "src/repro/kernels/merge_lookup.py:65"),
        "merge_pick": ("src/repro_torch/csrc/merge_lookup.cu",
                       "src/repro/kernels/merge_lookup.py:65"),
        "gss": ("src/repro_torch/csrc/gss.cu", "src/repro/kernels/gss.py:48"),
        "gss_pick": ("src/repro_torch/csrc/gss.cu", "src/repro/kernels/gss.py:48"),
        "multi_merge_scores": ("src/repro_torch/csrc/merge_multi.cu",
                               "src/repro/kernels/merge_multi.py:68"),
        "multi_merge_choose": ("src/repro_torch/csrc/merge_multi.cu",
                               "src/repro/kernels/merge_multi.py:68"),
        "merge_event": ("src/repro_torch/csrc/merge_event.cu",
                        "src/repro/kernels/merge_event.py:193"),
        "merge_event_rounds": ("src/repro_torch/csrc/merge_event.cu",
                               "src/repro/kernels/merge_event.py:193"),
        "train_step": ("src/repro_torch/csrc/train_step.cu",
                       "src/repro/kernels/train_step.py:370"),
        "class_scores": ("src/repro_torch/csrc/class_scores.cu",
                         "src/repro/kernels/ops.py:103 and, on the serve path, "
                         "src/repro/kernels/rbf_kernel.py:57"),
        "bdca_ascent": ("src/repro_torch/csrc/bdca_ascent.cu", "src/repro/core/bdca.py:124"),
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
