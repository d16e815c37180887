"""Training entry point: the language models' trainer and streamed budgeted-SVM training.

PyTorch counterpart of ``repro.launch.train``.

``--arch <lm>`` trains a language model (``train_loop``) on the port's
bigram stream (frames for the encoder) with AdamW and the cosine schedule,
under the reference's fault-tolerance contract:

  * checkpoints are atomic and keep-last-k (``repro_torch.checkpoint``), in
    the reference's names and layout (``{"params", "opt"}``), so either
    package resumes the other's; on start the trainer resumes from the
    newest complete one;
  * a per-step deadline flags stragglers; after ``max_strikes``
    consecutive overruns the trainer saves and exits with 75 (EX_TEMPFAIL)
    for its supervisor (``launch.elastic``) to restart it;
  * ``FAULT_AT_STEP`` crashes the process at that step (fault drills).

``--arch svm_bsgd`` is ``svm_stream_loop``: streamed SVM training over a
chunk source (a directory of ``.npz`` shards or a LIBSVM text file) through
the streaming loops, with checkpoints, prefetch, retries and the finite
guard; ``--svm-layout replicated`` or ``slots`` trains one binary problem
(``fit_stream``), ``class`` ``--svm-classes`` one-vs-rest problems
(``fit_multiclass_stream``).

On one process both arms train on one device; under ``torchrun`` every
rank joins a process group (``launch.dist``): the LM arm trains
data-parallel (``launch.steps.make_train_step``), the SVM arm runs the
layout's chunk program (``core.distributed``).  ``train_loop(cfg,
mesh=make_mesh((2, 4), ("data", "model")), strategy="tp" | "fsdp")``, called
alike on every rank, lays the model out on a ``DeviceMesh`` instead
(``sharding.specs``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m --smoke --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch svm_bsgd \\
        --stream shards/ --svm-layout class --svm-classes 10 --ckpt-dir ck
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch svm_bsgd --svm-layout slots --stream shards/

It runs on the card; ``--device cpu`` runs it on the host (the CPU tests use
it).
"""
from __future__ import annotations

import argparse
import glob
import os


EX_TEMPFAIL = 75


def _train_state(cfg, model, opt_state) -> dict:
    """The checkpoint tree, the reference's ``{"params", "opt"}`` layout, in
    host memory (the scanned layers are stacked there, not on the card).  A
    DTensor is gathered whole a leaf at a time, which every rank of its mesh
    must call."""
    from torch.distributed.tensor import DTensor

    from ..convert import lm_tree
    from ..train.optimizer import OptState

    def host(tensors):
        return lm_tree(cfg, {k: (t.detach().full_tensor() if isinstance(t, DTensor) else
                                 t.detach()).cpu() for k, t in tensors.items()})

    return {"params": host(dict(model.named_parameters())),
            "opt": OptState(step=opt_state.step.cpu(), m=host(opt_state.m),
                            v=host(opt_state.v))}


def _restore(ckpt_dir: str, step: int, cfg, model, opt_state):
    """Load ``step`` into ``model`` and ``opt_state`` in place; returns the
    state with the checkpoint's step counter.  A DTensor takes this rank's
    block of the stored tensor, at its own placements on its own mesh."""
    import torch
    from torch.distributed.tensor import DTensor

    from ..sharding.specs import from_full

    from .. import checkpoint as ckpt
    from ..convert import lm_flat, lm_tree
    from ..train.optimizer import OptState

    def spec(moments):
        shapes = {k: ckpt.ShapeDtype(tuple(t.shape), t.dtype) for k, t in moments.items()}
        return lm_tree(cfg, shapes, stack=lambda xs: ckpt.ShapeDtype((len(xs),) + xs[0].shape,
                                                                     xs[0].dtype))

    params = dict(model.named_parameters())
    target = {"params": spec(params),
              "opt": OptState(step=ckpt.ShapeDtype((), torch.int32), m=spec(opt_state.m),
                              v=spec(opt_state.v))}
    state = ckpt.load(ckpt_dir, step, target, device="cpu")
    with torch.no_grad():
        for have, tree in ((params, state["params"]), (opt_state.m, state["opt"].m),
                           (opt_state.v, state["opt"].v)):
            for k, t in lm_flat(cfg, tree).items():
                dst = have[k]
                dst.copy_(from_full(t, dst.device_mesh, dst.placements)
                          if isinstance(dst, DTensor) else t)
    return OptState(step=state["opt"].step.to(opt_state.step.device), m=opt_state.m,
                    v=opt_state.v)


def train_loop(cfg, *, steps: int = 100, batch_size: int = 8, seq_len: int = 128,
               ckpt_dir: str | None = None, ckpt_every: int = 25, lr: float = 3e-3,
               step_deadline_s: float | None = None, max_strikes: int = 3, log_every: int = 10,
               seed: int = 0, verbose: bool = True, schedule_total: int | None = None,
               device=None, group=None, model=None, batch_fn=None, mesh=None,
               strategy: str = "tp") -> dict:
    """Train ``cfg``'s model to ``steps`` steps; returns ``{"losses",
    "resumed_from", "final_loss", "bigram_floor", "model", "opt_state",
    "ms_per_step"}``.

    AdamW on the cosine schedule over ``schedule_total or steps`` (pass the
    whole job's length when running a leg of it, so an interrupted and
    resumed run sees the same schedule).  The model is ``init_lm(cfg,
    seed=seed)`` on ``device`` (default the card) unless ``model`` is given;
    step i's batch is ``batch_fn(i)`` when given, else drawn from the port's
    bigram stream (``frames_batch`` for the encoder) by a generator seeded
    from ``(seed + 1, i)``.  The loop reads the device only to log, at a
    deadline's check and at the end (``ms_per_step`` is the wall time a step
    after the first).  ``group``, a process group of W ranks each calling
    this alike, trains data-parallel; rank 0 alone writes checkpoints.

    ``mesh``, a ``DeviceMesh`` over every rank (each calling this alike),
    lays the model out by ``strategy`` (``"tp"`` or ``"fsdp"``,
    ``sharding.specs``): drawn a parameter at a time on the host and sharded
    (``init_lm(..., mesh=)``) unless ``model`` is given already laid out,
    the AdamW moments at the parameters' placements, each step's batch drawn
    whole on every rank and its rows sharded over the data axes
    (``make_train_step(..., mesh=)``), and a resume restoring the newest
    checkpoint onto this mesh, whichever mesh wrote it.  The device is the
    mesh's."""
    import time

    import torch
    import torch.distributed as dist

    from .. import checkpoint as ckpt
    from ..core import resolve_device
    from ..data.tokens import BigramStream, frames_batch, step_generator
    from ..models import init_lm
    from ..train.optimizer import AdamW, cosine_schedule
    from .steps import make_train_step

    if mesh is not None:
        if group is not None:
            raise ValueError("pass a process group or a mesh, not both")
        device, group = mesh.device_type, dist.group.WORLD
    dev = resolve_device(device)
    if model is None:
        model = init_lm(cfg, seed=seed, device=dev, mesh=mesh, strategy=strategy)
    else:
        have = next(model.parameters()).device
        if have.type != dev.type or dev.index not in (None, have.index):
            raise ValueError(f"model on {have}, training on {dev}")
        dev = have
    rank, world = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))
    total = schedule_total or steps
    opt = AdamW(lr=cosine_schedule(lr, warmup=min(20, total // 10 + 1), total=total))
    opt_state = opt.init(dict(model.named_parameters()))

    start_step, resumed_from = 0, None
    latest = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if latest is not None:
        opt_state = _restore(ckpt_dir, latest, cfg, model, opt_state)
        start_step = resumed_from = latest
        if verbose and rank == 0:
            print(f"[train] resumed from step {latest}", flush=True)

    def save(step):
        if mesh is not None or rank == 0:      # gathering a DTensor takes every rank
            state = _train_state(cfg, model, opt_state)
        if rank == 0:
            ckpt.save(ckpt_dir, step, state)

    step_fn = (make_train_step(cfg, opt, mesh=mesh, strategy=strategy) if mesh is not None
               else make_train_step(cfg, opt, group=group))
    frames = cfg.input_kind == "frames"
    stream = None if frames or batch_fn else BigramStream(cfg.vocab_size, seed=seed, device=dev)
    fault_at = int(os.environ.get("FAULT_AT_STEP", -1))
    losses, strikes = [], 0
    t_first = last = None
    for step in range(start_step, steps):
        if batch_fn is not None:
            batch = batch_fn(step)
        else:
            gen = step_generator(seed + 1, step, dev)
            batch = (frames_batch(gen, batch_size, seq_len, cfg.frame_dim, cfg.vocab_size)
                     if frames else stream.batch(gen, batch_size, seq_len))
        t0 = time.perf_counter()
        opt_state, loss = step_fn(model, opt_state, batch)
        losses.append(loss if mesh is None else loss.to_local())   # replicated: the whole value
        if step == fault_at:
            print(f"[train] FAULT INJECTION at step {step}", flush=True)
            os._exit(137)
        if step_deadline_s is not None and step > start_step:   # the first step warms up
            float(loss)
            over = torch.tensor(float(time.perf_counter() - t0 > step_deadline_s), device=dev)
            if world > 1:                      # every rank strikes together
                dist.all_reduce(over, op=dist.ReduceOp.MAX, group=group)
            if float(over):
                strikes += 1
                if rank == 0:
                    print(f"[train] STRAGGLER step {step}: {time.perf_counter() - t0:.2f}s > "
                          f"{step_deadline_s}s ({strikes}/{max_strikes})", flush=True)
                if strikes >= max_strikes:
                    if ckpt_dir:
                        save(step + 1)
                    raise SystemExit(EX_TEMPFAIL)
            else:
                strikes = 0
        if step == start_step or (verbose and step % log_every == 0):
            value = float(loss)                # waits for the step
            now = time.perf_counter()
            if verbose and rank == 0 and step % log_every == 0:
                span = ("first step" if last is None else
                        f"{(now - last[1]) / (step - last[0]) * 1e3:.1f} ms a step")
                print(f"[train] step {step} loss {value:.6f} ({span})", flush=True)
            t_first = now if step == start_step else t_first
            last = (step, now)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save(step + 1)
    values = torch.stack(losses).tolist() if losses else []       # waits for the last step
    ms_per_step = ((time.perf_counter() - t_first) / (len(values) - 1) * 1e3
                   if len(values) > 1 else None)
    if ckpt_dir:
        save(steps)
    if world > 1:
        dist.barrier(group)        # rank 0's last checkpoint is on disk before any rank returns
    return {"losses": values, "resumed_from": resumed_from,
            "final_loss": values[-1] if values else None,
            "bigram_floor": stream.bigram_entropy() if stream is not None else None,
            "model": model, "opt_state": opt_state, "ms_per_step": ms_per_step}


def svm_stream_loop(source, *, layout: str = "replicated", n_classes: int = 8, budget: int = 128,
                    batch_size: int = 8, method: str = "lookup-wd", gamma: float = 0.5,
                    lambda_: float = 1e-4, epochs: int = 1, seed: int = 0,
                    ckpt_dir: str | None = None, ckpt_every: int = 0,
                    max_chunks: int | None = None, prefetch: int = 0, verbose: bool = True,
                    retry=None, guard_finite: bool = False, report=None, skip_chunks=(),
                    device=None, group=None):
    """Streamed SVM training over any ``data.stream.ChunkSource``.

    ``layout="replicated"`` or ``"slots"`` trains one binary problem
    (``fit_stream``), ``"class"`` ``n_classes`` one-vs-rest problems
    (``fit_multiclass_stream``); epoch shuffling, remainder carry,
    checkpoints every ``ckpt_every`` chunks and mid-epoch resume are the
    streaming drivers' contract.  ``prefetch``/``retry``/``guard_finite``/
    ``report``/``skip_chunks`` go to the driver as they are.

    ``group``, a process group of W > 1 ranks, makes every rank (each calling
    this with the same arguments) run each chunk through ``layout``'s chunk
    program (``core.distributed.make_distributed_chunk_step``) on its part
    of the chunk's batch axis and of the state; the streaming driver holds the whole
    state on every rank between chunks (one gather a chunk), and rank 0
    alone writes the checkpoints.  With no group, or a world of 1, it is the
    single-device loop.

    Returns ``(state, cfg)``."""
    import torch.distributed as dist

    from ..core import (BSGDConfig, MulticlassSVMConfig, fit_multiclass_stream, fit_stream,
                        resolve_device)
    from ..core import distributed as dist_mod

    if layout not in dist_mod.LAYOUTS:
        raise ValueError(f"layout={layout!r} not in {dist_mod.LAYOUTS}")
    dev = resolve_device(device)
    bcfg = BSGDConfig(budget=budget, lambda_=lambda_, gamma=gamma, method=method,
                      batch_size=batch_size)
    is_class = layout == "class"
    cfg = MulticlassSVMConfig(n_classes=n_classes, binary=bcfg) if is_class else bcfg
    fit = fit_multiclass_stream if is_class else fit_stream
    kw = dict(epochs=epochs, seed=seed, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
              max_chunks=max_chunks, prefetch=prefetch, retry=retry,
              guard_finite=guard_finite, report=report, skip_chunks=skip_chunks, device=dev)
    rank, world = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))
    ran = layout
    if world == 1:
        state = fit(cfg, source, **kw)
    else:
        ran = dist_mod.resolve_layout(cfg, layout, world)
        kw["ckpt_every"] = ckpt_every if rank == 0 else 0     # rank 0 alone writes
        state = fit(cfg, source, chunk_fn=_distributed_chunks(cfg, group, layout, dev), **kw)
        dist.barrier(group)        # rank 0's last checkpoint is on disk before any rank returns
    if verbose and rank == 0:
        print(f"[train] svm stream done on {dev}: layout={ran} chunks={source.n_chunks} "
              f"rows={source.n_rows} sv_count={state.count.tolist()} ranks={world}", flush=True)
    return state, cfg


def _distributed_chunks(cfg, group, layout: str, dev):
    """The streaming drivers' ``chunk_fn`` of a distributed run: the whole state
    and the whole host chunk in, each rank's part through the layout's chunk
    program, the whole state out on every rank."""
    import torch

    from ..core import distributed as dist_mod
    from ..core.multiclass import MulticlassSVMConfig, check_labels

    is_class = isinstance(cfg, MulticlassSVMConfig)
    chunk = dist_mod.make_distributed_chunk_step(cfg, group, layout=layout)

    def chunk_fn(state, xc, yc):
        if is_class:
            check_labels(yc, cfg.n_classes)
        xc = dist_mod.shard_rows(torch.as_tensor(xc), group, dim=1)
        yc = dist_mod.shard_rows(torch.as_tensor(yc), group, dim=1)
        xc = xc.to(dev, torch.float32)
        yc = yc.to(dev, torch.int64 if is_class else torch.float32)
        part = chunk(dist_mod.shard_state(cfg, state, group, layout), xc, yc)
        return dist_mod.gather_state(cfg, part, group, layout)

    return chunk_fn


def _open_stream(path: str, *, chunk_rows: int, n_features: int | None, binary: bool):
    """A shard directory (``*.npz``) or a LIBSVM text file as a chunk source."""
    from ..data.stream import FileChunks, LibsvmChunks

    if os.path.isdir(path):
        shards = sorted(glob.glob(os.path.join(path, "*.npz")))
        if not shards:
            raise SystemExit(f"{path}: no .npz shards")
        return FileChunks(shards)
    return LibsvmChunks(path, chunk_rows, n_features, binary=binary)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (language-model arms)")
    ap.add_argument("--steps", type=int, default=100, help="language models: steps to train")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128, help="language models: tokens a row")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--deadline", type=float, default=None, metavar="SECONDS",
                    help="language models: a step's deadline; 3 overruns in a row save and "
                         "exit 75")
    ap.add_argument("--lr", type=float, default=3e-3, help="language models: peak learning rate")
    ap.add_argument("--log-every", type=int, default=10,
                    help="language models: log the loss every this many steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", default=None, metavar="PATH",
                    help="svm_bsgd: chunk source, a directory of .npz shards or a LIBSVM "
                         "text file")
    ap.add_argument("--svm-layout", default="replicated",
                    choices=("replicated", "slots", "class"))
    ap.add_argument("--svm-classes", type=int, default=8)
    ap.add_argument("--svm-budget", type=int, default=128)
    ap.add_argument("--chunk-rows", type=int, default=4096,
                    help="rows per chunk for LIBSVM streams")
    ap.add_argument("--n-features", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--prefetch", type=int, default=0, metavar="DEPTH",
                    help="svm_bsgd: load, assemble and copy the next DEPTH chunks on a "
                         "background thread while the device runs the current chunk")
    ap.add_argument("--retry", type=int, default=0, metavar="ATTEMPTS",
                    help="svm_bsgd: retry transient chunk-load failures up to ATTEMPTS times "
                         "(bounded backoff); chunks that exhaust retries are quarantined and "
                         "skipped, not fatal")
    ap.add_argument("--guard-finite", action="store_true",
                    help="svm_bsgd: per-chunk non-finite sentinel: roll back to the last good "
                         "state and skip the offending chunk instead of training on NaN/Inf")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    if args.arch != "svm_bsgd":
        _train_lm(args)
        return
    if not args.stream:
        raise SystemExit("--arch svm_bsgd needs --stream PATH")
    from ..data import ResilienceReport, RetryPolicy

    from . import dist as dist_launch

    source = _open_stream(args.stream, chunk_rows=args.chunk_rows, n_features=args.n_features,
                          binary=args.svm_layout != "class")
    report = ResilienceReport() if args.retry or args.guard_finite else None
    retry = RetryPolicy(max_attempts=args.retry) if args.retry else None
    device, group = args.device, None
    if "WORLD_SIZE" in os.environ:            # started by torchrun
        import torch.distributed as dist

        device, group = dist_launch.init(args.device), dist.group.WORLD
    try:
        svm_stream_loop(source, layout=args.svm_layout, n_classes=args.svm_classes,
                        budget=args.svm_budget, batch_size=args.batch_size, epochs=args.epochs,
                        seed=args.seed, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        prefetch=args.prefetch, retry=retry, guard_finite=args.guard_finite,
                        report=report, device=device, group=group)
    finally:
        dist_launch.shutdown()
    if report is not None:
        print(f"[train] resilience: {report!r}")


def _train_lm(args) -> None:
    from ..configs import get, get_smoke

    from . import dist as dist_launch

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    device, group, rank = args.device, None, 0
    if "WORLD_SIZE" in os.environ:            # started by torchrun
        import torch.distributed as dist

        device, group = dist_launch.init(args.device), dist.group.WORLD
        rank = dist.get_rank()
    try:
        metrics = train_loop(cfg, steps=args.steps, batch_size=args.batch_size,
                             seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every, step_deadline_s=args.deadline,
                             lr=args.lr, log_every=args.log_every, seed=args.seed,
                             device=device, group=group)
    finally:
        dist_launch.shutdown()
    if rank == 0:
        world = 1 if group is None else int(os.environ["WORLD_SIZE"])
        print(f"[train] done: {cfg.name} final loss {metrics['final_loss']:.6f} (bigram floor "
              f"{metrics['bigram_floor']}) ranks={world}", flush=True)


if __name__ == "__main__":
    main()
