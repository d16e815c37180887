"""Training driver: streamed budgeted-SVM training (``--arch svm_bsgd``).

The ``--arch svm_bsgd`` arm of ``repro.launch.train``: ``svm_stream_loop``
trains over a chunk source (a directory of ``.npz`` shards or a LIBSVM text
file) through the streaming drivers, with checkpoints, prefetch, retries and
the finite guard.  ``--svm-layout replicated`` or ``slots`` trains one binary
problem (``fit_stream``), ``class`` ``--svm-classes`` one-vs-rest problems
(``fit_multiclass_stream``).  On one process these are the single-device
drivers; under ``torchrun`` every rank runs the layout's chunk program
(``core.distributed``) over a process group (``launch.dist``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch svm_bsgd \\
        --stream shards/ --svm-layout class --svm-classes 10 --ckpt-dir ck
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch svm_bsgd --svm-layout slots --stream shards/

It runs on the card; ``--device cpu`` runs it on the host (the CPU tests use
it).  The language-model arms need the training half of the LM scaffold
(ROADMAP.md Queue 1 item 12) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import glob
import os


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
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
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
        raise NotImplementedError(
            f"--arch {args.arch}: language-model training (train_loop, the optimizer, the "
            "pipeline) is the training half of ROADMAP.md Queue 1 item 12 and is not ported "
            "yet; language models serve through repro_torch.launch.serve")
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


if __name__ == "__main__":
    main()
