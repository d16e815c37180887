"""Training driver: streamed budgeted-SVM training (``--arch svm_bsgd``).

The ``--arch svm_bsgd`` arm of ``repro.launch.train``: ``svm_stream_loop``
trains over a chunk source (a directory of ``.npz`` shards or a LIBSVM text
file) through the streaming drivers, with checkpoints, prefetch, retries and
the finite guard.  On one card, ``--svm-layout replicated`` runs
``fit_stream``'s chunk program and ``class`` runs ``fit_multiclass_stream``'s
(the reference holds its mesh loop to these single-device drivers).

    PYTHONPATH=src python -m repro_torch.launch.train --arch svm_bsgd \\
        --stream shards/ --svm-layout class --svm-classes 10 --ckpt-dir ck

It runs on the card; ``--device cpu`` runs it on the host (the CPU tests use
it).  The ``slots`` layout needs the distributed layer (ROADMAP.md Queue 1
item 11) and the language-model arms the LM scaffold (item 12); both raise
``NotImplementedError``.
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
                    device=None):
    """Streamed SVM training over any ``data.stream.ChunkSource`` on one device.

    ``layout="replicated"`` trains one binary problem (``fit_stream``),
    ``"class"`` ``n_classes`` one-vs-rest problems
    (``fit_multiclass_stream``); epoch shuffling, remainder carry,
    checkpoints every ``ckpt_every`` chunks and mid-epoch resume are the
    streaming drivers' contract.  ``prefetch``/``retry``/``guard_finite``/
    ``report``/``skip_chunks`` go to the driver as they are.

    Returns ``(state, cfg)``."""
    from ..core import (BSGDConfig, MulticlassSVMConfig, fit_multiclass_stream, fit_stream,
                        resolve_device)

    if layout == "slots":
        raise NotImplementedError(
            "--svm-layout slots shards the SV slots across devices: the distributed layer is "
            "not ported to repro_torch yet (ROADMAP.md Queue 1 item 11)")
    if layout not in ("replicated", "class"):
        raise ValueError(f"layout={layout!r} not in ('replicated', 'slots', 'class')")
    dev = resolve_device(device)
    bcfg = BSGDConfig(budget=budget, lambda_=lambda_, gamma=gamma, method=method,
                      batch_size=batch_size)
    kw = dict(epochs=epochs, seed=seed, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
              max_chunks=max_chunks, prefetch=prefetch, retry=retry,
              guard_finite=guard_finite, report=report, skip_chunks=skip_chunks, device=dev)
    if layout == "class":
        cfg = MulticlassSVMConfig(n_classes=n_classes, binary=bcfg)
        state = fit_multiclass_stream(cfg, source, **kw)
    else:
        cfg = bcfg
        state = fit_stream(cfg, source, **kw)
    if verbose:
        print(f"[train] svm stream done on {dev}: layout={layout} chunks={source.n_chunks} "
              f"rows={source.n_rows} sv_count={state.count.tolist()}", flush=True)
    return state, cfg


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
            f"--arch {args.arch}: the language-model training arms are not ported to "
            "repro_torch yet (ROADMAP.md Queue 1 item 12)")
    if not args.stream:
        raise SystemExit("--arch svm_bsgd needs --stream PATH")
    from ..data import ResilienceReport, RetryPolicy

    source = _open_stream(args.stream, chunk_rows=args.chunk_rows, n_features=args.n_features,
                          binary=args.svm_layout != "class")
    report = ResilienceReport() if args.retry or args.guard_finite else None
    retry = RetryPolicy(max_attempts=args.retry) if args.retry else None
    svm_stream_loop(source, layout=args.svm_layout, n_classes=args.svm_classes,
                    budget=args.svm_budget, batch_size=args.batch_size, epochs=args.epochs,
                    seed=args.seed, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    prefetch=args.prefetch, retry=retry, guard_finite=args.guard_finite,
                    report=report, device=args.device)
    if report is not None:
        print(f"[train] resilience: {report!r}")


if __name__ == "__main__":
    main()
