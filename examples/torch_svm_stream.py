"""Streaming-epoch BSGD on the PyTorch/CUDA port: train over a chunked on-disk
dataset that never sits in memory whole, match the in-memory model, and
survive a mid-epoch kill.

    PYTHONPATH=src python examples/torch_svm_stream.py [--n 8192] [--chunk-rows 1024]

What it shows:
  1. the dataset is sharded into on-disk ``.npz`` chunks, at least
     ``--min-ratio`` (default 4) times larger than any single resident chunk;
  2. one streamed pass (``fit_stream`` over ``FileChunks``) equals the
     in-memory ``train_epoch`` on the same realized row order bit for bit
     (the port's streamed steps are the in-memory ones), with equal accuracy;
  3. a run killed mid-epoch (``max_chunks``) resumes from its every-2-chunks
     checkpoint and finishes bit for bit the uninterrupted run;
  4. streamed rows/sec.

Runs on the card; ``--device cpu`` runs it on the host.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import (BSGDConfig, accuracy, fit_stream, init_state, resolve_device,
                              train_epoch)
from repro_torch.data import (EpochKey, FileChunks, epoch_permutation, make_susy_like,
                              train_test_split, write_npz_chunks)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bit_equal(a, b) -> bool:
    return all((u is None and v is None) or torch.equal(u, v) for u, v in zip(a, b))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--chunk-rows", type=int, default=1024)
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--min-ratio", type=int, default=4,
                    help="dataset must be >= this many resident chunks")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = make_susy_like(np.random.default_rng(1), args.n)
    (xtr, ytr), (xte, yte) = train_test_split(x, y)
    cfg = BSGDConfig(budget=args.budget, lambda_=2e-5, gamma=2.0**-7,
                     batch_size=args.batch_size)

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_npz_chunks(os.path.join(tmp, "shards"), xtr, ytr, args.chunk_rows)
        source = FileChunks(paths)
        ratio = source.n_rows / max(source.chunk_lens)
        print(f"SUSY-like on disk: {source.n_rows} rows in {source.n_chunks} chunks of "
              f"<= {max(source.chunk_lens)} ({ratio:.1f}x larger than any resident chunk) "
              f"on {dev}")
        if ratio < args.min_ratio:
            raise SystemExit(f"dataset only {ratio:.1f}x a chunk (need >= {args.min_ratio})")

        # -- 1. streamed single pass ------------------------------------
        _sync(dev)
        t0 = time.perf_counter()
        st_stream = fit_stream(cfg, source, epochs=1, seed=0, device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        acc_stream = float(accuracy(st_stream, xte, yte, cfg.gamma, device=dev))
        print(f"  streamed:  time={dt:6.2f}s rows/sec={source.n_rows / dt:,.0f} "
              f"acc={acc_stream:.4f} SVs={int(st_stream.count)}")

        # -- 2. in-memory twin on the same realized order ----------------
        perm = epoch_permutation(source, EpochKey(0, 0))
        t0 = time.perf_counter()
        st_mem = train_epoch(cfg, cfg.table(), init_state(cfg, source.dim, device=dev),
                             xtr, ytr, perm, device=dev)
        _sync(dev)
        dt_mem = time.perf_counter() - t0
        acc_mem = float(accuracy(st_mem, xte, yte, cfg.gamma, device=dev))
        print(f"  in-memory: time={dt_mem:6.2f}s rows/sec={source.n_rows / dt_mem:,.0f} "
              f"acc={acc_mem:.4f}")
        if not _bit_equal(st_mem, st_stream) or acc_mem != acc_stream:
            raise SystemExit("streamed state differs from train_epoch on the same order")
        print("  state bit-equal to in-memory train_epoch on the same order")

        # -- 3. kill mid-epoch, resume from checkpoint ------------------
        ck = os.path.join(tmp, "ckpt")
        kill_after = source.n_chunks // 2 + 1
        fit_stream(cfg, source, epochs=1, seed=0, ckpt_dir=ck, ckpt_every=2,
                   max_chunks=kill_after, device=dev)        # "SIGKILL" after N chunks
        st_resumed = fit_stream(cfg, source, epochs=1, seed=0, ckpt_dir=ck, ckpt_every=2,
                                device=dev)                  # picks up the cursor
        if not _bit_equal(st_stream, st_resumed):
            raise SystemExit("resumed state differs from the uninterrupted run")
        print(f"  killed after {kill_after}/{source.n_chunks} chunks, resumed mid-epoch: "
              "final state bit-equal")


if __name__ == "__main__":
    main()
