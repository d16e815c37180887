"""Restart supervisor: run the language-model trainer, restart it when it fails.

PyTorch counterpart of ``repro.launch.elastic``.  A child training process
that dies (a node failure, an injected fault, the straggler exit 75) is
started again and resumes from the newest atomic checkpoint.  A checkpoint
holds whole tensors, so the restart may use another world size
(``--devices N`` runs the child under ``torchrun --standalone
--nproc-per-node N``) and loads it the same: the reference's elastic
reshard.

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch smollm_360m \\
        --steps 60 --ckpt-dir ck --fault-at 30
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def supervise(cmd: list[str], *, max_restarts: int = 5, env_extra=None,
              verbose: bool = True) -> int:
    """Run ``cmd``; restart it on any non-zero exit, up to ``max_restarts``
    times.  ``env_extra`` (fault injections) goes to the first run only.
    Returns the number of restarts."""
    restarts = 0
    while True:
        env = dict(os.environ)
        if env_extra:
            env.update(env_extra)
            env_extra = None
        t0 = time.time()
        proc = subprocess.run(cmd, env=env)
        if proc.returncode == 0:
            if verbose:
                print(f"[elastic] child finished OK after {restarts} restarts", flush=True)
            return restarts
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(f"child kept failing ({restarts} restarts)")
        if verbose:
            print(f"[elastic] child exited rc={proc.returncode} after {time.time() - t0:.1f}s; "
                  f"restart {restarts}", flush=True)


def child_command(args) -> list[str]:
    """The trainer's command line for ``args`` (``main``'s options)."""
    train = ["-m", "repro_torch.launch.train", "--arch", args.arch, "--smoke",
             "--steps", str(args.steps), "--ckpt-dir", args.ckpt_dir,
             "--ckpt-every", str(args.ckpt_every), "--batch-size", str(args.batch_size),
             "--seq-len", str(args.seq_len), "--log-every", str(args.log_every)]
    if args.device:
        train += ["--device", args.device]
    if args.devices:
        return [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(args.devices)] + train
    return [sys.executable] + train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None,
                    help="restart with this many ranks under torchrun (elastic)")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the trainer's torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    env_extra = {"FAULT_AT_STEP": str(args.fault_at)} if args.fault_at is not None else None
    restarts = supervise(child_command(args), max_restarts=args.max_restarts,
                         env_extra=env_extra)
    print(f"[elastic] done: restarts {restarts}", flush=True)
    return restarts


if __name__ == "__main__":
    main()
