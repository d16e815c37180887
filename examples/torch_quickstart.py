"""Quickstart on the PyTorch/CUDA port: a budgeted kernel SVM with the precomputed-lookup merge.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

Builds the 400x400 lookup tables (one-time), trains BSGD on a
non-linearly-separable problem under a budget of 40 support vectors, and
compares the paper's four budget-maintenance solvers.  Runs on the card;
``--device cpu`` runs it on the host.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import METHODS, BSGDConfig, accuracy, default_table, fit, resolve_device
from repro_torch.data import make_two_moons, train_test_split


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = make_two_moons(np.random.default_rng(0), args.n, noise=0.15)
    (xtr, ytr), (xte, yte) = train_test_split(x, y)
    print(f"two-moons: {xtr.shape[0]} train / {xte.shape[0]} test on {dev}")

    t0 = time.time()
    default_table()   # precompute h(m,kappa) / WD(m,kappa) once
    print(f"lookup tables built in {time.time() - t0:.2f}s (400x400, GSS eps=1e-10)")

    for method in METHODS:
        cfg = BSGDConfig(budget=40, lambda_=1e-4, gamma=2.0, method=method)
        t0 = time.time()
        st = fit(cfg, xtr, ytr, epochs=args.epochs, seed=0, device=dev)
        _sync(dev)
        dt = time.time() - t0
        acc = float(accuracy(st, xte, yte, cfg.gamma, device=dev))
        print(f"  {method:12s} acc={acc:.4f}  SVs={int(st.count)}/{cfg.budget} "
              f"merges={int(st.n_merges)}  time={dt:.2f}s")


if __name__ == "__main__":
    main()
