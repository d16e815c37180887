"""Serve batched requests with a merge-budgeted KV cache, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_budgeted_kv_serve.py [--budget 64] [--device cuda|cpu]

The paper's precomputed merge applied to decode-time attention
(``repro_torch.core.budgeted_kv``): when the cache reaches its budget, the
two least costly entries of every (request, head) are MERGED with a lookup
of the SAME h(m, kappa) table, instead of one being evicted.  The
attention output of the merge policy and of the eviction baseline is held
against an exact full cache over a drifting key stream (numpy draws from a
seed).  Runs on the card; ``--device cpu`` runs it on the host.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import default_table, resolve_device
from repro_torch.core.budgeted_kv import init_kv_state, kv_append, kv_attend


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    table = default_table().to(dev)
    gamma = 1.0 / (2.0 * args.head_dim)        # RBF width matched to the q.k scale
    scale = 1.0 / args.head_dim ** 0.5
    rng = np.random.default_rng(args.seed)
    shape = (args.batch, 1, args.heads, args.head_dim)

    states = {p: init_kv_state(args.batch, args.budget, args.heads, args.head_dim,
                               torch.float32, device=dev) for p in ("merge", "evict")}
    full_k, full_v = [], []
    errs = {"merge": [], "evict": []}
    t0 = time.time()
    for t in range(args.steps):
        # a drifting key distribution (nearby keys merge gracefully)
        center = np.sin(np.arange(args.head_dim) * 0.1 + t * 0.02)
        k_new = torch.from_numpy((center + 0.3 * rng.standard_normal(shape)).astype(np.float32))
        v_new = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        k_new, v_new = k_new.to(dev), v_new.to(dev)
        for policy in states:
            states[policy] = kv_append(states[policy], k_new, v_new, gamma, table, policy=policy)
        full_k.append(k_new)
        full_v.append(v_new)

        if (t + 1) % 64 == 0:
            q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
            fk, fv = torch.cat(full_k, dim=1), torch.cat(full_v, dim=1)
            scores = torch.einsum("bqhd,bwhd->bhqw", q, fk) * scale
            out_f = torch.einsum("bhqw,bwhd->bqhd", torch.softmax(scores, dim=-1), fv)
            line = f"  t={t + 1:4d} cache={states['merge'].count:3d}/{args.budget}"
            for policy in ("merge", "evict"):
                out_b = kv_attend(states[policy], q, scale)
                rel = float(torch.linalg.norm(out_b - out_f)
                            / torch.clamp(torch.linalg.norm(out_f), min=1e-9))
                errs[policy].append(rel)
                line += f"  {policy}_err={rel:.4f}"
            print(line)

    print(f"done in {time.time() - t0:.1f}s on {dev}; cache memory = "
          f"{args.budget / args.steps:.1%} of full at t={args.steps}")
    m, e = errs["merge"][-1], errs["evict"][-1]
    print(f"final rel err: merge={m:.4f} evict={e:.4f} "
          f"(merge better by {100 * (e - m) / max(e, 1e-9):.1f}%)")
    if m > e + 1e-6:
        raise AssertionError(f"merging lost to eviction (paper claim): {m:.4f} > {e:.4f}")


if __name__ == "__main__":
    main()
