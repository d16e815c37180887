"""Serving driver: the budgeted SVM as a request server (``--arch svm_bsgd``).

The ``--arch svm_bsgd`` arm of ``repro.launch.serve``: ``serve_svm`` loads a
checkpoint in ``repro.checkpoint``'s format (``--model``; one the JAX
package wrote serves as well) or trains a small in-process model, pushes a
ragged request trace through a warmed ``core.predict.BatchQueue`` and
checks the queue's labels bit for bit against one direct ``predict_labels``
call on every run.  ``--bank-dtype bfloat16`` serves the bf16 bank.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch svm_bsgd --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch svm_bsgd \\
        --model ckpts/run1 --gamma 0.5 --bank-dtype bfloat16

It runs on the card.  ``--device cpu`` runs it on the host (the CPU tests
use it).  The train-while-serve arm (``--live``) and the language-model
arms are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse

import numpy as np


def serve_svm(*, model_dir: str | None = None, gamma: float = 0.5, bank_dtype: str | None = None,
              n_classes: int = 8, budget: int = 64, dim: int = 16, train_rows: int = 2048,
              rows: int = 4096, max_batch: int = 256, min_bucket: int = 8,
              top_k: int | None = None, seed: int = 0, device=None,
              verbose: bool = True) -> dict:
    """Serve a budgeted SVM: a batched request queue over the serve cell.

    Loads ``model_dir`` (a checkpoint directory holding an ``SVMState``
    under ``state``) or, without one, trains ``n_classes`` Gaussian blobs
    (numpy seed ``seed``) for one epoch in-process.  A ragged trace of
    ``rows`` request rows goes through a ``BatchQueue`` (``max_batch``-row
    microbatches, power-of-two pad buckets) and its labels are asserted
    bitwise equal to one direct ``predict_labels`` call.  ``top_k`` also
    serves the k best class ids and softmax probabilities of a sample and
    re-asserts that rank 1 is bitwise the argmax label.  Returns the stats
    dict (rows/s, p50/p99 microbatch latency, buckets, pad waste)."""
    from ..core import (MulticlassSVMConfig, drive_trace, export_model, fit_multiclass,
                        load_serve_model, predict_labels, predict_proba, ragged_trace_sizes,
                        resolve_device, top_k_labels)
    from ..data import make_blobs_multiclass

    dev = resolve_device(device)
    if model_dir:
        model = load_serve_model(model_dir, gamma, bank_dtype=bank_dtype, device=dev)
        if verbose:
            print(f"[serve] loaded {model_dir}: C={model.n_classes} "
                  f"slots={model.sv_x.shape[1]} dim={model.dim} bank={model.sv_x.dtype} "
                  f"sv_count={model.count.tolist()}")
    else:
        cfg = MulticlassSVMConfig.create(n_classes, budget=budget, lambda_=1e-3, gamma=gamma,
                                         batch_size=8)
        x, y = make_blobs_multiclass(np.random.default_rng(seed), train_rows, dim, n_classes,
                                     sep=2.5)
        state = fit_multiclass(cfg, x, y, epochs=1, seed=seed, device=dev)
        model = export_model(state, gamma, bank_dtype=bank_dtype)
        if verbose:
            print(f"[serve] trained in-process on {dev}: C={n_classes} budget={budget} "
                  f"dim={dim} bank={model.sv_x.dtype}")

    rng = np.random.default_rng(seed)
    req_x = rng.standard_normal((rows, model.dim)).astype(np.float32)
    result = drive_trace(model, req_x, ragged_trace_sizes(rows, max_batch, rng),
                         max_batch=max_batch, min_bucket=min_bucket)
    result.update(dim=model.dim, n_classes=model.n_classes, device=str(dev))
    if top_k:
        sample = req_x[:min(64, rows)]
        ids, vals = top_k_labels(model, sample, k=top_k)
        probs = predict_proba(model, sample).cpu().numpy()
        direct = predict_labels(model, sample)
        assert bool((ids[:, 0] == direct).all()), "top-1 of top_k_labels diverged from " \
                                                  "predict_labels"
        assert np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)
        result.update(top_k=int(top_k), top1_prob_mean=round(float(probs.max(axis=1).mean()), 4))
        if verbose:
            head = [(ids[i].tolist(), np.round(vals[i].cpu().numpy(), 3).tolist(),
                     round(float(probs[i].max()), 3)) for i in range(min(3, len(sample)))]
            print(f"[serve] top-{top_k} sample (ids, scores, p_top1): {head}; mean top-1 prob "
                  f"{result['top1_prob_mean']}; rank 1 == argmax labels (bitwise)")
    if verbose:
        print(f"[serve] {result['rows']} rows in {result['requests']} requests -> "
              f"{result['microbatches']} microbatches (buckets {result['bucket_counts']}, "
              f"{result['padded_rows']} pad rows)")
        print(f"[serve] {result['rows_per_s']} rows/s; batch latency p50={result['p50_ms']} ms "
              f"p99={result['p99_ms']} ms; queue == direct predict (bitwise)")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--model", default=None, metavar="CKPT_DIR",
                    help="svm_bsgd: checkpoint directory to serve (repro.checkpoint format)")
    ap.add_argument("--gamma", type=float, default=0.5,
                    help="svm_bsgd: RBF width the model was trained with")
    ap.add_argument("--bank-dtype", default=None, choices=(None, "float32", "bfloat16"),
                    help="svm_bsgd: the served SV bank's dtype")
    ap.add_argument("--rows", type=int, default=4096,
                    help="svm_bsgd: total request rows in the trace")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="svm_bsgd: microbatch rows per serve-cell call")
    ap.add_argument("--top-k", type=int, default=None, metavar="K",
                    help="svm_bsgd: also serve the K best class ids and softmax "
                         "probabilities of a sample (rank 1 re-asserted bitwise)")
    ap.add_argument("--live", action="store_true",
                    help="svm_bsgd: train while serving (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    if args.arch != "svm_bsgd":
        raise NotImplementedError(
            f"--arch {args.arch}: the language-model serving arms are not ported to "
            "repro_torch yet (ROADMAP.md Queue 1 item 12)")
    if args.live:
        raise NotImplementedError(
            "--live (train while serving) needs the streaming trainers, not ported to "
            "repro_torch yet (ROADMAP.md Queue 1 items 8 and 10)")
    if args.smoke:
        # the top-k drive defaults on only for the in-process 4-class model:
        # --model may be binary, where an unasked-for top_k would be an error
        kw = dict(rows=1024, max_batch=64, budget=32, train_rows=1024, n_classes=4,
                  bank_dtype=args.bank_dtype or "bfloat16",
                  top_k=args.top_k or (None if args.model else 3))
    else:
        kw = dict(rows=args.rows, max_batch=args.max_batch, bank_dtype=args.bank_dtype,
                  top_k=args.top_k)
    serve_svm(model_dir=args.model, gamma=args.gamma, seed=args.seed, device=args.device, **kw)


if __name__ == "__main__":
    main()
