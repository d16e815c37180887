"""Serving: language-model prefill and decode, and the budgeted SVM
as a request server.

Two arms, as ``repro.launch.serve``:

  * language-model archs (``--arch smollm_360m`` and the other nine of
    ``configs.ARCH_NAMES``): ``serve`` draws seeded weights and prompt
    tokens, prefills, places the prefill cache at the start of a decode cache
    of ``prompt_len + gen + 1`` positions (a ring of the window for
    sliding-window archs) and decodes greedily, the argmax on the card and no
    host read a token (``generate``); it prints the prefill and decode times.
    ``--smoke`` serves the architecture's reduced config.  The encoder
    (``hubert_xlarge``) has no decode step and is refused: serve it with
    ``repro_torch.models.encode_step``.

        PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m
        PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m --smoke \\
            --batch 4 --prompt-len 32 --gen 32 --device cpu

  * ``--arch svm_bsgd``: ``serve_svm`` loads a checkpoint in
    ``repro.checkpoint``'s format (``--model``; one the JAX package wrote
    serves as well) or trains a small in-process model, pushes a ragged
    request trace through a warmed ``core.predict.BatchQueue`` and checks the
    queue's labels bit for bit against one direct ``predict_labels`` call on
    every run.  ``--bank-dtype bfloat16`` serves the bf16 bank.

        PYTHONPATH=src python -m repro_torch.launch.serve --arch svm_bsgd --smoke
        PYTHONPATH=src python -m repro_torch.launch.serve --arch svm_bsgd \\
            --model ckpts/run1 --gamma 0.5 --bank-dtype bfloat16

    ``--live`` is train-while-serve (``serve_svm_live``): a background
    ``fit_multiclass_stream`` publishes snapshots into a ``ModelBank`` while
    an ``AsyncBatchQueue`` serves a request trace over it; ``--faults SEED``
    adds the chaos drill (retries, quarantine, the finite guard, a supervised
    restart from a checkpoint).

        PYTHONPATH=src python -m repro_torch.launch.serve --arch svm_bsgd --smoke --live

Both arms run on the card.  ``--device cpu`` runs them on the host (the CPU
tests use it).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _wait(dev: torch.device) -> None:
    """Wait for the card at a timing boundary.  The wait is deliberate, so
    it is made with the sync debug mode off (a caller may run the decode loop
    under ``torch.cuda.set_sync_debug_mode("error")``)."""
    if dev.type == "cuda":
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize(dev)
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def _place(dst, src):
    """The prefill cache's tensor ``src`` at offset 0 of the decode cache's
    ``dst`` (the reference's ``place``): ``src`` itself where the shapes
    agree.  A prefill longer than a sliding-window ring does not fit."""
    if src.shape == dst.shape:
        return src
    if src.dim() != dst.dim() or src.shape[0] != dst.shape[0]:
        return dst
    if any(a > b for a, b in zip(src.shape, dst.shape)):
        raise ValueError(f"the prefill cache {tuple(src.shape)} does not fit the decode cache "
                         f"{tuple(dst.shape)}: a prompt longer than the sliding window")
    dst[tuple(slice(0, n) for n in src.shape)] = src.to(dst.dtype)
    return dst


def _cache_compatible(cache, pf_cache) -> bool:
    """Whether the prefill cache has the decode cache's structure."""
    return (pf_cache is not None and len(pf_cache) == len(cache)
            and all(a.keys() == b.keys() for a, b in zip(cache, pf_cache)))


def generate(cfg, model, tokens, gen: int, *, greedy: bool = True, timings: dict | None = None,
             logits: list | None = None):
    """Prefill ``tokens`` (B, P) and decode ``gen`` tokens greedily.

    The decode cache holds ``P + gen + 1`` positions with the prefill cache
    placed at 0; the position is a 0-d tensor on the model's device and the
    argmax stays there, so the loop reads nothing from the device.  Returns
    the (B, gen + 1) tokens: the prefill's argmax (the prompt's last token
    when not ``greedy``) and each step's.  ``timings`` receives
    ``prefill_s`` and ``decode_s`` (host clock, the card waited for at both
    ends); ``logits`` receives the prefill's last logits and each step's
    (B, V), left on the device."""
    from ..models import decode_step, init_cache, prefill

    dev = tokens.device
    batch, prompt_len = tokens.shape
    with torch.no_grad():
        _wait(dev)
        t0 = time.perf_counter()
        last, pf_cache = prefill(cfg, model, tokens)
        _wait(dev)
        t_prefill = time.perf_counter() - t0

        cache = init_cache(cfg, batch, prompt_len + gen + 1, device=dev)
        compatible = _cache_compatible(cache, pf_cache)
        if compatible:
            cache = [{k: _place(c[k], p[k]) for k in c} for c, p in zip(cache, pf_cache)]
        cur = (torch.argmax(last, dim=-1)[:, None].to(torch.int32) if greedy
               else tokens[:, -1:])
        out, seen = [cur], [last]
        pos = torch.full((), prompt_len if compatible else 0, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for _ in range(gen):
            last, cache = decode_step(cfg, model, cache, cur, pos)
            cur = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
            out.append(cur)
            seen.append(last)
            pos = pos + 1
        _wait(dev)
        t_decode = time.perf_counter() - t0
    if timings is not None:
        timings.update(prefill_s=t_prefill, decode_s=t_decode)
    if logits is not None:
        logits.extend(seen)
    return torch.cat(out, dim=1)


def serve(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 32, seed: int = 0,
          greedy: bool = True, verbose: bool = True, device=None, stats: dict | None = None):
    """Serve a language model: seeded weights (``models.init_lm``) and prompt
    tokens (ids below ``vocab_size``, from a ``torch.Generator`` on the device
    seeded with ``seed``), then ``generate``; nothing is copied from the host,
    so the whole call runs under ``torch.cuda.set_sync_debug_mode("error")``.  Returns the (batch, gen + 1) tokens; ``stats`` receives
    ``prefill_ms``, ``decode_ms_per_token`` and ``tokens_per_s`` (batch
    tokens a second of decode)."""
    from ..core import resolve_device
    from ..models import init_lm

    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is an encoder and has no decode step; run it with "
                         "repro_torch.models.encode_step")
    dev = resolve_device(device)
    model = init_lm(cfg, seed=seed, device=dev)
    draw = torch.Generator(device=dev)
    draw.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=draw, device=dev)
    timings: dict = {}
    out = generate(cfg, model, toks, gen, greedy=greedy, timings=timings)
    ms_tok = timings["decode_s"] / max(gen, 1) * 1e3
    result = dict(prefill_ms=timings["prefill_s"] * 1e3, decode_ms_per_token=ms_tok,
                  tokens_per_s=batch * gen / timings["decode_s"] if gen else 0.0)
    if stats is not None:
        stats.update(result)
    if verbose:
        print(f"[serve] {cfg.name} on {dev}: prefill {batch}x{prompt_len}: "
              f"{result['prefill_ms']:.1f} ms; decode {gen} steps: "
              f"{timings['decode_s'] * 1e3:.1f} ms ({ms_tok:.2f} ms/tok incl. dispatch, "
              f"{result['tokens_per_s']:.1f} tokens/s)")
    return out


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


# the final snapshot's bitwise gate re-serves at most this many of the
# trace's first rows (its direct call holds (rows, C * slots) kernel values)
LIVE_CHECK_ROWS = 16_384


def live_problem(*, n_classes: int = 4, budget: int = 32, dim: int = 16, gamma: float = 0.5,
                 train_rows: int = 4096, chunk_rows: int = 512, seed: int = 0):
    """The ``--live`` arm's trainer config and chunk source: ``n_classes``
    Gaussian blobs (numpy seed ``seed``) in ``chunk_rows``-row chunks,
    batch ``min(64, chunk_rows)``, no kernel cache, composed maintenance."""
    from ..core import MulticlassSVMConfig
    from ..data import ArrayChunks, make_blobs_multiclass

    cfg = MulticlassSVMConfig.create(n_classes, budget=budget, lambda_=1e-3, gamma=gamma,
                                     batch_size=min(64, chunk_rows))
    x, y = make_blobs_multiclass(np.random.default_rng(seed), train_rows, dim, n_classes,
                                 sep=2.5)
    return cfg, ArrayChunks(x, y, chunk_rows=chunk_rows)


def serve_svm_live(*, gamma: float = 0.5, bank_dtype: str | None = None, n_classes: int = 4,
                   budget: int = 32, dim: int = 16, train_rows: int = 4096,
                   chunk_rows: int = 512, epochs: int = 2, publish_every: int = 2,
                   rows: int = 4096, max_batch: int = 64, min_bucket: int = 8, seed: int = 0,
                   verbose: bool = True, faults=None, retry=None, ckpt_dir: str | None = None,
                   ckpt_every: int = 0, max_restarts: int = 2, report=None,
                   device=None) -> dict:
    """Train-while-serve: a background trainer hot-swaps the model mid-trace.

    ``fit_multiclass_stream(bank=..., publish_every=...)`` runs on a
    background thread (``prefetch=2``: chunk staging on its own worker),
    publishing an immutable ``ServeModel`` snapshot into a ``ModelBank``
    every ``publish_every`` chunks, while the foreground replays a ragged
    request trace of ``rows`` rows through an ``AsyncBatchQueue`` over the
    bank: every published version is picked up at the next microbatch, no
    drain, no pause.  The problem is ``live_problem``'s.  The whole trace is
    submitted at once, as the reference does.  Returns the serve stats plus
    the version histogram (``versions: {version: microbatches}``) and
    ``published_during_trace`` (snapshots the trainer published while the
    trace ran), then serves the trace's first rows (at most
    ``LIVE_CHECK_ROWS``) against the FINAL snapshot, whose queue labels are
    asserted bitwise one direct call's.

    Trainer and server share one Python process.  On the card the trainer
    runs on a stream of its own and replays its chunk programs from CUDA
    graphs (``cuda_graph=True``): it needs the interpreter lock a few times
    a group of steps, not at every kernel, so a dispatcher kept busy by the
    trace does not starve it, and its device work runs beside the server's
    instead of queueing ahead of it; each snapshot is published once it is
    computed (``bsgd._make_publish``).

    Resilience (DESIGN.md §16): ``faults`` (a ``data.FaultSchedule``) wraps
    the chunk source in ``FaultyChunks`` and arms the recovery stack:
    retries (``retry`` defaults to ``RetryPolicy()``), the finite guard and
    checkpoints (``ckpt_dir`` defaults to a temporary directory,
    ``ckpt_every`` to ``publish_every``).  A SUPERVISOR wraps the trainer: a
    crash leaves serving up on the last published version and restarts the
    trainer (up to ``max_restarts``) from the newest verifiable checkpoint.
    The final snapshot is asserted finite, and the result carries
    ``restarts``/``retries``/``quarantined``/``rollbacks``."""
    import tempfile
    import threading

    from ..core import (ModelBank, drive_trace, fit_multiclass_stream, ragged_trace_sizes,
                        resolve_device)
    from ..data import FaultyChunks, ResilienceReport, RetryPolicy

    dev = resolve_device(device)
    cfg, source = live_problem(n_classes=n_classes, budget=budget, dim=dim, gamma=gamma,
                               train_rows=train_rows, chunk_rows=chunk_rows, seed=seed)
    report = report if report is not None else ResilienceReport()
    tmp_ckpt = None
    if faults is not None:
        source = FaultyChunks(source, faults)
        retry = retry if retry is not None else RetryPolicy()
        if ckpt_dir is None:
            tmp_ckpt = tempfile.TemporaryDirectory(prefix="serve_live_ckpt_")
            ckpt_dir = tmp_ckpt.name
        if not ckpt_every:
            ckpt_every = publish_every
    bank = ModelBank()
    fail: list[BaseException] = []

    def trainer() -> None:
        attempts = 0
        while True:
            try:
                fit_multiclass_stream(cfg, source, epochs=epochs, seed=seed, prefetch=2,
                                      bank=bank, publish_every=publish_every,
                                      publish_dtype=bank_dtype, ckpt_dir=ckpt_dir,
                                      ckpt_every=ckpt_every, retry=retry, report=report,
                                      guard_finite=faults is not None, cuda_graph=True,
                                      device=dev)
                return
            except Exception as e:  # noqa: BLE001 — supervised: counted, restarted
                attempts += 1
                if attempts > max_restarts:
                    fail.append(e)   # re-raised on the main thread
                    return
                # serving stays up on the last published version; the next
                # attempt resumes from the newest verifiable checkpoint
                report.note_restart()
                if verbose:
                    print(f"[serve --live] trainer crashed ({e!r}); restart "
                          f"{attempts}/{max_restarts} from checkpoint")

    def trainer_on_its_stream() -> None:
        with torch.cuda.stream(torch.cuda.Stream(dev) if dev.type == "cuda" else None):
            trainer()

    # the trace is drawn before training starts, so serving begins at the
    # first snapshot
    rng = np.random.default_rng(seed)
    req_x = rng.standard_normal((rows, dim)).astype(np.float32)
    sizes = ragged_trace_sizes(rows, max_batch, rng)
    t = threading.Thread(target=trainer_on_its_stream, daemon=True, name="live-trainer")
    t.start()
    try:
        bank.wait(1, timeout=600.0)           # the first snapshot before serving
        first = bank.version
        result = drive_trace(bank, req_x, sizes, max_batch=max_batch, min_bucket=min_bucket,
                             queue="async")
        result["published_during_trace"] = bank.version - first
        t.join(timeout=1800.0)
        if t.is_alive():
            raise RuntimeError("background trainer did not finish within 1800 s")
        if fail:
            raise RuntimeError(f"background trainer failed past {max_restarts} "
                               "restarts") from fail[0]
    finally:
        if tmp_ckpt is not None:
            t.join(timeout=60.0)
            tmp_ckpt.cleanup()
    final_version, final_model = bank.current()
    for name in ("sv_x", "alpha"):
        if not bool(torch.isfinite(getattr(final_model, name).float()).all()):
            raise AssertionError(f"published ServeModel.{name} contains non-finite values — "
                                 "the publish guard failed")
    # the final snapshot as a fixed model: drive_trace asserts queue == direct
    n_check = int(np.searchsorted(np.cumsum(sizes), min(rows, LIVE_CHECK_ROWS), side="right"))
    check = drive_trace(final_model, req_x, sizes[:max(n_check, 1)], max_batch=max_batch,
                        min_bucket=min_bucket, queue="async")
    result.update(dim=dim, n_classes=n_classes, device=str(dev), final_version=final_version,
                  final_check_rows=check["rows"], restarts=report.restarts,
                  retries=report.retries, quarantined=report.quarantined_chunks(),
                  rollbacks=len(report.rollbacks))
    if verbose:
        print(f"[serve --live] {result['rows']} rows while training on {dev} "
              f"({result['microbatches']} microbatches); versions served: "
              f"{result.get('versions')} (final v{final_version}; "
              f"{result['published_during_trace']} published during the trace)")
        print(f"[serve --live] {result['rows_per_s']} rows/s; p50={result['p50_ms']} ms "
              f"p99={result['p99_ms']} ms; pad waste {result['pad_waste_frac']}; final "
              f"snapshot queue == direct predict (bitwise) on {check['rows']} rows")
        if faults is not None:
            print(f"[serve --live] resilience: {report!r}; final snapshot finite "
                  "(guarded publish)")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="svm_bsgd or a language model of repro_torch.configs.ARCH_NAMES")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="language models: prompts")
    ap.add_argument("--prompt-len", type=int, default=32, help="language models: prompt tokens")
    ap.add_argument("--gen", type=int, default=32, help="language models: tokens decoded")
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
                    help="svm_bsgd: train-while-serve: a background fit_multiclass_stream "
                         "publishes snapshots into a ModelBank every K chunks while an "
                         "AsyncBatchQueue serves the trace, hot-swapping mid-flight")
    ap.add_argument("--publish-every", type=int, default=2, metavar="K",
                    help="svm_bsgd --live: chunks between snapshots")
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="svm_bsgd --live: chaos drill: inject FaultSchedule.chaos(SEED) "
                         "(transient IO errors, stalls, a NaN chunk, a fatal chunk, a trainer "
                         "crash) and run the recovery stack: retries, quarantine, guarded "
                         "publish, supervised restart from a checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    if args.arch != "svm_bsgd":
        from ..configs import get, get_smoke

        if args.live or args.model:
            raise ValueError(f"--arch {args.arch}: --live and --model are svm_bsgd options")

        cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
        serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
              device=args.device)
        return
    if args.live:
        faults = None
        if args.faults is not None:
            from ..data import FaultSchedule
            faults = FaultSchedule.chaos(args.faults, nan_chunk=2, crash_chunk=3, fatal_chunk=5)
        kw = dict(rows=1024, train_rows=2048, chunk_rows=256, epochs=1) if args.smoke else {}
        serve_svm_live(gamma=args.gamma, bank_dtype=args.bank_dtype,
                       publish_every=args.publish_every, seed=args.seed, faults=faults,
                       device=args.device, **kw)
        return
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
