"""Single-pass online evaluation: prequential (test-then-train) streaming.

Counterpart of ``repro.core.online``.  One pass over a chunk stream in which
every chunk is first SCORED by the current model (those predictions are the
online record: the model has never seen the rows) and then TRAINED on.  The
cumulative mistake count over the pass is the prequential error; the
per-chunk accuracy trace localizes where a model loses it, e.g. right after a
drift point injected by ``data.stream.DriftChunks``.

  * chunks are visited in NATURAL order by default (``key=None``): a
    shuffled pass would average any drift schedule away;
  * the pass is deterministic given the chunk source: the driver draws no
    randomness of its own, so two runs agree bit for bit.

Each chunk trains through ``bsgd.train_chunk`` / ``multiclass.
train_chunk_multiclass`` on its batch-aligned prefix; the up-to-``batch_size
- 1`` remainder rows of a chunk are scored but not trained.  A cold binary
model scores ``sign(0) = 0`` and pays a full mistake on every first-chunk row.
Scoring reads each chunk's predictions back to the host: one sync a chunk.
"""
from __future__ import annotations

import numpy as np

from .bsgd import BSGDConfig, _owned, _sync, _to, init_state, predict, resolve_device, train_chunk
from .multiclass import (MulticlassSVMConfig, init_multiclass_state, predict_multiclass,
                         train_chunk_multiclass)
from ..data.stream import iter_epoch


def prequential_stream(cfg, source, *, key=None, impl: str = "auto", state=None,
                       prefetch: int = 0, retry=None, report=None, skip_chunks=(),
                       device=None) -> dict:
    """One prequential pass: score each chunk, then train on it.

    ``cfg`` is a binary ``BSGDConfig`` (labels in {-1, +1}) or a
    ``MulticlassSVMConfig`` (integer class ids).  ``state`` continues from an
    existing model (copied first); None starts cold.  ``retry``/``report``/
    ``skip_chunks`` go to ``iter_epoch`` (quarantined chunks are neither
    scored nor trained on).  Runs on ``device`` (default the card).  Returns
    the final state plus the online record::

        {"state", "n_rows", "mistakes", "mistake_rate",   # cumulative
         "chunk_acc",                                     # per-chunk trace
         "chunk_mistakes"}
    """
    multi = isinstance(cfg, MulticlassSVMConfig)
    binary = cfg.binary if multi else cfg
    if not isinstance(binary, BSGDConfig):
        raise TypeError(f"cfg must be BSGDConfig or MulticlassSVMConfig, "
                        f"got {type(cfg).__name__}")
    dev = resolve_device(device)
    table = binary.table()
    table = None if table is None else table.to(dev)
    if state is None:
        state = (init_multiclass_state(cfg, source.dim, device=dev) if multi
                 else init_state(binary, source.dim, device=dev))
    else:
        state = _owned(_to(state, dev))
    score = predict_multiclass if multi else predict
    train = train_chunk_multiclass if multi else train_chunk
    bsz = binary.batch_size
    mistakes = 0
    n_rows = 0
    chunk_acc, chunk_mist = [], []
    for _, x, y in iter_epoch(source, key, prefetch=prefetch, retry=retry, report=report,
                              skip_chunks=skip_chunks):
        x = np.asarray(x, np.float32)
        y = np.asarray(y)
        # test ...
        pred = score(state, x, binary.gamma, impl=impl, device=dev).cpu().numpy()
        wrong = int(np.sum(pred != y))
        mistakes += wrong
        n_rows += x.shape[0]
        chunk_mist.append(wrong)
        chunk_acc.append(round(1.0 - wrong / x.shape[0], 4))
        # ... then train on the batch-aligned prefix
        steps = x.shape[0] // bsz
        if steps:
            xc = x[:steps * bsz].reshape(steps, bsz, -1)
            yc = y[:steps * bsz].reshape(steps, bsz)
            state = train(cfg, table, state, xc, yc, impl=impl)
    _sync(state)
    return {"state": state, "n_rows": n_rows, "mistakes": mistakes,
            "mistake_rate": round(mistakes / max(n_rows, 1), 4),
            "chunk_acc": chunk_acc, "chunk_mistakes": chunk_mist}
