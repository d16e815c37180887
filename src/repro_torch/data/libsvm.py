"""LIBSVM text format parser (the paper's datasets ship in this format).

The port's own copy of ``repro.data.libsvm`` (numpy only): the same rows,
labels and label conventions."""
from __future__ import annotations

import numpy as np


def parse_libsvm(path_or_lines, n_features: int | None = None, *,
                 binary: bool = True):
    """Returns ``(x (n, d) float32, y (n,) float32)``.

    ``binary=True`` (the paper's setting) maps every label to {-1, +1} by
    sign; ``binary=False`` keeps the raw labels untouched so multi-class
    sets survive for ``core.multiclass``.  ``fit_multiclass`` expects
    0-based integer ids: remap first, e.g. ``y.astype(int) - 1`` for the
    common 1..C LIBSVM convention (it raises on out-of-range labels).
    """
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    rows, ys = [], []
    max_idx = 0
    for line in lines:
        parts = line.strip().split()
        if not parts:
            continue
        label = float(parts[0])
        ys.append((1.0 if label > 0 else -1.0) if binary else label)
        feats = {}
        for tok in parts[1:]:
            idx, val = tok.split(":")
            idx = int(idx)
            feats[idx] = float(val)
            max_idx = max(max_idx, idx)
        rows.append(feats)
    d = n_features or max_idx
    x = np.zeros((len(rows), d), np.float32)
    for i, feats in enumerate(rows):
        for idx, val in feats.items():
            x[i, idx - 1] = val  # libsvm is 1-indexed
    return x, np.asarray(ys, np.float32)


def dump_libsvm(path: str, x, y, *, append: bool = False) -> None:
    """Write (x, y) in LIBSVM text format (sparse: zeros are omitted).

    ``append=True`` adds rows to an existing file — the chunked writing path:
    dump a dataset chunk-by-chunk without ever materializing it whole, then
    read it back with ``iter_libsvm_chunks`` / ``data.stream.LibsvmChunks``.
    """
    with open(path, "a" if append else "w") as f:
        for xi, yi in zip(x, y):
            feats = " ".join(f"{j+1}:{v:.6g}" for j, v in enumerate(xi) if v != 0)
            f.write(f"{int(yi):+d} {feats}\n")


def iter_libsvm_chunks(path: str, chunk_rows: int, n_features: int, *,
                       binary: bool = True):
    """Yield ``(x, y)`` chunks of up to ``chunk_rows`` parsed incrementally.

    One sequential pass with O(chunk) memory — the no-random-access
    counterpart of ``data.stream.LibsvmChunks`` (which scans offsets
    once so chunks can be loaded in shuffled order).  ``n_features`` is
    required: a chunk cannot infer the full feature width on its own.
    """
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows={chunk_rows} < 1")
    buf = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            buf.append(line)
            if len(buf) == chunk_rows:
                yield parse_libsvm(buf, n_features=n_features, binary=binary)
                buf = []
    if buf:
        yield parse_libsvm(buf, n_features=n_features, binary=binary)
