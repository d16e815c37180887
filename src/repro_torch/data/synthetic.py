"""Synthetic classification data over a numpy ``Generator``, and drift schedules.

Counterparts of ``repro.data.synthetic``'s generators with the same shapes
and class structure, and its two drift schedules (numpy in both packages, so
they are equal array for array).  They draw from numpy, not ``jax.random``, so one seed
gives the same arrays to both packages (float32 rows, labels in {-1, +1}).
"""
from __future__ import annotations

import numpy as np


def make_blobs(rng: np.random.Generator, n: int, dim: int, *, sep: float = 2.0,
               noise: float = 1.0):
    """Two Gaussian blobs centred at -sep/2 and +sep/2 on every axis."""
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    centers = np.stack([np.full((dim,), -sep / 2), np.full((dim,), sep / 2)])
    x = centers[((y + 1) // 2).astype(np.int64)] + noise * rng.standard_normal((n, dim))
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm]


def make_blobs_multiclass(rng: np.random.Generator, n: int, dim: int, n_classes: int = 5, *,
                          sep: float = 3.0, noise: float = 1.0):
    """C Gaussian blobs at centres drawn ``sep * N(0, I)``; labels are int32 in [0, C).

    In dim >= ~4 the distance between two centres concentrates near
    ``sep * sqrt(2 dim)`` while a point's spread along it is ``noise``."""
    centers = sep * rng.standard_normal((n_classes, dim))
    y = rng.integers(0, n_classes, n).astype(np.int32)
    x = centers[y] + noise * rng.standard_normal((n, dim))
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm]


def make_two_moons(rng: np.random.Generator, n: int, *, noise: float = 0.15, dim: int = 2):
    """Two interleaved half circles; dimensions past 2 are pure noise."""
    n_half = n // 2
    t = np.linspace(0.0, np.pi, n_half)
    x_a = np.stack([np.cos(t), np.sin(t)], axis=1)
    x_b = np.stack([1.0 - np.cos(t), 0.5 - np.sin(t)], axis=1)
    x = np.concatenate([x_a, x_b]) + noise * rng.standard_normal((2 * n_half, 2))
    y = np.concatenate([np.ones(n_half), -np.ones(n_half)]).astype(np.float32)
    if dim > 2:
        x = np.concatenate([x, 0.5 * rng.standard_normal((2 * n_half, dim - 2))], axis=1)
    perm = rng.permutation(2 * n_half)
    return x[perm].astype(np.float32), y[perm]


def make_susy_like(rng: np.random.Generator, n: int, dim: int = 18, *, flip: float = 0.2):
    """Overlapping classes: a quadratic boundary in a random subspace plus label noise."""
    x = rng.standard_normal((n, dim))
    w = rng.standard_normal((dim,))
    score = x @ w + 0.5 * np.sum(x[:, : dim // 2] ** 2, axis=1) - dim // 4
    y = np.where(score > 0, 1.0, -1.0)
    y = np.where(rng.random(n) < flip, -y, y)
    return x.astype(np.float32), y.astype(np.float32)


def train_test_split(x, y, *, test_frac: float = 0.2):
    """``((x_train, y_train), (x_test, y_test))``: the first ``test_frac`` rows are the test set."""
    n_test = int(x.shape[0] * test_frac)
    return (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test])


# ---------------------------------------------------------------------------
# Drift schedules (consumed by data.stream.DriftChunks)
# ---------------------------------------------------------------------------

def label_flip_schedule(n_chunks: int, *, start: float = 0.5,
                        prob: float = 1.0) -> np.ndarray:
    """Step label drift: per-chunk flip probabilities, shape ``(n_chunks,)``.

    Chunks before position ``floor(start * n_chunks)`` are clean; from there
    on every row's label flips with probability ``prob`` (binary labels
    negate, class ids rotate — see ``DriftChunks``).  ``prob=1.0`` at
    ``start=0.5`` is the classic mid-stream concept reversal: a model that
    cannot forget its budgeted bank pays for it in cumulative mistakes.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks={n_chunks} < 1")
    if not 0.0 <= prob <= 1.0:
        raise ValueError(f"prob={prob} outside [0, 1]")
    sched = np.zeros((n_chunks,), np.float32)
    sched[int(start * n_chunks):] = prob
    return sched


def mean_shift_schedule(n_chunks: int, dim: int, *, magnitude: float = 3.0,
                        start: float = 0.5, kind: str = "step",
                        direction=None) -> np.ndarray:
    """Covariate drift: per-chunk additive shifts, shape ``(n_chunks, dim)``.

    ``kind="step"`` jumps the input mean by ``magnitude`` (along the unit
    ``direction``, default the normalized all-ones diagonal) at position
    ``floor(start * n_chunks)``; ``kind="ramp"`` interpolates linearly from
    zero at that position to the full shift at the last chunk — gradual
    drift.  Labels are untouched: the decision boundary moves under the
    model instead.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks={n_chunks} < 1")
    if kind not in ("step", "ramp"):
        raise ValueError(f"kind={kind!r} not in ('step', 'ramp')")
    d = (np.full((dim,), 1.0, np.float32) if direction is None
         else np.asarray(direction, np.float32))
    if d.shape != (dim,):
        raise ValueError(f"direction shape {d.shape} != ({dim},)")
    d = d / max(float(np.linalg.norm(d)), 1e-12)
    s0 = int(start * n_chunks)
    w = np.zeros((n_chunks,), np.float32)
    if kind == "step":
        w[s0:] = 1.0
    else:
        span = max(n_chunks - 1 - s0, 1)
        for c in range(s0, n_chunks):
            w[c] = (c - s0) / span
    return (magnitude * w)[:, None] * d[None, :]
