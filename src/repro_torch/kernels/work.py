"""The hand-written kernels' work: ``(bytes, fp32 operations)`` of one call.

Bytes count each input read once and each output written once; operations
are counted as PERF.md §6's bound column counts them.  Where the work
depends on the data, the caller passes what the data needs: ``chip_smoke.py``
the counts of its inputs, a plan (each wrapper's planned branch) the steady
state's most, every active slot a valid candidate, each reading four table
cells, up to the table's size.  ``launch.roofline.bound_s`` turns a work
into the least time a card takes for it.
"""
from __future__ import annotations

import numpy as np


def table_cells(valid: int, g0: int, g1: int) -> int:
    """The plan's table cells read by ``valid`` bilinear lookups: four each, at
    most the table."""
    return min(4 * valid, g0 * g1)


def rbf_matrix_work(n, m, d, x_elem, y_elem=None):
    """x (n, d) and y (m, d) read, K (n, m) fp32 written; two operations a
    multiply-add of x.y and of the norms, five an output (the epilogue)."""
    y_elem = x_elem if y_elem is None else y_elem
    return (x_elem * n * d + y_elem * m * d + 4 * n * m,
            2.0 * n * m * d + 2.0 * (n + m) * d + 5.0 * n * m)


def merge_scores_work(rows, s, cells):
    """alpha, kappa (fp32) and valid (bool) of each row, a_min, the table cells,
    wd and interp written; ~25 operations a candidate."""
    return rows * (s * (4 + 4 + 1) + 4 + 2 * 4 * s) + 4 * cells, 25.0 * rows * s


def merge_pick_work(rows, s, valid, cells):
    """alpha and kappa of each row, count, i_min and a_min, the WD-table cells
    the valid candidates read, four h-table cells a row, the three outputs;
    ~25 operations a valid candidate and 4 a candidate (mask, argmin)."""
    return (2 * 4 * rows * s + rows * (4 + 8 + 4) + 4 * cells + 16 * rows + rows * (8 + 4 + 4),
            25.0 * valid + 4.0 * rows * s)


def gss_work(n, n_iters):
    """m and kappa read, h written (fp32); ~6 + 30 a bracket step a problem."""
    return 12.0 * n, n * (6.0 + 30.0 * n_iters)


def gss_pick_work(rows, s, valid, n_iters):
    """merge_pick's inputs without tables and its outputs; per valid candidate
    ~31 + 30 a bracket step, 4 a candidate."""
    return (2 * 4 * rows * s + rows * (4 + 8 + 4) + rows * (8 + 4 + 4),
            (31.0 + 30.0 * n_iters) * valid + 4.0 * rows * s)


def multi_merge_scores_work(alpha_numel, rows, s, cells):
    """alpha, each row's kappa (fp32) and valid (bool), a_min, both tables'
    cells, wd and h written; ~38 operations a candidate."""
    return (alpha_numel * 4 + rows * s * (4 + 1) + rows * 4 + 2 * 4 * cells + 2 * 4 * rows * s,
            38.0 * rows * s)


def multi_merge_choose_work(c, p, s, valid, cells):
    """alpha, the P kappa rows, a_idx, a_min and count of each class, the
    WD-table cells, four h-table cells a pair, the four outputs; ~25
    operations a valid (pair, candidate), 4 a (pair, candidate)."""
    return (4 * c * s + 4 * c * p * s + c * p * (8 + 4) + 4 * c + 4 * cells + 16 * c * p
            + c * p * (8 + 1 + 1 + 4), 25.0 * valid + 4.0 * c * p * s)


def event_round_bytes(n_act, n_over, d, sv_elem):
    """One event round's own bytes: per executing class three cache rows read
    and two rows and two columns written over its active slots, three SV
    rows read and two written, four h-table cells."""
    return n_act * 4 * (3 + 4) + n_over * (5 * d * sv_elem + 4 * 4)


def event_round_ops(n_act, n_over, valid, d):
    """One event round's operations: ~25 a valid candidate (coordinates,
    bilinear mix, score), ~10 an active slot (the argmin and the z row), 3 a
    feature of each executing class (z)."""
    return 25.0 * valid + 10.0 * n_act + 3.0 * d * n_over


def merge_event_work(c, d, sv_elem, n_act, n_over, valid, cells):
    """One merge_event round over ``n_act`` active slots of its ``n_over``
    executing classes with ``valid`` candidates: count and over of every
    class, alpha over the active slots, the round's bytes, the WD-table
    cells; ``event_round_ops``."""
    return (c * (4 + 1) + n_act * 4 + event_round_bytes(n_act, n_over, d, sv_elem) + 4 * cells,
            event_round_ops(n_act, n_over, valid, d))


def merge_event_rounds_work(c, d, sv_elem, n_act, rounds, cells):
    """One merge_event_rounds call: count and n_events of every class and
    alpha over the ``n_act`` active slots of the classes over budget read and
    written once, the ``cells`` WD-table cells its rounds read in all; then,
    for each round that runs, given as ``(n_act, n_over, valid)`` of the
    state before it, the round's bytes and ``event_round_ops``."""
    n_bytes, n_ops = c * 4 * 4 + 2 * 4 * n_act + 4 * cells, 0.0
    for act, over, valid in rounds:
        n_bytes += event_round_bytes(act, over, d, sv_elem)
        n_ops += event_round_ops(act, over, valid, d)
    return n_bytes, n_ops


def train_step_work(c, s, d, b, sv_elem, new, retired, rounds, mid, p):
    """One fused step: the bank, alpha (read and written), the minibatch,
    targets, k_bb and the counters once; per class the cache rows and columns
    its ``new`` inserts write (two of ``mid`` entries each), and per retired
    SV the seven cache rows and five SV rows its event touches over ``mid``
    active slots; two operations a multiply-add of the margin and the norms,
    ~10 a margin entry, ~25 a scored (pair, candidate) and ~10 an active slot
    of every one of ``rounds`` events.  ``new``, ``retired``, ``rounds`` and
    ``mid`` are per class: one number for every class, or C numbers."""
    new, retired, rounds, mid = (np.broadcast_to(np.asarray(v, dtype=np.float64), (c,))
                                 for v in (new, retired, rounds, mid))
    return (c * s * d * sv_elem + 2 * c * s * 4 + b * d * 4 + c * b * 4 + b * b * 4 + 7 * c * 4
            + float((new * 2 * mid * 4 + retired * (7 * mid * 4 + 5 * d * sv_elem)).sum()),
            2.0 * c * s * d * (b + 1) + 10.0 * c * b * s
            + float((rounds * mid * (25.0 * p + 10.0)).sum()))


def serve_cell_work(n, c, s, d, x_elem, bank_elem):
    """x (n, d), the bank (C s, d) and alpha (C, s) read, scores (C, n) and
    labels (n,) written; K's operations as rbf_matrix's, two a product of
    the contraction, C - 1 compares a row."""
    m = c * s
    return (x_elem * n * d + bank_elem * m * d + 4.0 * (m + c * n + n),
            2.0 * n * m * d + 2.0 * (n + m) * d + 5.0 * n * m + 2.0 * n * m + n * (c - 1))


def bdca_ascent_work(c, s, counts, rounds):
    """The active block of each class's cache read once, alpha read and
    written, the counts; f = b k (2 n^2) and each sweep's n coordinate
    updates (~2 n + 8 each), for the classes' active counts ``counts``."""
    return (float(sum(n * n for n in counts) * 4 + c * s * 8 + c * 4),
            float(sum(2 * n * n + rounds * n * (2 * n + 8) for n in counts)))
