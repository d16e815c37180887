"""Launch wrappers for the hand-written multi-merge kernels (``csrc/merge_multi.cu``).

Replace ``repro.kernels.merge_multi.multi_merge_scores_pallas`` on the H100.
``multi_merge_scores_cuda``: for R fixed-partner rows, every candidate's WD
score and merge coefficient h from the two Lookup tables in one launch, one
thread per (row, candidate); rows share an alpha row in groups, so the class
axis folds its ``(C, P)`` pairs onto ``C * P`` rows without copying alpha.
``multi_merge_choose_cuda``: a whole multi-merge event's scoring and greedy
disjoint pair choice, one block per class.

The per-call path is lean, as in ``merge_lookup``: the C entry point is bound
once, one pass of checks, one output allocation a dtype, no copy of a
contiguous input, the raw stream.  ``launches`` and ``choose_launches`` count the two
kernels' launches.
"""
from __future__ import annotations

import torch

from . import _build, planned as _planned, work as _work

launches = 0
choose_launches = 0
_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
_STATIC_SMEM = 2_048           # bound on the choose kernel's static shared memory (~1 KB)
_dense = _build.dense


def multi_merge_scores_cuda(alpha, kappa_rows, valid, a_min, h_table, wd_table, *,
                            planned: bool = False):
    """``(wd, h)`` of the shape of ``kappa_rows`` on the card.

    kappa_rows, valid: (..., s), R rows of s; alpha: (..., s) with A rows, R a
    multiple of A (row r reads alpha row ``r // (R // A)``); a_min: R fp32;
    tables: (G0, G1) fp32 of one shape.  Invalid slots get WD 3.4e38."""
    dev = alpha.get_device()
    if not planned and (dev < 0 or any(t.get_device() != dev
                                       for t in (kappa_rows, valid, a_min, h_table, wd_table))):
        raise ValueError("multi_merge_scores_cuda needs every input on one CUDA device")
    if not (alpha.dtype == kappa_rows.dtype == a_min.dtype == h_table.dtype == wd_table.dtype
            == _F32):
        raise TypeError("multi_merge_scores_cuda takes fp32 alpha, kappa_rows, a_min and tables")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    shape = kappa_rows.shape
    s = shape[-1] if kappa_rows.dim() else 0
    rows = kappa_rows.numel() // s if s else 0
    n_alpha = alpha.numel() // s if s and alpha.dim() and alpha.shape[-1] == s else 0
    if (kappa_rows.dim() < 2 or valid.shape != shape or a_min.numel() != rows or n_alpha == 0
            or rows % n_alpha):
        raise ValueError(f"shapes do not pair: alpha {tuple(alpha.shape)}, kappa_rows "
                         f"{tuple(shape)}, valid {tuple(valid.shape)}, "
                         f"a_min {tuple(a_min.shape)}")
    g0, g1 = wd_table.shape
    if h_table.shape != wd_table.shape or g0 < 2 or g1 < 2:
        raise ValueError("the two tables must share one shape of at least 2 x 2")
    out = kappa_rows.new_empty((2, *shape))
    wd, h = out.unbind(0)
    if planned:
        _planned.record("multi_merge_scores", _work.multi_merge_scores_work(
            alpha.numel(), rows, s, _work.table_cells(rows * s, g0, g1)))
        return wd, h
    status = _build.function("merge_multi", "multi_merge_scores_launch", "pipppppiiiippp")(
        _dense(alpha).data_ptr(), rows // n_alpha, _dense(kappa_rows).data_ptr(),
        _dense(valid).data_ptr(), _dense(a_min).data_ptr(), _dense(h_table).data_ptr(),
        _dense(wd_table).data_ptr(), g0, g1, rows, s, wd.data_ptr(), h.data_ptr(),
        _build.stream(dev))
    _build.check(status, "multi_merge_scores")
    _build.count(globals(), "launches")
    return wd, h


def multi_merge_choose_cuda(alpha, kappa_rows, a_idx, a_min, count, budget: int, h_table,
                            wd_table, *, planned: bool = False):
    """One multi-merge event's scoring and greedy pair choice per class, on the card.

    alpha: (C, s) fp32; kappa_rows: (C, P, s) fp32, the fixed partners' kernel
    rows; a_idx: (C, P) int64 and a_min: (C, P) fp32, the fixed partners (the
    P smallest active |alpha|, cheapest first) and their coefficients; count:
    (C,) int32; tables: (G0, G1) fp32 of one shape; P >= 1, as far as the
    pair lists and the (P, s) scores fit one block's shared memory.  Returns
    ``(b_idx, merged, execute, h_star)``, (C, P) each: every pair's best
    untaken partner (int64), whether it merges or, executing without a
    partner, falls back to removal (bool, bool), and the h table at its
    partner (fp32), as ``kernels.ref.multi_merge_choose`` computes them."""
    dev = alpha.get_device()
    if not planned and (dev < 0 or any(t.get_device() != dev
                                       for t in (kappa_rows, a_idx, a_min, count, h_table,
                                                 wd_table))):
        raise ValueError("multi_merge_choose_cuda needs every input on one CUDA device")
    if not (alpha.dtype == kappa_rows.dtype == a_min.dtype == h_table.dtype == wd_table.dtype
            == _F32):
        raise TypeError("multi_merge_choose_cuda takes fp32 alpha, kappa_rows, a_min and tables")
    if count.dtype != _I32 or a_idx.dtype != _I64:
        raise TypeError(f"count must be int32 and a_idx int64, got {count.dtype}, {a_idx.dtype}")
    if kappa_rows.dim() != 3:
        raise ValueError(f"kappa_rows must be (C, P, s), got {tuple(kappa_rows.shape)}")
    c, p, s = kappa_rows.shape
    if (s == 0 or alpha.shape != (c, s) or a_idx.shape != (c, p) or a_min.shape != (c, p)
            or count.shape != (c,)):
        raise ValueError(f"shapes do not pair: alpha {tuple(alpha.shape)}, kappa_rows "
                         f"{(c, p, s)}, a_idx {tuple(a_idx.shape)}, a_min "
                         f"{tuple(a_min.shape)}, count {tuple(count.shape)}")
    if p < 1:
        raise ValueError(f"P={p} pairs: at least one")
    need = _build.pair_choice_bytes(p) + p * s * 4 + _STATIC_SMEM
    if need > _build.SMEM_LIMIT:
        raise ValueError(f"multi_merge_choose_cuda keeps P = {p} pairs' lists and P x s = {p} x "
                         f"{s} scores in shared memory: {need} bytes, more than a block has "
                         f"({_build.SMEM_LIMIT})")
    g0, g1 = wd_table.shape
    if h_table.shape != wd_table.shape or g0 < 2 or g1 < 2:
        raise ValueError("the two tables must share one shape of at least 2 x 2")
    n = c * p
    b_idx, h_star = a_idx.new_empty((c, p)), a_min.new_empty((c, p))
    merged, execute = a_idx.new_empty((2, c, p), dtype=torch.bool).unbind(0)
    if n == 0:
        return b_idx, merged, execute, h_star
    if planned:
        valid = n * (s - 1)
        _planned.record("multi_merge_choose", _work.multi_merge_choose_work(
            c, p, s, valid, _work.table_cells(valid, g0, g1)))
        return b_idx, merged, execute, h_star
    status = _build.function("merge_multi", "multi_merge_choose_launch", "pppppippiiiiippppp")(
        _dense(alpha).data_ptr(), _dense(kappa_rows).data_ptr(), _dense(a_idx).data_ptr(),
        _dense(a_min).data_ptr(), _dense(count).data_ptr(), budget, _dense(h_table).data_ptr(),
        _dense(wd_table).data_ptr(), g0, g1, c, p, s, b_idx.data_ptr(), merged.data_ptr(),
        execute.data_ptr(), h_star.data_ptr(), _build.stream(dev))
    _build.check(status, "multi_merge_choose")
    _build.count(globals(), "choose_launches")
    return b_idx, merged, execute, h_star
