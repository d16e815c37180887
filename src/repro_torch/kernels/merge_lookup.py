"""Launch wrappers for the hand-written Lookup scoring kernels (``csrc/merge_lookup.cu``).

Replace ``repro.kernels.merge_lookup.merge_scores_pallas`` on the H100.
``merge_scores_cuda``: for one fixed partner (one per row of candidates),
every candidate's table coordinates ``(m, kappa)``, a four-point bilinear
gather from the ``(G, G)`` table and the WD score.  ``merge_pick_cuda``: a
whole Lookup-WD event's choice per row in one launch (mask, scores,
first-occurrence argmin, h at the winner).  Fixed-partner coefficients and
counts stay on the device, so a training step never waits for them.

The per-call path is lean because a training step is host-bound: the C entry
point is bound once, devices and dtypes are checked in one pass, the outputs
come from one allocation a dtype (each view of it costs the host as much as
a launch), contiguous inputs are not copied and the stream is read raw.  ``launches`` and ``pick_launches`` count the two kernels' launches.
"""
from __future__ import annotations

import torch

from . import _build, planned as _planned, work as _work

launches = 0
pick_launches = 0
_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
_dense = _build.dense


def merge_scores_cuda(alpha, kappa_row, valid, a_min, table, *, planned: bool = False):
    """``(wd, interp)`` of the shape of ``alpha`` for candidates ``alpha``/``kappa_row``/
    ``valid`` of one shape (..., s), fixed-partner coefficients ``a_min`` (one
    fp32 per row of s, any shape, on the same device) and ``table`` (G0, G1)
    fp32.  Invalid slots get WD 3.4e38."""
    dev = alpha.get_device()
    if not planned and (dev < 0 or any(t.get_device() != dev
                                       for t in (kappa_row, valid, a_min, table))):
        raise ValueError("merge_scores_cuda needs every input on one CUDA device")
    if not (alpha.dtype == kappa_row.dtype == a_min.dtype == table.dtype == _F32):
        raise TypeError("merge_scores_cuda takes fp32 alpha, kappa_row, a_min and table")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    shape = alpha.shape
    if alpha.dim() not in (1, 2):
        raise ValueError(f"alpha must be (s,) or (R, s), got {tuple(shape)}")
    s, n = shape[-1], alpha.numel()
    if kappa_row.shape != shape or valid.shape != shape or a_min.numel() != (n // s if s else 0):
        raise ValueError("alpha, kappa_row, valid must share a shape, with one a_min per row")
    if table.dim() != 2 or table.shape[0] < 2 or table.shape[1] < 2:
        raise ValueError(f"table must be at least 2 x 2, got {tuple(table.shape)}")
    out = alpha.new_empty((2, *shape))
    wd, interp = out.unbind(0)
    if n == 0:
        return wd, interp
    if planned:
        g = table.shape
        _planned.record("merge_scores", _work.merge_scores_work(
            n // s, s, _work.table_cells(n, g[0], g[1])))
        return wd, interp
    status = _build.function("merge_lookup", "merge_scores_launch", "pppppiiiippp")(
        _dense(alpha).data_ptr(), _dense(kappa_row).data_ptr(), _dense(valid).data_ptr(),
        _dense(a_min).data_ptr(), _dense(table).data_ptr(), table.shape[0], table.shape[1], n, s,
        wd.data_ptr(), interp.data_ptr(), _build.stream(dev))
    _build.check(status, "merge_scores")
    _build.count(globals(), "launches")
    return wd, interp


def merge_pick_cuda(alpha, kappa, count, i_min, a_min, wd_table, h_table, *,
                    planned: bool = False):
    """``(j_star, wd_j, h_j)`` of one Lookup-WD event per row, on the card.

    alpha, kappa: (s,) or (R, s) fp32; count: one int32 per row (a binary
    state's 0-d count, or (R,)); i_min: (R,) int64, the fixed partner's slot;
    a_min: (R,) fp32, its coefficient; tables: (G0, G1) fp32 of one shape.
    Candidate j is valid when ``j < count``, ``alpha_j * a_min > 0`` and
    ``j != i_min``.  Returns the first-occurrence argmin of the Lookup-WD
    scores (R,) int64 (slot 0 when none is valid), its score (R,) (3.4e38,
    ``>= NO_PARTNER``, when none is valid) and the h table at the winner (R,)."""
    dev = alpha.get_device()
    if not planned and (dev < 0 or any(t.get_device() != dev
                                       for t in (kappa, count, i_min, a_min, wd_table, h_table))):
        raise ValueError("merge_pick_cuda needs every input on one CUDA device")
    if not (alpha.dtype == kappa.dtype == a_min.dtype == wd_table.dtype == h_table.dtype == _F32):
        raise TypeError("merge_pick_cuda takes fp32 alpha, kappa, a_min and tables")
    if count.dtype != _I32 or i_min.dtype != _I64:
        raise TypeError(f"count must be int32 and i_min int64, got {count.dtype}, {i_min.dtype}")
    if alpha.dim() not in (1, 2) or alpha.shape[-1] == 0:
        raise ValueError(f"alpha must be (s,) or (R, s) with s > 0, got {tuple(alpha.shape)}")
    s = alpha.shape[-1]
    rows = alpha.numel() // s
    if (kappa.shape != alpha.shape or count.numel() != rows or i_min.numel() != rows
            or a_min.numel() != rows):
        raise ValueError(f"shapes do not pair: alpha {tuple(alpha.shape)}, kappa "
                         f"{tuple(kappa.shape)}, count {tuple(count.shape)}, i_min "
                         f"{tuple(i_min.shape)}, a_min {tuple(a_min.shape)}")
    g0, g1 = wd_table.shape
    if h_table.shape != wd_table.shape or g0 < 2 or g1 < 2:
        raise ValueError("the two tables must share one shape of at least 2 x 2")
    j_star = i_min.new_empty(rows)
    wd_j, h_j = a_min.new_empty((2, rows)).unbind(0)
    if rows == 0:
        return j_star, wd_j, h_j
    if planned:
        valid = rows * (s - 1)
        _planned.record("merge_pick", _work.merge_pick_work(
            rows, s, valid, _work.table_cells(valid, g0, g1)))
        return j_star, wd_j, h_j
    status = _build.function("merge_lookup", "merge_pick_launch", "pppppppiiiipppp")(
        _dense(alpha).data_ptr(), _dense(kappa).data_ptr(), _dense(count).data_ptr(),
        _dense(i_min).data_ptr(), _dense(a_min).data_ptr(), _dense(wd_table).data_ptr(),
        _dense(h_table).data_ptr(), g0, g1, rows, s, j_star.data_ptr(), wd_j.data_ptr(),
        h_j.data_ptr(), _build.stream(dev))
    _build.check(status, "merge_pick")
    _build.count(globals(), "pick_launches")
    return j_star, wd_j, h_j
