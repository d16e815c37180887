"""Launch wrapper for the hand-written multi-merge scoring kernel (``csrc/merge_multi.cu``).

Replaces ``repro.kernels.merge_multi.multi_merge_scores_pallas`` on the H100:
for R fixed-partner rows, every candidate's WD score and merge coefficient h
from the two Lookup tables in one launch, one thread per (row, candidate).
Rows share an alpha row in groups of ``rows_per_alpha``, so the class axis
folds its ``(C, P)`` pairs onto ``C * P`` rows without copying alpha.
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _lib():
    lib = _build.load("merge_multi")
    fn = lib.multi_merge_scores_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def multi_merge_scores_cuda(alpha, kappa_rows, valid, a_min, h_table, wd_table):
    """``(wd, h)`` of shape (R, s) on the card.

    alpha: (A, s) fp32 with R a multiple of A (row r reads alpha row
    ``r // (R // A)``); kappa_rows: (R, s) fp32; valid: (R, s) bool; a_min:
    (R,) fp32; tables: (G0, G1) fp32 of one shape.  Invalid slots get WD 3.4e38."""
    global launches
    dev = alpha.device
    if not alpha.is_cuda or any(t.device != dev
                                for t in (kappa_rows, valid, a_min, h_table, wd_table)):
        raise ValueError("multi_merge_scores_cuda needs every input on one CUDA device")
    if any(t.dtype != torch.float32 for t in (alpha, kappa_rows, a_min, h_table, wd_table)):
        raise TypeError("multi_merge_scores_cuda takes fp32 alpha, kappa_rows, a_min and tables")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if kappa_rows.dim() != 2 or alpha.dim() != 2:
        raise ValueError("alpha must be (A, s) and kappa_rows (R, s)")
    rows, s = kappa_rows.shape
    n_alpha = alpha.shape[0]
    if (alpha.shape[1] != s or valid.shape != (rows, s) or a_min.shape != (rows,)
            or n_alpha == 0 or rows % n_alpha):
        raise ValueError(f"shapes do not pair: alpha {tuple(alpha.shape)}, kappa_rows "
                         f"{tuple(kappa_rows.shape)}, valid {tuple(valid.shape)}, "
                         f"a_min {tuple(a_min.shape)}")
    g0, g1 = wd_table.shape
    if h_table.shape != wd_table.shape or g0 < 2 or g1 < 2:
        raise ValueError("the two tables must share one shape of at least 2 x 2")
    alpha, kappa_rows, valid, a_min = (t.contiguous() for t in (alpha, kappa_rows, valid, a_min))
    h_table, wd_table = h_table.contiguous(), wd_table.contiguous()
    wd = torch.empty((rows, s), dtype=torch.float32, device=dev)
    h = torch.empty((rows, s), dtype=torch.float32, device=dev)
    if rows * s == 0:
        return wd, h
    status = _lib()(alpha.data_ptr(), rows // n_alpha, kappa_rows.data_ptr(), valid.data_ptr(),
                    a_min.data_ptr(), h_table.data_ptr(), wd_table.data_ptr(), g0, g1, rows, s,
                    wd.data_ptr(), h.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "multi_merge_scores")
    launches += 1
    return wd, h
