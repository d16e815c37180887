"""Launch wrapper for the hand-written merge-scoring kernel (``csrc/merge_lookup.cu``).

Replaces ``repro.kernels.merge_lookup.merge_scores_pallas`` on the H100: for
one fixed partner (one per row of candidates), every candidate's table
coordinates ``(m, kappa)``, a four-point bilinear gather from the ``(G, G)``
table and the WD score.
``a_min`` stays on the device (a one-element tensor), so a training step
never waits for it.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _lib():
    lib = _build.load("merge_lookup")
    fn = lib.merge_scores_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def merge_scores_cuda(alpha, kappa_row, valid, a_min, table):
    """``(wd, interp)`` of the shape of ``alpha`` for candidates ``alpha``/``kappa_row``/
    ``valid``, (s,) or rows (R, s), fixed-partner coefficients ``a_min`` (one
    fp32 per row, on the same device) and ``table`` (G0, G1) fp32.  Invalid
    slots get WD 3.4e38."""
    global launches
    dev = alpha.device
    if not alpha.is_cuda or any(t.device != dev for t in (kappa_row, valid, a_min, table)):
        raise ValueError("merge_scores_cuda needs every input on one CUDA device")
    if any(t.dtype != torch.float32 for t in (alpha, kappa_row, a_min, table)):
        raise TypeError("merge_scores_cuda takes fp32 alpha, kappa_row, a_min and table")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if alpha.dim() not in (1, 2):
        raise ValueError(f"alpha must be (s,) or (R, s), got {tuple(alpha.shape)}")
    s = alpha.shape[-1]
    rows = alpha.numel() // s if s else 0
    if kappa_row.shape != alpha.shape or valid.shape != alpha.shape or a_min.numel() != rows:
        raise ValueError("alpha, kappa_row, valid must share a shape, with one a_min per row")
    g0, g1 = table.shape
    if g0 < 2 or g1 < 2:
        raise ValueError(f"table must be at least 2 x 2, got {tuple(table.shape)}")
    alpha, kappa_row, valid = alpha.contiguous(), kappa_row.contiguous(), valid.contiguous()
    a_min, table = a_min.contiguous(), table.contiguous()
    wd = torch.empty(alpha.shape, dtype=torch.float32, device=dev)
    interp = torch.empty(alpha.shape, dtype=torch.float32, device=dev)
    if alpha.numel() == 0:
        return wd, interp
    status = _lib()(alpha.data_ptr(), kappa_row.data_ptr(), valid.data_ptr(), a_min.data_ptr(),
                    table.data_ptr(), g0, g1, alpha.numel(), s, wd.data_ptr(), interp.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "merge_scores")
    launches += 1
    return wd, interp
