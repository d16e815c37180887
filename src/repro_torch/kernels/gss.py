"""Launch wrappers for the hand-written golden-section-search kernels (``csrc/gss.cu``).

Replace ``repro.kernels.gss.gss_pallas`` on the H100.  ``gss_cuda``: one
thread per ``(m, kappa)`` problem, ``n_iters`` bracket steps in registers.
``gss_pick_cuda``: a whole GSS merge event's choice per row in one launch
(mask, every valid candidate's search and weight degradation,
first-occurrence argmin, h* at the winner), with the lean per-call path of
``merge_lookup.merge_pick_cuda``.  ``launches`` and ``pick_launches``
count the two kernels' launches.
"""
from __future__ import annotations

import torch

from . import _build, planned as _planned, work as _work

launches = 0
pick_launches = 0
_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
_dense = _build.dense


def gss_cuda(m: torch.Tensor, kappa: torch.Tensor, n_iters: int, *,
             planned: bool = False) -> torch.Tensor:
    """argmax_h of the merge objective per element; m, kappa fp32 of one shape."""
    if not planned and (not m.is_cuda or kappa.device != m.device):
        raise ValueError("gss_cuda needs m and kappa on one CUDA device")
    if m.dtype != torch.float32 or kappa.dtype != torch.float32:
        raise TypeError("gss_cuda takes fp32 m and kappa")
    if m.shape != kappa.shape:
        raise ValueError(f"m {tuple(m.shape)} and kappa {tuple(kappa.shape)} differ")
    if n_iters < 0:
        raise ValueError(f"n_iters={n_iters} < 0")
    m, kappa = m.contiguous(), kappa.contiguous()
    h = torch.empty_like(m)
    if m.numel() == 0:
        return h
    if planned:
        _planned.record("gss", _work.gss_work(m.numel(), n_iters))
        return h
    status = _build.function("gss", "gss_launch", "pppiip")(
        m.data_ptr(), kappa.data_ptr(), h.data_ptr(), m.numel(), int(n_iters),
        _build.stream(m.get_device()))
    _build.check(status, "gss")
    _build.count(globals(), "launches")
    return h


def gss_pick_cuda(alpha, kappa, count, i_min, a_min, n_iters: int, *, planned: bool = False):
    """``(j_star, wd_j, h_j)`` of one GSS merge event per row, on the card.

    alpha, kappa: (s,) or (R, s) fp32; count: one int32 per row (a binary
    state's 0-d count, or (R,)); i_min: (R,) int64, the fixed partner's slot;
    a_min: (R,) fp32, its coefficient; ``n_iters`` bracket steps.  Candidate
    j is valid when ``j < count``, ``alpha_j * a_min > 0`` and ``j !=
    i_min``.  Returns the first-occurrence argmin of the weight degradations
    (R,) int64 (slot 0 when none is valid), its WD (R,) (3.4e38, ``>=
    NO_PARTNER``, when none is valid) and h* at the winner (R,)."""
    dev = alpha.get_device()
    if not planned and (dev < 0 or any(t.get_device() != dev
                                       for t in (kappa, count, i_min, a_min))):
        raise ValueError("gss_pick_cuda needs every input on one CUDA device")
    if not (alpha.dtype == kappa.dtype == a_min.dtype == _F32):
        raise TypeError("gss_pick_cuda takes fp32 alpha, kappa and a_min")
    if count.dtype != _I32 or i_min.dtype != _I64:
        raise TypeError(f"count must be int32 and i_min int64, got {count.dtype}, {i_min.dtype}")
    if alpha.dim() not in (1, 2) or alpha.shape[-1] == 0:
        raise ValueError(f"alpha must be (s,) or (R, s) with s > 0, got {tuple(alpha.shape)}")
    if n_iters < 0:
        raise ValueError(f"n_iters={n_iters} < 0")
    s = alpha.shape[-1]
    rows = alpha.numel() // s
    if (kappa.shape != alpha.shape or count.numel() != rows or i_min.numel() != rows
            or a_min.numel() != rows):
        raise ValueError(f"shapes do not pair: alpha {tuple(alpha.shape)}, kappa "
                         f"{tuple(kappa.shape)}, count {tuple(count.shape)}, i_min "
                         f"{tuple(i_min.shape)}, a_min {tuple(a_min.shape)}")
    j_star = i_min.new_empty(rows)
    wd_j, h_j = a_min.new_empty((2, rows)).unbind(0)
    if rows == 0:
        return j_star, wd_j, h_j
    if planned:
        _planned.record("gss_pick", _work.gss_pick_work(rows, s, rows * (s - 1), n_iters))
        return j_star, wd_j, h_j
    status = _build.function("gss", "gss_pick_launch", "pppppiiipppp")(
        _dense(alpha).data_ptr(), _dense(kappa).data_ptr(), _dense(count).data_ptr(),
        _dense(i_min).data_ptr(), _dense(a_min).data_ptr(), rows, s, int(n_iters),
        j_star.data_ptr(), wd_j.data_ptr(), h_j.data_ptr(), _build.stream(dev))
    _build.check(status, "gss_pick")
    _build.count(globals(), "pick_launches")
    return j_star, wd_j, h_j
