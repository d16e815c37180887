"""Launch wrapper for the hand-written maintenance-event kernel (``csrc/merge_event.cu``).

Replaces ``repro.kernels.merge_event.merge_event_pallas`` on the H100: one
thread block per class runs one whole Lookup-WD merge event (or the removal
fallback) on every class whose ``over`` flag is set, and updates the stacked
``sv_x``, ``alpha`` and kernel cache IN PLACE, as the TPU kernel aliases its
outputs to its inputs.  Classes with ``over`` clear are not touched.
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0
_SV_DTYPES = (torch.float32, torch.bfloat16)


def merge_event_cuda(sv_x, alpha, kmat, count, over, h_table, wd_table, decisions=None):
    """One event round on the card, in place; returns ``(sv_x, alpha, kmat)``.

    sv_x: (C, S, D) fp32 or bf16; alpha: (C, S) fp32; kmat: (C, S, S) fp32,
    all three contiguous (they are written in place); count: (C,) int32;
    over: (C,) bool; tables: (G0, G1) fp32 of one shape.  ``decisions``, a
    contiguous (C, 3) int32 tensor or None, receives each executing class's
    ``(i_min, j_star, merged)``."""
    global launches
    dev = sv_x.device
    ins = (alpha, kmat, count, over, h_table, wd_table)
    if not sv_x.is_cuda or any(t.device != dev for t in ins):
        raise ValueError("merge_event_cuda needs every input on one CUDA device")
    if sv_x.dtype not in _SV_DTYPES:
        raise TypeError(f"sv_x must be fp32 or bf16, got {sv_x.dtype}")
    if any(t.dtype != torch.float32 for t in (alpha, kmat, h_table, wd_table)):
        raise TypeError("merge_event_cuda takes fp32 alpha, kmat and tables")
    if count.dtype != torch.int32 or over.dtype != torch.bool:
        raise TypeError(f"count must be int32 and over bool, got {count.dtype}, {over.dtype}")
    if sv_x.dim() != 3:
        raise ValueError(f"sv_x must be (C, S, D), got {tuple(sv_x.shape)}")
    c, s, d = sv_x.shape
    if (alpha.shape != (c, s) or kmat.shape != (c, s, s) or count.shape != (c,)
            or over.shape != (c,)):
        raise ValueError("alpha (C, S), kmat (C, S, S), count and over (C,) must pair "
                         f"with sv_x {tuple(sv_x.shape)}")
    if not all(t.is_contiguous() for t in (sv_x, alpha, kmat)):
        raise ValueError("merge_event_cuda updates sv_x, alpha and kmat in place: "
                         "they must be contiguous")
    g0, g1 = wd_table.shape
    if h_table.shape != wd_table.shape or g0 < 2 or g1 < 2:
        raise ValueError("the two tables must share one shape of at least 2 x 2")
    if decisions is not None and (decisions.shape != (c, 3) or decisions.dtype != torch.int32
                                  or decisions.device != dev or not decisions.is_contiguous()):
        raise ValueError("decisions must be a contiguous (C, 3) int32 tensor on the card")
    count, over = count.contiguous(), over.contiguous()
    h_table, wd_table = h_table.contiguous(), wd_table.contiguous()
    if c == 0 or s == 0:
        return sv_x, alpha, kmat
    status = _build.function("merge_event", "merge_event_launch", "pippppppiiiiipp")(
        sv_x.data_ptr(), int(sv_x.dtype == torch.bfloat16), alpha.data_ptr(), kmat.data_ptr(),
        count.data_ptr(), over.data_ptr(), h_table.data_ptr(), wd_table.data_ptr(), g0, g1, c,
        s, d, None if decisions is None else decisions.data_ptr(),
        _build.stream(sv_x.get_device()))
    _build.check(status, "merge_event")
    launches += 1
    return sv_x, alpha, kmat
