"""Launch wrappers for the hand-written maintenance-event kernels (``csrc/merge_event.cu``).

Replaces ``repro.kernels.merge_event.merge_event_pallas`` on the H100: one
thread-block cluster per class (``CLUSTER`` blocks unless the caller fixes
another size) runs a whole Lookup-WD merge event (or the removal fallback)
and updates the stacked ``sv_x``, ``alpha`` and kernel cache IN PLACE, as
the TPU kernel aliases its outputs to its inputs.

* ``merge_event_cuda``: one round, on every class whose ``over`` flag is set
  (the others are not touched); ``launches`` counts its launches.
* ``merge_event_rounds_cuda``: a step's ``rounds`` masked rounds in one
  launch, each class running events while ``count > budget``, with
  ``count`` and ``n_events`` updated in place; ``rounds_launches`` counts
  its launches.
"""
from __future__ import annotations

import torch

from . import _build, planned as _planned, work as _work

launches = 0
rounds_launches = 0
_SV_DTYPES = (torch.float32, torch.bfloat16)
# Blocks a class.  An event round is a chain of dependent reads and cluster
# barriers, not a volume of work: on an H100 at C = 10, S = 508, D = 780 the
# rounds kernel is fastest at 8 blocks a class, ahead of 1 and 16
# (chip_smoke.py phase 7 times all three; PERF.md).
CLUSTER = 8


def _check_state(what, sv_x, alpha, kmat, count, others, cluster, planned=False):
    """The checks both entries share; returns ``(C, S, D)``."""
    dev = sv_x.get_device()
    if not planned and (dev < 0 or any(t.get_device() != dev
                                       for t in (alpha, kmat, count, *others))):
        raise ValueError(f"{what} needs every input on one CUDA device")
    if sv_x.dtype not in _SV_DTYPES:
        raise TypeError(f"sv_x must be fp32 or bf16, got {sv_x.dtype}")
    if any(t.dtype != torch.float32 for t in (alpha, kmat, *others[-2:])):
        raise TypeError(f"{what} takes fp32 alpha, kmat and tables")
    if count.dtype != torch.int32:
        raise TypeError(f"count must be int32, got {count.dtype}")
    if sv_x.dim() != 3:
        raise ValueError(f"sv_x must be (C, S, D), got {tuple(sv_x.shape)}")
    c, s, d = sv_x.shape
    if alpha.shape != (c, s) or kmat.shape != (c, s, s) or count.shape != (c,):
        raise ValueError(f"alpha (C, S), kmat (C, S, S) and count (C,) must pair with sv_x "
                         f"{tuple(sv_x.shape)}")
    if not all(t.is_contiguous() for t in (sv_x, alpha, kmat)):
        raise ValueError(f"{what} updates sv_x, alpha and kmat in place: they must be "
                         "contiguous")
    h_table, wd_table = others[-2:]
    if h_table.shape != wd_table.shape or h_table.dim() != 2 or min(h_table.shape) < 2:
        raise ValueError("the two tables must share one shape of at least 2 x 2")
    if cluster is not None and cluster not in _build.CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster} not in {_build.CLUSTER_SIZES}")
    return c, s, d


def merge_event_cuda(sv_x, alpha, kmat, count, over, h_table, wd_table, decisions=None, *,
                     cluster: int | None = None, planned: bool = False):
    """One event round on the card, in place; returns ``(sv_x, alpha, kmat)``.

    sv_x: (C, S, D) fp32 or bf16; alpha: (C, S) fp32; kmat: (C, S, S) fp32,
    all three contiguous (they are written in place); count: (C,) int32;
    over: (C,) bool; tables: (G0, G1) fp32 of one shape.  ``decisions``, a
    contiguous (C, 3) int32 tensor or None, receives each executing class's
    ``(i_min, j_star, merged)``.  ``cluster`` fixes the blocks a class
    (default ``CLUSTER``)."""
    c, s, d = _check_state("merge_event_cuda", sv_x, alpha, kmat, count,
                           (over, h_table, wd_table), cluster, planned)
    if over.dtype != torch.bool:
        raise TypeError(f"over must be bool, got {over.dtype}")
    if over.shape != (c,):
        raise ValueError(f"over (C,) must pair with sv_x {tuple(sv_x.shape)}")
    if decisions is not None and (decisions.shape != (c, 3) or decisions.dtype != torch.int32
                                  or (decisions.get_device() != sv_x.get_device()
                                      and not planned)
                                  or not decisions.is_contiguous()):
        raise ValueError("decisions must be a contiguous (C, 3) int32 tensor on the card")
    count, over = count.contiguous(), over.contiguous()
    h_table, wd_table = h_table.contiguous(), wd_table.contiguous()
    if c == 0 or s == 0:
        return sv_x, alpha, kmat
    if planned:                      # every class over budget, every slot active
        g0, g1 = wd_table.shape
        _planned.record("merge_event", _work.merge_event_work(
            c, d, sv_x.element_size(), c * s, c, c * (s - 1),
            _work.table_cells(c * (s - 1), g0, g1)))
        return sv_x, alpha, kmat
    bf16 = sv_x.dtype == torch.bfloat16
    g0, g1 = wd_table.shape
    status = _build.function("merge_event", "merge_event_launch", "pippppppiiiiiipp")(
        sv_x.data_ptr(), int(bf16), alpha.data_ptr(), kmat.data_ptr(), count.data_ptr(),
        over.data_ptr(), h_table.data_ptr(), wd_table.data_ptr(), g0, g1, c, s, d,
        cluster or CLUSTER, None if decisions is None else decisions.data_ptr(),
        _build.stream(sv_x.get_device()))
    _build.check(status, "merge_event")
    _build.count(globals(), "launches")
    return sv_x, alpha, kmat


def merge_event_rounds_cuda(sv_x, alpha, kmat, count, n_events, h_table, wd_table, *,
                            rounds: int, budget: int, cluster: int | None = None,
                            planned: bool = False):
    """A step's masked event rounds on the card in one launch, in place.

    As ``merge_event_cuda``, with ``count`` and ``n_events`` ((C,) int32,
    contiguous) read and written in place: each class runs up to ``rounds``
    events, one while ``count > budget``, then ``count -= 1`` and
    ``n_events += 1``.  Returns ``(sv_x, alpha, kmat, count, n_events)``."""
    c, s, d = _check_state("merge_event_rounds_cuda", sv_x, alpha, kmat, count,
                           (n_events, h_table, wd_table), cluster, planned)
    if n_events.dtype != torch.int32:
        raise TypeError(f"n_events must be int32, got {n_events.dtype}")
    if n_events.shape != (c,):
        raise ValueError(f"n_events (C,) must pair with sv_x {tuple(sv_x.shape)}")
    if not (count.is_contiguous() and n_events.is_contiguous()):
        raise ValueError("count and n_events are written in place: they must be contiguous")
    if rounds < 1:
        raise ValueError(f"rounds={rounds} < 1")
    h_table, wd_table = h_table.contiguous(), wd_table.contiguous()
    if c == 0 or s == 0:
        return sv_x, alpha, kmat, count, n_events
    if planned:                      # every class over budget each round, every slot active
        g0, g1 = wd_table.shape
        _planned.record("merge_event_rounds", _work.merge_event_rounds_work(
            c, d, sv_x.element_size(), c * s, [(c * s, c, c * (s - 1))] * int(rounds),
            _work.table_cells(int(rounds) * c * (s - 1), g0, g1)))
        return sv_x, alpha, kmat, count, n_events
    bf16 = sv_x.dtype == torch.bfloat16
    g0, g1 = wd_table.shape
    status = _build.function("merge_event", "merge_event_rounds_launch", "pippppppiiiiiiiip")(
        sv_x.data_ptr(), int(bf16), alpha.data_ptr(), kmat.data_ptr(), count.data_ptr(),
        n_events.data_ptr(), h_table.data_ptr(), wd_table.data_ptr(), g0, g1, c, s, d,
        int(rounds), int(budget), cluster or CLUSTER, _build.stream(sv_x.get_device()))
    _build.check(status, "merge_event_rounds")
    _build.count(globals(), "rounds_launches")
    return sv_x, alpha, kmat, count, n_events
