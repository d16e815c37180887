"""Budget maintenance: merge (paper Alg. 1) and removal, on the device.

PyTorch counterpart of ``repro.core.budget`` for the strategies this port
carries.  The SV set lives in fixed-size tensors (``slots`` rows) with a
``count`` watermark; inactive slots are masked.  Nothing here reads a
tensor back to the host: every choice (fixed partner, merge partner, merge
or removal fallback, whether an event runs at all) is a masked
``torch.where`` on the device, so a training step never waits for the card.

``method`` says how candidates are scored (paper section 4):
  ``gss`` / ``gss-precise`` — golden section search at eps 1e-2 / 1e-10
  (the CUDA ``gss`` kernel on the card); ``lookup-h`` — the h table, WD
  exact; ``lookup-wd`` — the WD table, h read at the winner only (both
  lookups through the CUDA ``merge_scores`` kernel on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import merge_math
from .lookup import MergeLookupTable
from ..kernels import ops as kops
from ..kernels import ref as kref

METHODS = ("gss", "gss-precise", "lookup-h", "lookup-wd")
STRATEGIES = ("merge", "multi-merge", "removal", "removal-project", "quantized")
PORTED_STRATEGIES = ("merge", "removal")
NO_PARTNER = kref.NO_PARTNER


class MaintenanceInfo(NamedTuple):
    """Diagnostics of one event (0-d tensors on the state's device)."""

    i_min: torch.Tensor    # slot of the fixed (min-|alpha|) partner
    j_star: torch.Tensor   # slot of the chosen merge partner
    h_star: torch.Tensor   # merge coefficient used (1.0 on removal)
    wd_star: torch.Tensor  # weight degradation of the executed event
    merged: torch.Tensor   # bool: True = merged, False = removal fallback


def candidate_scores(alpha, kappa_row, i_min, valid, method: str,
                     table: MergeLookupTable | None, *, impl: str = "auto"):
    """Per-candidate ``(wd, h)`` for merging slot ``i_min`` with each slot j.

    ``kappa_row[j] = k(x_{i_min}, x_j)``; ``i_min`` is a one-element index
    tensor.  Invalid candidates score >= ``NO_PARTNER``.  For ``lookup-wd``
    ``h`` is None: only the winner's h is ever used, and
    ``_merge_once`` reads it from the h table at the winner alone.
    """
    a_min = alpha.index_select(0, i_min.reshape(1))
    if method == "lookup-wd":
        wd, _ = kops.merge_scores(alpha, kappa_row, valid, a_min, table.wd_table, impl=impl)
        return wd, None
    if method == "lookup-h":
        _, h = kops.merge_scores(alpha, kappa_row, valid, a_min, table.h_table, impl=impl)
    elif method in ("gss", "gss-precise"):
        eps = merge_math.EPS_STANDARD if method == "gss" else merge_math.EPS_PRECISE
        m, kap = kref.merge_coords(a_min, alpha, kappa_row)
        h = kops.gss_solve(m, kap, n_iters=merge_math.gss_num_iters(eps), impl=impl)
    else:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    kap = torch.clamp(kappa_row, 0.0, 1.0)
    a_z = merge_math.merge_alpha_z(a_min, alpha, kap, h)
    wd = merge_math.weight_degradation(a_min, alpha, kap, a_z)
    return torch.where(valid, wd, torch.inf), h


def _merge_once(sv_x, alpha, count, gamma, method, table, *, kappa_row=None,
                execute=None, impl: str = "auto"):
    """One merge event, or the removal fallback when no same-sign partner exists.

    ``execute`` (a bool tensor, or None for always) masks the whole event:
    where it is False every write is dropped and ``count`` is unchanged, so
    callers can run a fixed number of events without asking the device
    whether one is due.  Returns ``(sv_x, alpha, count - executed, info)``.
    """
    slots = alpha.shape[0]
    idx = torch.arange(slots, device=alpha.device)
    active = idx < count

    # 1. fixed partner: the active SV with minimal |alpha| (first on ties)
    i_min = torch.argmin(torch.where(active, alpha.abs(), torch.inf)).reshape(1)
    a_min = alpha.index_select(0, i_min)
    x_min = sv_x.index_select(0, i_min)[0]

    # 2. kappa row k(x_{i_min}, x_j), recomputed per event (no kernel cache)
    if kappa_row is None:
        kappa_row = kops.rbf_row(sv_x, x_min, gamma, impl=impl)
    kappa_row = kappa_row.to(alpha.dtype)

    # 3. score the same-sign candidates, pick the best
    valid = active & (alpha * a_min > 0) & (idx != i_min)
    wd, h = candidate_scores(alpha, kappa_row, i_min, valid, method, table, impl=impl)
    j_star = torch.argmin(wd).reshape(1)
    wd_j = wd.index_select(0, j_star)
    has_partner = wd_j < NO_PARTNER
    a_j = alpha.index_select(0, j_star)
    kappa_j = kappa_row.index_select(0, j_star)
    if h is None:   # lookup-wd: the h table read at the winner only
        _, h_j = kops.merge_scores(a_j, kappa_j, torch.ones_like(has_partner), a_min,
                                   table.h_table, impl=impl)
    else:
        h_j = h.index_select(0, j_star)

    # 4. merged point and coefficient
    z = merge_math.merge_point(h_j, x_min, sv_x.index_select(0, j_star)[0])
    a_z = merge_math.merge_alpha_z(a_min, a_j, torch.clamp(kappa_j, 0.0, 1.0), h_j)

    # 5. branch-free write: merge puts z at lo and moves the last SV into hi;
    #    removal moves the last SV into i_min.  Index ``slots`` drops a write.
    last = (count.to(torch.int64) - 1).reshape(1)
    v_last = sv_x.index_select(0, last.clamp(min=0))[0]
    a_last = alpha.index_select(0, last.clamp(min=0))
    lo, hi = torch.minimum(i_min, j_star), torch.maximum(i_min, j_star)
    ex = torch.ones_like(has_partner) if execute is None else execute
    t1 = torch.where(ex, torch.where(has_partner, lo, i_min), slots)
    t2 = torch.where(ex & has_partner, hi, slots)
    t_last = torch.where(ex, last, slots)
    sv1 = torch.where(has_partner, z.to(sv_x.dtype), v_last)
    a1 = torch.where(has_partner, a_z.to(alpha.dtype), a_last)
    col = idx[:, None]
    sv_x = torch.where(col == t1, sv1, torch.where(col == t2, v_last, sv_x))
    alpha = torch.where(idx == t1, a1, torch.where(idx == t2, a_last, alpha))
    alpha = torch.where(idx == t_last, 0.0, alpha)

    info = MaintenanceInfo(
        i_min=i_min[0], j_star=j_star[0],
        h_star=torch.where(has_partner, h_j, 1.0)[0],
        wd_star=torch.where(has_partner, wd_j, a_min * a_min)[0],
        merged=has_partner[0])
    return sv_x, alpha, count - ex.to(count.dtype).reshape(count.shape), info


def maintenance_step(sv_x, alpha, count, gamma, method: str = "lookup-wd",
                     table: MergeLookupTable | None = None, kappa_row=None, *,
                     impl: str = "auto"):
    """One budget-maintenance event: merge two SVs (or remove one), count -= 1.

    Returns ``(sv_x, alpha, count, MaintenanceInfo)``."""
    return _merge_once(sv_x, alpha, count, gamma, method, table, kappa_row=kappa_row,
                       impl=impl)


def _compaction_perm(hole_mask):
    """Stable permutation pushing hole slots behind every survivor."""
    slots = hole_mask.shape[0]
    idx = torch.arange(slots, device=hole_mask.device)
    return torch.argsort(torch.where(hole_mask, slots + idx, idx), stable=True)


def _removal_all(sv_x, alpha, count, budget: int):
    """Remove the ``count - budget`` smallest-|alpha| SVs in one permutation
    (the identity when ``count <= budget``)."""
    slots = alpha.shape[0]
    idx = torch.arange(slots, device=alpha.device)
    active = idx < count
    excess = torch.clamp(count - budget, min=0)
    order = torch.argsort(torch.where(active, alpha.abs(), torch.inf), stable=True)
    rank = torch.empty_like(idx).scatter_(0, order, idx)
    perm = _compaction_perm(active & (rank < excess))
    new_count = count - excess
    alpha = torch.where(idx < new_count, alpha.index_select(0, perm), 0.0)
    return sv_x.index_select(0, perm), alpha, new_count


def run_maintenance(sv_x, alpha, count, n_events, gamma, table, *, budget: int,
                    strategy: str = "merge", method: str = "lookup-wd",
                    unroll: int = 1, impl: str = "auto"):
    """Budget maintenance until ``count <= budget``, without a host sync.

    ``merge`` runs exactly ``unroll`` events, each masked to a no-op once
    ``count <= budget`` (the reference's ``unroll`` form): the caller
    guarantees the excess never exceeds ``unroll``, which holds for
    ``unroll = batch_size`` since one step inserts at most ``batch_size``
    rows.  ``removal`` drops the whole excess in one permutation.  Returns
    ``(sv_x, alpha, count, n_events)``, ``n_events`` +1 per executed event.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
    if strategy not in PORTED_STRATEGIES:
        raise NotImplementedError(
            f"strategy={strategy!r} is not ported yet (ROADMAP.md Queue 1 item 5)")
    if strategy == "removal":
        over = count > budget
        sv_x, alpha, count = _removal_all(sv_x, alpha, count, budget)
        return sv_x, alpha, count, n_events + over.to(n_events.dtype)
    if unroll < 1:
        raise ValueError(f"unroll={unroll} < 1")
    for _ in range(unroll):
        over = count > budget
        sv_x, alpha, count, _ = _merge_once(sv_x, alpha, count, gamma, method, table,
                                            execute=over, impl=impl)
        n_events = n_events + over.to(n_events.dtype)
    return sv_x, alpha, count, n_events
