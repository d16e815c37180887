"""Budget maintenance as a strategy engine over an optional kernel cache, on the device.

PyTorch counterpart of ``repro.core.budget``.  The SV set lives in
fixed-size tensors (``slots`` rows) with a ``count`` watermark; inactive
slots are masked.  Every choice (fixed partners, merge partners, merge or
removal fallback, whether an event runs at all) is a masked ``torch.where``
or scatter on the device, so a training step never waits for the card; the
one host read is the drain form of the maintenance entry points
(``unroll=0``, their default), which reads the largest excess once.

Every strategy is written once, for a leading class axis: ``sv_x`` (C, S, D),
``alpha`` (C, S), ``kmat`` (C, S, S) or None, ``count`` (C,).  The binary
entry points (``maintenance_step``, ``run_maintenance``) run it with C = 1,
except the uncached merge event of the binary step, which keeps a form
without the class axis (``_merge_once_binary``: the lifts cost the
host-bound step ~10%); the one-vs-rest engine runs all classes in one pass
(the reference's ``jax.vmap``).

``method`` says how candidates are scored (paper section 4):
  ``gss`` / ``gss-precise`` — golden section search at eps 1e-2 / 1e-10
  (an event's whole choice is one CUDA ``gss_pick`` launch on the card, a
  multi-merge event's scoring the CUDA ``gss`` kernel); ``lookup-h`` — the
  h table, WD exact (the CUDA ``merge_scores`` kernel on the card);
  ``lookup-wd`` — the WD table, h read at the winner only (an event's whole
  choice is one CUDA ``merge_pick`` launch on the card, a multi-merge
  event's scoring and greedy pair choice one ``multi_merge_choose``
  launch).

``strategy`` says what one event does: ``merge`` (paper Alg. 1),
``multi-merge`` (the P smallest-|alpha| SVs merge with their best partners
in one fused update), ``removal`` (drop the excess smallest-|alpha| SVs),
``removal-project`` (drop them after projecting their mass onto the
survivors through the cached rows) and ``quantized`` (a fixed codebook in
the first ``budget`` slots absorbs each over-budget violator).  The last two
read the cache.  ``run_maintenance_classes`` is the fused event engine: one
``merge_event_rounds`` kernel launch for a step's rounds on every class.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernel_cache, merge_math
from .lookup import MergeLookupTable
from ..kernels import ops as kops
from ..kernels import planned
from ..kernels import ref as kref

METHODS = ("gss", "gss-precise", "lookup-h", "lookup-wd")
STRATEGIES = ("merge", "multi-merge", "removal", "removal-project", "quantized")
NO_PARTNER = kref.NO_PARTNER
put_rows = kref.put_rows


class MaintenanceInfo(NamedTuple):
    """Diagnostics of one event (tensors on the state's device)."""

    i_min: torch.Tensor    # slot of the fixed (min-|alpha|) partner
    j_star: torch.Tensor   # slot of the chosen merge partner
    h_star: torch.Tensor   # merge coefficient used (1.0 on removal)
    wd_star: torch.Tensor  # weight degradation of the executed event
    merged: torch.Tensor   # bool: True = merged, False = removal fallback


def _scores(alpha, kappa, a_min, valid, method: str, table, *, impl: str):
    """``(wd, h)`` of fixed partners with coefficients ``a_min`` against every slot.

    One fixed partner: alpha, kappa, valid (s,), a_min (1,).  One per class:
    alpha, kappa, valid (C, s), a_min (C,).  P per class: alpha (s,) or
    (C, s), kappa and valid (P, s) or (C, P, s), a_min (P,) or (C, P).
    Invalid candidates score >= ``NO_PARTNER``.  ``h`` is None for lookup-wd."""
    s = alpha.shape[-1]
    alpha_b = alpha[:, None, :] if kappa.dim() == 3 else alpha
    if method in ("lookup-wd", "lookup-h"):
        tab = table.wd_table if method == "lookup-wd" else table.h_table
        if kappa.dim() == alpha.dim():
            wd, h = kops.merge_scores(alpha, kappa, valid, a_min, tab, impl=impl)
        else:   # the P fixed partners (of every class) folded onto the rows
            wd, h = kops.merge_scores(alpha_b.expand(kappa.shape).reshape(-1, s),
                                      kappa.reshape(-1, s), valid.reshape(-1, s),
                                      a_min.reshape(-1), tab, impl=impl)
            wd, h = wd.view(kappa.shape), h.view(kappa.shape)
        if method == "lookup-wd":
            return wd, None
    elif method not in ("gss", "gss-precise"):
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    a_col = a_min if kappa.dim() == 1 else a_min[..., None]
    if method in ("gss", "gss-precise"):
        m, kap = kref.merge_coords(a_col, alpha_b, kappa)
        h = kops.gss_solve(m, kap, n_iters=_gss_iters(method), impl=impl)
    kap = torch.clamp(kappa, 0.0, 1.0)
    a_z = merge_math.merge_alpha_z(a_col, alpha_b, kap, h)
    wd = merge_math.weight_degradation(a_col, alpha_b, kap, a_z)
    return torch.where(valid, wd, torch.inf), h


def _gss_iters(method: str) -> int:
    """Bracket steps of the runtime search: 10 for ``gss`` (eps 1e-2), 48 for
    ``gss-precise`` (eps 1e-10)."""
    eps = merge_math.EPS_STANDARD if method == "gss" else merge_math.EPS_PRECISE
    return merge_math.gss_num_iters(eps)


def candidate_scores(alpha, kappa_row, i_min, valid, method: str,
                     table: MergeLookupTable | None, *, impl: str = "auto"):
    """Per-candidate ``(wd, h)`` for merging slot(s) ``i_min`` with each slot j.

    alpha (s,); ``kappa_row[j] = k(x_{i_min}, x_j)``, (s,) with ``i_min`` a
    one-element index tensor, or (P, s) with ``i_min`` (P,) for P fixed
    partners.  Invalid candidates score >= ``NO_PARTNER``.  For ``lookup-wd``
    ``h`` is None: only the winner's h is ever used, and ``_merge_once``
    reads it from the h table at the winner alone."""
    a_min = alpha.index_select(0, i_min.reshape(-1))
    return _scores(alpha, kappa_row, a_min, valid, method, table, impl=impl)


def _merge_once_binary(sv_x, alpha, count, gamma, method, table, *, kappa_row=None,
                       execute=None, impl: str = "auto"):
    """``_merge_once`` for one binary state without the kernel cache: sv_x
    (S, D), alpha (S,), count ().  The same event, written without the class
    axis: on the host-bound binary step the C = 1 lifts and two-index
    gathers of the class-axis form cost ~10% of a step (PERF.md), so the
    binary entry points select this form.  Returns ``(sv_x, alpha,
    count - executed, info)`` with 0-d info fields."""
    slots = alpha.shape[0]
    idx = kref.iota(slots, alpha.device)
    active = idx < count

    # 1. fixed partner: the active SV with minimal |alpha| (first on ties)
    i_min = torch.argmin(torch.where(active, alpha.abs(), torch.inf)).reshape(1)
    a_min = alpha.index_select(0, i_min)
    x_min = sv_x.index_select(0, i_min)[0]

    # 2. kappa row k(x_{i_min}, x_j), recomputed per event
    if kappa_row is None:
        kappa_row = kops.rbf_row(sv_x, x_min, gamma, impl=impl)
    kappa_row = kappa_row.to(alpha.dtype)

    # 3. score the same-sign candidates, pick the best; lookup-wd reads the
    #    h table at the winner only, in the same pass, and gss searches h*
    #    candidate by candidate (each one launch on the card)
    if method == "lookup-wd":
        j_star, wd_j, h_j = kops.merge_pick(alpha, kappa_row, count, i_min, a_min, table,
                                            impl=impl)
    elif method in ("gss", "gss-precise"):
        j_star, wd_j, h_j = kops.gss_pick(alpha, kappa_row, count, i_min, a_min,
                                          n_iters=_gss_iters(method), impl=impl)
    else:
        valid = active & (alpha * a_min > 0) & (idx != i_min)
        wd, h = _scores(alpha, kappa_row, a_min, valid, method, table, impl=impl)
        j_star = torch.argmin(wd).reshape(1)
        wd_j, h_j = wd.index_select(0, j_star), h.index_select(0, j_star)
    has_partner = wd_j < NO_PARTNER
    a_j = alpha.index_select(0, j_star)
    kappa_j = kappa_row.index_select(0, j_star)

    # 4. merged point and coefficient
    z = merge_math.merge_point(h_j, x_min, sv_x.index_select(0, j_star)[0])
    a_z = merge_math.merge_alpha_z(a_min, a_j, torch.clamp(kappa_j, 0.0, 1.0), h_j)

    # 5. branch-free write, as in ``_merge_once``; index ``slots`` drops a write
    last = (count.to(torch.int64) - 1).reshape(1).clamp(min=0)
    v_last = sv_x.index_select(0, last)[0]
    a_last = alpha.index_select(0, last)
    lo, hi = torch.minimum(i_min, j_star), torch.maximum(i_min, j_star)
    ex = torch.ones_like(has_partner) if execute is None else execute
    t1 = torch.where(ex, torch.where(has_partner, lo, i_min), slots)
    t2 = torch.where(ex & has_partner, hi, slots)
    t_last = torch.where(ex, last, slots)
    m1, m2 = idx == t1, idx == t2
    sv1 = torch.where(has_partner, z.to(sv_x.dtype), v_last)
    sv_x = torch.where(m1[:, None], sv1, torch.where(m2[:, None], v_last, sv_x))
    a1 = torch.where(has_partner, a_z.to(alpha.dtype), a_last)
    alpha = torch.where(idx == t_last, 0.0, torch.where(m1, a1, torch.where(m2, a_last, alpha)))

    info = MaintenanceInfo(
        i_min=i_min[0], j_star=j_star[0], h_star=torch.where(has_partner, h_j, 1.0)[0],
        wd_star=torch.where(has_partner, wd_j, a_min * a_min)[0], merged=has_partner[0])
    return sv_x, alpha, count - ex.to(count.dtype).reshape(count.shape), info


def _merge_once(sv_x, alpha, kmat, count, gamma, method, table, *, kappa_row=None,
                execute=None, impl: str = "auto"):
    """One merge event per class, or the removal fallback where no same-sign
    partner exists.

    ``kmat`` is the (C, S, S) cache or None (then kappa rows are recomputed
    unless ``kappa_row`` is given).  ``execute`` ((C,) bool, or None for
    always) masks the whole event per class: where it is False every write
    is dropped and ``count`` is unchanged.  Returns ``(sv_x, alpha, kmat,
    count - executed, info)``; the inputs are not modified."""
    c, s = alpha.shape
    idx, ar = kref.iota(s, alpha.device), kref.iota(c, alpha.device)
    active = idx < count[:, None]

    # 1. fixed partner: the active SV with minimal |alpha| (first on ties)
    i_min = torch.argmin(torch.where(active, alpha.abs(), torch.inf), dim=1)
    a_min = alpha[ar, i_min]
    x_min = sv_x[ar, i_min]

    # 2. kappa row k(x_{i_min}, x_j): a cache read, or a recompute without one
    if kappa_row is None:
        kappa_row = (kmat[ar, i_min] if kmat is not None
                     else kops.rbf_row(sv_x, x_min, gamma, impl=impl))
    kappa_row = kappa_row.to(alpha.dtype)

    # 3. score the same-sign candidates, pick the best; lookup-wd reads the
    #    h table at the winner only, in the same pass, and gss searches h*
    #    candidate by candidate (each one launch on the card)
    if method == "lookup-wd":
        j_star, wd_j, h_j = kops.merge_pick(alpha, kappa_row, count, i_min, a_min, table,
                                            impl=impl)
    elif method in ("gss", "gss-precise"):
        j_star, wd_j, h_j = kops.gss_pick(alpha, kappa_row, count, i_min, a_min,
                                          n_iters=_gss_iters(method), impl=impl)
    else:
        valid = active & (alpha * a_min[:, None] > 0) & (idx != i_min[:, None])
        wd, h = _scores(alpha, kappa_row, a_min, valid, method, table, impl=impl)
        j_star = torch.argmin(wd, dim=1)
        wd_j, h_j = wd[ar, j_star], h[ar, j_star]
    has_partner = wd_j < NO_PARTNER
    a_j, kappa_j = alpha[ar, j_star], kappa_row[ar, j_star]

    # 4. merged point and coefficient; every gather before any write
    z = merge_math.merge_point(h_j[:, None], x_min, sv_x[ar, j_star])
    a_z = merge_math.merge_alpha_z(a_min, a_j, torch.clamp(kappa_j, 0.0, 1.0), h_j)
    last = (count.to(torch.int64) - 1).clamp(min=0)
    v_last, a_last = sv_x[ar, last], alpha[ar, last]
    lo, hi = torch.minimum(i_min, j_star), torch.maximum(i_min, j_star)

    # 5. branch-free write: a merge puts z at lo and moves the last SV into
    #    hi; the removal fallback moves the last SV into i_min.  Index ``s``
    #    drops a write.
    ex = torch.ones_like(has_partner) if execute is None else execute
    t1 = torch.where(ex, torch.where(has_partner, lo, i_min), s)
    t2 = torch.where(ex & has_partner, hi, s)
    t_last = torch.where(ex, last, s)
    if kmat is not None:
        # the z row from the two parents' rows; rows then columns, with the
        # intersections fixed so the two writes agree
        block = kmat[ar[:, None], torch.stack([j_star, last], dim=1)]
        row_last = block[:, 1]
        z_row = kernel_cache.z_row_from_rows(kappa_row.float(), block[:, 0], kappa_j[:, None],
                                             h_j[:, None]).to(kmat.dtype)
        z_row_l = z_row[ar, last][:, None]
        col = idx[None, :]
        r_merge = torch.where(col == lo[:, None], 1.0,
                              torch.where(col == hi[:, None], z_row_l, z_row))
        r_move = torch.where(col == lo[:, None], z_row_l,
                             torch.where(col == hi[:, None], 1.0, row_last))
        r_remove = torch.where(col == i_min[:, None], 1.0, row_last)
        rows = torch.stack([torch.where(has_partner[:, None], r_merge, r_remove), r_move], dim=1)
        kmat = kref.put_rows_and_columns(kmat, torch.stack([t1, t2], dim=1), rows)
    # the two targets' (C, S) masks serve both writes; t1 wins over t2, and
    # alpha[last] = 0 over both (it comes after the two moves)
    m1, m2 = idx == t1[:, None], idx == t2[:, None]
    sv1 = torch.where(has_partner[:, None], z.to(sv_x.dtype), v_last)
    sv_x = torch.where(m1[..., None], sv1[:, None],
                       torch.where(m2[..., None], v_last[:, None], sv_x))
    a1 = torch.where(has_partner, a_z.to(alpha.dtype), a_last)
    alpha = torch.where(idx == t_last[:, None], 0.0,
                        torch.where(m1, a1[:, None], torch.where(m2, a_last[:, None], alpha)))

    info = MaintenanceInfo(i_min=i_min, j_star=j_star,
                           h_star=torch.where(has_partner, h_j, 1.0),
                           wd_star=torch.where(has_partner, wd_j, a_min * a_min),
                           merged=has_partner)
    return sv_x, alpha, kmat, count - ex.to(count.dtype), info


def maintenance_step(sv_x, alpha, count, gamma, method: str = "lookup-wd",
                     table: MergeLookupTable | None = None, kappa_row=None, *,
                     impl: str = "auto"):
    """One budget-maintenance event on a binary state: merge two SVs (or
    remove one), count -= 1.  Pass ``kappa_row`` to skip the recompute.

    Returns ``(sv_x, alpha, count, MaintenanceInfo)``."""
    return _merge_once_binary(sv_x, alpha, count, gamma, method, table, kappa_row=kappa_row,
                              impl=impl)


def _multi_merge_once(sv_x, alpha, kmat, count, gamma, method, table, budget: int,
                      merge_batch: int, *, impl: str = "auto"):
    """One fused multi-merge event per class: up to P = ``merge_batch``
    disjoint same-sign pairs merge at once, count -= the executed pairs
    (>= 1 when over budget, <= min(P, count - budget); 0 otherwise, with
    nothing written).  Returns ``(sv_x, alpha, kmat, count)``."""
    c, s = alpha.shape
    p = merge_batch
    dev = alpha.device
    idx, ar = kref.iota(s, dev), kref.iota(c, dev)
    arc = ar[:, None]
    active = idx < count[:, None]

    # 1. fixed partners: the P smallest-|alpha| active SVs, cheapest first,
    #    lower slot first on ties (top_k's order; a stable sort keeps it)
    abs_a = torch.where(active, alpha.abs(), torch.inf)
    a_idx = torch.sort(abs_a, dim=1, stable=True).indices[:, :p]          # (C, P)
    a_min = alpha[arc, a_idx]

    # 2. kappa rows from the cache, or one (P, S) rbf block per class
    if kmat is not None:
        kappa_rows = kmat[arc, a_idx].to(alpha.dtype)
    else:
        kappa_rows = kops.rbf_per_class(sv_x[arc, a_idx], sv_x, gamma, impl=impl)

    # 3.-4. score all P x S pairs, then the greedy disjoint pair choice in
    #    |alpha| order (the loop is over the P pairs, every class at once):
    #    executing a pair takes both slots, a pair whose fixed slot was taken
    #    as an earlier partner is skipped, and none executes once the excess
    #    is covered.  Lookup-WD runs both in one launch on the card.
    if method == "lookup-wd":
        b_idx, merged, execute, h_star = kops.multi_merge_choose(
            alpha, kappa_rows, a_idx, a_min, count, budget, table, impl=impl)
    else:
        # a pair may merge with another pair's fixed slot; only its own is excluded
        self_mask = idx[None, None, :] == a_idx[:, :, None]
        valid = active[:, None, :] & (a_min[:, :, None] * alpha[:, None, :] > 0) & ~self_mask
        wd, h = _scores(alpha, kappa_rows, a_min, valid, method, table, impl=impl)
        b_idx, merged, execute = kref.greedy_pairs(wd, a_idx, count, budget)
        h_star = h[arc, kref.iota(p, dev), b_idx]
    n_exec = execute.sum(dim=1, dtype=count.dtype)

    # 5. one fused update: z_q overwrites a_q; b_q (or a_q on the removal
    #    fallback) becomes a hole; non-executing pairs write nothing
    kap = torch.clamp(kappa_rows[arc, kref.iota(p, dev), b_idx], 0.0, 1.0)
    a_z = merge_math.merge_alpha_z(a_min, alpha[arc, b_idx], kap, h_star)
    z = merge_math.merge_point(h_star[..., None], sv_x[arc, a_idx], sv_x[arc, b_idx])
    write_idx = torch.where(merged, a_idx, s)
    hole_idx = torch.where(merged, b_idx, torch.where(execute, a_idx, s))
    if kmat is not None:
        kmat = kernel_cache.apply_multi_merge(kmat, a_idx, b_idx, h_star, write_idx)
    sv_x = put_rows(sv_x, write_idx, z.to(sv_x.dtype))
    alpha = put_rows(alpha, write_idx, a_z.to(alpha.dtype))

    # 6. compaction by targeted moves: the k-th hole below the new watermark
    #    takes the k-th surviving slot above it (O(P S), not a permutation)
    hole_mask = torch.zeros((c, s + 1), dtype=torch.bool, device=dev).scatter_(
        1, hole_idx, True)[:, :s]
    new_count = count - n_exec
    below = idx < new_count[:, None]
    front_hole = hole_mask & below
    tail_surv = active & ~hole_mask & ~below
    dst = torch.sort(torch.where(front_hole, idx, s), dim=1).values[:, :p]
    src = torch.sort(torch.where(tail_surv, idx, s), dim=1).values[:, :p]
    src_c = src.clamp(max=s - 1)
    if kmat is not None:
        rows = kmat[arc, src_c]                                            # (C, P, S)
        kmat = kref.put_rows_and_columns(kmat, dst, rows)
        # the moved rows' intersections: slot dst_l now holds the old src_l
        kmat = kref.put_block(kmat, dst, dst, rows.gather(2, src_c[:, None, :].expand(c, p, p)))
    sv_x = put_rows(sv_x, dst, sv_x[arc, src_c])
    alpha = torch.where(below, put_rows(alpha, dst, alpha[arc, src_c]), 0.0)
    return sv_x, alpha, kmat, new_count


def _compaction_perm(hole_mask):
    """Stable permutation pushing hole slots behind every survivor, per class."""
    s = hole_mask.shape[-1]
    idx = kref.iota(s, hole_mask.device)
    return torch.argsort(torch.where(hole_mask, s + idx, idx), dim=-1, stable=True)


def _holes(alpha, count, budget: int):
    """The ``count - budget`` smallest-|alpha| active slots of each class (C, S)."""
    idx = kref.iota(alpha.shape[1], alpha.device)
    active = idx < count[:, None]
    excess = torch.clamp(count - budget, min=0)
    order = torch.argsort(torch.where(active, alpha.abs(), torch.inf), dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, idx.expand_as(order))
    return active, active & (rank < excess[:, None]), count - excess


def _compact(sv_x, alpha, kmat, hole_mask, new_count):
    c, s = alpha.shape
    arc = kref.iota(c, alpha.device)[:, None]
    perm = _compaction_perm(hole_mask)
    alpha = torch.where(kref.iota(s, alpha.device) < new_count[:, None],
                        alpha[arc, perm], 0.0)
    if kmat is not None:
        kmat = kernel_cache.permute(kmat, perm)
    return sv_x[arc, perm], alpha, kmat, new_count


def _removal_all(sv_x, alpha, kmat, count, budget: int):
    """Remove the ``count - budget`` smallest-|alpha| SVs of each class in one
    permutation (the identity where ``count <= budget``)."""
    _, hole_mask, new_count = _holes(alpha, count, budget)
    return _compact(sv_x, alpha, kmat, hole_mask, new_count)


def _removal_project_all(sv_x, alpha, kmat, count, budget: int):
    """BOGD-style removal (arXiv 1206.4633): the same holes as ``_removal_all``,
    but each dropped SV's mass first moves onto the survivors, survivor j
    gaining ``sum_i alpha_i k(x_i, x_j) / sum_j' k(x_i, x_j')`` over dropped
    i, every k read from the cache."""
    active, hole_mask, new_count = _holes(alpha, count, budget)
    surv = active & ~hole_mask
    k_hs = torch.where(hole_mask[:, :, None] & surv[:, None, :], kmat.float(), 0.0)
    denom = torch.clamp(k_hs.sum(dim=2), min=1e-12)
    w = torch.where(hole_mask, alpha.float(), 0.0) / denom
    gain = torch.bmm(w[:, None, :], k_hs)[:, 0]
    over = (count > budget)[:, None]
    alpha = torch.where(surv & over, alpha + gain.to(alpha.dtype), alpha)
    return _compact(sv_x, alpha, kmat, hole_mask, new_count)


def _quantized_all(sv_x, alpha, kmat, count, budget: int):
    """Fixed-centroid absorption (arXiv 1701.00167): the first ``budget`` slots
    are the codebook; each fresh violator in slots [budget, count) adds
    ``alpha_i k(x_i, c_j)`` to its nearest centroid j (the argmax of its
    cached row over the codebook), and ``count`` drops back to ``budget``."""
    c, s = alpha.shape
    idx = kref.iota(s, alpha.device)
    fresh = (idx >= budget) & (idx < count[:, None])
    cent = (idx < budget).expand(c, s)
    k_fc = torch.where(fresh[:, :, None] & cent[:, None, :], kmat.float(), -1.0)
    nearest = torch.argmax(k_fc, dim=2)                                    # (C, S)
    k_near = k_fc.gather(2, nearest[:, :, None])[:, :, 0]
    w = torch.where(fresh, alpha.float() * k_near, 0.0)
    # fresh slots are the static tail [budget, S): sum their one-hot rows in order
    tail = slice(budget, s)
    onehot = nearest[:, tail, None] == idx
    gain = torch.where(onehot, w[:, tail, None], 0.0).sum(dim=1)
    over = (count > budget)[:, None]
    alpha = torch.where(cent & over, alpha + gain.to(alpha.dtype),
                        torch.where(over, 0.0, alpha))
    return sv_x, alpha, kmat, torch.minimum(count, torch.full_like(count, budget))


def kmeans_codebook(x, k: int, *, iters: int = 10, seed: int = 0, init=None):
    """Lloyd's k-means over ``x`` (n, dim): a (k, dim) float32 codebook for
    warm-starting the quantized strategy (``seed_codebook``).

    ``init`` gives the k starting rows by index; by default they are drawn
    without replacement from a numpy generator seeded with ``seed``.  A
    cluster that goes empty keeps its previous centroid."""
    x = torch.as_tensor(x).float()
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"kmeans_codebook needs 1 <= k={k} <= n={n}")
    if init is None:
        init = np.random.default_rng(seed).choice(n, k, replace=False)
    cent = x[torch.as_tensor(np.array(init), device=x.device).long()]
    for _ in range(iters):
        d2 = torch.sum((x[:, None, :] - cent[None, :, :]) ** 2, dim=-1)
        assign = torch.argmin(d2, dim=1)
        one_hot = (assign[:, None] == torch.arange(k, device=x.device)[None, :]).to(x.dtype)
        sums = one_hot.T @ x
        counts = one_hot.sum(dim=0)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cent = torch.where((counts > 0)[:, None], new, cent)
    return cent


def seed_codebook(state, centroids, gamma, *, impl: str = "auto"):
    """Seed a fresh binary state's bank with a fixed centroid codebook: the
    centroids (k, dim) go into the first k slots, the cache's codebook block
    is filled exactly, and the watermark is set to k with zero coefficients.
    Needs the kernel cache."""
    if state.kmat is None:
        raise ValueError("seed_codebook requires the kernel cache (use_kernel_cache=True): "
                         "quantized absorption reads cached kernel rows")
    c = torch.as_tensor(centroids).to(state.sv_x.device)
    k = c.shape[0]
    if k > state.alpha.shape[0]:
        raise ValueError(f"codebook k={k} exceeds the bank's {state.alpha.shape[0]} slots")
    sv_x = state.sv_x.clone()
    sv_x[:k] = c.to(sv_x.dtype)
    block = kops.rbf_matrix(sv_x[:k], sv_x[:k], gamma, impl=impl).float()
    block = (block + block.T) / 2                  # exact symmetry (I2)
    block.fill_diagonal_(1.0)
    kmat = state.kmat.clone()
    kmat[:k, :k] = block
    return state._replace(sv_x=sv_x, kmat=kmat,
                          count=torch.full_like(state.count, k))


def run_maintenance_stacked(sv_x, alpha, kmat, count, n_events, gamma, table, *, budget: int,
                            strategy: str = "merge", method: str = "lookup-wd",
                            merge_batch: int = 4, impl: str = "auto", unroll: int = 0):
    """``run_maintenance`` for every class of a stacked state at once (the
    reference's ``jax.vmap`` of it): sv_x (C, S, D), alpha (C, S), kmat
    (C, S, S) or None, count and n_events (C,).  ``unroll`` as in
    ``run_maintenance``; the drain (``unroll=0``) runs as many masked events
    as the largest class excess."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
    over = count > budget
    if strategy in ("removal", "removal-project", "quantized"):
        if strategy != "removal" and kmat is None:
            raise ValueError(f"strategy={strategy!r} reads cached kernel rows and needs the "
                             "kernel cache (use_kernel_cache=True)")
        fn = {"removal": _removal_all, "removal-project": _removal_project_all,
              "quantized": _quantized_all}[strategy]
        sv_x, alpha, kmat, count = fn(sv_x, alpha, kmat, count, budget)
        return sv_x, alpha, kmat, count, n_events + over.to(n_events.dtype)
    for _ in _rounds(count, budget, unroll):
        over = count > budget
        if strategy == "merge":
            sv_x, alpha, kmat, count, _ = _merge_once(sv_x, alpha, kmat, count, gamma, method,
                                                      table, execute=over, impl=impl)
        else:
            sv_x, alpha, kmat, count = _multi_merge_once(sv_x, alpha, kmat, count, gamma, method,
                                                         table, budget, merge_batch, impl=impl)
        n_events = n_events + over.to(n_events.dtype)
    return sv_x, alpha, kmat, count, n_events


def _events(count, budget: int, unroll: int) -> int:
    """The masked events (rounds) a maintenance call runs: ``unroll``, or for
    the drain (``unroll=0``) the largest excess ``count - budget``, which is
    read from the card (the drain's one host sync).  Every executed event
    lowers ``count`` by at least one, so that many reach the budget, and a
    masked event past it changes nothing: a drain of e events equals
    ``unroll=e`` bit for bit."""
    if unroll < 0:
        raise ValueError(f"unroll={unroll} < 0")
    if unroll or not planned.is_fake(count):
        return unroll or int(torch.clamp(count - budget, min=0).max())
    return planned.excess()          # a dry run cannot read the card: the stated count


def _rounds(count, budget: int, unroll: int):
    """The loop over a maintenance call's ``_events`` rounds.  In a dry run (a
    fake ``count``) one round is traced, standing for all of them
    (``kernels.planned.rounds``): the rounds are alike in shape."""
    if planned.is_fake(count):
        return planned.rounds(_events(count, budget, unroll))
    return range(_events(count, budget, unroll))


def run_maintenance(sv_x, alpha, kmat, count, n_events, gamma, table, *, budget: int,
                    strategy: str = "merge", method: str = "lookup-wd", merge_batch: int = 4,
                    impl: str = "auto", unroll: int = 0):
    """Budget maintenance of a binary state until ``count <= budget``.

    ``kmat`` is the (S, S) kernel cache, or None to recompute kappa rows per
    event; it is kept consistent through merges and compaction.  ``merge``
    and ``multi-merge`` run events masked to a no-op once ``count <=
    budget``: by default (``unroll=0``, the reference's while loop) as many
    as the excess ``count - budget``, which costs one host read of
    ``count``; with ``unroll > 0`` exactly ``unroll`` of them and no host
    sync (the reference's ``unroll`` form), where the caller guarantees the
    excess never exceeds ``unroll``.  The training step passes ``unroll =
    batch_size``: one step inserts at most ``batch_size`` rows and every
    event lowers ``count`` by at least one, so there it reaches the state
    the drain does.  The removal strategies drop the whole excess in one
    pass.  Returns ``(sv_x, alpha,
    kmat, count, n_events)``, ``n_events`` +1 per executed event.  Uncached
    ``merge`` runs the binary event (``_merge_once_binary``); every other
    case runs the class-axis code with C = 1."""
    if strategy == "merge" and kmat is None:
        for _ in _rounds(count, budget, unroll):
            over = count > budget
            sv_x, alpha, count, _ = _merge_once_binary(sv_x, alpha, count, gamma, method, table,
                                                       execute=over, impl=impl)
            n_events = n_events + over.to(n_events.dtype)
        return sv_x, alpha, None, count, n_events
    out = run_maintenance_stacked(
        sv_x[None], alpha[None], None if kmat is None else kmat[None], count.reshape(1),
        n_events.reshape(1), gamma, table, budget=budget, strategy=strategy, method=method,
        merge_batch=merge_batch, impl=impl, unroll=unroll)
    sv_x, alpha, kmat, count1, n1 = out
    return (sv_x[0], alpha[0], None if kmat is None else kmat[0], count1.reshape(count.shape),
            n1.reshape(n_events.shape))


def run_maintenance_classes(sv_x, alpha, kmat, count, n_events, table, *, budget: int,
                            impl: str = "auto", unroll: int = 0):
    """Budget maintenance for a stacked class axis as fused event rounds.

    The rounds are ONE ``merge_event_rounds`` launch in which, each round,
    every class still over budget runs a whole Lookup-WD merge event and the
    other classes are not touched.  By default (``unroll=0``, the
    reference's drain) the launch runs as many rounds as the largest class
    excess, read from the card once (a host sync); ``unroll > 0`` runs that
    many masked rounds with no sync (one insert minibatch bounds the excess
    by ``batch_size``, the training step's ``unroll``, which then reaches
    the drain's state).  With no class over budget the state comes back
    bitwise unchanged.  The cache is required: the event
    reads its kappa rows from it.  With C = 1 this is the single-class
    engine (``_merge_once`` off the cache), whose decisions the event's are
    pinned to.  Returns ``(sv_x, alpha, kmat, count, n_events)``; the inputs
    are not modified (``event_rounds_`` is the form that takes them over)."""
    _check_event_engine(kmat, table)
    if sv_x.shape[0] == 1:
        return run_maintenance_stacked(sv_x, alpha, kmat, count, n_events, 0.0, table,
                                       budget=budget, strategy="merge", method="lookup-wd",
                                       impl=impl, unroll=unroll)
    # the event updates its operands in place: work on copies
    sv_x, alpha, kmat = (t.clone(memory_format=torch.contiguous_format)
                         for t in (sv_x, alpha, kmat))
    return event_rounds_(sv_x, alpha, kmat, count, n_events, table, budget=budget, impl=impl,
                         unroll=unroll)


def event_rounds_(sv_x, alpha, kmat, count, n_events, table, *, budget: int,
                  impl: str = "auto", unroll: int = 0):
    """``run_maintenance_classes`` on operands the caller hands over: ``sv_x``,
    ``alpha`` and ``kmat`` are updated IN PLACE (each first made contiguous,
    which copies only one that is not) and returned with the new ``count``
    and ``n_events``.  For a caller whose operands are fresh tensors of its
    own, such as the insert half of a training step, this saves the copies.
    ``unroll`` as in ``run_maintenance_classes`` (0 drains, with one host
    read of ``count``)."""
    _check_event_engine(kmat, table)
    rounds = _events(count, budget, unroll)
    sv_x, alpha, kmat = sv_x.contiguous(), alpha.contiguous(), kmat.contiguous()
    # the rounds update count and n_events in place too: on a copy (one
    # launch for both), since the caller's counters may be its previous state's
    count, n_events = torch.stack((count, n_events))
    if rounds == 0:
        return sv_x, alpha, kmat, count, n_events
    return kops.merge_event_rounds(sv_x, alpha, kmat, count, n_events, table, rounds=rounds,
                                   budget=budget, impl=impl)


def _check_event_engine(kmat, table) -> None:
    if kmat is None:
        raise ValueError("run_maintenance_classes needs the kernel cache "
                         "(use_kernel_cache=True): the fused event reads its kappa rows from kmat")
    if table is None:
        raise ValueError("run_maintenance_classes scores with Lookup-WD and needs the table")
