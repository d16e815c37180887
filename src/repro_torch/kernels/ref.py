"""Plain PyTorch versions of the port's kernels: the semantics of record.

Each hand-written CUDA kernel is held against the function here on the
card (``chip_smoke.py``), and these are what ``kernels.ops`` runs for
tensors on the CPU.  They mirror ``repro.kernels.ref`` operation by
operation, so the CPU path agrees with the JAX reference to float32
round-off.  Inputs stored in bf16 are widened to fp32 first, which is what
the kernels compute.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# Scores at/above this mean "no valid partner".  The plain scorer marks
# invalid slots +inf and the CUDA scorer a finite 3.4e38; real WDs are far
# below 1e30, so both lose every argmin and both compare >= NO_PARTNER.
NO_PARTNER = 1e30
# kappa values are clipped away from 0 before log (core.merge_math.KAPPA_MIN).
_KAPPA_MIN = 1e-30
_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0


def rbf_matrix(x, y, gamma):
    """K[i, j] = exp(-gamma ||x_i - y_j||^2) in matmul form,
    ||x||^2 + ||y||^2 - 2 x.y clamped at 0.  x (..., n, d), y (..., m, d) -> (..., n, m)."""
    x, y = x.float(), y.float()
    xn = torch.sum(x * x, dim=-1)[..., :, None]
    yn = torch.sum(y * y, dim=-1)[..., None, :]
    d2 = xn + yn - 2.0 * (x @ y.mT)
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def rbf_row(sv_x, x, gamma):
    """kappa_row[j] = k(x, sv_x[j]) in direct-difference form; sv_x (..., s, d),
    x (..., d) -> (..., s).

    Numerically not the matmul form: the two differ by float32 round-off,
    as they do in the reference."""
    diff = sv_x.float() - x.float()[..., None, :]
    return torch.exp(-gamma * torch.sum(diff * diff, dim=-1))


def bilinear_lookup(table, u, v):
    """Bilinear interpolation of ``table`` (G0, G1) at unit-square coords (u, v).

    ``table[i, j]`` holds the value at ``(i/(G0-1), j/(G1-1))``; i0/j0 are
    clipped to G-2 so the edges interpolate inside the last cell."""
    g0, g1 = table.shape
    uu = torch.clamp(u, 0.0, 1.0) * (g0 - 1)
    vv = torch.clamp(v, 0.0, 1.0) * (g1 - 1)
    i0 = torch.clamp(torch.floor(uu).to(torch.int64), 0, g0 - 2)
    j0 = torch.clamp(torch.floor(vv).to(torch.int64), 0, g1 - 2)
    du = uu - i0
    dv = vv - j0
    top = table[i0, j0] * (1 - dv) + table[i0, j0 + 1] * dv
    bot = table[i0 + 1, j0] * (1 - dv) + table[i0 + 1, j0 + 1] * dv
    return top * (1 - du) + bot * du


def merge_coords(a_min, alpha, kappa):
    """Table coordinates ``(m, kappa)`` of the merge problem, clipped to the unit square.

    ``m = a_min / (a_min + alpha)`` with a zero denominator read as 1, so
    masked-out entries stay finite and cannot poison an argmin."""
    denom = a_min + alpha
    m = torch.clamp(a_min / torch.where(denom == 0, 1.0, denom), 0.0, 1.0)
    return m, torch.clamp(kappa, 0.0, 1.0)


def merge_scores(alpha, kappa_row, valid, a_min, wd_table):
    """Lookup-WD score per candidate, +inf at invalid slots.

    alpha, kappa_row, valid: (s,); a_min: scalar or one-element tensor (or
    rows (R, s) with a_min (R, 1))."""
    m, kap = merge_coords(a_min, alpha, kappa_row)
    denom = a_min + alpha
    wd = denom * denom * bilinear_lookup(wd_table, m, kap)
    return torch.where(valid, wd, torch.inf)


def _safe_log(k):
    return torch.log(torch.clamp(k.float(), _KAPPA_MIN, 1.0))


def gss(m, kappa, n_iters: int):
    """Golden section search maximizing m k^((1-h)^2) + (1-m) k^(h^2) over [0, 1],
    ``n_iters`` bracket steps, in float32; returns the final bracket's midpoint."""
    m = m.float()
    lk = _safe_log(kappa)

    def s(h):
        u = 1.0 - h
        return m * torch.exp(u * u * lk) + (1.0 - m) * torch.exp(h * h * lk)

    a = torch.zeros_like(m)
    b = torch.ones_like(m)
    for _ in range(n_iters):
        span = b - a
        c = b - span * _INVPHI
        d = a + span * _INVPHI
        go_left = s(c) > s(d)
        a, b = torch.where(go_left, a, c), torch.where(go_left, d, b)
    return 0.5 * (a + b)


def merge_pick(alpha, kappa, count, i_min, a_min, wd_table, h_table):
    """The choice of one Lookup-WD merge event per row (the plain version of
    the ``merge_pick`` kernel): ``core.budget._merge_once``'s step 3, op for op.

    alpha, kappa: (s,) or (R, s); count: 0-d or (R,); i_min, a_min: (R,).
    Candidate j is valid when ``j < count``, ``alpha_j * a_min > 0`` and
    ``j != i_min``.  Returns ``(j_star, wd_j, h_j)`` (R,): the first-occurrence
    argmin of the Lookup-WD scores (+inf where invalid, so slot 0 when none
    is valid), its score, and the h table at the winner."""
    s = alpha.shape[-1]
    alpha, kappa = alpha.reshape(-1, s), kappa.reshape(-1, s)
    a_col = a_min.reshape(-1, 1)
    idx = iota(s, alpha.device)
    valid = (idx < count.reshape(-1, 1)) & (alpha * a_col > 0) & (idx != i_min.reshape(-1, 1))
    wd = merge_scores(alpha, kappa, valid, a_col, wd_table)
    j_star = torch.argmin(wd, dim=1)
    at_j = lambda t: t.gather(1, j_star[:, None])[:, 0]
    m, kap = merge_coords(a_min.reshape(-1), at_j(alpha), at_j(kappa))
    return j_star, at_j(wd), bilinear_lookup(h_table, m, kap)


def gss_pick(alpha, kappa, count, i_min, a_min, n_iters: int):
    """The choice of one GSS merge event per row (the plain version of the
    ``gss_pick`` kernel): ``core.budget._merge_once``'s step 3 under ``gss``
    and ``gss-precise``, op for op.

    alpha, kappa: (s,) or (R, s); count: 0-d or (R,); i_min, a_min: (R,).
    Candidate j is valid when ``j < count``, ``alpha_j * a_min > 0`` and
    ``j != i_min``.  Every candidate's h* comes from ``n_iters`` bracket steps
    of ``gss`` at its ``(m, kappa)``, then its merged coefficient and weight
    degradation (``core.merge_math.merge_alpha_z`` and
    ``weight_degradation``).  Returns ``(j_star, wd_j, h_j)`` (R,): the
    first-occurrence argmin of the WD (+inf where invalid, so slot 0 when
    none is valid), its WD, and h* at the winner."""
    s = alpha.shape[-1]
    alpha, kappa = alpha.reshape(-1, s), kappa.reshape(-1, s)
    a_col = a_min.reshape(-1, 1)
    idx = iota(s, alpha.device)
    valid = (idx < count.reshape(-1, 1)) & (alpha * a_col > 0) & (idx != i_min.reshape(-1, 1))
    m, kap = merge_coords(a_col, alpha, kappa)
    h = gss(m, kap, n_iters)
    u = 1.0 - h
    a_z = a_col * _kappa_pow(kap, u * u) + alpha * _kappa_pow(kap, h * h)
    wd = a_col * a_col + alpha * alpha + 2.0 * a_col * alpha * kap - a_z * a_z
    wd = torch.where(valid, wd, torch.inf)
    j_star = torch.argmin(wd, dim=1)
    at_j = lambda t: t.gather(1, j_star[:, None])[:, 0]
    return j_star, at_j(wd), at_j(h)


def multi_merge_scores_rows(alpha_rows, kappa_rows, valid, a_min, h_table, wd_table):
    """Lookup-WD scoring where every fixed partner brings its own candidate-alpha row.

    alpha_rows, kappa_rows, valid: (P, s); a_min: (P,); tables: (G, G).
    Returns ``(wd, h)`` of shape (P, s), WD +inf at invalid slots."""
    a = a_min[:, None]
    m, kap = merge_coords(a, alpha_rows, kappa_rows)
    denom = a + alpha_rows
    wd = denom * denom * bilinear_lookup(wd_table, m, kap)
    return torch.where(valid, wd, torch.inf), bilinear_lookup(h_table, m, kap)


def multi_merge_scores(alpha, kappa_rows, valid, a_min, h_table, wd_table):
    """P fixed partners sharing one alpha: alpha (s,); kappa_rows, valid (P, s);
    a_min (P,) -> ``(wd, h)`` of shape (P, s)."""
    alpha_rows = alpha[None, :].expand(kappa_rows.shape)
    return multi_merge_scores_rows(alpha_rows, kappa_rows, valid, a_min, h_table, wd_table)


def multi_merge_scores_classes(alpha, kappa_rows, valid, a_min, h_table, wd_table):
    """Class-batched form: alpha (C, s); kappa_rows, valid (C, P, s); a_min (C, P)
    -> ``(wd, h)`` of shape (C, P, s)."""
    c, p, s = kappa_rows.shape
    wd, h = multi_merge_scores_rows(alpha[:, None, :].expand(c, p, s).reshape(c * p, s),
                                    kappa_rows.reshape(c * p, s), valid.reshape(c * p, s),
                                    a_min.reshape(c * p), h_table, wd_table)
    return wd.reshape(c, p, s), h.reshape(c, p, s)


def greedy_pairs(wd, a_idx, count, budget: int):
    """The greedy disjoint pair choice of a multi-merge event, every class at
    once (``core.budget._multi_merge_once`` step 4).

    wd: (C, P, s) scores of the P fixed partners (slots ``a_idx`` (C, P), in
    |alpha| order), ``>= NO_PARTNER`` where a candidate may not merge; count:
    (C,).  In |alpha| order a pair executes unless its fixed slot was taken as
    an earlier partner or the excess ``count - budget`` is covered, merges
    with its best untaken candidate (first on ties) or falls back to removal,
    and takes both slots.  Returns ``(b_idx, merged, execute)``, (C, P) each."""
    c, p, s = wd.shape
    dev = wd.device
    idx, ar = iota(s, dev), iota(c, dev)
    excess = count - budget
    taken = torch.zeros((c, s), dtype=torch.bool, device=dev)
    consumed = torch.zeros((c, p), dtype=torch.bool, device=dev)
    n_exec = torch.zeros_like(count)
    b_list, merged_list, exec_list = [], [], []
    for q in range(p):
        wd_q = torch.where(taken, torch.inf, wd[:, q])
        j_q = torch.argmin(wd_q, dim=1)
        exec_q = ~consumed[:, q] & (n_exec < excess)
        merged_q = exec_q & (wd_q[ar, j_q] < NO_PARTNER)
        b_list.append(j_q)
        merged_list.append(merged_q)
        exec_list.append(exec_q)
        taken = (taken | ((idx == j_q[:, None]) & merged_q[:, None])
                 | ((idx == a_idx[:, q, None]) & exec_q[:, None]))
        consumed = consumed | ((a_idx == j_q[:, None]) & merged_q[:, None])
        n_exec = n_exec + exec_q.to(n_exec.dtype)
    return torch.stack(b_list, dim=1), torch.stack(merged_list, dim=1), torch.stack(exec_list, dim=1)


def multi_merge_choose(alpha, kappa_rows, a_idx, a_min, count, budget: int, h_table, wd_table):
    """Scoring and greedy pair choice of one multi-merge event per class (the
    plain version of the ``multi_merge_choose`` kernel): steps 3-4 of
    ``core.budget._multi_merge_once`` under Lookup-WD, op for op.

    alpha: (C, s); kappa_rows: (C, P, s); a_idx: (C, P) int64; a_min: (C, P);
    count: (C,).  A pair may merge with another pair's fixed slot; only its
    own is excluded.  Returns ``(b_idx, merged, execute, h_star)``, (C, P)
    each, ``h_star`` the h table at each pair's candidate."""
    c, p, s = kappa_rows.shape
    idx = iota(s, alpha.device)
    active = idx < count[:, None]
    self_mask = idx[None, None, :] == a_idx[:, :, None]
    valid = active[:, None, :] & (a_min[:, :, None] * alpha[:, None, :] > 0) & ~self_mask
    wd, h = multi_merge_scores_classes(alpha, kappa_rows, valid, a_min, h_table, wd_table)
    b_idx, merged, execute = greedy_pairs(wd, a_idx, count, budget)
    h_star = h[iota(c, alpha.device)[:, None], iota(p, alpha.device), b_idx]
    return b_idx, merged, execute, h_star


def class_scores(x, sv_x, alpha, gamma):
    """Per-class decision scores, class by class (the oracle of ``ops.class_scores``).

    x: (n, d); sv_x: (C, slots, d); alpha: (C, slots), inactive slots zeroed
    -> (C, n)."""
    return torch.stack([rbf_matrix(x, sv_x[c], gamma).to(alpha.dtype) @ alpha[c]
                        for c in range(sv_x.shape[0])])


def rbf_matrix_rows(x, y, gamma):
    """``rbf_matrix`` with every output's sums in one fixed order, whatever n:
    x.y, |x|^2 and |y|^2 summed feature by feature (k = 0, 1, ..., d - 1),
    elementwise products and adds only.  A matrix product may pick its
    algorithm, and so its order of summation, by the row count; this form
    gives a row the same bits in a batch of any size (the serve cell's plain
    path).  x (n, d), y (m, d) -> (n, m) fp32."""
    x, y = x.float(), y.float()
    xy = x.new_zeros((x.shape[0], y.shape[0]))
    xn = x.new_zeros((x.shape[0], 1))
    yn = y.new_zeros((y.shape[0],))
    for k in range(x.shape[1]):
        xk, yk = x[:, k:k + 1], y[:, k]
        xy = xy + xk * yk
        xn = xn + xk * xk
        yn = yn + yk * yk
    d2 = xn + yn - 2.0 * xy
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def class_scores_labels(k, alpha, *, binary: bool = False):
    """The serve cell's contraction and label (the plain version of
    ``csrc/class_scores.cu``): ``(scores, labels)``.

    k: (n, C * s) fp32 kernel block; alpha: (C, s) fp32.  scores[c, i] sums
    k[i, c s + j] * alpha[c, j] as the kernel does: lane l of 32 adds the
    products of slots l, l + 32, ... in order (each product rounded, then
    each sum), then the butterfly halves the 32 partials (lane l plus lane
    l + 16, then + 8, ...).  Elementwise ops only, so a row's scores do not
    depend on n.  labels: (n,) int32, the first maximum over classes (a NaN
    counts as the maximum, as ``jnp.argmax``), or for a binary model (C = 1)
    the fp32 sign, 0 for a zero score and NaN for NaN (``jnp.sign``)."""
    c, s = alpha.shape
    n = k.shape[0]
    lanes = -(-s // 32) * 32
    kk = torch.nn.functional.pad(k.float().view(n, c, s), (0, lanes - s))
    aa = torch.nn.functional.pad(alpha.float(), (0, lanes - s))
    part = kk.new_zeros((n, c, 32))
    for t in range(0, lanes, 32):
        part = part + kk[..., t:t + 32] * aa[:, t:t + 32]
    for half in (16, 8, 4, 2, 1):
        part = part[..., :half] + part[..., half:2 * half]
    scores = part[..., 0].T.contiguous()                  # (C, n)
    if binary:
        v = scores[0]
        return scores, torch.where(v > 0, 1.0, torch.where(v < 0, -1.0, v))
    best, arg = scores[0], torch.zeros(n, dtype=torch.int32, device=k.device)
    for q in range(1, c):
        v = scores[q]
        better = (v > best) | (torch.isnan(v) & ~torch.isnan(best))
        best = torch.where(better, v, best)
        arg = torch.where(better, q, arg).to(torch.int32)
    return scores, arg


def _kappa_pow(kappa, expo):
    """kappa**expo as exp(expo log kappa) (``core.merge_math.kappa_pow``)."""
    return torch.exp(expo * _safe_log(kappa))


@functools.lru_cache(maxsize=64)
def iota(n: int, device) -> torch.Tensor:
    """``torch.arange(n)`` on ``device``, made once (on the card each fresh
    ``arange`` is a launch).  Shared: callers must not write to it."""
    return torch.arange(n, device=device)


def put_rows(a, t, rows):
    """``a`` with ``a[c, t[c, k]] = rows[c, k]`` along dim 1, out of place; an
    entry whose ``t[c, k]`` equals ``a.shape[1]`` is dropped, and where two
    entries share a target the earlier one wins.

    a: (C, n, ...); t: (C, K) int; rows: (C, K, ...).  A few elementwise
    passes over ``a`` and no host sync: the form for the training path on
    the card, where a launch costs more than the bytes."""
    c, n = a.shape[:2]
    idx = iota(n, a.device)
    pad = (1,) * (a.dim() - 2)
    if t.shape[1] <= 3:
        # one where-pass per entry, last entry first; few view ops, since on
        # the card the host's dispatch of each op is what a step waits on
        col = idx.view(1, n, *pad)
        targets = t.view(c, -1, 1, *pad).unbind(1)
        for tk, rk in zip(reversed(targets), reversed(rows.unsqueeze(2).unbind(1))):
            a = torch.where(col == tk, rk, a)
        return a
    hit, src = torch.max(t[:, :, None] == idx, dim=1)        # any hit, and the first one
    return torch.where(hit.view(c, n, *pad), rows[iota(c, a.device)[:, None], src], a)


def put_rows_and_columns(a, t, rows):
    """``a`` (C, n, n) with rows ``t``, then the same columns, set from
    ``rows`` (C, K, n), out of place (``put_rows``' drop rule)."""
    a = put_rows(a, t, rows)
    return put_rows(a.transpose(1, 2), t, rows).transpose(1, 2)


def put_block(a, r, q, vals):
    """``a`` (C, n, n) with ``a[c, r[c, i], q[c, j]] = vals[c, i, j]``, out of
    place; pairs where either index equals n are dropped."""
    c, n = a.shape[:2]
    idx = iota(n, a.device)
    hit_r, src_r = torch.max(r[:, :, None] == idx, dim=1)
    hit_q, src_q = torch.max(q[:, :, None] == idx, dim=1)
    g = vals[iota(c, a.device)[:, None, None], src_r[:, :, None], src_q[:, None, :]]
    return torch.where(hit_r[:, :, None] & hit_q[:, None, :], g, a)


def put_diag(a, t, value: float):
    """``a`` (C, n, n) with ``a[c, t[c, k], t[c, k]] = value``, out of place;
    targets equal to n are dropped."""
    idx = iota(a.shape[1], a.device)
    on = (t[:, :, None] == idx).any(dim=1)                                # (C, n)
    return torch.where(on[:, :, None] & (idx[:, None] == idx), value, a)


def merge_event(sv_x, alpha, kmat, count, over, h_table, wd_table, decisions=None):
    """One maintenance-event round over stacked classes, IN PLACE (the plain
    version of the ``merge_event`` kernel).

    Per class with ``over`` set, one cached Lookup-WD merge event exactly as
    ``core.budget._merge_once`` runs it on that class: the active argmin-|alpha|
    fixed partner (first on ties), its kappa row read from the cache, every
    candidate scored from the WD table, the best same-sign partner or the
    removal fallback, the merged point's cache row from the log-space combine
    of the two parent rows, and the two-row + two-column cache update with
    the old ``last`` moved into the freed slot.

    sv_x: (C, s, d) fp32 or bf16; alpha: (C, s); kmat: (C, s, s) fp32; count:
    (C,) int; over: (C,) bool.  Classes with ``over`` clear are not written.
    ``decisions`` ((C, 3) int32 or None) receives each executing class's
    ``(i_min, j_star, merged)``.  Returns ``(sv_x, alpha, kmat)``, the same
    tensors; the caller owns ``count -= over``.
    """
    c, s = alpha.shape
    dev = alpha.device
    idx = torch.arange(s, device=dev)
    ar = torch.arange(c, device=dev)
    active = idx[None, :] < count[:, None]

    # 1. fixed partners: per-class active min-|alpha| slot (first on ties)
    i_min = torch.argmin(torch.where(active, alpha.abs(), torch.inf), dim=1)
    a_min = alpha[ar, i_min]

    # 2. kappa rows from the cache
    kappa_row = kmat[ar, i_min].to(alpha.dtype)

    # 3. Lookup-WD scores; h only at the winner (the same elementwise lookup)
    valid = active & (alpha * a_min[:, None] > 0) & (idx[None, :] != i_min[:, None])
    m, kap = merge_coords(a_min[:, None], alpha, kappa_row)
    denom = a_min[:, None] + alpha
    wd = torch.where(valid, denom * denom * bilinear_lookup(wd_table, m, kap), torch.inf)
    j_star = torch.argmin(wd, dim=1)
    has_partner = wd[ar, j_star] < NO_PARTNER

    # 4. merge math on the chosen pairs; every gather before any write
    last = (count.to(torch.int64) - 1) % s
    lo, hi = torch.minimum(i_min, j_star), torch.maximum(i_min, j_star)
    h_m = bilinear_lookup(h_table, m[ar, j_star], kap[ar, j_star])
    k_ij = kappa_row[ar, j_star]
    kap_m = torch.clamp(k_ij, 0.0, 1.0)
    a_j, a_last = alpha[ar, j_star], alpha[ar, last]
    u = 1.0 - h_m
    a_z = (a_min * _kappa_pow(kap_m, u * u) + a_j * _kappa_pow(kap_m, h_m * h_m)).to(alpha.dtype)
    x_i, x_j, v_last = sv_x[ar, i_min].float(), sv_x[ar, j_star].float(), sv_x[ar, last]
    z = h_m[:, None] * x_i + (1.0 - h_m[:, None]) * x_j
    row_j, row_last = kmat[ar, j_star], kmat[ar, last]
    lz = (h_m[:, None] * _safe_log(kappa_row) + (1.0 - h_m[:, None]) * _safe_log(row_j)
          - (h_m * (1.0 - h_m))[:, None] * _safe_log(k_ij)[:, None])
    z_row = torch.exp(torch.clamp(lz, max=0.0)).to(kmat.dtype)

    # 5. in the executing classes, slot t1 <- z (or the old ``last`` on
    #    removal) and, on a merge, slot hi <- the old ``last``; rows first,
    #    then columns, so the intersections take the column values
    col = idx[None, :]
    z_row_l = z_row[ar, last][:, None]
    r_merge = torch.where(col == lo[:, None], 1.0,
                          torch.where(col == hi[:, None], z_row_l, z_row))
    r_move = torch.where(col == lo[:, None], z_row_l,
                         torch.where(col == hi[:, None], 1.0, row_last))
    r1 = torch.where(has_partner[:, None], r_merge,
                     torch.where(col == i_min[:, None], 1.0, row_last))
    t1 = torch.where(has_partner, lo, i_min)
    moved = over & has_partner
    c1, c2 = ar[over], ar[moved]
    kmat[c1, t1[over]] = r1[over]
    kmat[c2, hi[moved]] = r_move[moved]
    kmat[c1, :, t1[over]] = r1[over]
    kmat[c2, :, hi[moved]] = r_move[moved]
    sv_x[c1, t1[over]] = torch.where(has_partner[:, None], z.to(sv_x.dtype), v_last)[over]
    sv_x[c2, hi[moved]] = v_last[moved]
    alpha[c1, t1[over]] = torch.where(has_partner, a_z, a_last)[over]
    alpha[c2, hi[moved]] = a_last[moved]
    alpha[c1, last[over]] = 0.0
    if decisions is not None:
        made = torch.stack([i_min, j_star, has_partner.long()], dim=1)
        decisions[over] = made[over].to(decisions.dtype)
    return sv_x, alpha, kmat


def merge_event_rounds(sv_x, alpha, kmat, count, n_events, h_table, wd_table, *, rounds: int,
                       budget: int):
    """A step's masked event rounds, IN PLACE (the plain version of the
    ``merge_event_rounds`` kernel): ``rounds`` rounds of ``merge_event``, each
    on the classes still over ``budget``, then ``count -= over`` and
    ``n_events += over``.  ``count`` and ``n_events`` ((C,) int32) are
    updated in place too.  Returns ``(sv_x, alpha, kmat, count, n_events)``,
    the same tensors."""
    cnt, n = count.clone(), n_events.clone()
    for _ in range(rounds):
        over = cnt > budget
        merge_event(sv_x, alpha, kmat, cnt, over, h_table, wd_table)
        cnt = cnt - over.to(cnt.dtype)
        n = n + over.to(n.dtype)
    count.copy_(cnt)
    n_events.copy_(n)
    return sv_x, alpha, kmat, count, n_events


def multi_merge_event(sv_x, alpha, kmat, count, over, h_table, wd_table, *, budget: int,
                      merge_batch: int):
    """One multi-merge maintenance round over stacked classes, off the kernel
    cache (the plain version of the ``train_step`` kernel's multi-merge rounds).

    The class-axis restatement of ``core.budget._multi_merge_once`` with the
    cache and Lookup-WD scoring, plus ``core.kernel_cache.apply_multi_merge``
    (the kernels package does not import ``core``; the tests pin the two bit
    for bit).  Per class with ``over`` set: the P = ``merge_batch``
    smallest-|alpha| active SVs, lower slot first on ties, are the fixed
    partners; each scores every candidate from both tables; in |alpha| order a
    pair executes unless its slot was taken as an earlier partner or the
    excess is already covered, and merges with its best untaken same-sign
    candidate (or falls back to removal); z_q overwrites slot a_q, its cache
    row comes from the log-space combine, the (P, P) block among the z's is
    symmetrized with its diagonal pinned to 1; then the k-th hole below the
    new watermark takes the k-th surviving slot above it.  Classes with
    ``over`` clear come back bitwise unchanged.

    sv_x: (C, s, d); alpha: (C, s); kmat: (C, s, s) fp32; count: (C,) int;
    over: (C,) bool.  Returns new ``(sv_x, alpha, kmat, count)``; the inputs
    are not modified.
    """
    c, s = alpha.shape
    p = merge_batch
    dev = alpha.device
    idx, ar = iota(s, dev), iota(c, dev)
    arc = ar[:, None]
    active = idx < count[:, None]

    # 1. fixed partners (top_k's order: a stable sort)
    abs_a = torch.where(active, alpha.abs(), torch.inf)
    a_idx = torch.sort(abs_a, dim=1, stable=True).indices[:, :p]          # (C, P)
    a_min = alpha[arc, a_idx]

    # 2. kappa rows from the cache; 3.-4. both tables at every candidate and
    #    the greedy disjoint pair choice in |alpha| order
    kappa_rows = kmat[arc, a_idx].to(alpha.dtype)
    b_idx, merged, execute, h_star = multi_merge_choose(alpha, kappa_rows, a_idx, a_min, count,
                                                        budget, h_table, wd_table)
    n_exec = execute.sum(dim=1, dtype=count.dtype)

    # 5. merge math, every gather before any write
    kap = torch.clamp(kappa_rows[arc, iota(p, dev), b_idx], 0.0, 1.0)
    u = 1.0 - h_star
    a_z = a_min * _kappa_pow(kap, u * u) + alpha[arc, b_idx] * _kappa_pow(kap, h_star * h_star)
    hz = h_star[..., None]
    z = hz * sv_x[arc, a_idx] + (1.0 - hz) * sv_x[arc, b_idx]
    write_idx = torch.where(merged, a_idx, s)
    hole_idx = torch.where(merged, b_idx, torch.where(execute, a_idx, s))
    lk = _safe_log(kmat[arc, torch.cat([a_idx, b_idx], dim=1)])         # (C, 2P, s)
    lk_a, lk_b = lk[:, :p], lk[:, p:]
    lk_ab = lk_a.gather(2, b_idx[:, :, None])                           # (C, P, 1)
    lz = torch.clamp(hz * lk_a + (1.0 - hz) * lk_b - hz * (1.0 - hz) * lk_ab, max=0.0)
    hr = h_star[:, None, :]
    cross = torch.exp(torch.clamp(
        hr * lz.gather(2, a_idx[:, None, :].expand(c, p, p))
        + (1.0 - hr) * lz.gather(2, b_idx[:, None, :].expand(c, p, p))
        - hr * (1.0 - hr) * lk_ab[:, None, :, 0], max=0.0))
    cross = 0.5 * (cross + cross.transpose(1, 2))
    cross = torch.where(torch.eye(p, dtype=torch.bool, device=dev), 1.0, cross).to(kmat.dtype)
    km = put_rows_and_columns(kmat, write_idx, torch.exp(lz).to(kmat.dtype))
    km = put_block(km, write_idx, write_idx, cross)
    sv = put_rows(sv_x, write_idx, z.to(sv_x.dtype))
    al = put_rows(alpha, write_idx, a_z.to(alpha.dtype))

    # 6. targeted-move compaction
    hole_mask = torch.zeros((c, s + 1), dtype=torch.bool, device=dev).scatter_(
        1, hole_idx, True)[:, :s]
    new_count = count - n_exec
    below = idx < new_count[:, None]
    dst = torch.sort(torch.where(hole_mask & below, idx, s), dim=1).values[:, :p]
    src = torch.sort(torch.where(active & ~hole_mask & ~below, idx, s), dim=1).values[:, :p]
    src_c = src.clamp(max=s - 1)
    rows = km[arc, src_c]
    km = put_rows_and_columns(km, dst, rows)
    km = put_block(km, dst, dst, rows.gather(2, src_c[:, None, :].expand(c, p, p)))
    sv = put_rows(sv, dst, sv[arc, src_c])
    al = torch.where(below, put_rows(al, dst, al[arc, src_c]), 0.0)

    ov = over.to(torch.bool)
    return (torch.where(ov[:, None, None], sv, sv_x), torch.where(ov[:, None], al, alpha),
            torch.where(ov[:, None, None], km, kmat), torch.where(ov, new_count, count))


def train_step_fused(sv_x, alpha, kmat, count, step, n_inserts, n_merges, xb, yb, k_bb,
                     h_table, wd_table, *, budget: int, lambda_: float, gamma: float,
                     batch_size: int, maintenance: str = "merge", merge_batch: int = 4):
    """One whole training step for every class, IN PLACE (the plain version of
    the ``train_step`` kernel).

    Per class: the margin rows ``k(xb, sv_c)`` from ONE ``rbf_matrix`` call
    against the flattened (C * s, d) bank; the Pegasos shrink and violator
    insert with ``core.bsgd.insert_from_rows``' expressions (float32
    ``eta = 1 / (lambda t)``, the shrink ``1 - eta lambda`` rounded once
    through a float64 product); the cache insert of
    ``core.kernel_cache.insert_rows`` (rows, then columns, then the
    diagonal, the margin rows reused and ``k_bb`` patched in among the new
    slots); then ``batch_size`` masked rounds of ``merge_event`` or
    ``multi_merge_event``, each a bitwise no-op for a class at or under
    ``budget``.

    sv_x: (C, s, d); alpha: (C, s); kmat: (C, s, s) fp32; count, step,
    n_inserts, n_merges: (C,) int32; xb: (batch, d); yb: (C, batch)
    one-vs-rest targets in {-1, +1}; k_bb: (batch, batch) ``k(xb, xb)``.
    ``sv_x``, ``alpha``, ``kmat``, ``count``, ``n_inserts`` and ``n_merges``
    are updated in place; returns them with ``step + 1`` as ``(sv_x, alpha,
    kmat, count, step + 1, n_inserts, n_merges)``.
    """
    c, s, d = sv_x.shape
    b = xb.shape[0]
    idx = iota(s, alpha.device)
    k_b = rbf_matrix(xb, sv_x.reshape(c * s, d), gamma).view(b, c, s).transpose(0, 1).contiguous()

    cnt = count[:, None]
    f = (k_b.to(alpha.dtype) @ torch.where(idx < cnt, alpha, 0.0)[..., None])[..., 0]
    margin = yb * f
    eta = 1.0 / (lambda_ * step)
    shrink = (1.0 - eta.double() * float(np.float32(lambda_))).to(torch.float32)
    viol = margin < 1.0
    pos = torch.where(viol, cnt + torch.cumsum(viol.to(torch.int32), -1) - 1, s)
    written, src = torch.max(pos.unsqueeze(-1) == idx, dim=-2)                  # (C, s)
    sv = torch.where(written.unsqueeze(-1), xb.to(sv_x.dtype)[src], sv_x)
    new_alpha = (eta[:, None] * yb / batch_size).to(alpha.dtype)
    al = torch.where(written, new_alpha.gather(-1, src), alpha * shrink[:, None])
    n_new = viol.sum(-1).to(torch.int32)
    rows = put_rows(k_b.to(kmat.dtype).transpose(1, 2), pos,
                    k_bb.to(kmat.dtype).T.expand(c, b, b)).transpose(1, 2)
    km = put_diag(put_rows_and_columns(kmat, pos, rows), pos, 1.0)

    cnt, n_mrg = count + n_new, n_merges
    for _ in range(batch_size):
        over = cnt > budget
        if maintenance == "merge":
            merge_event(sv, al, km, cnt, over, h_table, wd_table)
            cnt = cnt - over.to(cnt.dtype)
        else:
            sv, al, km, cnt = multi_merge_event(sv, al, km, cnt, over, h_table, wd_table,
                                                budget=budget, merge_batch=merge_batch)
        n_mrg = n_mrg + over.to(n_mrg.dtype)
    sv_x.copy_(sv)
    alpha.copy_(al)
    kmat.copy_(km)
    count.copy_(cnt)
    n_inserts.add_(n_new)
    n_merges.copy_(n_mrg)
    return sv_x, alpha, kmat, count, step + 1, n_inserts, n_merges


def bdca_ascent(alpha, kmat, count, C: float, rounds: int):
    """``rounds`` Gauss-Seidel sweeps of exact 1-D dual maximization, IN PLACE
    (the plain version of the ``bdca_ascent`` kernel).

    alpha: (s,) signed coefficients ``b_i = y_i a_i`` with kmat (s, s) and a
    0-d count, or stacked (C, s), (C, s, s) and (C,); kmat is the kernel
    cache.  Per class, ``b`` is alpha with stale (``>= count``) slots zeroed
    and ``f = b @ k``, summed in ascending slot order, a product rounded and
    then added (by the cache's exact symmetry, I2, this is the reference's
    ``k @ b``).  Each sweep visits every coordinate ``i < count`` in order:
    ``a = clip(|b_i| + 1 - y_i f_i, 0, C)`` with ``y_i = sign(b_i)``; a live
    coordinate (``b_i != 0``) takes ``b_i <- y_i a`` and ``f <- f + (b_new -
    b_i) k[i]``, the product rounded before the add; a frozen one (``b_i =
    0``) changes nothing.  Coordinates past ``count`` are not live.  alpha
    receives ``b`` (stale slots zero) and is returned."""
    one = alpha.dim() == 1
    b = alpha[None] if one else alpha
    k = (kmat[None] if one else kmat).float()
    n = count.reshape(-1)
    c, s = b.shape
    idx = iota(s, b.device)
    b = torch.where(idx < n[:, None], b, 0.0)
    top = min(int(n.max()), s) if c else 0
    rows = k.unbind(1)                  # rows[i]: (C, s), row i of every class
    f = torch.zeros_like(b)
    for j in range(top):
        f = torch.where(j < n[:, None], f + b[:, j:j + 1] * rows[j], f)
    cap = float(np.float32(C))
    # b and f are updated in place below, so their column views stay current;
    # b is zero past each class's count, so a coordinate there is not live
    b_col, f_col = b.unbind(1), f.unbind(1)
    for _ in range(rounds):
        for i in range(top):
            bi, fi = b_col[i], f_col[i]
            y = torch.sign(bi)
            live = bi != 0
            a_new = torch.clamp((torch.abs(bi) + 1.0) - y * fi, 0.0, cap)
            b_new = torch.where(live, y * a_new, bi)
            torch.where(live[:, None], f + (b_new - bi)[:, None] * rows[i], f, out=f)
            bi.copy_(b_new)
    alpha.copy_(b[0] if one else b)
    return alpha
