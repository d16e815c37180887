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


def class_scores(x, sv_x, alpha, gamma):
    """Per-class decision scores, class by class (the oracle of ``ops.class_scores``).

    x: (n, d); sv_x: (C, slots, d); alpha: (C, slots), inactive slots zeroed
    -> (C, n)."""
    return torch.stack([rbf_matrix(x, sv_x[c], gamma).to(alpha.dtype) @ alpha[c]
                        for c in range(sv_x.shape[0])])


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
