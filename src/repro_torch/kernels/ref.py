"""Plain PyTorch versions of the port's kernels: the semantics of record.

Each hand-written CUDA kernel is held against the function here on the
card (``chip_smoke.py``), and these are what ``kernels.ops`` runs for
tensors on the CPU.  They mirror ``repro.kernels.ref`` operation by
operation, so the CPU path agrees with the JAX reference to float32
round-off.  Inputs stored in bf16 are widened to fp32 first, which is what
the kernels compute.
"""
from __future__ import annotations

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
    ||x||^2 + ||y||^2 - 2 x.y clamped at 0.  x (n, d), y (m, d) -> (n, m)."""
    x, y = x.float(), y.float()
    xn = torch.sum(x * x, dim=-1)[:, None]
    yn = torch.sum(y * y, dim=-1)[None, :]
    d2 = xn + yn - 2.0 * (x @ y.T)
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def rbf_row(sv_x, x, gamma):
    """kappa_row[j] = k(x, sv_x[j]) in direct-difference form; sv_x (s, d), x (d,) -> (s,).

    Numerically not the matmul form: the two differ by float32 round-off,
    as they do in the reference."""
    diff = sv_x.float() - x.float()[None, :]
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

    alpha, kappa_row, valid: (s,); a_min: scalar or one-element tensor."""
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
