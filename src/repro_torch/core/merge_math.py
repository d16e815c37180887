"""Closed-form math of the support-vector merging problem (paper sections 2-3).

Merging ``(alpha_a, x_a)`` and ``(alpha_b, x_b)`` under the Gaussian kernel
reduces to a 1-D problem on ``z = h x_a + (1 - h) x_b``.  With
``m = alpha_a / (alpha_a + alpha_b)`` and ``kappa = k(x_a, x_b)``:

    h*(m, kappa) = argmax_{h in [0,1]} s(h),  s(h) = m kappa^{(1-h)^2} + (1-m) kappa^{h^2}
    alpha_z = alpha_a kappa^{(1-h)^2} + alpha_b kappa^{h^2}
    WD      = alpha_a^2 + alpha_b^2 + 2 alpha_a alpha_b kappa - alpha_z^2

PyTorch counterpart of ``repro.core.merge_math``: plain functions on
tensors, float32 at run time; ``gss_numpy`` is the float64 numpy search the
tables are built with.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import ref as kref

INVPHI = (math.sqrt(5.0) - 1.0) / 2.0  # 1/phi ~ 0.618034
# kappa = exp(-gamma d^2) is clipped away from 0 so log(kappa) stays finite.
KAPPA_MIN = 1e-30
# Paper precisions: runtime GSS eps=0.01, table-build GSS eps=1e-10.
EPS_STANDARD = 1e-2
EPS_PRECISE = 1e-10


def gss_num_iters(eps: float) -> int:
    """Iterations for the bracket [0,1] to shrink below ``eps`` (width *= 1/phi)."""
    return int(math.ceil(math.log(eps) / math.log(INVPHI)))


def kappa_pow(kappa, expo):
    """kappa**expo computed as exp(expo * log kappa), safe at kappa -> 0."""
    return torch.exp(expo * torch.log(torch.clamp(kappa, KAPPA_MIN, 1.0)))


def s_objective(h, m, kappa):
    """s_{m,kappa}(h) = m kappa^{(1-h)^2} + (1-m) kappa^{h^2} (to maximize)."""
    u = 1.0 - h
    return m * kappa_pow(kappa, u * u) + (1.0 - m) * kappa_pow(kappa, h * h)


def golden_section_search(m, kappa, eps: float = EPS_STANDARD):
    """Maximize ``s_{m,kappa}`` over [0, 1] in float32 with a fixed number of
    bracket steps: ``gss_num_iters(eps)``, 10 at eps 1e-2 and 48 at 1e-10.

    The bracket loop is ``kernels.ref.gss``, the plain version of the CUDA
    kernel, so the runtime search and the kernel's oracle are one code."""
    m, kappa = torch.broadcast_tensors(torch.as_tensor(m), torch.as_tensor(kappa))
    return kref.gss(m, kappa, gss_num_iters(eps))


def wd_norm_at(h, m, kappa):
    """WD / (alpha_a + alpha_b)^2 = m^2 + (1-m)^2 + 2 m (1-m) kappa - s(h)^2."""
    s = s_objective(h, m, kappa)
    return m * m + (1.0 - m) * (1.0 - m) + 2.0 * m * (1.0 - m) * kappa - s * s


def merge_alpha_z(alpha_a, alpha_b, kappa, h):
    """Optimal merged coefficient for z = h x_a + (1-h) x_b (paper Alg. 1 line 8)."""
    u = 1.0 - h
    return alpha_a * kappa_pow(kappa, u * u) + alpha_b * kappa_pow(kappa, h * h)


def weight_degradation(alpha_a, alpha_b, kappa, alpha_z):
    """||Delta||^2 = alpha_a^2 + alpha_b^2 + 2 alpha_a alpha_b kappa - alpha_z^2."""
    return (alpha_a * alpha_a + alpha_b * alpha_b + 2.0 * alpha_a * alpha_b * kappa
            - alpha_z * alpha_z)


def merge_point(h, x_a, x_b):
    """z = h * x_a + (1 - h) * x_b."""
    return h * x_a + (1.0 - h) * x_b


def gss_numpy(m, kappa, eps: float = EPS_PRECISE):
    """float64 numpy golden section search (vectorized), for the table build.

    float32 cannot localize a smooth argmax beyond ~3e-4, so the paper's
    eps=1e-10 table build runs in doubles, as the reference C++ did."""
    m = np.asarray(m, np.float64)
    kappa = np.clip(np.asarray(kappa, np.float64), KAPPA_MIN, 1.0)
    lk = np.log(kappa)

    def s(h):
        return m * np.exp((1.0 - h) ** 2 * lk) + (1.0 - m) * np.exp(h**2 * lk)

    a = np.zeros_like(m)
    b = np.ones_like(m)
    for _ in range(gss_num_iters(eps)):
        span = b - a
        c = b - span * INVPHI
        d = a + span * INVPHI
        go_left = s(c) > s(d)
        a = np.where(go_left, a, c)
        b = np.where(go_left, d, b)
    return 0.5 * (a + b)
