"""Dispatch between the hand-written CUDA kernels and their plain versions.

``impl`` (every op takes it):
  * ``"auto"`` — the CUDA kernel for tensors on a CUDA device, the plain
    PyTorch version (``kernels.ref``) for tensors on the CPU;
  * ``"cuda"`` — the CUDA kernel; raises for CPU tensors;
  * ``"ref"``  — the plain version, on whatever device the tensors are.

A CUDA tensor under ``"auto"`` launches its kernel or raises: nothing falls
back to the plain version.  ``launch_counts()`` reads each kernel's launch
counter; ``reset_launch_counts()`` sets them to 0.
"""
from __future__ import annotations

import torch

from . import gss as gss_kernel
from . import merge_lookup, rbf_kernel, ref

IMPLS = ("auto", "cuda", "ref")
_KERNELS = {"rbf_matrix": rbf_kernel, "merge_scores": merge_lookup, "gss": gss_kernel}


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs tensors on a CUDA device")
    return impl == "cuda" or (impl == "auto" and t.is_cuda)


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def rbf_matrix(x, y, gamma, *, impl: str = "auto"):
    """K[i, j] = exp(-gamma ||x_i - y_j||^2); x (n, d), y (m, d) -> (n, m) fp32."""
    if _use_kernel(impl, x):
        return rbf_kernel.rbf_matrix_cuda(x, y, gamma)
    return ref.rbf_matrix(x, y, gamma)


def rbf_row(sv_x, x, gamma, *, impl: str = "auto"):
    """kappa_row[j] = k(x, sv_x[j]); sv_x (s, d), x (d,) -> (s,).

    On the card this is the matmul-form kernel with n = 1 (as the reference
    does on the TPU); on the CPU the direct-difference form (as the
    reference does off the TPU)."""
    if _use_kernel(impl, sv_x):
        return rbf_kernel.rbf_matrix_cuda(x.reshape(1, -1), sv_x, gamma)[0]
    return ref.rbf_row(sv_x, x, gamma)


def merge_scores(alpha, kappa_row, valid, a_min, table, *, impl: str = "auto"):
    """``(wd, interp)`` per candidate for one fixed partner.

    alpha, kappa_row, valid (bool): (s,); a_min: one-element tensor on the
    same device; table: (G, G).  ``interp`` is the table interpolated at
    each candidate's ``(m, kappa)``; ``wd = (a_min + alpha)^2 * interp`` at
    valid slots, and a value >= ``ref.NO_PARTNER`` at invalid ones (+inf on
    the plain path, 3.4e38 from the kernel)."""
    if _use_kernel(impl, alpha):
        return merge_lookup.merge_scores_cuda(alpha, kappa_row, valid, a_min.reshape(1), table)
    wd = ref.merge_scores(alpha, kappa_row, valid, a_min, table)
    m, kap = ref.merge_coords(a_min, alpha, kappa_row)
    return wd, ref.bilinear_lookup(table, m, kap)


def gss_solve(m, kappa, *, n_iters: int, impl: str = "auto"):
    """argmax_h of the merge objective for (m, kappa) of any one shape."""
    if _use_kernel(impl, m):
        return gss_kernel.gss_cuda(m.float(), kappa.float(), n_iters)
    return ref.gss(m, kappa, n_iters)
