"""Launch wrapper for the hand-written RBF kernel-matrix kernel (``csrc/rbf_kernel.cu``).

Replaces ``repro.kernels.rbf_kernel.rbf_matrix_pallas`` on the H100.  The
wrapper checks devices, dtypes and contiguity, allocates the output on the
current stream, launches, and raises if the launch was refused.  Up to
``THIN_ROWS`` rows go to the kernel that reads the bank once for all of
them (``rbf_thin``), more to the register-tiled one (``rbf_tiled``); the
two sum in different orders, so the cutover is part of what an output's
bits are.  ``launches`` counts the kernel launches made through
:func:`rbf_matrix_cuda`.
"""
from __future__ import annotations

import torch

from . import _build, planned as _planned, work as _work

launches = 0
_DTYPES = (torch.float32, torch.bfloat16)
# csrc/rbf_kernel.cu: THIN_ROWS, the rule's cutover (measured on an H100 at
# n = 8, 16 and 32), and THIN_MAX, the most rows rbf_thin takes when
# ``path="thin"`` asks for it
THIN_ROWS, THIN_MAX = 16, 32
_PATHS = {"auto": 0, "thin": 1, "tiled": 2}


def rbf_matrix_cuda(x: torch.Tensor, y: torch.Tensor, gamma: float, *,
                    path: str = "auto", planned: bool = False) -> torch.Tensor:
    """K[i, j] = exp(-gamma ||x_i - y_j||^2) on the card; x (n, d), y (m, d) -> (n, m) fp32.

    ``path`` picks the kernel: ``"auto"`` the rule (``rbf_thin`` for n <=
    ``THIN_ROWS``), ``"thin"`` or ``"tiled"`` one of them (for measuring the
    cutover; thin takes at most ``THIN_MAX`` rows).  ``planned`` (fake tensors,
    ``ops._use_kernel``) allocates the output and records the work instead
    of launching."""
    if not planned and (not (x.is_cuda and y.is_cuda) or x.device != y.device):
        raise ValueError("rbf_matrix_cuda needs x and y on one CUDA device")
    if x.dtype not in _DTYPES or y.dtype not in _DTYPES:
        raise TypeError(f"rbf_matrix_cuda takes fp32 or bf16, got {x.dtype}, {y.dtype}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(y.shape)} do not pair")
    if path not in _PATHS:
        raise ValueError(f"path={path!r} not in {tuple(_PATHS)}")
    if path == "thin" and x.shape[0] > THIN_MAX:
        raise ValueError(f"path='thin' takes at most {THIN_MAX} rows, got {x.shape[0]}")
    x, y = x.contiguous(), y.contiguous()
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    if planned:
        _planned.record("rbf_matrix", _work.rbf_matrix_work(n, m, d, x.element_size(),
                                                               y.element_size()))
        return out
    fn = _build.function("rbf_kernel", "rbf_matrix_launch", "pipipiiifip")
    status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
                int(y.dtype == torch.bfloat16), out.data_ptr(), n, m, d, float(gamma),
                _PATHS[path], _build.stream(x.get_device()))
    _build.check(status, "rbf_matrix")
    _build.count(globals(), "launches")
    return out
