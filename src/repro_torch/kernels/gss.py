"""Launch wrapper for the hand-written golden-section-search kernel (``csrc/gss.cu``).

Replaces ``repro.kernels.gss.gss_pallas`` on the H100: one thread per
``(m, kappa)`` problem, ``n_iters`` bracket steps in registers.
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0


def gss_cuda(m: torch.Tensor, kappa: torch.Tensor, n_iters: int) -> torch.Tensor:
    """argmax_h of the merge objective per element; m, kappa fp32 of one shape."""
    global launches
    if not m.is_cuda or kappa.device != m.device:
        raise ValueError("gss_cuda needs m and kappa on one CUDA device")
    if m.dtype != torch.float32 or kappa.dtype != torch.float32:
        raise TypeError("gss_cuda takes fp32 m and kappa")
    if m.shape != kappa.shape:
        raise ValueError(f"m {tuple(m.shape)} and kappa {tuple(kappa.shape)} differ")
    if n_iters < 0:
        raise ValueError(f"n_iters={n_iters} < 0")
    m, kappa = m.contiguous(), kappa.contiguous()
    h = torch.empty_like(m)
    if m.numel() == 0:
        return h
    status = _build.function("gss", "gss_launch", "pppiip")(
        m.data_ptr(), kappa.data_ptr(), h.data_ptr(), m.numel(), int(n_iters),
        _build.stream(m.get_device()))
    _build.check(status, "gss")
    launches += 1
    return h
