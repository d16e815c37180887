"""Launch wrapper for the hand-written BDCA ascent kernel (``csrc/bdca_ascent.cu``).

Replaces ``repro.core.bdca.ascent_rounds``, the dual solver's Gauss-Seidel
sweeps, which the reference runs outside Pallas as an XLA loop: one launch,
one thread block a class, runs every sweep over the cached Gram matrix and
updates alpha IN PLACE.  The plain version is ``ref.bdca_ascent``;
``launches`` counts this kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

launches = 0
# 1,024 threads of 16 columns each (csrc/bdca_ascent.cu)
MAX_SLOTS = 16_384


def bdca_ascent_cuda(alpha, kmat, count, C: float, rounds: int):
    """``rounds`` sweeps on the card, alpha updated in place and returned.

    alpha: (s,) fp32 with kmat (s, s) fp32 and a 0-d int32 count, or stacked
    (C, s), (C, s, s) and (C,); alpha must be contiguous (it is written in
    place), s <= ``MAX_SLOTS``.  ``C`` is the box, rounded to fp32."""
    dev = alpha.get_device()
    if dev < 0 or kmat.get_device() != dev or count.get_device() != dev:
        raise ValueError("bdca_ascent_cuda needs alpha, kmat and count on one CUDA device")
    if alpha.dtype != torch.float32 or kmat.dtype != torch.float32:
        raise TypeError(f"bdca_ascent_cuda takes fp32 alpha and kmat, got {alpha.dtype}, "
                        f"{kmat.dtype}")
    if count.dtype != torch.int32:
        raise TypeError(f"count must be int32, got {count.dtype}")
    if alpha.dim() not in (1, 2):
        raise ValueError(f"alpha must be (s,) or (C, s), got {tuple(alpha.shape)}")
    c, s = (1, alpha.shape[0]) if alpha.dim() == 1 else alpha.shape
    if kmat.shape != (*alpha.shape, s) or count.numel() != c or count.dim() != alpha.dim() - 1:
        raise ValueError(f"kmat {tuple(kmat.shape)} and count {tuple(count.shape)} must pair "
                         f"with alpha {tuple(alpha.shape)}")
    if not alpha.is_contiguous():
        raise ValueError("bdca_ascent_cuda updates alpha in place: it must be contiguous")
    if s > MAX_SLOTS:
        raise ValueError(f"bdca_ascent_cuda takes at most {MAX_SLOTS} slots, got {s}")
    if rounds < 0:
        raise ValueError(f"rounds={rounds} < 0")
    if c == 0 or s == 0:
        return alpha
    status = _build.function("bdca_ascent", "bdca_ascent_launch", "pppiifip")(
        alpha.data_ptr(), _build.dense(kmat).data_ptr(), _build.dense(count).data_ptr(), c, s,
        float(np.float32(C)), int(rounds), _build.stream(dev))
    _build.check(status, "bdca_ascent")
    _build.count(globals(), "launches")
    return alpha
