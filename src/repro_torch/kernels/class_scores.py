"""Launch wrapper for the hand-written serve-cell contraction (``csrc/class_scores.cu``).

Replaces the per-class contraction and the argmax or sign that the reference
runs after its kernel block (``repro.kernels.ops.class_scores``,
``repro.core.predict.predict_labels``).  One launch takes the kernel block K
(n, C * s) and alpha (C, s) and writes the scores (C, n) and the labels
(n,), each (row, class) sum in one fixed order whatever n, so that a row's
scores do not depend on the batch it is served in.  The plain version is
``ref.class_scores_labels``; ``launches`` counts this kernel's launches.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0
_F32 = torch.float32


def class_scores_cuda(k: torch.Tensor, alpha: torch.Tensor, *, binary: bool = False):
    """``(scores, labels)`` on the card.

    k: (n, C * s) fp32, the kernel block of n rows against the flattened
    (C * s, d) bank; alpha: (C, s) fp32 with inactive slots zeroed.  scores
    (C, n) fp32; labels (n,) int32 class ids (the first maximum wins), or for
    a binary model (``binary``, C = 1) the fp32 signs of its one score."""
    if not k.is_cuda or alpha.device != k.device:
        raise ValueError("class_scores_cuda needs k and alpha on one CUDA device")
    if k.dtype != _F32 or alpha.dtype != _F32:
        raise TypeError(f"class_scores_cuda takes fp32 k and alpha, got {k.dtype}, {alpha.dtype}")
    if k.dim() != 2 or alpha.dim() != 2 or alpha.numel() == 0 or k.shape[1] != alpha.numel():
        raise ValueError(f"k {tuple(k.shape)} must be (n, C * s) for alpha {tuple(alpha.shape)} "
                         "(C, s), s > 0")
    c, s = alpha.shape
    if binary and c != 1:
        raise ValueError(f"a binary model has one class, got C = {c}")
    n = k.shape[0]
    scores = torch.empty((c, n), dtype=_F32, device=k.device)
    labels = torch.empty((n,), dtype=_F32 if binary else torch.int32, device=k.device)
    if n == 0:
        return scores, labels
    status = _build.function("class_scores", "class_scores_launch", "ppppiiiip")(
        _build.dense(k).data_ptr(), _build.dense(alpha).data_ptr(), scores.data_ptr(),
        labels.data_ptr(), n, c, s, int(binary), _build.stream(k.get_device()))
    _build.check(status, "class_scores")
    _build.count(globals(), "launches")
    return scores, labels
