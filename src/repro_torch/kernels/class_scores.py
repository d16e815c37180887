"""Launch wrapper for the hand-written serve cell (``csrc/class_scores.cu``).

Replaces, on the serve path, the reference's kernel block
(``repro.kernels.rbf_kernel.rbf_matrix_pallas``) and the per-class
contraction and argmax or sign it runs after it
(``repro.kernels.ops.class_scores``, ``repro.core.predict.predict_labels``).
One launch takes the request rows x (n, d), the flattened bank (C * s, d)
and alpha (C, s) and writes the scores (C, n) and the labels (n,); the
kernel block K stays in shared memory.  Each (row, class) sum has one fixed
order whatever n, so a row's scores do not depend on the batch it is served
in: they are the bits of ``rbf_tiled``'s K contracted by
``ref.class_scores_labels``, the plain version (after ``ref.rbf_matrix_rows``
on the CPU).  ``launches`` counts this kernel's launches.
"""
from __future__ import annotations

import threading

import torch

from . import _build, planned as _planned, work as _work

launches = 0
_F32 = torch.float32
_DTYPES = (torch.float32, torch.bfloat16)
# the smallest of csrc/class_scores.cu's row tiles (its rule picks the tile)
_MIN_TILE = 8
# The labels of a row tile are written by the last block to finish it, found
# by a counter a row tile that the kernel leaves at 0; launches on one stream
# run in order, so each stream keeps one set of counters.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()
_MIN_TICKETS = 4_096


def _tickets(dev: int, stream: int, n: int) -> torch.Tensor:
    """The zeroed counters of ``stream`` on card ``dev``, one for each row tile
    of n rows at the smallest tile (allocated once a stream, at its first
    launch: a queue's warm-up)."""
    need = -(-n // _MIN_TILE)
    t = _TICKETS.get((dev, stream))
    if t is None or t.numel() < need:
        with _TICKETS_LOCK:
            t = _TICKETS.get((dev, stream))
            if t is None or t.numel() < need:
                t = torch.zeros(max(need, _MIN_TICKETS), dtype=torch.int32,
                                device=torch.device("cuda", dev))
                _TICKETS[(dev, stream)] = t
    return t


def serve_cell_cuda(x: torch.Tensor, bank: torch.Tensor, alpha: torch.Tensor, gamma: float, *,
                    binary: bool = False, planned: bool = False):
    """``(scores, labels)`` of the serve cell on the card, in one launch.

    x: (n, d) fp32 or bf16 request rows; bank: (C * s, d) fp32 or bf16, the
    (C, s, d) bank flattened; alpha: (C, s) fp32 with inactive slots zeroed.
    scores (C, n) fp32; labels (n,) int32 class ids (the first maximum wins),
    or for a binary model (``binary``, C = 1) the fp32 signs of its one
    score."""
    dev = x.get_device()
    if not planned and (dev < 0 or bank.get_device() != dev or alpha.get_device() != dev):
        raise ValueError("serve_cell_cuda needs x, bank and alpha on one CUDA device")
    if x.dtype not in _DTYPES or bank.dtype not in _DTYPES or alpha.dtype != _F32:
        raise TypeError(f"serve_cell_cuda takes fp32 or bf16 x and bank and fp32 alpha, got "
                        f"{x.dtype}, {bank.dtype}, {alpha.dtype}")
    if (x.dim() != 2 or bank.dim() != 2 or alpha.dim() != 2 or alpha.numel() == 0
            or bank.shape[0] != alpha.numel() or x.shape[1] != bank.shape[1]):
        raise ValueError(f"x {tuple(x.shape)} and bank {tuple(bank.shape)} must pair as (n, d) "
                         f"and (C * s, d) for alpha {tuple(alpha.shape)} (C, s), s > 0")
    c, s = alpha.shape
    if binary and c != 1:
        raise ValueError(f"a binary model has one class, got C = {c}")
    n, d = x.shape
    scores = torch.empty((c, n), dtype=_F32, device=x.device)
    labels = torch.empty((n,), dtype=_F32 if binary else torch.int32, device=x.device)
    if n == 0:
        return scores, labels
    if planned:
        _planned.record("class_scores", _work.serve_cell_work(
            n, c, s, d, x.element_size(), bank.element_size()))
        return scores, labels
    stream = _build.stream(dev)
    status = _build.function("class_scores", "class_scores_launch", "pipippppiiiifip")(
        _build.dense(x).data_ptr(), int(x.dtype == torch.bfloat16), _build.dense(bank).data_ptr(),
        int(bank.dtype == torch.bfloat16), _build.dense(alpha).data_ptr(), scores.data_ptr(),
        labels.data_ptr(), _tickets(dev, stream, n).data_ptr(), n, c, s, d, float(gamma),
        int(binary), stream)
    _build.check(status, "class_scores")
    _build.count(globals(), "launches")
    return scores, labels
