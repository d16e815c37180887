"""Launch wrapper for the hand-written BDCA ascent kernel (``csrc/bdca_ascent.cu``).

Replaces ``repro.core.bdca.ascent_rounds``, the dual solver's Gauss-Seidel
sweeps, which the reference runs outside Pallas as an XLA loop: one launch,
one thread block a class, runs every sweep over the cached Gram matrix and
updates alpha IN PLACE.  The block is a chain warp, which walks 32
coordinates at a time with shuffles, and bulk warps, which own the margins
and apply each 32 deltas at once.  The plain version is ``ref.bdca_ascent``;
``launches`` counts this kernel's launches.

``chain_probe_cuda`` and ``latency_probe_cuda`` are measurement probes
beside the kernel (``chip_smoke.py`` reads them), on no path.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build, planned as _planned, work as _work

launches = 0
MAX_SLOTS = 16_384
# columns of f a bulk thread owns (the kernel's template instances), and the
# bulk threads a block may have beside its chain warp
COLUMNS_PER_THREAD = (1, 2, 4, 8, 32)
MAX_BULK_THREADS = 512
# with one column a thread the kernel stages cache rows through shared
# memory: three buffers of 32 rows and up to 3 floats of 16-byte
# realignment each (csrc/bdca_ascent.cu NBUF, staged_floats)
BUFFERS, ROWS_A_BUFFER = 3, 32


def geometry(s: int) -> tuple[int, int, int]:
    """``(columns a bulk thread, threads a block, dynamic shared bytes)`` of a
    launch over ``s`` slots: the fewest columns a thread that 512 bulk
    threads cover ``s`` with, bulk threads rounded up to whole warps, one
    chain warp more; b twice (the sweep's source and destination) and, at
    one column a thread, three buffers of staged cache rows.  The kernel's launch
    (``bdca_ascent_launch``) sizes its shared memory the same way."""
    if not 0 < s <= MAX_SLOTS:
        raise ValueError(f"bdca_ascent takes 1 to {MAX_SLOTS} slots, got {s}")
    nq = next(q for q in COLUMNS_PER_THREAD if q * MAX_BULK_THREADS >= s)
    bulk = -(-s // nq)
    staged = BUFFERS * ((ROWS_A_BUFFER * s + 7) & ~3) if nq == 1 else 0
    return nq, 32 + -(-bulk // 32) * 32, (staged + 2 * s) * 4


def _check(alpha, kmat, count, rounds: int, what: str,
           planned: bool = False) -> tuple[int, int, int]:
    """The launch's device, classes and slots, after the checks every entry
    point here shares; raises on anything the kernel does not take."""
    dev = alpha.get_device()
    if not planned and (dev < 0 or kmat.get_device() != dev or count.get_device() != dev):
        raise ValueError(f"{what} needs alpha, kmat and count on one CUDA device")
    if alpha.dtype != torch.float32 or kmat.dtype != torch.float32:
        raise TypeError(f"{what} takes fp32 alpha and kmat, got {alpha.dtype}, {kmat.dtype}")
    if count.dtype != torch.int32:
        raise TypeError(f"count must be int32, got {count.dtype}")
    if alpha.dim() not in (1, 2):
        raise ValueError(f"alpha must be (s,) or (C, s), got {tuple(alpha.shape)}")
    c, s = (1, alpha.shape[0]) if alpha.dim() == 1 else alpha.shape
    if kmat.shape != (*alpha.shape, s) or count.numel() != c or count.dim() != alpha.dim() - 1:
        raise ValueError(f"kmat {tuple(kmat.shape)} and count {tuple(count.shape)} must pair "
                         f"with alpha {tuple(alpha.shape)}")
    if not alpha.is_contiguous():
        raise ValueError(f"{what} updates alpha in place: it must be contiguous")
    if s > MAX_SLOTS:
        raise ValueError(f"{what} takes at most {MAX_SLOTS} slots, got {s}")
    if rounds < 0:
        raise ValueError(f"rounds={rounds} < 0")
    return dev, c, s


def bdca_ascent_cuda(alpha, kmat, count, C: float, rounds: int, *, planned: bool = False):
    """``rounds`` sweeps on the card, alpha updated in place and returned.

    alpha: (s,) fp32 with kmat (s, s) fp32 and a 0-d int32 count, or stacked
    (C, s), (C, s, s) and (C,); alpha must be contiguous (it is written in
    place), s <= ``MAX_SLOTS``.  ``C`` is the box, rounded to fp32."""
    dev, c, s = _check(alpha, kmat, count, rounds, "bdca_ascent_cuda", planned)
    if c == 0 or s == 0:
        return alpha
    if planned:                      # every slot of every class active
        _planned.record("bdca_ascent", _work.bdca_ascent_work(c, s, [s] * c, rounds))
        return alpha
    nq, threads, _ = geometry(s)
    status = _build.function("bdca_ascent", "bdca_ascent_launch", "pppiifiiip")(
        alpha.data_ptr(), _build.dense(kmat).data_ptr(), _build.dense(count).data_ptr(), c, s,
        float(np.float32(C)), int(rounds), nq, threads, _build.stream(dev))
    _build.check(status, "bdca_ascent")
    _build.count(globals(), "launches")
    return alpha


def chain_probe_cuda(alpha, kmat, count, C: float, rounds: int):
    """The kernel's chain warp alone on these arguments (no bulk: every
    block's margins start at 0), for timing: returns (2, C) int64 on the
    card, each class's whole chain and its chain loops alone (no gather, no
    copies), in clock64 cycles.  alpha is overwritten with what means
    nothing; pass a copy."""
    dev, c, s = _check(alpha, kmat, count, rounds, "chain_probe_cuda")
    cycles = torch.zeros(2, c, dtype=torch.int64, device=alpha.device)
    if c == 0 or s == 0:
        return cycles
    status = _build.function("bdca_ascent", "bdca_chain_probe_launch", "pppiifipp")(
        alpha.data_ptr(), _build.dense(kmat).data_ptr(), _build.dense(count).data_ptr(), c, s,
        float(np.float32(C)), int(rounds), cycles.data_ptr(), _build.stream(dev))
    _build.check(status, "bdca_chain_probe")
    return cycles


def latency_probe_cuda(device=None) -> tuple[float, float, float]:
    """Dependent-issue latencies on the card, in clock64 cycles: an fp32 add,
    a ``__shfl_sync`` and a ``max.NaN`` (the chain's clip), each the mean of
    a chain of 256 on one warp."""
    dev = torch.device("cuda" if device is None else device)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    sink = torch.empty(32, dtype=torch.float32, device=dev)
    status = _build.function("bdca_ascent", "bdca_latency_probe_launch", "ppp")(
        out.data_ptr(), sink.data_ptr(), _build.stream(out.get_device()))
    _build.check(status, "bdca_latency_probe")
    add, shfl, clip = out.tolist()
    return add / 256, shfl / 256, clip / 256
