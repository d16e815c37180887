"""Launch wrapper for the hand-written fused train-step kernel (``csrc/train_step.cu``).

Replaces ``repro.kernels.train_step.train_step_pallas`` on the H100: one
thread-block cluster of K blocks per class runs a whole training step
(margin rows, Pegasos shrink and violator insert with the cache insert, then
``batch_size`` masked ``merge`` or ``multi-merge`` event rounds) and updates
the stacked state IN PLACE, as the TPU kernel aliases its outputs to its
inputs.  K is the largest cluster size whose C clusters the card keeps
resident at once (``_build.choose_cluster``), unless the caller fixes it;
every K writes the same bits.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, planned as _planned, work as _work

launches = 0
_SV_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=64)
def cluster_size(sv_bf16: bool, c: int, s: int, d: int, b: int, multi: bool, p: int) -> int:
    """The cluster size K the launch takes for this shape (cached), among the
    sizes whose blocks' shared memory fits (a large minibatch's margin rows,
    B x S / K floats a block, may fit only the larger K)."""
    sizes = [k for k in _build.CLUSTER_SIZES
             if 0 <= _smem_need(s, d, b, multi, p, k) <= _build.SMEM_LIMIT]
    resident = _build.resident_clusters("train_step", "train_step_max_clusters", sizes,
                                        int(sv_bf16), c, s, d, b, int(multi), p)
    return _build.choose_cluster(c, resident)


@functools.lru_cache(maxsize=64)
def _smem_need(s: int, d: int, b: int, multi: bool, p: int, k: int) -> int:
    fn = _build.function("train_step", "train_step_smem_bytes", "iiiiii", ctypes.c_longlong)
    return fn(s, d, b, int(multi), p, k)


def train_step_cuda(sv_x, alpha, kmat, count, step, n_inserts, n_merges, xb, yb, k_bb,
                    h_table, wd_table, *, budget: int, lambda_: float, gamma: float,
                    batch_size: int, maintenance: str = "merge", merge_batch: int = 4,
                    cluster: int | None = None, planned: bool = False):
    """One fused step on the card, in place.

    sv_x: (C, S, D) fp32 or bf16; alpha: (C, S) fp32; kmat: (C, S, S) fp32;
    count, n_inserts, n_merges: (C,) int32 -- these six contiguous, as they
    are written in place; step: (C,) int32; xb: (B, D) fp32 with B =
    ``batch_size``; yb: (C, B) fp32 one-vs-rest targets; k_bb: (B, B) fp32
    ``k(xb, xb)``; tables: (G0, G1) fp32 of one shape.  ``maintenance`` is
    ``"merge"`` or ``"multi-merge"`` (``merge_batch`` pairs an event, at most
    S).  ``cluster`` fixes the blocks a class (one of
    ``_build.CLUSTER_SIZES``); None takes ``cluster_size``'s choice.  A
    shape whose blocks' shared memory does not fit raises, as does a launch
    the card refuses.
    Returns the six updated tensors and ``step + 1`` as ``(sv_x, alpha,
    kmat, count, step + 1, n_inserts, n_merges)``."""
    dev = sv_x.device
    state = (alpha, kmat, count, n_inserts, n_merges)
    ins = (*state, step, xb, yb, k_bb, h_table, wd_table)
    if not planned and (not sv_x.is_cuda or any(t.device != dev for t in ins)):
        raise ValueError("train_step_cuda needs every input on one CUDA device")
    if sv_x.dtype not in _SV_DTYPES:
        raise TypeError(f"sv_x must be fp32 or bf16, got {sv_x.dtype}")
    if any(t.dtype != torch.float32 for t in (alpha, kmat, xb, yb, k_bb, h_table, wd_table)):
        raise TypeError("train_step_cuda takes fp32 alpha, kmat, xb, yb, k_bb and tables")
    if any(t.dtype != torch.int32 for t in (count, step, n_inserts, n_merges)):
        raise TypeError("count, step, n_inserts and n_merges must be int32")
    if maintenance not in ("merge", "multi-merge"):
        raise ValueError(f"maintenance={maintenance!r} not in ('merge', 'multi-merge')")
    if sv_x.dim() != 3:
        raise ValueError(f"sv_x must be (C, S, D), got {tuple(sv_x.shape)}")
    c, s, d = sv_x.shape
    b = batch_size
    if (alpha.shape != (c, s) or kmat.shape != (c, s, s)
            or any(t.shape != (c,) for t in (count, step, n_inserts, n_merges))
            or xb.shape != (b, d) or yb.shape != (c, b) or k_bb.shape != (b, b)):
        raise ValueError(f"shapes do not pair with sv_x {tuple(sv_x.shape)} and batch_size {b}")
    if not all(t.is_contiguous() for t in (sv_x, *state)):
        raise ValueError("train_step_cuda updates sv_x, alpha, kmat, count, n_inserts and "
                         "n_merges in place: they must be contiguous")
    multi = maintenance == "multi-merge"
    p = merge_batch if multi else 1
    if not 1 <= p <= s:
        raise ValueError(f"merge_batch={merge_batch} outside [1, S={s}]")
    if cluster is not None and cluster not in _build.CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster} not in {_build.CLUSTER_SIZES}")
    g0, g1 = wd_table.shape
    if h_table.shape != wd_table.shape or g0 < 2 or g1 < 2:
        raise ValueError("the two tables must share one shape of at least 2 x 2")
    step, xb, yb, k_bb = (t.contiguous() for t in (step, xb, yb, k_bb))
    h_table, wd_table = h_table.contiguous(), wd_table.contiguous()
    if c == 0 or s == 0 or b == 0:
        return sv_x, alpha, kmat, count, step + 1, n_inserts, n_merges
    if planned:                      # every row inserted and retired, every slot active
        events = b if p == 1 else -(-b // p)
        _planned.record("train_step", _work.train_step_work(
            c, s, d, b, sv_x.element_size(), b, b, events, s, p))
        return sv_x, alpha, kmat, count, step + 1, n_inserts, n_merges
    bf16 = sv_x.dtype == torch.bfloat16
    k = cluster or cluster_size(bf16, c, s, d, b, multi, p)
    need = _smem_need(s, d, b, multi, p, k)
    if need < 0 or need > _build.SMEM_LIMIT:
        raise ValueError(f"train_step_cuda needs {need} bytes of shared memory a block for "
                         f"S={s}, D={d}, B={b}, K={k} (limit {_build.SMEM_LIMIT})")
    status = _build.function("train_step", "train_step_launch", "pipppppppppppiiiiiiiffiiip")(
        sv_x.data_ptr(), int(bf16), alpha.data_ptr(), kmat.data_ptr(),
        count.data_ptr(), step.data_ptr(), n_inserts.data_ptr(), n_merges.data_ptr(),
        xb.data_ptr(), yb.data_ptr(), k_bb.data_ptr(), h_table.data_ptr(), wd_table.data_ptr(),
        g0, g1, c, s, d, b, budget, float(lambda_), float(gamma), int(multi), p, k,
        _build.stream(sv_x.get_device()))
    _build.check(status, "train_step")
    _build.count(globals(), "launches")
    return sv_x, alpha, kmat, count, step + 1, n_inserts, n_merges
