"""A decode-time KV cache under a budget, maintained by the paper's merge.

PyTorch counterpart of ``repro.core.budgeted_kv``.  A KV cache is a kernel
expansion: keys are support vectors, values (vector-valued) coefficients,
and the attention kernel exp(q.k) is locally Gaussian in k.  Evicting an
entry is BSGD's removal; merging is what the paper shows to be better, with
the merge coefficient read from the same precomputed table.  When the cache
is full, each (batch, head) merges its least-important pair (Alg. 1):

  1. the entry with the smallest importance ||v|| (the alpha analogue);
  2. kappa_j = exp(-gamma ||k_min - k_j||^2), the plain ``rbf_row``;
  3. m = |v_min| / (|v_min| + |v_j|), the partner j of least table WD and
     h(m, kappa_j) from the SAME ``MergeLookupTable``;
  4. k_z = h k_min + (1-h) k_j and the importance-weighted mean of the two
     values; the higher slot takes the last entry and the last value is
     zeroed.

Every (batch, head) is maintained in one pass of tensor ops.  ``count`` is
the same for all of them and follows from the number of appends, so it is a
Python int and ``kv_append`` decides maintenance without reading the device.
``kv_append`` writes into the state's tensors in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ref
from . import merge_math
from .lookup import MergeLookupTable


class KVBudgetState(NamedTuple):
    k: torch.Tensor   # (B, W, H, hd)
    v: torch.Tensor   # (B, W, H, hd)
    count: int        # filled slots (the same across batch and heads)


def init_kv_state(batch: int, budget: int, n_heads: int, head_dim: int, dtype,
                  device=None) -> KVBudgetState:
    shape = (batch, budget, n_heads, head_dim)
    return KVBudgetState(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device), count=0)


def _at(t, i):
    """t (B, H, W, hd) at slots i (B, H) -> (B, H, hd)."""
    return torch.gather(t, 2, i[:, :, None, None].expand(-1, -1, 1, t.shape[-1]))[:, :, 0]


def _put(t, i, rows) -> None:
    """t[b, h, i[b, h]] = rows[b, h], in place."""
    t.scatter_(2, i[:, :, None, None].expand(-1, -1, 1, t.shape[-1]), rows[:, :, None])


def _importance(v, count: int):
    """||v|| of the filled slots, +inf past ``count``; v (B, H, W, hd)."""
    norm = torch.sqrt(torch.sum(v * v, dim=-1))
    return torch.where(torch.arange(v.shape[2], device=v.device) < count, norm, torch.inf), norm


def merge_choice(k, v, count: int, gamma, table: MergeLookupTable):
    """Each (batch, head)'s merge: k/v (B, H, W, hd) -> ``(i_min, j, h, a_min,
    a_j)``, the least-important slot, its partner, the table's h and both
    importances (B, H)."""
    w = k.shape[2]
    idx = torch.arange(w, device=k.device)
    active = idx < count
    imp, norm = _importance(v, count)
    i_min = torch.argmin(imp, dim=-1)                      # first occurrence
    a_min = torch.gather(imp, 2, i_min[:, :, None])

    kappa = ref.rbf_row(k, _at(k, i_min), gamma)           # (B, H, W)
    a_j = torch.where(active, norm, 0.0)
    s = a_min + a_j
    m = torch.clamp(a_min / torch.where(s == 0, 1.0, s), 0.0, 1.0)
    kap = torch.clamp(kappa, 0.0, 1.0)
    wd = s ** 2 * table.lookup_wd_norm(m, kap)
    wd = torch.where(active & (idx != i_min[:, :, None]), wd, torch.inf)
    j = torch.argmin(wd, dim=-1)

    pick = lambda t: torch.gather(t, 2, j[:, :, None])[:, :, 0]   # noqa: E731
    h = table.lookup_h(pick(m), pick(kap))
    return i_min, j, h, a_min[:, :, 0], pick(a_j)


def _compact(k, v, lo, hi, k_lo, v_lo, count: int) -> None:
    """Slot lo takes (k_lo, v_lo), slot hi the last entry, the last value 0."""
    last = count - 1
    k_last, v_last = k[:, :, last].clone(), v[:, :, last].clone()
    _put(k, lo, k_lo)
    _put(k, hi, k_last)
    _put(v, lo, v_lo)
    _put(v, hi, v_last)
    v[:, :, last] = 0.0


def _merge(k, v, count: int, gamma, table: MergeLookupTable) -> None:
    """Merge the least-important pair of every (batch, head), in place."""
    i_min, j, h, a_min, a_j = merge_choice(k, v, count, gamma, table)
    k_z = merge_math.merge_point(h[:, :, None], _at(k, i_min), _at(k, j))
    # the importance-weighted mean of the two values: the reference's
    # documented adaptation of alpha_z for softmax-normalised attention
    v_z = ((a_min[:, :, None] * _at(v, i_min) + a_j[:, :, None] * _at(v, j))
           / (a_min + a_j + 1e-9)[:, :, None])
    _compact(k, v, torch.minimum(i_min, j), torch.maximum(i_min, j), k_z, v_z, count)


def _evict(k, v, count: int) -> None:
    """The removal baseline: drop the min-||v|| entry of every (batch, head)."""
    i_min = torch.argmin(_importance(v, count)[0], dim=-1)
    last = count - 1
    _compact(k, v, i_min, i_min, k[:, :, last].clone(), v[:, :, last].clone(), count)


def kv_append(state: KVBudgetState, k_new, v_new, gamma, table: MergeLookupTable, *,
              policy: str = "merge") -> KVBudgetState:
    """Append one token's K/V (B, 1, H, hd); at the budget first merge (or
    evict) in every (batch, head).  ``table`` must be on the state's device.
    Returns the state with ``count <= budget``; its tensors are updated in
    place."""
    if policy not in ("merge", "evict"):
        raise ValueError(f"policy must be 'merge' or 'evict', not {policy!r}")
    k, v, count = state
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)   # (B, H, W, hd) views
    if count >= k.shape[1]:
        if policy == "merge":
            _merge(kt, vt, count, gamma, table)
        else:
            _evict(kt, vt, count)
        count -= 1
    k[:, count] = k_new[:, 0].to(k.dtype)
    v[:, count] = v_new[:, 0].to(v.dtype)
    return KVBudgetState(k=k, v=v, count=count + 1)


def kv_attend(state: KVBudgetState, q, scale: float):
    """q: (B, 1, H, hd) against the budgeted cache -> (B, 1, H, hd)."""
    valid = torch.arange(state.k.shape[1], device=q.device) < state.count
    bias = torch.where(valid, 0.0, -1e30)[None, None, None, :]
    scores = torch.einsum("bqhd,bwhd->bhqw", q.float(), state.k.float()) * scale + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqw,bwhd->bqhd", probs, state.v.float()).to(q.dtype)
