"""Persistent SV-SV kernel cache: incremental kappa rows for budget maintenance.

PyTorch counterpart of ``repro.core.kernel_cache``.  ``SVMState.kmat`` holds
the ``(slots, slots)`` kernel matrix of the SV set, so maintenance reads its
kappa rows instead of recomputing them:

  * **insert** reuses the ``k(xb, sv)`` rows the margins already computed;
    only the ``(batch, batch)`` block among the new points is new;
  * **merge** gives ``z = h x_a + (1-h) x_b`` its row in closed form, since
    for the Gaussian kernel ``log k(z, c) = h log k(x_a, c) + (1-h) log
    k(x_b, c) - h (1-h) log k(x_a, x_b)``: an O(slots) combine of two cached
    rows, independent of the feature count;
  * **removal / compaction** moves rows and columns, with no kernel math.

Invariants, masked by the ``count`` watermark:

  I1. ``kmat[i, j] == k(sv_x[i], sv_x[j])`` up to float32 round-off;
  I2. ``kmat`` is exactly symmetric (every update writes a row and its
      column from the same values);
  I3. ``kmat[i, i] == 1`` (set, never derived);
  I4. entries past the watermark are stale and never read.

The cache is fp32 whatever ``sv_dtype`` is.  Every update function takes one
``(S, S)`` cache with its indices, or a stacked ``(C, S, S)`` cache with a
leading class axis on every index; it returns a new tensor and leaves its
input as it was.  The writes are ``torch.where`` passes over the cache (a
few launches, no host sync), not scatters.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import ref as kref
from .merge_math import KAPPA_MIN


def init_cache(slots: int, dtype=torch.float32, *, device=None):
    """Fresh all-stale cache (``count = 0`` masks every entry)."""
    return torch.zeros((slots, slots), dtype=dtype, device=device)


def exact_cache(sv_x, gamma, dtype=torch.float32):
    """Ground-truth cache rebuilt from the SV set, (S, S) or stacked (C, S, S)."""
    k = kref.rbf_matrix(sv_x, sv_x, gamma).to(dtype)
    # I3: the matmul form yields exp(-gamma * eps) on the diagonal, not exactly 1
    eye = torch.eye(k.shape[-1], dtype=torch.bool, device=k.device)
    return torch.where(eye, 1.0, k)


def _safe_log(k):
    return torch.log(torch.clamp(k.float(), KAPPA_MIN, 1.0))


def _combine_rows(lk_a, lk_b, lk_ab, h):
    """Log-space kernel row of ``z = h x_a + (1-h) x_b``, clamped at 0 so that
    float noise in the ``-h(1-h) log k_ab`` term cannot push an entry above 1."""
    lz = h * lk_a + (1.0 - h) * lk_b - h * (1.0 - h) * lk_ab
    return torch.clamp(lz, max=0.0)


def z_row_from_rows(row_i, row_j, k_ij, h):
    """``k(z, .)`` from the two parents' kernel rows and their pair kernel
    (broadcasting: stacked rows take ``k_ij`` and ``h`` as (C, 1) columns)."""
    return torch.exp(_combine_rows(_safe_log(row_i), _safe_log(row_j), _safe_log(k_ij), h))


def _class_axis(fn):
    """Let ``fn``, written for a stacked (C, S, S) cache whose every other
    argument has a leading class axis, also take one (S, S) cache."""
    @functools.wraps(fn)
    def wrapper(kmat, *args):
        if kmat.dim() == 3:
            return fn(kmat, *args)
        lifted = [torch.as_tensor(a, device=kmat.device)[None] for a in args]
        return fn(kmat[None], *lifted)[0]
    return wrapper


def _ar(kmat):
    return kref.iota(kmat.shape[0], kmat.device)


@_class_axis
def merge_z_row(kmat, i, j, h):
    """``k(z, sv[q])`` for every slot q from cached rows only, for
    ``z = h sv[i] + (1-h) sv[j]``."""
    ar = _ar(kmat)
    return z_row_from_rows(kmat[ar, i], kmat[ar, j], kmat[ar, i, j][:, None],
                           h[:, None]).to(kmat.dtype)


@_class_axis
def insert_rows(kmat, idx, k_new_old, k_new_new):
    """Cache update for a minibatch insert at slots ``idx``, written rows,
    then columns, then the diagonal, as the reference writes them.

    idx: (batch,) target slots, ``slots`` for rows that are not inserted;
    k_new_old: (batch, slots) ``k(xb, sv_old)``, the margin rows, reused;
    k_new_new: (batch, batch) ``k(xb, xb)``."""
    # the new rows' columns at the inserted slots hold new-vs-new values
    rows = kref.put_rows(k_new_old.to(kmat.dtype).transpose(1, 2), idx,
                         k_new_new.to(kmat.dtype).transpose(1, 2)).transpose(1, 2)
    kmat = kref.put_rows_and_columns(kmat, idx, rows)
    return kref.put_diag(kmat, idx, 1.0)


@_class_axis
def apply_merge(kmat, i_min, j_star, last, h):
    """Cache update for one merge: slot ``lo`` <- z, slot ``hi`` <- the old
    slot ``last``, ``last`` retired (``core.budget``'s compaction)."""
    ar = _ar(kmat)
    z_row = merge_z_row(kmat, i_min, j_star, h)
    lo, hi = torch.minimum(i_min, j_star)[:, None], torch.maximum(i_min, j_star)[:, None]
    kmat = kref.put_rows_and_columns(kmat, hi, kmat[ar, last][:, None])
    kmat = kref.put_diag(kmat, hi, 1.0)
    # z_row was computed against the pre-move layout: slot hi now holds the
    # old ``last``, and k(z, z) = 1
    z_row = kref.put_rows(z_row, torch.cat([lo, hi], dim=1),
                          torch.stack([torch.ones_like(z_row[:, 0]), z_row[ar, last]], dim=1))
    return kref.put_rows_and_columns(kmat, lo, z_row[:, None])


@_class_axis
def apply_removal(kmat, i_min, last):
    """Cache update for the removal fallback: slot ``i_min`` <- the old ``last``."""
    i = i_min[:, None]
    kmat = kref.put_rows_and_columns(kmat, i, kmat[_ar(kmat), last][:, None])
    return kref.put_diag(kmat, i, 1.0)


@_class_axis
def apply_multi_merge(kmat, a_idx, b_idx, h, write_idx):
    """Cache update for P merges of disjoint pairs ``(a_p, b_p)`` at once.

    a_idx, b_idx: (P,) slots of the pairs; h: (P,) merge coefficients;
    write_idx: (P,) slot receiving ``z_p`` (``a_p``), or ``slots`` for pairs
    that did not merge (their writes drop).  Writes the z rows and columns
    and the (P, P) block ``k(z_p, z_q)``, itself the merge identity applied
    to the z rows.  Compaction is a separate step."""
    p = a_idx.shape[1]
    c = kmat.shape[0]
    a_idx, b_idx = a_idx.long(), b_idx.long()
    lk = _safe_log(kmat[_ar(kmat)[:, None], torch.cat([a_idx, b_idx], dim=1)])  # (C, 2P, S)
    lk_a, lk_b = lk[:, :p], lk[:, p:]
    lk_ab = lk_a.gather(2, b_idx[:, :, None])[:, :, 0]              # (C, P) log k(a_p, b_p)
    lz = _combine_rows(lk_a, lk_b, lk_ab[:, :, None], h[:, :, None])
    z_rows = torch.exp(lz).to(kmat.dtype)
    # k(z_p, z_q): the z_p row's entries at a_q and b_q with the (a_q, b_q) pair kernel
    cross = torch.exp(_combine_rows(lz.gather(2, a_idx[:, None, :].expand(c, p, p)),
                                    lz.gather(2, b_idx[:, None, :].expand(c, p, p)),
                                    lk_ab[:, None, :], h[:, None, :]))
    # k(z_p, z_q) and k(z_q, z_p) round differently: average them for I2, pin I3
    cross = 0.5 * (cross + cross.transpose(1, 2))
    eye = torch.eye(p, dtype=torch.bool, device=kmat.device)
    cross = torch.where(eye, 1.0, cross).to(kmat.dtype)
    kmat = kref.put_rows_and_columns(kmat, write_idx, z_rows)
    return kref.put_block(kmat, write_idx, write_idx, cross)


@_class_axis
def permute(kmat, perm):
    """Apply a slot permutation to both axes (compaction by permutation)."""
    return kmat[_ar(kmat)[:, None, None], perm[:, :, None], perm[:, None, :]]


class CacheInvariantError(AssertionError):
    """A violation of I1-I3 found by ``check_invariants``."""


def check_invariants(kmat, sv_x, count, gamma, *, tol: float = 5e-5, context: str = "") -> None:
    """Host-side check of I1-I3 over the active block, per class for stacked
    states: I1 against a rebuild from ``sv_x`` within ``tol``, I2 and I3
    exactly.  Raises ``CacheInvariantError`` naming the invariant and the
    worst entry.  O(count^2 dim): a debugging and test tool."""
    kmat = torch.as_tensor(kmat).detach().cpu().float()
    sv = torch.as_tensor(sv_x).detach().cpu().float()
    if sv.dim() == 3:
        counts = torch.as_tensor(count).reshape(-1)
        for q in range(sv.shape[0]):
            check_invariants(kmat[q], sv[q], counts[q], gamma, tol=tol,
                             context=f"{context}[class {q}]")
        return
    c = int(count)
    if c == 0:
        return
    got = kmat[:c, :c].numpy()
    want = exact_cache(sv[:c], gamma).numpy()
    where = f"{context}: " if context else ""
    if not np.array_equal(got, got.T):
        i, j = np.unravel_index(np.argmax(np.abs(got - got.T)), got.shape)
        raise CacheInvariantError(f"{where}I2 violated: kmat[{i},{j}]={got[i, j]!r} != "
                                  f"kmat[{j},{i}]={got[j, i]!r}")
    diag = np.diag(got)
    if not np.array_equal(diag, np.ones(c, got.dtype)):
        i = int(np.argmax(np.abs(diag - 1.0)))
        raise CacheInvariantError(f"{where}I3 violated: kmat[{i},{i}]={diag[i]!r} != 1")
    err = np.abs(got - want)
    if not np.all(err <= tol):
        i, j = np.unravel_index(np.argmax(err), err.shape)
        raise CacheInvariantError(
            f"{where}I1 violated: |kmat[{i},{j}] - k(sv_{i}, sv_{j})| = {err[i, j]:.3e} > "
            f"tol {tol:g} (cached {got[i, j]!r}, exact {want[i, j]!r})")


def invariant_errors(kmat, sv_x, count, gamma):
    """Worst I1 error per class (a (C,) float64 array; 0 for an empty class)."""
    kmat = torch.as_tensor(kmat).detach().cpu().float().reshape(-1, *kmat.shape[-2:])
    sv = torch.as_tensor(sv_x).detach().cpu().float().reshape(-1, *sv_x.shape[-2:])
    counts = torch.as_tensor(count).reshape(-1).tolist()
    out = np.zeros(len(counts))
    for q, c in enumerate(counts):
        if c:
            out[q] = float((kmat[q, :c, :c] - exact_cache(sv[q, :c], gamma)).abs().max())
    return out
