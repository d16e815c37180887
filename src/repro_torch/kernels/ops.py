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

from . import bdca as bdca_kernel
from . import class_scores as class_scores_kernel
from . import gss as gss_kernel
from . import merge_event as merge_event_kernel
from . import merge_lookup, merge_multi, rbf_kernel, ref
from . import train_step as train_step_kernel

IMPLS = ("auto", "cuda", "ref")
# kernel name -> (wrapper module, its launch counter)
_KERNELS = {"rbf_matrix": (rbf_kernel, "launches"), "merge_scores": (merge_lookup, "launches"),
            "merge_pick": (merge_lookup, "pick_launches"), "gss": (gss_kernel, "launches"),
            "gss_pick": (gss_kernel, "pick_launches"),
            "multi_merge_scores": (merge_multi, "launches"),
            "multi_merge_choose": (merge_multi, "choose_launches"),
            "merge_event": (merge_event_kernel, "launches"),
            "merge_event_rounds": (merge_event_kernel, "rounds_launches"),
            "train_step": (train_step_kernel, "launches"),
            "class_scores": (class_scores_kernel, "launches"),
            "bdca_ascent": (bdca_kernel, "launches")}


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs tensors on a CUDA device")
    return impl == "cuda" or (impl == "auto" and t.is_cuda)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, counter) for name, (mod, counter) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, counter in _KERNELS.values():
        setattr(mod, counter, 0)


def rbf_matrix(x, y, gamma, *, impl: str = "auto"):
    """K[i, j] = exp(-gamma ||x_i - y_j||^2); x (n, d), y (m, d) -> (n, m) fp32."""
    if _use_kernel(impl, x):
        return rbf_kernel.rbf_matrix_cuda(x, y, gamma)
    return ref.rbf_matrix(x, y, gamma)


def rbf_per_class(x, y, gamma, *, impl: str = "auto"):
    """K[c, i, j] = k(x[c, i], y[c, j]); x (C, n, d), y (C, m, d) -> (C, n, m).

    On the card one ``rbf_matrix`` launch covers every class: with C > 1 it
    scores every class's rows against the whole flattened bank and keeps the
    diagonal blocks, so it does C times the work it keeps.  Only the
    uncached class-axis paths call it (kappa rows of ``merge`` and
    ``multi-merge`` without the kernel cache); the cached ones read their
    rows from the cache."""
    if not _use_kernel(impl, x):
        return ref.rbf_matrix(x, y, gamma)
    c, n, d = x.shape
    if c == 1:
        return rbf_kernel.rbf_matrix_cuda(x[0], y[0], gamma)[None]
    k = rbf_kernel.rbf_matrix_cuda(x.reshape(c * n, d), y.reshape(-1, d), gamma)
    ar = torch.arange(c, device=x.device)
    return k.view(c, n, c, -1)[ar, :, ar]


def rbf_row(sv_x, x, gamma, *, impl: str = "auto"):
    """kappa_row[j] = k(x, sv_x[j]); sv_x (s, d), x (d,) -> (s,), or one row per
    class: sv_x (C, s, d), x (C, d) -> (C, s).

    On the card this is the matmul-form kernel with n = 1 (as the reference
    does on the TPU); on the CPU the direct-difference form (as the
    reference does off the TPU)."""
    if _use_kernel(impl, sv_x):
        if sv_x.dim() == 2:
            return rbf_kernel.rbf_matrix_cuda(x.reshape(1, -1), sv_x, gamma)[0]
        return rbf_per_class(x[:, None, :], sv_x, gamma, impl=impl)[:, 0]
    return ref.rbf_row(sv_x, x, gamma)


def class_scores(x, sv_x, alpha, gamma, *, impl: str = "auto"):
    """All-class decision scores (C, n): ``serve_cell``'s scores.

    x: (n, d); sv_x: (C, slots, d); alpha: (C, slots), inactive slots zeroed
    by the caller.  Oracle: ``ref.class_scores`` (one call per class)."""
    return serve_cell(x, sv_x, alpha, gamma, impl=impl)[0]


def serve_cell(x, sv_x, alpha, gamma, *, binary: bool = False, impl: str = "auto"):
    """The serve cell: ``(scores, labels)`` for request rows x (n, d).

    sv_x: (C, slots, d) fp32 or bf16 bank, folded into one (n, C * slots)
    kernel block; alpha: (C, slots), inactive slots zeroed, contracted in
    fp32.  scores (C, n); labels (n,) int32 argmax ids, or the fp32 signs of
    a binary model's one score (``binary``, C = 1).  Every sum has one order
    whatever n, so a row's scores and label are the same bits in a batch of
    any size: on the card ``rbf_tiled`` (``path="tiled"`` for every n; one
    thread sums each output in feature order) then one ``class_scores``
    launch; on the CPU ``ref.rbf_matrix_rows`` then
    ``ref.class_scores_labels``."""
    c, slots, d = sv_x.shape
    bank = sv_x.reshape(c * slots, d)
    if _use_kernel(impl, x):
        k = rbf_kernel.rbf_matrix_cuda(x, bank, gamma, path="tiled")
        return class_scores_kernel.class_scores_cuda(k, alpha.float(), binary=binary)
    return ref.class_scores_labels(ref.rbf_matrix_rows(x, bank, gamma), alpha, binary=binary)


def merge_scores(alpha, kappa_row, valid, a_min, table, *, impl: str = "auto"):
    """``(wd, interp)`` per candidate for one fixed partner, or one per row.

    alpha, kappa_row, valid (bool): (s,) with a_min a one-element tensor, or
    rows (R, s) with a_min (R,), on the same device; table: (G, G).
    ``interp`` is the table interpolated at each candidate's ``(m, kappa)``;
    ``wd = (a_min + alpha)^2 * interp`` at valid slots, and a value >=
    ``ref.NO_PARTNER`` at invalid ones (+inf on the plain path, 3.4e38 from
    the kernel)."""
    if _use_kernel(impl, alpha):
        return merge_lookup.merge_scores_cuda(alpha, kappa_row, valid, a_min, table)
    a = a_min.reshape(-1, 1) if alpha.dim() == 2 else a_min
    wd = ref.merge_scores(alpha, kappa_row, valid, a, table)
    m, kap = ref.merge_coords(a, alpha, kappa_row)
    return wd, ref.bilinear_lookup(table, m, kap)


def gss_solve(m, kappa, *, n_iters: int, impl: str = "auto"):
    """argmax_h of the merge objective for (m, kappa) of any one shape."""
    if _use_kernel(impl, m):
        return gss_kernel.gss_cuda(m.float(), kappa.float(), n_iters)
    return ref.gss(m, kappa, n_iters)


def gss_pick(alpha, kappa, count, i_min, a_min, *, n_iters: int, impl: str = "auto"):
    """The choice of one GSS merge event per row: ``(j_star, wd_j, h_j)``.

    Inputs as ``merge_pick``'s, without the tables: each valid candidate's
    h* comes from ``n_iters`` golden-section bracket steps (10 for ``gss``,
    48 for ``gss-precise``), then its exact weight degradation; ``j_star``
    is the first-occurrence argmin (slot 0 when none is valid), ``wd_j`` its
    WD (``>= ref.NO_PARTNER`` when none is valid: the removal fallback) and
    ``h_j`` h* at the winner.  On the card one ``gss_pick`` launch; the
    plain version is ``ref.gss_pick``."""
    if _use_kernel(impl, alpha):
        return gss_kernel.gss_pick_cuda(alpha, kappa, count, i_min, a_min, n_iters)
    return ref.gss_pick(alpha, kappa, count, i_min, a_min, n_iters)


def merge_pick(alpha, kappa, count, i_min, a_min, table, *, impl: str = "auto"):
    """The choice of one Lookup-WD merge event per row: ``(j_star, wd_j, h_j)``.

    alpha, kappa: (s,) for a binary state, or rows (R, s); count: the active
    slots, 0-d int32 or (R,); i_min: (R,) int64 and a_min: (R,), the fixed
    partner's slot and coefficient; ``table`` a ``MergeLookupTable``.
    Candidate j is valid when ``j < count``, ``alpha_j * a_min > 0`` and
    ``j != i_min``; ``j_star`` (R,) is the first-occurrence argmin of the
    Lookup-WD scores (slot 0 when none is valid), ``wd_j`` its score
    (``>= ref.NO_PARTNER`` when none is valid: the removal fallback) and
    ``h_j`` the h table at the winner.  On the card one ``merge_pick``
    launch; the plain version is ``ref.merge_pick``."""
    if _use_kernel(impl, alpha):
        return merge_lookup.merge_pick_cuda(alpha, kappa, count, i_min, a_min, table.wd_table,
                                            table.h_table)
    return ref.merge_pick(alpha, kappa, count, i_min, a_min, table.wd_table, table.h_table)


def multi_merge_scores(alpha, kappa_rows, valid, a_min, table, *, impl: str = "auto"):
    """``(wd, h)`` for P fixed merge partners at once, both tables in one pass.

    Flat: alpha (s,); kappa_rows, valid (P, s); a_min (P,) -> (P, s).
    Class-batched: alpha (C, s); kappa_rows, valid (C, P, s); a_min (C, P)
    -> (C, P, s), the (C, P) pairs folded onto the rows of ONE kernel launch
    with class c's alpha shared by its P rows.  ``table`` is a
    ``MergeLookupTable``.  Invalid slots get WD +inf (plain) or 3.4e38
    (kernel), argmin-safe either way."""
    if _use_kernel(impl, alpha):
        return merge_multi.multi_merge_scores_cuda(alpha, kappa_rows, valid, a_min,
                                                   table.h_table, table.wd_table)
    fn = ref.multi_merge_scores_classes if kappa_rows.dim() == 3 else ref.multi_merge_scores
    return fn(alpha, kappa_rows, valid, a_min, table.h_table, table.wd_table)


def multi_merge_choose(alpha, kappa_rows, a_idx, a_min, count, budget: int, table, *,
                       impl: str = "auto"):
    """Scoring and greedy disjoint pair choice of one multi-merge event per class.

    alpha: (C, s); kappa_rows: (C, P, s), the fixed partners' kernel rows;
    a_idx: (C, P) int64 and a_min: (C, P), the P smallest active |alpha|
    (cheapest first) and their coefficients; count: (C,) int32; ``table`` a
    ``MergeLookupTable``.  Returns ``(b_idx, merged, execute, h_star)``, (C, P)
    each, as ``core.budget._multi_merge_once`` steps 3-4 define them: in
    |alpha| order a pair executes unless its slot was taken as an earlier
    partner or the excess ``count - budget`` is covered, and merges with its
    best untaken same-sign candidate or falls back to removal; ``h_star`` is
    the h table at each pair's candidate.  On the card one
    ``multi_merge_choose`` launch (one block a class); the plain version is
    ``ref.multi_merge_choose``."""
    if _use_kernel(impl, alpha):
        return merge_multi.multi_merge_choose_cuda(alpha, kappa_rows, a_idx, a_min, count,
                                                   budget, table.h_table, table.wd_table)
    return ref.multi_merge_choose(alpha, kappa_rows, a_idx, a_min, count, budget,
                                  table.h_table, table.wd_table)


def merge_event(sv_x, alpha, kmat, count, over, table, *, decisions=None, impl: str = "auto"):
    """One maintenance-event round over stacked classes, IN PLACE.

    sv_x: (C, s, d) fp32 or bf16; alpha: (C, s) fp32; kmat: (C, s, s) fp32
    kernel cache; count: (C,) int32; over: (C,) bool; ``table`` a
    ``MergeLookupTable``.  Every class with ``over`` set runs one Lookup-WD
    merge event (argmin-|alpha| fixed partner, cached kappa row, best
    same-sign partner, removal fallback) exactly as ``core.budget._merge_once``
    would on its slice; classes with ``over`` clear are not written.
    ``decisions`` ((C, 3) int32 or None) receives each executing class's
    ``(i_min, j_star, merged)``.

    Both the kernel and the plain version update ``sv_x``, ``alpha`` and
    ``kmat`` in place (the TPU kernel aliases its outputs to its inputs) and
    return them; clone the inputs first to keep them.  The caller owns
    ``count -= over`` and the round schedule; the training paths run a
    step's rounds in one ``merge_event_rounds`` call instead."""
    if _use_kernel(impl, sv_x):
        return merge_event_kernel.merge_event_cuda(sv_x, alpha, kmat, count, over,
                                                   table.h_table, table.wd_table, decisions)
    return ref.merge_event(sv_x, alpha, kmat, count, over, table.h_table, table.wd_table,
                           decisions)


def merge_event_rounds(sv_x, alpha, kmat, count, n_events, table, *, rounds: int, budget: int,
                       impl: str = "auto"):
    """A step's ``rounds`` masked maintenance-event rounds over stacked
    classes, IN PLACE: each round, every class with ``count > budget`` runs
    one Lookup-WD merge event (``merge_event``), then ``count -= 1`` and
    ``n_events += 1`` there.  Shapes as ``merge_event``; ``count`` and
    ``n_events`` ((C,) int32) are updated in place as well, so hand over
    tensors that nothing else holds.  On the card one ``merge_event_rounds``
    launch (one cluster a class runs the loop); the plain version
    ``ref.merge_event_rounds`` is the loop of ``ref.merge_event``.  Returns
    ``(sv_x, alpha, kmat, count, n_events)``."""
    if _use_kernel(impl, sv_x):
        return merge_event_kernel.merge_event_rounds_cuda(
            sv_x, alpha, kmat, count, n_events, table.h_table, table.wd_table, rounds=rounds,
            budget=budget)
    return ref.merge_event_rounds(sv_x, alpha, kmat, count, n_events, table.h_table,
                                  table.wd_table, rounds=rounds, budget=budget)


def train_step(sv_x, alpha, kmat, count, step, n_inserts, n_merges, xb, yb, k_bb, table, *,
               budget: int, lambda_: float, gamma: float, batch_size: int,
               maintenance: str = "merge", merge_batch: int = 4, impl: str = "auto"):
    """One whole training step for every class, IN PLACE: margin rows, Pegasos
    shrink and violator insert with the cache insert, then ``batch_size``
    masked ``merge`` or ``multi-merge`` event rounds.

    sv_x: (C, s, d) fp32 or bf16; alpha: (C, s); kmat: (C, s, s) fp32 kernel
    cache; count, step, n_inserts, n_merges: (C,) int32; xb: (batch, d);
    yb: (C, batch) one-vs-rest targets; k_bb: (batch, batch) ``k(xb, xb)``;
    ``table`` a ``MergeLookupTable``.  ``sv_x``, ``alpha``, ``kmat``,
    ``count``, ``n_inserts`` and ``n_merges`` are updated in place, by the
    kernel and the plain version alike (the TPU kernel aliases its outputs to
    its inputs); the call returns them with ``step + 1`` as ``(sv_x, alpha,
    kmat, count, step + 1, n_inserts, n_merges)``.  Clone the state first to
    keep it."""
    kw = dict(budget=budget, lambda_=lambda_, gamma=gamma, batch_size=batch_size,
              maintenance=maintenance, merge_batch=merge_batch)
    args = (sv_x, alpha, kmat, count, step, n_inserts, n_merges, xb, yb, k_bb,
            table.h_table, table.wd_table)
    if _use_kernel(impl, sv_x):
        return train_step_kernel.train_step_cuda(*args, **kw)
    return ref.train_step_fused(*args, **kw)


def bdca_ascent(alpha, kmat, count, C: float, rounds: int, *, impl: str = "auto"):
    """BDCA's ``rounds`` Gauss-Seidel sweeps of exact 1-D dual maximization
    over the working set, IN PLACE on ``alpha`` (returned).

    alpha: (s,) signed coefficients with kmat (s, s) and a 0-d int32 count,
    or stacked (C, s), (C, s, s) and (C,); ``C`` is the dual box.  Stale
    slots (``>= count``) come back zero; frozen ones (``alpha = 0``) stay.
    The kernel and the plain version alike update alpha in place; clone it
    first to keep it.  On the card one ``bdca_ascent`` launch (one block a
    class), reading ``count`` there; the plain version is
    ``ref.bdca_ascent``."""
    if _use_kernel(impl, alpha):
        return bdca_kernel.bdca_ascent_cuda(alpha, kmat, count, C, rounds)
    return ref.bdca_ascent(alpha, kmat, count, C, rounds)
