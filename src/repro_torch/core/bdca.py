"""BDCA: budgeted dual coordinate ascent on the cached working-set Gram matrix.

PyTorch counterpart of ``repro.core.bdca``: the dual subspace-ascent solver
of "Dual SVM Training on a Budget" (Qaadan, Schüler & Glasmachers, arXiv
1806.10182), the second solver behind ``BSGDConfig.solver``.  It shares
every other layer (the §14 solver contract in DESIGN.md):

  * the working set is the budgeted SV bank, ``SVMState`` with its ``count``
    watermark;
  * its Gram matrix is ``SVMState.kmat``, the kernel cache, so
    ``solver="bdca"`` requires ``use_kernel_cache=True``;
  * a minibatch row enters iff its margin violates ``y f(x) < 1`` (BSGD's
    criterion), with the optimal dual step from 0, ``y clip(1 - y f(x), 0,
    C)``, from the margin rows the step already computed;
  * budget maintenance is ``bsgd.drain_budget``, every strategy and engine.

``SVMState.alpha`` holds the signed coefficients ``b_i = y_i a_i``; the box
is ``|b_i| <= C``.  A sweep maximizes the dual exactly along each coordinate
in turn (``K_ii = 1``), carrying the margins ``f = K b`` along: on the card
one ``bdca_ascent`` launch runs a step's sweeps for every class
(``kernels.ops.bdca_ascent``).  A coordinate driven to ``a_i = 0`` loses its
sign and freezes; batch inserts are Jacobi-style, as in the reference.
"""
from __future__ import annotations

import torch

from . import kernel_cache
from .bsgd import BSGDConfig, SVMState, decision_rows, drain_budget
from ..kernels import ops as kops
from ..kernels import ref as kref


def box_from_lambda(n: int, lambda_: float, *, cap: float = 4.0) -> float:
    """Dual box ``C`` for a primal regularizer ``lambda_`` at sample size n:
    the textbook ``1 / (n lambda_)``, clamped to ``cap``.  At the paper's
    small lambdas the textbook box reaches ~1e2, and merged SVs (whose
    coefficients stand for sums of duals) then take steps of that size
    against a Gram matrix they no longer match; the reference's invariant
    harness pins solver parity at C <= 4."""
    if n < 1:
        raise ValueError(f"n={n} < 1")
    if lambda_ <= 0.0:
        raise ValueError(f"lambda_={lambda_} must be > 0")
    return min(float(cap), 1.0 / (n * lambda_))


def _masked(alpha, count):
    """Signed coefficients with stale (>= count) slots zeroed."""
    return torch.where(torch.arange(alpha.shape[-1], device=alpha.device) < count, alpha, 0.0)


def dual_objective(alpha, kmat, count):
    """D(a) = sum_i |b_i| - 1/2 b^T K b over the active working set (binary
    state; stale slots contribute nothing)."""
    b = _masked(alpha, count).float()
    return torch.sum(torch.abs(b)) - 0.5 * (b @ (kmat.float() @ b))


def kkt_residual(alpha, kmat, count, C):
    """Max |projected dual gradient| over live (non-frozen) coordinates: the
    interior ones contribute ``|g_i|``, those at the box only ``max(-g_i,
    0)``, frozen ``a_i = 0`` slots nothing.  Zero iff the live working set
    is dual-optimal at this box."""
    b = _masked(alpha, count).float()
    f = kmat.float() @ b
    a = torch.abs(b)
    g = 1.0 - torch.sign(b) * f
    live = (torch.arange(alpha.shape[-1], device=alpha.device) < count) & (a > 0)
    pg = torch.where(a >= C, torch.clamp(-g, min=0.0), torch.abs(g))
    return torch.max(torch.where(live, pg, 0.0))


def ascent_rounds(alpha, kmat, count, C, rounds: int, *, impl: str = "auto"):
    """``rounds`` Gauss-Seidel sweeps of exact 1-D dual maximization; returns
    the new signed coefficients (stale slots zero) and leaves ``alpha`` as it
    was.  Binary (s,) or stacked (C, s) with a leading class axis on kmat
    and count."""
    return kops.bdca_ascent(alpha.clone(memory_format=torch.contiguous_format), kmat, count, C,
                            rounds, impl=impl)


def insert_from_rows(cfg: BSGDConfig, state: SVMState, xb, yb, k_b, k_bb=None, *,
                     impl: str = "auto") -> SVMState:
    """The BDCA half of a step: dual violator insert, then the ascent sweeps.

    The counterpart of ``bsgd.insert_from_rows``, with its shapes (binary, or
    stacked with a leading class axis) and its post-condition: ``count`` may
    exceed the budget by up to ``batch_size``.  ``k_b = k(xb, sv_x)`` are
    the margin rows, ``k_bb = k(xb, xb)`` the cache block among the new
    points.  No Pegasos shrink: the box bounds the coefficients."""
    return _insert(cfg, state, xb, yb, k_b, k_bb, decision_rows(state, k_b), impl=impl)


def _insert(cfg: BSGDConfig, state: SVMState, xb, yb, k_b, k_bb, f, *,
            impl: str = "auto") -> SVMState:
    """``insert_from_rows`` given ``f``, the decision values of ``xb``."""
    slots = state.alpha.shape[-1]
    idx = kref.iota(slots, state.alpha.device)
    count = state.count[..., None]
    margin = yb * f

    # the optimal dual step from a = 0 (K_ii = 1): nonzero iff the margin
    # violates, BSGD's insert criterion
    viol = margin < 1.0
    a_new = torch.clamp(1.0 - margin, 0.0, cfg.bdca_C)
    pos = torch.where(viol, count + torch.cumsum(viol.to(torch.int32), -1) - 1, slots)
    written, src = torch.max(pos.unsqueeze(-1) == idx, dim=-2)        # (..., slots)
    sv_x = torch.where(written.unsqueeze(-1), xb.to(state.sv_x.dtype)[src], state.sv_x)
    alpha = torch.where(written, (yb * a_new).to(state.alpha.dtype).gather(-1, src), state.alpha)
    n_new = viol.sum(-1).to(torch.int32)
    k_bb = k_bb if pos.dim() == 1 else k_bb.expand(*pos.shape, xb.shape[0])
    kmat = kernel_cache.insert_rows(state.kmat, pos, k_b, k_bb)
    count = state.count + n_new

    # every coordinate of the working set (bank and fresh inserts), each
    # kappa a cache read; alpha is this step's own tensor, updated in place
    alpha = kops.bdca_ascent(alpha, kmat, count, cfg.bdca_C, cfg.bdca_rounds, impl=impl)
    return SVMState(sv_x=sv_x, alpha=alpha, count=count, step=state.step + 1,
                    n_inserts=state.n_inserts + n_new, n_merges=state.n_merges, kmat=kmat)


def train_step_from_rows(cfg: BSGDConfig, table, state: SVMState, xb, yb, k_b, k_bb=None, *,
                         impl: str = "auto") -> SVMState:
    """One BDCA step from precomputed kernel rows: the dual insert and ascent
    sweeps, then ``bsgd.drain_budget``, the BSGD step's maintenance."""
    state = insert_from_rows(cfg, state, xb, yb, k_b, k_bb, impl=impl)
    return drain_budget(cfg, table, state, impl=impl)
