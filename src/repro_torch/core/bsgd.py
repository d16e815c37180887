"""Budgeted stochastic gradient descent kernel SVM (Pegasos + merge budget), in PyTorch.

PyTorch counterpart of ``repro.core.bsgd`` for binary problems:

  * SV storage has ``slots = budget + batch_size`` rows; ``count`` is the
    active watermark.  Insert writes at the watermark; maintenance merges
    (or removes) until ``count <= budget`` (``core.budget``).
  * Pegasos step t: eta_t = 1/(lambda t); alpha *= (1 - eta_t lambda); every
    margin violator of the minibatch is inserted with alpha = eta_t y / batch.
  * ``batch_size = 1`` is the paper's setting.
  * With ``use_kernel_cache`` the state carries the SV-SV kernel matrix
    ``kmat`` (``core.kernel_cache``), and maintenance reads its kappa rows.
  * Every state leaf may carry a leading class axis (``core.multiclass``);
    ``insert_from_rows`` takes either form.

The state stays on its device for a whole epoch: a step reads nothing back
to the host.  Entry points (``init_state``, ``fit``, ``train_epoch``,
``decision_function``, ``accuracy``) run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card and no explicit device they raise.
Matrix products assume PyTorch's default full-fp32 matmul
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import budget as budget_mod
from . import kernel_cache
from .lookup import MergeLookupTable, default_table
from ..kernels import ops as kops


class SVMState(NamedTuple):
    sv_x: torch.Tensor       # (slots, dim)
    alpha: torch.Tensor      # (slots,)
    count: torch.Tensor      # () int32 — active SVs
    step: torch.Tensor       # () int32 — Pegasos t (starts at 1)
    n_inserts: torch.Tensor  # () int32 — margin violations so far
    n_merges: torch.Tensor   # () int32 — budget-maintenance events so far
    kmat: torch.Tensor | None = None  # (slots, slots) fp32 SV-SV kernel cache, or None


@dataclasses.dataclass(frozen=True)
class BSGDConfig:
    """Budgeted-SGD hyperparameters (one binary problem).

    The fields and their validation are ``repro.core.bsgd.BSGDConfig``'s, so
    one config means the same in both packages.  A valid setting that this
    port does not carry yet raises ``NotImplementedError`` naming the
    ROADMAP.md item: ``solver="bdca"``.  ``maintenance_engine="pallas"``
    runs the fused ``merge_event`` kernel; ``step_engine="pallas"`` runs the
    whole step (margin rows, insert, event rounds) as one ``train_step``
    kernel launch per step.  Maintenance always runs ``batch_size`` masked
    events (or rounds) per step (the reference's ``unroll_maintenance``
    form), whichever ``unroll_maintenance`` says.
    """

    budget: int = 100
    lambda_: float = 1e-4
    gamma: float = 1.0
    method: str = "lookup-wd"          # gss | gss-precise | lookup-h | lookup-wd
    batch_size: int = 1
    grid_size: int = 400
    dtype: str = "float32"             # alpha / margin arithmetic dtype
    sv_dtype: str | None = None        # SV row storage; None = dtype
    use_kernel_cache: bool = False
    maintenance: str = "merge"         # merge | multi-merge | removal |
                                       # removal-project | quantized
    merge_batch: int = 4
    unroll_maintenance: bool = False
    maintenance_engine: str = "xla"    # xla | pallas
    step_engine: str = "composed"      # composed | pallas
    solver: str = "bsgd"               # bsgd | bdca
    bdca_rounds: int = 2
    bdca_C: float = 1.0

    def __post_init__(self):
        if self.method not in budget_mod.METHODS:
            raise ValueError(f"method={self.method!r} not in {budget_mod.METHODS}")
        if self.maintenance not in budget_mod.STRATEGIES:
            raise ValueError(f"maintenance={self.maintenance!r} not in "
                             f"{budget_mod.STRATEGIES}")
        if self.maintenance == "multi-merge" and not (1 <= self.merge_batch <= self.budget):
            raise ValueError("multi-merge needs 1 <= merge_batch <= budget")
        if self.maintenance_engine not in ("xla", "pallas"):
            raise ValueError(f"maintenance_engine={self.maintenance_engine!r}"
                             " not in ('xla', 'pallas')")
        if self.maintenance_engine == "pallas" and not (
                self.use_kernel_cache and self.maintenance == "merge"
                and self.method == "lookup-wd"):
            raise ValueError(
                "maintenance_engine='pallas' runs the fused Lookup-WD merge "
                "event off the kernel cache: it requires "
                "use_kernel_cache=True, maintenance='merge' and "
                "method='lookup-wd'")
        if self.maintenance in ("removal-project", "quantized") and not self.use_kernel_cache:
            raise ValueError(
                f"maintenance={self.maintenance!r} reads projection/"
                "absorption coefficients from cached kernel rows: it "
                "requires use_kernel_cache=True")
        if self.step_engine not in ("composed", "pallas"):
            raise ValueError(f"step_engine={self.step_engine!r} not in "
                             "('composed', 'pallas')")
        if self.step_engine == "pallas" and not (
                self.use_kernel_cache and self.method == "lookup-wd"
                and self.maintenance in ("merge", "multi-merge")):
            raise ValueError(
                "step_engine='pallas' runs the fused train-step megakernel "
                "off the kernel cache: it requires use_kernel_cache=True, "
                "method='lookup-wd' and maintenance in "
                "('merge', 'multi-merge')")
        if self.solver not in ("bsgd", "bdca"):
            raise ValueError(f"solver={self.solver!r} not in ('bsgd', 'bdca')")
        if self.solver == "bdca":
            if not self.use_kernel_cache:
                raise ValueError(
                    "solver='bdca' ascends on the cached working-set Gram "
                    "matrix (SVMState.kmat): it requires "
                    "use_kernel_cache=True")
            if self.step_engine == "pallas":
                raise ValueError(
                    "step_engine='pallas' fuses the Pegasos primal update; "
                    "solver='bdca' needs step_engine='composed' "
                    "(maintenance_engine='pallas' composes fine)")
            if self.bdca_rounds < 1:
                raise ValueError("solver='bdca' needs bdca_rounds >= 1")
            if not self.bdca_C > 0:
                raise ValueError("solver='bdca' needs bdca_C > 0")
        if self.batch_size < 1:
            raise ValueError(f"batch_size={self.batch_size} < 1")
        self._check_ported()

    def _check_ported(self):
        if self.solver == "bdca":
            raise NotImplementedError(
                "solver='bdca' is not ported to repro_torch yet (ROADMAP.md Queue 1 item 9)")

    @property
    def slots(self) -> int:
        return self.budget + self.batch_size

    def table(self) -> MergeLookupTable | None:
        if self.method.startswith("lookup"):
            return default_table(self.grid_size)
        return None

    @staticmethod
    def from_C(n: int, C: float, **kw) -> "BSGDConfig":
        return BSGDConfig(lambda_=1.0 / (n * C), **kw)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.  Raises where
    the card is asked for and there is none: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _to(state: SVMState, dev: torch.device) -> SVMState:
    return SVMState(*(None if t is None else t.to(dev) for t in state))


def _owned(state: SVMState) -> SVMState:
    """A contiguous copy of every leaf, for the fused step to update in place."""
    return SVMState(*(None if t is None else t.clone(memory_format=torch.contiguous_format)
                      for t in state))


def _tensor(a, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(a).to(dev, dtype)


def init_state(cfg: BSGDConfig, dim: int, *, device=None) -> SVMState:
    dev = resolve_device(device)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    return SVMState(
        sv_x=torch.zeros((cfg.slots, dim), dtype=getattr(torch, cfg.sv_dtype or cfg.dtype),
                         device=dev),
        alpha=torch.zeros((cfg.slots,), dtype=getattr(torch, cfg.dtype), device=dev),
        count=zero(), step=torch.ones((), dtype=torch.int32, device=dev),
        n_inserts=zero(), n_merges=zero(),
        kmat=kernel_cache.init_cache(cfg.slots, device=dev) if cfg.use_kernel_cache else None)


def decision_function(state: SVMState, x, gamma, *, impl: str = "auto", device=None):
    """f(x) = sum_j alpha_j k(sv_j, x);  x: (n, d) -> (n,)."""
    dev = resolve_device(device)
    state = _to(state, dev)
    k = kops.rbf_matrix(_tensor(x, dev), state.sv_x, gamma, impl=impl)   # (n, slots)
    active = torch.arange(state.alpha.shape[0], device=dev) < state.count
    return k.to(state.alpha.dtype) @ torch.where(active, state.alpha, 0.0)


def predict(state: SVMState, x, gamma, **kw):
    return torch.sign(decision_function(state, x, gamma, **kw))


def accuracy(state: SVMState, x, y, gamma, *, impl: str = "auto", device=None):
    """Share of rows whose predicted sign equals ``y`` (a 0-d tensor)."""
    dev = resolve_device(device)
    pred = predict(state, x, gamma, impl=impl, device=dev)
    return (pred == _tensor(y, dev)).to(torch.float32).mean()


def insert_from_rows(cfg: BSGDConfig, state: SVMState, xb, yb, k_b, k_bb=None) -> SVMState:
    """The Pegasos shrink + violator insert half of a step (no maintenance).

    Binary: ``yb`` (batch,) and ``k_b = k(xb, sv_x)`` (batch, slots).  Stacked
    (every state leaf with a leading class axis): ``yb`` (C, batch) and
    ``k_b`` (C, batch, slots).  ``k_bb = k(xb, xb)`` (batch, batch) is needed
    only with the kernel cache.  ``count`` may exceed the budget by up to
    ``batch_size`` afterwards; ``drain_budget`` drains it."""
    slots = state.alpha.shape[-1]
    t = state.step
    eta = 1.0 / (cfg.lambda_ * t)                # float32, as the reference's

    idx = budget_mod.kref.iota(slots, state.alpha.device)
    count = state.count[..., None]
    active = idx < count
    a_act = torch.where(active, state.alpha, 0.0)
    k = k_b.to(state.alpha.dtype)
    f = k @ a_act if a_act.dim() == 1 else (k @ a_act[..., None])[..., 0]
    margin = yb * f

    # Pegasos shrink: w <- (1 - eta lambda) w.  Every fresh SV's |alpha| is
    # 1/(lambda t) up to round-off, so this factor's last bit decides the
    # min-|alpha| ties of maintenance.  The reference's compiled step rounds
    # 1 - eta*lambda once (a fused multiply-add); the product of two float32
    # values is exact in float64, so this rounds as the reference does.
    shrink = (1.0 - eta.double() * float(np.float32(cfg.lambda_))).to(torch.float32)
    alpha = state.alpha * shrink[..., None]

    # insert violators at the watermark: slot q takes the batch row whose
    # position is q (each slot is hit at most once; non-violators go to
    # ``slots`` and hit none).  ``xb`` is shared by every class.
    viol = margin < 1.0
    pos = torch.where(viol, count + torch.cumsum(viol.to(torch.int32), -1) - 1, slots)
    written, src = torch.max(pos.unsqueeze(-1) == idx, dim=-2)        # (..., slots)
    sv_x = torch.where(written.unsqueeze(-1), xb.to(state.sv_x.dtype)[src], state.sv_x)
    new_alpha = (eta.unsqueeze(-1) * yb / cfg.batch_size).to(alpha.dtype)
    alpha = torch.where(written, new_alpha.gather(-1, src), alpha)
    n_new = viol.sum(-1).to(torch.int32)

    kmat = state.kmat
    if cfg.use_kernel_cache:
        k_bb = k_bb if pos.dim() == 1 else k_bb.expand(*pos.shape, xb.shape[0])
        kmat = kernel_cache.insert_rows(kmat, pos, k_b, k_bb)
    return SVMState(sv_x=sv_x, alpha=alpha, count=state.count + n_new, step=t + 1,
                    n_inserts=state.n_inserts + n_new, n_merges=state.n_merges, kmat=kmat)


def drain_budget(cfg: BSGDConfig, table, state: SVMState, *, impl: str = "auto") -> SVMState:
    """The maintenance half of a train step: drain ``count`` back to the budget
    through the configured strategy, or the fused event engine
    (``maintenance_engine="pallas"``, lifted to one class)."""
    if cfg.maintenance_engine == "pallas":
        sv_x, alpha, kmat, count, n_merges = (a[0] for a in budget_mod.run_maintenance_classes(
            state.sv_x[None], state.alpha[None], state.kmat[None], state.count[None],
            state.n_merges[None], table, budget=cfg.budget, impl=impl, unroll=cfg.batch_size))
    else:
        sv_x, alpha, kmat, count, n_merges = budget_mod.run_maintenance(
            state.sv_x, state.alpha, state.kmat, state.count, state.n_merges, cfg.gamma, table,
            budget=cfg.budget, strategy=cfg.maintenance, method=cfg.method,
            merge_batch=cfg.merge_batch, unroll=cfg.batch_size, impl=impl)
    return state._replace(sv_x=sv_x, alpha=alpha, count=count, n_merges=n_merges, kmat=kmat)


def train_step_from_rows(cfg: BSGDConfig, table, state: SVMState, xb, yb, k_b, k_bb=None, *,
                         impl: str = "auto") -> SVMState:
    """Pegasos minibatch step + maintenance from precomputed kernel rows
    (``k_bb`` only with the kernel cache)."""
    state = insert_from_rows(cfg, state, xb, yb, k_b, k_bb)
    return drain_budget(cfg, table, state, impl=impl)


def _fused_step_(cfg: BSGDConfig, table, state: SVMState, xb, yb, *,
                 impl: str = "auto") -> SVMState:
    """``step_engine="pallas"``: the whole step as one ``train_step`` launch,
    the binary state lifted to C = 1 (views, so the leaves are updated IN
    PLACE; the state must own contiguous leaves)."""
    k_bb = kops.rbf_matrix(xb, xb, cfg.gamma, impl=impl)
    out = kops.train_step(
        state.sv_x[None], state.alpha[None], state.kmat[None], state.count.view(1),
        state.step.view(1), state.n_inserts.view(1), state.n_merges.view(1), xb, yb[None],
        k_bb, table, budget=cfg.budget, lambda_=cfg.lambda_, gamma=cfg.gamma,
        batch_size=cfg.batch_size, maintenance=cfg.maintenance, merge_batch=cfg.merge_batch,
        impl=impl)
    return state._replace(step=out[4].view(()))


def train_step(cfg: BSGDConfig, table, state: SVMState, xb, yb, *,
               impl: str = "auto") -> SVMState:
    """One minibatch step + budget maintenance on the state's device; the
    caller's state is left as it was.

    xb: (batch, dim), yb: (batch,) in {-1, +1}, on the state's device."""
    if cfg.step_engine == "pallas":
        return _fused_step_(cfg, table, _owned(state), xb, yb, impl=impl)
    k_b = kops.rbf_matrix(xb, state.sv_x, cfg.gamma, impl=impl)   # (batch, slots)
    k_bb = kops.rbf_matrix(xb, xb, cfg.gamma, impl=impl) if cfg.use_kernel_cache else None
    return train_step_from_rows(cfg, table, state, xb, yb, k_b, k_bb, impl=impl)


def train_epoch(cfg: BSGDConfig, table, state: SVMState, x, y, perm, *,
                impl: str = "auto", device=None) -> SVMState:
    """One pass over resident data in ``perm`` order.

    Args:
      table: the precomputed ``MergeLookupTable`` (``cfg.table()``), or None
        for the gss methods.
      x: (n, d) rows; y: (n,) labels in {-1, +1}; perm: (n,) row order (rows
        past the last full ``batch_size`` multiple are dropped).  numpy
        arrays or tensors; they are moved to the device.
    """
    dev = resolve_device(device)
    state = _to(state, dev)
    table = None if table is None else table.to(dev)
    b = cfg.batch_size
    order = _tensor(perm, dev, torch.int64)
    steps = order.shape[0] // b
    order = order[: steps * b]
    xs = _tensor(x, dev).index_select(0, order)
    ys = _tensor(y, dev).index_select(0, order)
    step_fn = train_step
    if cfg.step_engine == "pallas":   # one copy of the state, updated in place every step
        state, step_fn = _owned(state), _fused_step_
    for i in range(steps):
        state = step_fn(cfg, table, state, xs[i * b:(i + 1) * b], ys[i * b:(i + 1) * b],
                        impl=impl)
    return state


def fit(cfg: BSGDConfig, x, y, *, epochs: int = 1, seed: int = 0, impl: str = "auto",
        state: SVMState | None = None, device=None) -> SVMState:
    """Train a budgeted SVM on in-memory data: shuffled epochs over (x, y).

    Each epoch's permutation comes from a ``torch.Generator`` seeded with
    ``seed`` (torch cannot reproduce the reference's ``jax.random`` draws;
    pass a permutation to ``train_epoch`` to replay a given order).
    """
    dev = resolve_device(device)
    table = cfg.table()
    table = None if table is None else table.to(dev)
    x, y = _tensor(x, dev), _tensor(y, dev)
    if state is None:
        state = init_state(cfg, x.shape[1], device=dev)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(epochs):
        perm = torch.randperm(x.shape[0], generator=gen)
        state = train_epoch(cfg, table, state, x, y, perm, impl=impl, device=dev)
    return state
