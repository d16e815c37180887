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
to the host.  The streaming drivers (``train_chunk``, ``train_epoch_stream``,
``fit_stream``) train over a ``data.stream`` chunk source with only the
budgeted state resident: chunks load, shuffle and assemble on the host
(optionally ahead, on a worker thread), resume from checkpoints bit for bit,
and can retry, quarantine, guard and publish into a ``ModelBank``.  Entry points (``init_state``, ``fit``, ``train_epoch``,
``decision_function``, ``accuracy``) run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card and no explicit device they raise.
Matrix products assume PyTorch's default full-fp32 matmul
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import budget as budget_mod
from . import kernel_cache
from .. import checkpoint as ckpt_mod
from .lookup import MergeLookupTable, default_table
from ..kernels import _build as kops_build
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
    one config means the same in both packages.  ``solver="bdca"`` trains
    with the dual coordinate-ascent solver (``core.bdca``: one
    ``bdca_ascent`` launch a step runs its ``bdca_rounds`` sweeps in the box
    ``bdca_C``), through the same maintenance.  ``maintenance_engine="pallas"``
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


def decision_rows(state: SVMState, k_b):
    """f(xb) from the margin rows ``k_b = k(xb, sv_x)``: (batch,), or (C, batch)
    for a stacked state; slots at or past ``count`` contribute nothing."""
    idx = budget_mod.kref.iota(state.alpha.shape[-1], state.alpha.device)
    a_act = torch.where(idx < state.count[..., None], state.alpha, 0.0)
    k = k_b.to(state.alpha.dtype)
    return k @ a_act if a_act.dim() == 1 else (k @ a_act[..., None])[..., 0]


def insert_from_rows(cfg: BSGDConfig, state: SVMState, xb, yb, k_b, k_bb=None) -> SVMState:
    """The Pegasos shrink + violator insert half of a step (no maintenance).

    Binary: ``yb`` (batch,) and ``k_b = k(xb, sv_x)`` (batch, slots).  Stacked
    (every state leaf with a leading class axis): ``yb`` (C, batch) and
    ``k_b`` (C, batch, slots).  ``k_bb = k(xb, xb)`` (batch, batch) is needed
    only with the kernel cache.  ``count`` may exceed the budget by up to
    ``batch_size`` afterwards; ``drain_budget`` drains it."""
    return _insert(cfg, state, xb, yb, k_b, k_bb, decision_rows(state, k_b))


def _insert(cfg: BSGDConfig, state: SVMState, xb, yb, k_b, k_bb, f) -> SVMState:
    """``insert_from_rows`` given ``f``, the decision values of ``xb``."""
    slots = state.alpha.shape[-1]
    t = state.step
    eta = 1.0 / (cfg.lambda_ * t)                # float32, as the reference's

    idx = budget_mod.kref.iota(slots, state.alpha.device)
    count = state.count[..., None]
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
    """One minibatch step + maintenance from precomputed kernel rows (``k_bb``
    only with the kernel cache): the Pegasos insert, or with
    ``solver="bdca"`` the dual insert and ascent of ``core.bdca``."""
    if cfg.solver == "bdca":
        from . import bdca
        return bdca.train_step_from_rows(cfg, table, state, xb, yb, k_b, k_bb, impl=impl)
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
    """One minibatch step + budget maintenance on the state's device
    (``cfg.solver`` picks the insert half); the caller's state is left as it
    was.

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


# ---------------------------------------------------------------------------
# Streaming epochs: chunked host pipeline -> one chunk program a chunk
# ---------------------------------------------------------------------------

def train_chunk(cfg: BSGDConfig, table, state: SVMState, xc, yc, *,
                impl: str = "auto") -> SVMState:
    """One resident chunk: the in-memory epoch's steps over its minibatches.

    ``xc: (steps, batch, dim)``, ``yc: (steps, batch)``: the chunk already
    shuffled and reshaped on the host (numpy arrays or tensors; they move to
    the state's device as float32, the casts of ``train_epoch``).  The steps
    are ``train_epoch``'s, so a streamed epoch equals the in-memory one bit
    for bit.  With ``step_engine="pallas"`` the fused step updates the
    state's leaves IN PLACE (the counterpart of the reference's donated
    state): the caller's state is consumed, and must own contiguous leaves
    (``init_state``, a restored checkpoint and ``fit_stream``'s copy do).
    Nothing here reads the device back to the host."""
    dev = state.alpha.device
    table = None if table is None else table.to(dev)
    xc, yc = _tensor(xc, dev), _tensor(yc, dev)
    step_fn = _fused_step_ if cfg.step_engine == "pallas" else train_step
    for i in range(xc.shape[0]):
        state = step_fn(cfg, table, state, xc[i], yc[i], impl=impl)
    return state


class _Block(NamedTuple):
    """An assembled chunk: ``(steps, batch, dim)`` rows and ``(steps, batch)``
    labels, host arrays or staged tensors."""

    x: object
    y: object


def _device_stage(dev: torch.device, y_dtype, *, check=None):
    """Staging for the default chunk programs: a host block to ``dev`` as
    float32 rows and ``y_dtype`` labels (``check(yc)`` first, on the host).

    On the card the block goes through pinned memory with a non-blocking
    copy on the stream that is current where the staging is made (the chunk
    programs' stream), also when the prefetch worker runs it: the copy is in
    order with the chunk programs, and the staged tensors belong to the
    stream that reads them."""
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def stage(xc, yc):
        if check is not None:
            check(yc)
        x = torch.as_tensor(xc).to(torch.float32)
        y = torch.as_tensor(yc).to(y_dtype)
        if stream is None:
            return _Block(x.to(dev), y.to(dev))
        x, y = x.pin_memory(), y.pin_memory()
        with torch.cuda.stream(stream):
            return _Block(x.to(dev, non_blocking=True), y.to(dev, non_blocking=True))

    return stage


# steps in one replayed CUDA graph of a chunk program (``_ChunkGraphs``)
GRAPH_STEPS = 16


class _ChunkGraphs:
    """A chunk program replayed from CUDA graphs on the card.

    ``chunk_fn(state, xc, yc)`` never reads the device back, so its steps can
    be captured: one graph of ``GRAPH_STEPS`` steps and one of a single step,
    replayed in turn over a block's steps.  The host then takes part three
    calls a group of steps (the rows' copy, the labels' copy, the replay)
    instead of once a kernel, which keeps a trainer that shares its process
    with a busy server from waiting on the interpreter lock at every launch.
    The graphs read and write one static state: a state handed in that is
    not it is copied into it first (a rollback's snapshot, a resumed one).
    The very first step runs eagerly (it loads the kernel libraries and
    makes the library handles a capture cannot make).  The same kernels run
    on the same inputs, so every bit equals the eager chunk program.  A
    capture records its launches (``_build.recording``); each replay counts
    them.  On the CPU it is the chunk program itself."""

    def __init__(self, chunk_fn):
        self.chunk_fn = chunk_fn
        self.static = None
        self.graphs = {}             # steps -> (graph, x, y, launch tally)

    def __call__(self, state, xc, yc):
        if not xc.is_cuda:
            return self.chunk_fn(state, xc, yc)
        i = 0
        if self.static is None:
            state = self.chunk_fn(state, xc[:1], yc[:1])
            self.static, i = _owned(state), 1
        elif any(a is not b for a, b in zip(self.static, state)):
            for a, b in zip(self.static, state):
                if a is not None:
                    a.copy_(b)
        n = xc.shape[0]
        for size in (GRAPH_STEPS, 1):
            while n - i >= size:
                graph, x, y, tally = self._graph(size, xc, yc)
                x.copy_(xc[i:i + size])
                y.copy_(yc[i:i + size])
                graph.replay()
                kops_build.add_counts(tally)
                i += size
        return self.static

    def _graph(self, size: int, xc, yc):
        if size in self.graphs:
            return self.graphs[size]
        x = torch.zeros((size, *xc.shape[1:]), dtype=xc.dtype, device=xc.device)
        y = torch.zeros((size, *yc.shape[1:]), dtype=yc.dtype, device=yc.device)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(xc.device)
        side = torch.cuda.Stream(xc.device)
        side.wait_stream(current)
        # thread_local: a server on another thread goes on launching, copying
        # and waiting on its events while this thread captures
        with torch.cuda.stream(side), kops_build.recording() as tally:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self.chunk_fn(self.static, x, y)
                for a, b in zip(self.static, out):
                    if a is not None and b is not a:
                        a.copy_(b)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass                 # the capture's own error; the first one is raised
                raise
            graph.capture_end()
        current.wait_stream(side)
        self.graphs[size] = (graph, x, y, tally)
        return self.graphs[size]


def _assemble_chunks(source, key, *, batch_size: int, start_chunk: int, end: int, carry,
                     stage=None, retry=None, report=None, skip_chunks=()):
    """Host-side assembly of one epoch: yield ``(pos, block, carry)``.

    The single definition of the chunk -> minibatch-block transform shared by
    the synchronous and prefetched streaming paths (the prefetched path runs
    this very generator on a worker thread, so the two are bitwise the same
    by construction).  Per chunk: prepend the previous chunk's remainder
    rows, reshape the batch-aligned part to ``(steps, batch, dim)`` (``block``
    is None for a chunk that yields no full batch) and copy the new remainder
    out of the chunk buffer (O(chunk) residency).  ``stage`` maps the
    assembled host arrays to the block the chunk program takes (default: the
    host arrays as a ``_Block``).  ``retry``/``report``/``skip_chunks`` pass
    straight to ``iter_epoch``: a quarantined (or skipped) chunk contributes
    no rows, so the carry flows across it and the surviving batch sequence is
    bitwise the one of a run where the chunk never existed."""
    from ..data import stream as stream_mod

    cx, cy = carry if carry is not None else (None, None)
    for pos, x, y in stream_mod.iter_epoch(source, key, start_chunk=start_chunk, end_chunk=end,
                                           retry=retry, report=report,
                                           skip_chunks=skip_chunks):
        x, y = np.asarray(x), np.asarray(y)
        if cx is not None and cx.size:
            x = np.concatenate([cx.astype(x.dtype, copy=False), x])
            y = np.concatenate([cy.astype(y.dtype, copy=False), y])
        steps = x.shape[0] // batch_size
        used = steps * batch_size
        # copy the (< batch_size rows) remainder: a view would keep the whole
        # chunk buffer alive through the next chunk's load
        cx, cy = x[used:].copy(), y[used:].copy()
        block = None
        if steps:
            xc = x[:used].reshape(steps, batch_size, x.shape[1])
            yc = y[:used].reshape(steps, batch_size)
            block = stage(xc, yc) if stage is not None else _Block(xc, yc)
        yield pos, block, (cx, cy)


def _stage_chunks(gen, depth: int):
    """Run an assembly generator ``depth`` items ahead on a worker thread.

    The prefetched pipeline: the worker loads, shuffles, assembles and (via
    the generator's ``stage``) copies chunk ``i+1``..``i+depth`` to the card
    while the consumer runs chunk ``i``.  A bounded queue applies
    backpressure; a worker exception re-raises on the CONSUMER's thread at the
    point the failing chunk would have been yielded, and abandoning the
    generator (early close, consumer exception) stops and joins the worker."""
    q = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()
    done, fail = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def work():
        try:
            for item in gen:
                if not put((None, item)):
                    return
            put((done, None))
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            put((fail, e))

    t = threading.Thread(target=work, daemon=True, name="chunk-stager")
    t.start()
    try:
        while True:
            tag, item = q.get()
            if tag is done:
                return
            if tag is fail:
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


def _all_finite(state: SVMState) -> bool:
    """Every float leaf finite: one reduction a leaf and ONE scalar read (the
    streaming guard's one sync a chunk; integer counters are always finite)."""
    flags = [torch.isfinite(t).all() for t in state if t is not None and t.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


@dataclasses.dataclass
class _StreamGuard:
    """Per-chunk training guards of the streaming drivers (DESIGN.md §16).

    ``finite=True`` clones every leaf before each chunk program and, after
    it, reads one all-finite flag over the float leaves.  On trip the chunk is
    rolled back and skipped: a poisoned state is never kept, checkpointed or
    published.  ``check`` (debug) runs a host-side validator, the cache
    invariant checker, on every accepted state."""

    finite: bool = True
    report: object = None       # data.faults.ResilienceReport (rollback tally)
    check: object = None        # callable(state) -> None, raises on violation


def _make_guard(guard_finite: bool, debug_invariants: bool, binary_cfg, report):
    """The ``guard_finite``/``debug_invariants`` knobs as a ``_StreamGuard``, or
    None: exactly the unguarded chunk loop."""
    if not (guard_finite or debug_invariants):
        return None
    check = None
    if debug_invariants and binary_cfg.use_kernel_cache:
        def check(state):
            kernel_cache.check_invariants(state.kmat, state.sv_x, state.count, binary_cfg.gamma)
    return _StreamGuard(finite=guard_finite, report=report, check=check)


def _sync(state: SVMState) -> None:
    if state.alpha.is_cuda:
        torch.cuda.synchronize(state.alpha.device)


def _stream_epoch(chunk_fn, state, source, *, batch_size: int, key, start_chunk: int = 0,
                  carry=None, on_chunk=None, max_chunks: int | None = None, prefetch: int = 0,
                  stage=None, retry=None, report=None, skip_chunks=(), guard=None):
    """Generic one-epoch streaming driver shared by binary and multi-class.

    ``chunk_fn(state, xc, yc) -> state`` runs one chunk program.  Rows left
    over when a chunk is not a multiple of ``batch_size`` *carry* into the
    next chunk (so the realized batch sequence equals the in-memory one on
    the concatenated order); the final sub-batch rows of the epoch are
    dropped, as ``train_epoch`` drops them.  ``on_chunk(state, pos, carry)``
    fires after each chunk program: the checkpoint hook.

    ``stage`` maps each assembled host block to what ``chunk_fn`` takes (the
    default chunk programs' ``_device_stage``; None keeps host arrays).
    ``prefetch > 0`` moves the whole host pipeline (chunk load, shuffle,
    carry splice, reshape and staging) onto a background worker running up
    to ``prefetch`` chunks ahead; it runs the same ``_assemble_chunks``
    generator, so the realized batch sequence, and with it every bit of the
    state, is that of ``prefetch=0``.

    Resilience (all off by default: then the loop is exactly the plain one):
    ``retry``/``report``/``skip_chunks`` flow into ``iter_epoch``; ``guard``
    (a ``_StreamGuard``) clones the state before each chunk and rolls back a
    chunk whose state has a non-finite float leaf, BEFORE ``on_chunk``.

    Returns ``(state, next_chunk, carry, chunks_run)``; ``next_chunk <
    source.n_chunks`` means the epoch was cut short by ``max_chunks``."""
    # resolve the budget to an exclusive end position up front so chunks past
    # it are never read from the source
    end = (source.n_chunks if max_chunks is None
           else min(source.n_chunks, start_chunk + max_chunks))
    gen = _assemble_chunks(source, key, batch_size=batch_size, start_chunk=start_chunk, end=end,
                           carry=carry, stage=stage, retry=retry, report=report,
                           skip_chunks=skip_chunks)
    items = _stage_chunks(gen, prefetch) if prefetch else gen
    out_carry = carry
    try:
        for pos, block, out_carry in items:
            if block is not None:
                xc, yc = block
                if guard is not None and guard.finite:
                    # the chunk program may update the state in place, so the
                    # last good state is cloned BEFORE its first launch
                    snap = _owned(state)
                    new_state = chunk_fn(state, xc, yc)
                    if _all_finite(new_state):
                        state = new_state
                    else:
                        state = snap       # roll back and skip the poisoned chunk
                        if guard.report is not None:
                            guard.report.note_rollback(pos)
                else:
                    state = chunk_fn(state, xc, yc)
                if guard is not None and guard.check is not None:
                    guard.check(state)
            if on_chunk is not None:
                on_chunk(state, pos, out_carry)
    finally:
        items.close()                     # stop (and join) the stager on any exit
    if out_carry is None:
        out_carry = (np.zeros((0, source.dim), np.float32), np.zeros((0,), np.float32))
    return state, end, out_carry, end - start_chunk


def _ckpt_template(state: SVMState, batch_size: int, dim: int):
    """Target tree of the streaming checkpoint (the reference's): the model
    state, the epoch key (uint32[2], the reference key's shape and dtype; the
    port stores ``(seed, epoch)``) and the padded inter-chunk carry rows."""
    return {
        "state": state,
        "epoch_key": ckpt_mod.ShapeDtype((2,), torch.uint32),
        "carry_x": ckpt_mod.ShapeDtype((batch_size - 1, dim), torch.float32),
        "carry_y": ckpt_mod.ShapeDtype((batch_size - 1,), torch.float32),
        "carry_n": ckpt_mod.ShapeDtype((), torch.int32),
    }


def _pad_carry(carry, batch_size: int, dim: int):
    cx, cy = carry
    n = cx.shape[0]
    px = np.zeros((batch_size - 1, dim), np.float32)
    py = np.zeros((batch_size - 1,), np.float32)
    px[:n], py[:n] = cx, cy
    return px, py, np.int32(n)


def _resume(ckpt_dir: str, state: SVMState, *, batch_size: int, dim: int, n_chunks: int,
            seed: int):
    """``(state, epoch, next_chunk, carry)`` from the newest verifiable streaming
    checkpoint in ``ckpt_dir``, or None when it holds no step.  Refuses a
    mismatched seed or chunking, and a mid-epoch cursor whose order the port
    cannot replay (written without ``"shuffle": "numpy"``: the JAX package
    draws its orders from ``jax.random``)."""
    if ckpt_mod.latest_step(ckpt_dir) is None:
        return None
    # a torn or bit-flipped newest step (a crash outside the atomic rename,
    # disk corruption) must not kill the restart: walk back to the newest
    # step whose checksums verify
    step = ckpt_mod.latest_verifiable_step(ckpt_dir)
    if step is None:
        raise ValueError(f"{ckpt_dir}: checkpoint steps {ckpt_mod.all_steps(ckpt_dir)} exist "
                         "but none verify (manifest/arrays corrupt) — refusing to silently "
                         "restart from scratch")
    meta = ckpt_mod.load_metadata(ckpt_dir, step)
    if meta.get("kind") != "stream-epoch":
        raise ValueError(f"{ckpt_dir}: step {step} is not a streaming checkpoint")
    # the cursor is only meaningful against the same shuffle and the same
    # chunking: a silent mismatch would train some rows twice and others never
    if meta["seed"] != seed:
        raise ValueError(f"{ckpt_dir}: checkpoint was written with seed={meta['seed']}, "
                         f"resume called with seed={seed}")
    if meta["n_chunks"] != n_chunks:
        raise ValueError(f"{ckpt_dir}: checkpoint cursor is against {meta['n_chunks']} chunks, "
                         f"source now has {n_chunks} — re-chunked data cannot resume mid-epoch")
    epoch, next_chunk = meta["epoch"], meta["next_chunk"]
    if next_chunk < n_chunks and meta.get("shuffle") != "numpy":
        raise ValueError(
            f"{ckpt_dir}: step {step} is a mid-epoch cursor (chunk {next_chunk} of {n_chunks}) "
            "written without the port's shuffle (no \"shuffle\": \"numpy\" in its metadata: "
            "the JAX package wrote it, its epoch order drawn from jax.random, which the port "
            "cannot replay); resume from an epoch-boundary checkpoint")
    tree = ckpt_mod.load(ckpt_dir, step, _ckpt_template(state, batch_size, dim), device="cpu")
    state = _to(tree["state"], state.alpha.device)
    cn = int(tree["carry_n"])
    carry = (tree["carry_x"][:cn].numpy(), tree["carry_y"][:cn].numpy())
    return state, epoch, next_chunk, carry


def _fit_stream(batch_size: int, source, chunk_fn, state, *, epochs: int, seed: int, ckpt_dir,
                ckpt_every: int, max_chunks, keep_last: int, prefetch: int = 0, stage=None,
                publish=None, publish_every: int = 0, retry=None, report=None, skip_chunks=(),
                guard=None):
    """Shared multi-epoch streaming driver (see ``fit_stream`` for the
    contract).  Epoch ``e`` streams in ``EpochKey(seed, e)`` order.
    ``publish(state)`` fires every ``publish_every`` chunks (and once at the
    very end): the ``ModelBank`` snapshot hook.  Resume walks back past torn
    checkpoint steps to the newest verifiable one."""
    from ..data.stream import EpochKey

    dim = source.dim
    n_chunks = source.n_chunks
    start_epoch, start_chunk, carry = 0, 0, None
    if ckpt_dir:
        resumed = _resume(ckpt_dir, state, batch_size=batch_size, dim=dim, n_chunks=n_chunks,
                          seed=seed)
        if resumed is not None:
            state, start_epoch, start_chunk, carry = resumed
            if start_chunk >= n_chunks:       # checkpoint at an epoch boundary
                start_epoch, start_chunk, carry = start_epoch + 1, 0, None

    budget_left = max_chunks
    for epoch in range(start_epoch, epochs):
        epoch_key = EpochKey(seed, epoch)

        def save(st, pos, cr, *, _epoch=epoch):
            done = pos + 1
            if publish is not None and publish_every and done % publish_every == 0:
                publish(st)
            if not (ckpt_dir and ckpt_every and done % ckpt_every == 0):
                return
            px, py, cn = _pad_carry(cr, batch_size, dim)
            ckpt_mod.save(ckpt_dir, _epoch * n_chunks + done,
                          {"state": st, "epoch_key": np.array([seed, _epoch], np.uint32),
                           "carry_x": px, "carry_y": py, "carry_n": cn},
                          keep_last=keep_last,
                          metadata={"kind": "stream-epoch", "epoch": _epoch,
                                    "next_chunk": done, "n_chunks": n_chunks, "seed": seed,
                                    "shuffle": "numpy"})

        state, next_chunk, carry, ran = _stream_epoch(
            chunk_fn, state, source, batch_size=batch_size, key=epoch_key,
            start_chunk=start_chunk, carry=carry, on_chunk=save, max_chunks=budget_left,
            prefetch=prefetch, stage=stage, retry=retry, report=report,
            skip_chunks=skip_chunks, guard=guard)
        if budget_left is not None:
            budget_left -= ran
        if next_chunk < n_chunks:             # cut short by max_chunks
            if publish is not None:
                publish(state)
            return state
        _sync(state)                          # sync only at the epoch's end
        start_chunk, carry = 0, None          # sub-batch remainder dropped
    if publish is not None:
        publish(state)                        # the final model always lands
    return state


def _make_publish(bank, gamma, bank_dtype):
    """The ``ModelBank`` snapshot hook of a streaming trainer, or None.

    ``export_model`` copies every leaf (the chunk programs may update the
    state in place), on the trainer's stream, before ``bank.publish`` swaps
    the slot.  A server launches on the device's default stream.  A trainer
    on that stream needs nothing more: the server's launches follow the
    copy.  A trainer on a stream of its own enqueues ahead of its device
    work, so it waits for the snapshot before publishing it (else the
    server would read a version still chunks away), and the snapshot's
    tensors are recorded on the default stream, so the caching allocator
    keeps their memory while the server still reads them."""
    if bank is None:
        return None
    from .predict import export_model   # lazy: predict imports this module

    def publish(state):
        model = export_model(state, gamma, bank_dtype=bank_dtype)
        if model.sv_x.is_cuda:
            current = torch.cuda.current_stream(model.sv_x.device)
            default = torch.cuda.default_stream(model.sv_x.device)
            if current != default:
                current.synchronize()
                for t in (model.sv_x, model.alpha, model.count):
                    t.record_stream(default)
        bank.publish(model)

    return publish


def train_epoch_stream(cfg: BSGDConfig, table, state: SVMState, source, *, key=None,
                       impl: str = "auto", start_chunk: int = 0, carry=None, on_chunk=None,
                       max_chunks: int | None = None, chunk_fn=None, prefetch: int = 0,
                       retry=None, report=None, skip_chunks=()):
    """One streamed pass over a ``data.stream`` chunk source, on the state's device.

    The chunked counterpart of ``train_epoch``: chunks are loaded on the host
    in the shuffled order of ``key`` (a ``data.EpochKey``, any object with its
    ``chunk_order``/``intra_perm`` methods, or None for natural order) and
    each runs as one ``train_chunk``; only the budgeted state stays on the
    device between chunks.  Remainder rows of a ragged chunk carry into the
    next chunk, so the realized minibatch sequence equals ``train_epoch`` on
    ``epoch_permutation(source, key)``.

    ``start_chunk``/``carry`` resume mid-epoch; ``on_chunk(state, pos,
    carry)`` fires after each chunk; ``max_chunks`` bounds how many chunk
    programs run.  ``chunk_fn(state, xc, yc)`` overrides the chunk program
    (it then takes host arrays).  ``prefetch > 0`` assembles and copies up to
    that many chunks ahead on a background thread, bitwise the same training.

    Returns ``(state, next_chunk, carry)``; ``next_chunk == source.n_chunks``
    means the epoch completed.  With ``step_engine="pallas"`` the chunk
    programs update ``state`` in place: keep using the returned state (or use
    ``fit_stream``, which copies a provided state up front)."""
    stage = None
    if chunk_fn is None:
        stage = _device_stage(state.alpha.device, torch.float32)
        table = None if table is None else table.to(state.alpha.device)

        def chunk_fn(st, xc, yc):
            return train_chunk(cfg, table, st, xc, yc, impl=impl)
    state, next_chunk, carry, _ = _stream_epoch(
        chunk_fn, state, source, batch_size=cfg.batch_size, key=key, start_chunk=start_chunk,
        carry=carry, on_chunk=on_chunk, max_chunks=max_chunks, prefetch=prefetch, stage=stage,
        retry=retry, report=report, skip_chunks=skip_chunks)
    if next_chunk == source.n_chunks:
        _sync(state)
    return state, next_chunk, carry


def fit_stream(cfg: BSGDConfig, source, *, epochs: int = 1, seed: int = 0, impl: str = "auto",
               state: SVMState | None = None, ckpt_dir: str | None = None, ckpt_every: int = 0,
               max_chunks: int | None = None, keep_last: int = 3, chunk_fn=None,
               prefetch: int = 0, bank=None, publish_every: int = 0, publish_dtype=None,
               retry=None, guard_finite: bool = False, debug_invariants: bool = False,
               report=None, skip_chunks=(), cuda_graph: bool = False,
               device=None) -> SVMState:
    """Out-of-core ``fit``: shuffled streamed epochs over a chunk source.

    Args:
      source: a ``data.stream.ChunkSource`` (``ArrayChunks``, ``FileChunks``,
        ``LibsvmChunks``, ...); only one chunk (``prefetch + 1`` with
        prefetch) is host-resident at a time and only the budgeted state
        lives on the device across chunks.
      epochs / seed: epoch ``e`` streams in ``data.EpochKey(seed, e)`` order
        (chunk order, then rows within each chunk, from numpy).  The
        reference draws its orders from ``jax.random``; the two packages
        stream alike only when an order is passed in (``train_epoch_stream``).
      ckpt_dir / ckpt_every: write a resumable checkpoint every
        ``ckpt_every`` chunks (0 = off) in the reference's format: the
        model, the epoch key, the inter-chunk carry rows, the ``(epoch,
        next_chunk)`` cursor, and ``"shuffle": "numpy"``.  Calling
        ``fit_stream`` again with the same ``ckpt_dir`` resumes from the
        newest verifiable step and reproduces the uninterrupted run bit for
        bit.  A mid-epoch checkpoint the JAX package wrote is refused (its
        order came from ``jax.random``); an epoch-boundary one resumes.
      max_chunks: stop after this many chunk programs without a final
        checkpoint: a hard kill, for tests and fault drills.
      chunk_fn: override the chunk program (it takes host arrays).
      prefetch: load, assemble and copy up to this many chunks ahead on a
        background thread (on the card: pinned memory, a non-blocking copy
        on the chunk programs' stream); bitwise the run of ``prefetch=0``.
      bank / publish_every / publish_dtype: publish an immutable, versioned
        ``ServeModel`` snapshot into ``bank`` (a ``core.predict.ModelBank``)
        every ``publish_every`` chunks and once at the end; ``publish_dtype``
        is the published bank's dtype (e.g. ``"bfloat16"``).
      retry / report / skip_chunks: ingest resilience (``data.faults``): a
        ``RetryPolicy`` retries transient load failures with bounded backoff
        and quarantines (skips, and records in ``report``, a
        ``ResilienceReport``) chunks that exhaust it; ``skip_chunks`` leaves
        chunk ids out as if they never existed.
      guard_finite: clone the state before each chunk and read one
        all-finite flag over its float leaves after it; a chunk leaving any
        non-finite value is rolled back and skipped (recorded in ``report``).
        One state copy and one scalar sync a chunk; off, the chunk loop is
        exactly the unguarded one.
      debug_invariants: also verify the kernel-cache invariants I1-I3 on
        every accepted state (host-side; a no-op without the cache).
      cuda_graph: on the card, replay the default chunk program's steps
        from CUDA graphs (``_ChunkGraphs``): the host takes part a few calls
        a group of ``GRAPH_STEPS`` steps instead of once a kernel; bitwise
        the eager run.  No effect on the CPU.
      device: where to train (default the card; ``"cpu"`` for the host).

    Returns the final ``SVMState``.  A caller-provided ``state`` is copied
    once up front, so the caller's tensors stay as they were."""
    dev = resolve_device(device)
    state = (init_state(cfg, source.dim, device=dev) if state is None
             else _owned(_to(state, dev)))
    stage = None
    if chunk_fn is None:
        stage = _device_stage(dev, torch.float32)
        table = cfg.table()
        table = None if table is None else table.to(dev)

        def chunk_fn(st, xc, yc):
            return train_chunk(cfg, table, st, xc, yc, impl=impl)
        if cuda_graph:
            chunk_fn = _ChunkGraphs(chunk_fn)
    return _fit_stream(cfg.batch_size, source, chunk_fn, state, epochs=epochs, seed=seed,
                       ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, max_chunks=max_chunks,
                       keep_last=keep_last, prefetch=prefetch, stage=stage,
                       publish=_make_publish(bank, cfg.gamma, publish_dtype),
                       publish_every=publish_every, retry=retry, report=report,
                       skip_chunks=skip_chunks,
                       guard=_make_guard(guard_finite, debug_invariants, cfg, report))
