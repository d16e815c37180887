"""One-vs-rest multi-class BSGD: the class axis as a leading state dimension.

PyTorch counterpart of the in-memory part of ``repro.core.multiclass``.  C
independent binary problems share one ``SVMState`` whose every tensor carries
a leading ``(C,)`` axis, and train in lockstep:

  * the margin rows of all classes come from ONE ``rbf_matrix`` call against
    the flattened ``(C * slots, dim)`` SV bank (``class_kernel_rows``);
  * the solver's update (Pegasos, or BDCA's dual ascent: one
    ``bdca_ascent`` launch for all classes) and budget maintenance are
    batched over the class axis (the reference's ``jax.vmap``), with one
    lookup table shared by every class;
  * with ``maintenance_engine="pallas"`` maintenance is the fused event
    engine, one ``merge_event`` launch per round for all classes
    (``budget.run_maintenance_classes``);
  * with ``step_engine="pallas"`` the whole step (margin rows, insert, event
    rounds) is one ``train_step`` launch for all classes.

Prediction is the argmax over the C decision functions, scored by the serve
cell (``kernels.ops.class_scores``: on the card one launch computes the
kernel block, the contraction and the label), the route ``core.predict``
serves through.  ``fit_multiclass_loop`` trains
the classes one after the other: the baseline the batched engine is measured
against.  ``train_chunk_multiclass``, ``train_epoch_multiclass_stream`` and
``fit_multiclass_stream`` stream the class axis over a chunk source through
``core.bsgd``'s streaming drivers.
"""
from __future__ import annotations

import dataclasses

import torch

from . import bdca
from . import budget as budget_mod
from .bsgd import (BSGDConfig, SVMState, _ChunkGraphs, _device_stage, _fit_stream, _make_guard, _make_publish,
                   _owned, _stream_epoch, _sync, _tensor, _to, fit, init_state, insert_from_rows,
                   resolve_device)
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class MulticlassSVMConfig:
    """C one-vs-rest copies of a binary ``BSGDConfig`` (labels are integer
    ids in [0, n_classes)); one lookup table serves every class."""

    n_classes: int
    binary: BSGDConfig

    def __post_init__(self):
        if self.n_classes < 2:
            raise ValueError(f"n_classes={self.n_classes} < 2")

    @property
    def slots(self) -> int:
        return self.binary.slots

    def table(self):
        return self.binary.table()

    @staticmethod
    def create(n_classes: int, **kw) -> "MulticlassSVMConfig":
        """Build from binary hyperparameters: ``create(5, budget=100, ...)``."""
        return MulticlassSVMConfig(n_classes=n_classes, binary=BSGDConfig(**kw))


def ovr_targets(y, n_classes: int, dtype=torch.float32):
    """Integer class labels (n,) -> one-vs-rest targets (C, n) in {-1, +1}."""
    y = torch.as_tensor(y).to(torch.int64)
    onehot = torch.arange(n_classes, device=y.device)[:, None] == y[None, :]
    return torch.where(onehot, 1.0, -1.0).to(dtype)


def check_labels(y, n_classes: int) -> None:
    """Raise unless every label is an integer in [0, n_classes) (reads ``y`` once)."""
    y = torch.as_tensor(y)
    y_min, y_max = int(y.min()), int(y.max())
    if y_min < 0 or y_max >= n_classes:
        raise ValueError(f"class labels must be integers in [0, {n_classes}); got range "
                         f"[{y_min}, {y_max}] — remap 1-based labels (e.g. y - 1) first")


def init_multiclass_state(cfg: MulticlassSVMConfig, dim: int, *, device=None) -> SVMState:
    """Stacked ``SVMState``: every leaf gains a leading ``(C,)`` axis (its own
    memory per class: the event kernel updates the stack in place)."""
    st = init_state(cfg.binary, dim, device=device)
    c = cfg.n_classes
    return SVMState(*(None if t is None else t.expand(c, *t.shape).clone() for t in st))


def class_kernel_rows(sv_x, x, gamma, *, impl: str = "auto"):
    """``k(x, sv_c)`` for every class from ONE kernel call: sv_x (C, slots, dim),
    x (n, dim) -> (C, n, slots)."""
    c, slots, dim = sv_x.shape
    k = kops.rbf_matrix(x, sv_x.reshape(c * slots, dim), gamma, impl=impl)
    return k.view(x.shape[0], c, slots).transpose(0, 1).contiguous()


def decision_function_multiclass(state: SVMState, x, gamma, *, impl: str = "auto",
                                 device=None):
    """Per-class scores f_c(x); x (n, d) -> (C, n), from the serve cell."""
    dev = resolve_device(device)
    state = _to(state, dev)
    active = torch.arange(state.alpha.shape[-1], device=dev)[None, :] < state.count[:, None]
    alpha = torch.where(active, state.alpha, 0.0)
    return kops.class_scores(_tensor(x, dev), state.sv_x, alpha, gamma, impl=impl)


def predict_multiclass(state: SVMState, x, gamma, **kw):
    """argmax over the C one-vs-rest decision functions; (n,) int32."""
    return torch.argmax(decision_function_multiclass(state, x, gamma, **kw), dim=0).to(torch.int32)


def accuracy_multiclass(state: SVMState, x, y, gamma, *, impl: str = "auto", device=None):
    """Share of rows whose predicted class is ``y`` (a 0-d tensor)."""
    dev = resolve_device(device)
    pred = predict_multiclass(state, x, gamma, impl=impl, device=dev)
    return (pred == _tensor(y, dev, torch.int32)).to(torch.float32).mean()


def _fused_step_multiclass_(cfg: MulticlassSVMConfig, table, state: SVMState, xb, yb, *,
                            impl: str = "auto") -> SVMState:
    """``step_engine="pallas"``: every class's whole step as one
    ``train_step`` launch, updating the state's leaves IN PLACE (the state
    must own contiguous leaves)."""
    b = cfg.binary
    k_bb = kops.rbf_matrix(xb, xb, b.gamma, impl=impl)
    y_ovr = ovr_targets(yb, cfg.n_classes, dtype=getattr(torch, b.dtype))
    out = kops.train_step(
        state.sv_x, state.alpha, state.kmat, state.count, state.step, state.n_inserts,
        state.n_merges, xb, y_ovr, k_bb, table, budget=b.budget, lambda_=b.lambda_,
        gamma=b.gamma, batch_size=b.batch_size, maintenance=b.maintenance,
        merge_batch=b.merge_batch, impl=impl)
    return state._replace(step=out[4])


def train_step_multiclass(cfg: MulticlassSVMConfig, table, state: SVMState, xb, yb, *,
                          impl: str = "auto") -> SVMState:
    """One lockstep step for all C one-vs-rest problems; the caller's state is
    left as it was.

    xb: (batch, dim); yb: (batch,) integer class ids in [0, C), on the
    state's device.  With ``step_engine="pallas"`` the whole step is one
    ``train_step`` launch.  Otherwise one kernel call gives every class's
    margin rows; the solver's insert half runs batched over the class axis
    (the Pegasos shrink and insert, or with ``solver="bdca"`` the dual
    insert and one ``bdca_ascent`` launch for every class), then
    maintenance drains every class: the fused event engine with
    ``maintenance_engine="pallas"``, else the configured strategy batched
    over the classes."""
    b = cfg.binary
    if b.step_engine == "pallas":
        return _fused_step_multiclass_(cfg, table, _owned(state), xb, yb, impl=impl)
    k_b = class_kernel_rows(state.sv_x, xb, b.gamma, impl=impl)       # (C, batch, slots)
    k_bb = kops.rbf_matrix(xb, xb, b.gamma, impl=impl) if b.use_kernel_cache else None
    y_ovr = ovr_targets(yb, cfg.n_classes, dtype=getattr(torch, b.dtype))
    if b.solver == "bdca":
        mid = bdca.insert_from_rows(b, state, xb, y_ovr, k_b, k_bb, impl=impl)
    else:
        mid = insert_from_rows(b, state, xb, y_ovr, k_b, k_bb)
    if b.maintenance_engine == "pallas":
        # mid's sv_x, alpha and kmat are this step's own fresh tensors: the
        # in-place event rounds take them over, with no copy
        out = budget_mod.event_rounds_(
            mid.sv_x, mid.alpha, mid.kmat, mid.count, mid.n_merges, table, budget=b.budget,
            impl=impl, unroll=b.batch_size)
    else:
        out = budget_mod.run_maintenance_stacked(
            mid.sv_x, mid.alpha, mid.kmat, mid.count, mid.n_merges, b.gamma, table,
            budget=b.budget, strategy=b.maintenance, method=b.method, merge_batch=b.merge_batch,
            impl=impl, unroll=b.batch_size)
    sv_x, alpha, kmat, count, n_merges = out
    return mid._replace(sv_x=sv_x, alpha=alpha, kmat=kmat, count=count, n_merges=n_merges)


def train_epoch_multiclass(cfg: MulticlassSVMConfig, table, state: SVMState, x, y, perm, *,
                           impl: str = "auto", device=None) -> SVMState:
    """One pass over resident (x, integer y) in ``perm`` order (rows past the
    last full ``batch_size`` multiple are dropped); inputs move to the device."""
    dev = resolve_device(device)
    state = _to(state, dev)
    table = None if table is None else table.to(dev)
    bs = cfg.binary.batch_size
    order = _tensor(perm, dev, torch.int64)
    steps = order.shape[0] // bs
    order = order[: steps * bs]
    xs = _tensor(x, dev).index_select(0, order)
    ys = _tensor(y, dev, torch.int64).index_select(0, order)
    step_fn = train_step_multiclass
    if cfg.binary.step_engine == "pallas":   # one copy of the state, updated in place
        state, step_fn = _owned(state), _fused_step_multiclass_
    for i in range(steps):
        state = step_fn(cfg, table, state, xs[i * bs:(i + 1) * bs], ys[i * bs:(i + 1) * bs],
                        impl=impl)
    return state


def fit_multiclass(cfg: MulticlassSVMConfig, x, y, *, epochs: int = 1, seed: int = 0,
                   impl: str = "auto", state: SVMState | None = None,
                   device=None) -> SVMState:
    """Train C one-vs-rest problems in lockstep on in-memory data.

    Shuffled epochs as in ``bsgd.fit`` (one ``torch.Generator`` seeded with
    ``seed``); labels are validated up front; ``state`` resumes a stacked
    model."""
    check_labels(y, cfg.n_classes)
    dev = resolve_device(device)
    table = cfg.table()
    table = None if table is None else table.to(dev)
    x, y = _tensor(x, dev), _tensor(y, dev, torch.int64)
    if state is None:
        state = init_multiclass_state(cfg, x.shape[1], device=dev)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(epochs):
        perm = torch.randperm(x.shape[0], generator=gen)
        state = train_epoch_multiclass(cfg, table, state, x, y, perm, impl=impl, device=dev)
    return state


def train_chunk_multiclass(cfg: MulticlassSVMConfig, table, state: SVMState, xc, yc, *,
                           impl: str = "auto") -> SVMState:
    """One resident chunk of the one-vs-rest engine: ``xc: (steps, batch,
    dim)``, ``yc: (steps, batch)`` class ids, through ``train_epoch_multiclass``'s
    steps (cf. ``bsgd.train_chunk``: with ``step_engine="pallas"`` the state
    is updated in place, and nothing reads the device back)."""
    dev = state.alpha.device
    table = None if table is None else table.to(dev)
    xc, yc = _tensor(xc, dev), _tensor(yc, dev, torch.int64)
    step_fn = (_fused_step_multiclass_ if cfg.binary.step_engine == "pallas"
               else train_step_multiclass)
    for i in range(xc.shape[0]):
        state = step_fn(cfg, table, state, xc[i], yc[i], impl=impl)
    return state


def train_epoch_multiclass_stream(cfg: MulticlassSVMConfig, table, state: SVMState, source, *,
                                  key=None, impl: str = "auto", start_chunk: int = 0,
                                  carry=None, on_chunk=None, max_chunks: int | None = None,
                                  chunk_fn=None, prefetch: int = 0, retry=None, report=None,
                                  skip_chunks=()):
    """One streamed pass of the one-vs-rest engine over a chunk source.

    The class-axis counterpart of ``bsgd.train_epoch_stream``, with the same
    chunk-carry contract (``key`` order, the state updated in place by the
    fused step, remainder carry, ``prefetch`` staging, ``(state, next_chunk,
    carry)`` return); labels are integer class ids in [0, C)."""
    stage = None
    if chunk_fn is None:
        stage = _device_stage(state.alpha.device, torch.int64)
        table = None if table is None else table.to(state.alpha.device)

        def chunk_fn(st, xc, yc):
            return train_chunk_multiclass(cfg, table, st, xc, yc, impl=impl)
    state, next_chunk, carry, _ = _stream_epoch(
        chunk_fn, state, source, batch_size=cfg.binary.batch_size, key=key,
        start_chunk=start_chunk, carry=carry, on_chunk=on_chunk, max_chunks=max_chunks,
        prefetch=prefetch, stage=stage, retry=retry, report=report, skip_chunks=skip_chunks)
    if next_chunk == source.n_chunks:
        _sync(state)
    return state, next_chunk, carry


def fit_multiclass_stream(cfg: MulticlassSVMConfig, source, *, epochs: int = 1, seed: int = 0,
                          impl: str = "auto", state: SVMState | None = None,
                          ckpt_dir: str | None = None, ckpt_every: int = 0,
                          max_chunks: int | None = None, keep_last: int = 3, chunk_fn=None,
                          prefetch: int = 0, bank=None, publish_every: int = 0,
                          publish_dtype=None, retry=None, guard_finite: bool = False,
                          debug_invariants: bool = False, report=None, skip_chunks=(),
                          cuda_graph: bool = False, device=None) -> SVMState:
    """Out-of-core ``fit_multiclass``: streamed shuffled epochs over a chunk
    source of integer-labelled rows, with ``bsgd.fit_stream``'s contract
    (``EpochKey`` order, checkpoints and bitwise resume, the copied caller
    state, ``prefetch`` staging, ``bank``/``publish_every`` snapshots, the
    resilience knobs and ``cuda_graph``).  Each chunk's labels are checked on the host, before
    staging, so the check reads nothing from the device."""
    dev = resolve_device(device)
    state = (init_multiclass_state(cfg, source.dim, device=dev) if state is None
             else _owned(_to(state, dev)))
    stage = None
    if chunk_fn is None:
        stage = _device_stage(dev, torch.int64, check=lambda yc: check_labels(yc, cfg.n_classes))
        table = cfg.table()
        table = None if table is None else table.to(dev)

        def chunk_fn(st, xc, yc):
            return train_chunk_multiclass(cfg, table, st, xc, yc, impl=impl)
        if cuda_graph:
            chunk_fn = _ChunkGraphs(chunk_fn)
    return _fit_stream(cfg.binary.batch_size, source, chunk_fn, state, epochs=epochs, seed=seed,
                       ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, max_chunks=max_chunks,
                       keep_last=keep_last, prefetch=prefetch, stage=stage,
                       publish=_make_publish(bank, cfg.binary.gamma, publish_dtype),
                       publish_every=publish_every, retry=retry, report=report,
                       skip_chunks=skip_chunks,
                       guard=_make_guard(guard_finite, debug_invariants, cfg.binary, report))


def fit_multiclass_loop(cfg: MulticlassSVMConfig, x, y, *, epochs: int = 1, seed: int = 0,
                        impl: str = "auto", device=None) -> SVMState:
    """Loop-over-classes baseline: C binary fits on the one-vs-rest labels, one
    after the other, then stacked.  The same seed gives the same permutations
    as ``fit_multiclass``, so both train the same model."""
    check_labels(y, cfg.n_classes)
    dev = resolve_device(device)
    y_ovr = ovr_targets(_tensor(y, dev, torch.int64), cfg.n_classes,
                        dtype=getattr(torch, cfg.binary.dtype))
    states = [fit(cfg.binary, x, y_ovr[c], epochs=epochs, seed=seed, impl=impl, device=dev)
              for c in range(cfg.n_classes)]
    return SVMState(*(None if leaves[0] is None else torch.stack(leaves)
                      for leaves in zip(*states)))
