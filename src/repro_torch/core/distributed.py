"""Distributed minibatch BSGD on ``torch.distributed``: the reference's layouts as SPMD steps.

PyTorch counterpart of ``repro.core.distributed``.  The reference lays its
arrays out on a device mesh and lets GSPMD insert the collectives; here every
rank runs the same program on its own shard, and the collectives are explicit
``torch.distributed`` calls on a process group the caller passes in
(``launch.dist.init`` starts one).  What each layout computes, and which rank
holds what (W ranks, rank r):

  * ``replicated``: every rank holds the whole SV state and takes
    ``batch / W`` rows of the minibatch.  It computes its rows' margin rows
    against the whole bank (``ops.rbf_matrix``); one all-gather brings every
    rank all margin rows and minibatch rows in rank order, and every rank
    runs the same insert and maintenance on the same inputs, so the ranks
    stay identical.
  * ``slots``: the SV arrays and the kernel cache's rows are split along the
    slot axis, rank r holding slots ``[r S/W, (r+1) S/W)``; the counters are
    on every rank.  Each rank computes k(xb, its slots) and its part of the
    decision values, and a sum all-reduce gives them.  Maintenance is the
    reference's first, naive plan: gather the SV state, decide on it
    replicated, keep each rank's slice (one all-gather a step, which also
    brings the margin rows the cache insert needs); the insert takes the
    summed decision values.  ``slots % W != 0`` falls back to
    ``replicated``, as the reference's layout does.
  * ``class``: whole classes a rank (rank r the classes ``[r C/W, (r+1)
    C/W)``); the minibatch is all-gathered once and each rank runs the class
    axis's step (``multiclass.train_step_ovr``) on its classes with no
    further collective, under every engine.  ``n_classes % W != 0`` keeps
    every class on every rank (the reference's fallback).
  * ``serve`` (``make_distributed_predict``): the exported bank on every
    rank, the request rows split over the ranks, each rank one serve cell,
    labels and scores gathered in rank order.

Each layout's step on W ranks equals the single-process step on the global
minibatch: integer state exact (off a float near-tie), floats to round-off
(``slots`` sums its margins in another order).  The batch axis splits
evenly: a batch that W does not divide raises ``ValueError``, as the
reference's pjit does.  The collectives take the tensors where they are:
NCCL works on the card, and gloo takes CUDA tensors too (it copies them
through pinned host memory inside the collective), so this module stages
nothing (``launch.dist.pick_backend`` says which backend a run gets).
``lower_svm_cell`` traces one rank's step of a layout on a fake process
group for the dry run (``launch.dryrun``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from . import bdca, bsgd
from .bsgd import BSGDConfig, SVMState, drain_budget, train_step, train_step_from_rows
from .multiclass import MulticlassSVMConfig, ovr_targets, train_step_ovr
from .predict import ServeModel, serve_cell
from ..kernels import ops as kops

LAYOUTS = ("replicated", "slots", "class")


def _world(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim 0 in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``."""
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def resolve_layout(cfg, layout: str, world: int) -> str:
    """The layout a run gets: ``layout``, or ``replicated`` where its axis does
    not divide over ``world`` ranks (``slots % W``; ``n_classes % W`` keeps
    every class on every rank).  Raises ``TypeError`` for a config the
    layout does not take."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r} not in {LAYOUTS}")
    if layout == "class":
        if not isinstance(cfg, MulticlassSVMConfig):
            raise TypeError(f"layout='class' needs a MulticlassSVMConfig, got "
                            f"{type(cfg).__name__}")
        return "class" if cfg.n_classes % world == 0 else "replicated"
    if not isinstance(cfg, BSGDConfig):
        raise TypeError(f"layout={layout!r} trains one binary problem: it needs a BSGDConfig, "
                        f"got {type(cfg).__name__} (layout='class' trains the class axis)")
    if layout == "slots" and cfg.slots % world == 0:
        return "slots"
    return "replicated"


def owned_range(n: int, rank: int, world: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous part ``[lo, hi)`` of an axis of ``n`` (W divides n)."""
    return rank * n // world, (rank + 1) * n // world


def shard_rows(x, group, dim: int = 0):
    """This rank's contiguous ``n / W`` rows of ``x`` along its batch axis
    ``dim`` (a view): dim 0 of a minibatch or a request batch, dim 1 of a
    chunk ``(steps, batch, ...)``.  Raises ``ValueError`` unless W divides n."""
    rank, world = _world(group)
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split evenly over {world} ranks")
    lo, hi = owned_range(n, rank, world)
    return x.narrow(dim, lo, hi - lo)


def _leaves(state: SVMState, axis: str) -> tuple[str, ...]:
    """The leaves a layout splits: along the slot axis the SV arrays and the
    cache rows, along the class axis every leaf."""
    names = ("sv_x", "alpha", "kmat") if axis == "slots" else SVMState._fields
    return tuple(n for n in names if getattr(state, n) is not None)


def shard_state(cfg, state: SVMState, group, layout: str) -> SVMState:
    """This rank's part of a whole state under ``layout`` (views; no collective)."""
    eff = resolve_layout(cfg, layout, dist.get_world_size(group))
    if eff == "replicated":
        return state
    return state._replace(**{n: shard_rows(getattr(state, n), group) for n in _leaves(state, eff)})


def gather_state(cfg, state: SVMState, group, layout: str) -> SVMState:
    """The whole state on every rank from each rank's part under ``layout``:
    one all-gather of the float leaves (and under ``class`` one of the
    counters); the state itself under ``replicated``."""
    eff = resolve_layout(cfg, layout, dist.get_world_size(group))
    if eff == "replicated":
        return state
    if eff == "slots":
        return state._replace(**_gather_slots(state, group))
    # class: the float leaves of each class as one row, the counters as another
    c = state.alpha.shape[0]
    floats = [state.sv_x.float().reshape(c, -1), state.alpha.float().reshape(c, -1)]
    if state.kmat is not None:
        floats.append(state.kmat.reshape(c, -1))
    rows = all_gather_rows(torch.cat(floats, 1), group)
    ints = all_gather_rows(torch.stack([state.count, state.step, state.n_inserts,
                                        state.n_merges], 1).to(torch.int64), group)
    s, d = state.sv_x.shape[1:]
    sv_x, alpha, kmat = torch.split(rows, [s * d, s, rows.shape[1] - s * d - s], 1)
    count, step, n_inserts, n_merges = ints.to(state.count.dtype).unbind(1)
    return SVMState(sv_x=sv_x.reshape(-1, s, d).to(state.sv_x.dtype),
                    alpha=alpha.to(state.alpha.dtype).contiguous(), count=count.contiguous(),
                    step=step.contiguous(), n_inserts=n_inserts.contiguous(),
                    n_merges=n_merges.contiguous(),
                    kmat=None if state.kmat is None else kmat.reshape(-1, s, s).contiguous())


def _gather_slots(state: SVMState, group, extra=None) -> dict:
    """The slot-split leaves (and ``extra``, rows of this rank's slots) whole,
    from one all-gather along the slot axis; ``extra`` comes back under
    ``"extra"``."""
    parts = [state.sv_x.float(), state.alpha.float()[:, None]]
    if state.kmat is not None:
        parts.append(state.kmat)
    if extra is not None:
        parts.append(extra)
    rows = all_gather_rows(torch.cat(parts, 1), group)
    out = torch.split(rows, [p.shape[1] for p in parts], 1)
    whole = {"sv_x": out[0].to(state.sv_x.dtype), "alpha": out[1][:, 0].to(state.alpha.dtype)}
    if state.kmat is not None:
        whole["kmat"] = out[2].contiguous()
    if extra is not None:
        whole["extra"] = out[-1]
    return whole


def _gather_batch(xb, yb, group):
    """The global minibatch on every rank from each rank's rows (one
    all-gather; labels, ±1 or class ids, travel exactly as float32)."""
    rows = all_gather_rows(torch.cat([xb.float(), yb.float()[:, None]], 1), group)
    return rows[:, :-1].contiguous(), rows[:, -1].to(yb.dtype)


def _replicated_step(cfg: BSGDConfig, table, state, xb, yb, group, impl):
    if cfg.step_engine == "pallas":
        # the fused step computes its margin rows inside its one launch:
        # every rank runs it on the whole minibatch
        xg, yg = _gather_batch(xb, yb, group)
        return train_step(cfg, table, state, xg, yg, impl=impl)
    k_own = kops.rbf_matrix(xb, state.sv_x, cfg.gamma, impl=impl)      # this rank's rows
    s, d = k_own.shape[1], xb.shape[1]
    rows = all_gather_rows(torch.cat([k_own, xb.float(), yb.float()[:, None]], 1), group)
    k_b, xg, yg = rows[:, :s].contiguous(), rows[:, s:s + d].contiguous(), rows[:, -1]
    k_bb = kops.rbf_matrix(xg, xg, cfg.gamma, impl=impl) if cfg.use_kernel_cache else None
    return train_step_from_rows(cfg, table, state, xg, yg.to(yb.dtype), k_b, k_bb, impl=impl)


def _slots_step(cfg: BSGDConfig, table, state, xb, yb, group, impl):
    rank, world = _world(group)
    xg, yg = _gather_batch(xb, yb, group)
    lo, _ = owned_range(cfg.slots, rank, world)
    if cfg.step_engine == "pallas":
        whole = state._replace(**_gather_slots(state, group))
        return shard_state(cfg, train_step(cfg, table, whole, xg, yg, impl=impl), group, "slots")
    k_own = kops.rbf_matrix(xg, state.sv_x, cfg.gamma, impl=impl)      # k(xb, this rank's slots)
    active = lo + torch.arange(state.alpha.shape[0], device=xg.device) < state.count
    f = all_reduce_sum(k_own.to(state.alpha.dtype) @ torch.where(active, state.alpha, 0.0),
                       group)
    whole = _gather_slots(state, group, extra=k_own.T)
    k_b = whole.pop("extra").T.contiguous()
    k_bb = kops.rbf_matrix(xg, xg, cfg.gamma, impl=impl) if cfg.use_kernel_cache else None
    whole = state._replace(**whole)
    if cfg.solver == "bdca":
        mid = bdca._insert(cfg, whole, xg, yg, k_b, k_bb, f, impl=impl)
    else:
        mid = bsgd._insert(cfg, whole, xg, yg, k_b, k_bb, f)
    return shard_state(cfg, drain_budget(cfg, table, mid, impl=impl), group, "slots")


def _class_step(cfg: MulticlassSVMConfig, table, state, xb, yb, group, impl, classes):
    xg, yg = _gather_batch(xb, yb, group)
    y_ovr = ovr_targets(yg, cfg.n_classes, dtype=getattr(torch, cfg.binary.dtype))
    return train_step_ovr(cfg.binary, table, state, xg, y_ovr[classes[0]:classes[1]], impl=impl)


def make_distributed_step(cfg, group, table=None, *, layout: str = "replicated",
                          impl: str = "auto"):
    """``step(state, xb, yb) -> state``: one step of ``layout`` on this rank.

    ``cfg`` is a ``BSGDConfig`` for ``replicated`` and ``slots`` or a
    ``MulticlassSVMConfig`` for ``class``; ``table`` defaults to
    ``cfg.table()``.  Every rank calls ``step`` with its part of the state
    (``shard_state``) and its ``batch / W`` contiguous rows of the global
    minibatch (``shard_rows``), on its device, and gets its part of the next
    state.  The caller's state is left as it was.  Raises ``ValueError`` when
    the batch does not split evenly over the ranks."""
    rank, world = _world(group)
    eff = resolve_layout(cfg, layout, world)
    b = cfg.binary if isinstance(cfg, MulticlassSVMConfig) else cfg
    if b.batch_size % world:
        raise ValueError(f"batch_size={b.batch_size} does not split evenly over {world} ranks")
    if table is None:
        table = cfg.table()
    rows = b.batch_size // world
    if isinstance(cfg, MulticlassSVMConfig):
        classes = (owned_range(cfg.n_classes, rank, world) if eff == "class"
                   else (0, cfg.n_classes))

        def body(tab, state, xb, yb):
            return _class_step(cfg, tab, state, xb, yb, group, impl, classes)
    else:
        fn = _slots_step if eff == "slots" else _replicated_step

        def body(tab, state, xb, yb):
            return fn(cfg, tab, state, xb, yb, group, impl)
    tables = {}                     # the table on each device a step has run on

    def step(state: SVMState, xb, yb) -> SVMState:
        if xb.shape[0] != rows:
            raise ValueError(f"each of {world} ranks takes {rows} rows of the batch of "
                             f"{b.batch_size}; got {xb.shape[0]}")
        dev = state.alpha.device
        if dev not in tables:
            tables[dev] = None if table is None else table.to(dev)
        return body(tables[dev], state, xb, yb)

    return step


def make_distributed_chunk_step(cfg, group, table=None, *, layout: str = "replicated",
                                impl: str = "auto"):
    """``chunk(state, xc, yc) -> state``: a chunk's steps of
    ``make_distributed_step``, the streaming drivers' chunk program.  ``xc``
    (steps, batch / W, dim) and ``yc`` (steps, batch / W) are this rank's
    part of the chunk's batch axis (``shard_rows(xc, group, dim=1)``), on its device."""
    step = make_distributed_step(cfg, group, table, layout=layout, impl=impl)

    def chunk(state: SVMState, xc, yc) -> SVMState:
        for i in range(xc.shape[0]):
            state = step(state, xc[i], yc[i])
        return state

    return chunk


def make_distributed_predict(group, *, impl: str = "auto"):
    """``predict(model, x) -> (scores, labels)``: the serve cell with the
    request rows split over the ranks (``layout="serve"``).

    Every rank holds the whole ``ServeModel`` and passes its ``n / W`` rows
    (``shard_rows``); it runs one serve cell on them, and one all-gather gives
    every rank the (C, n) scores and (n,) labels of all rows in rank order.
    A row's bits do not depend on its batch, so they equal one process's."""

    def predict(model: ServeModel, x):
        scores, labels = serve_cell(model, x, impl=impl)
        c = scores.shape[0]
        rows = all_gather_rows(torch.cat([scores.T, labels.float()[:, None]], 1), group)
        return rows[:, :c].T.contiguous(), rows[:, c].to(labels.dtype)

    return predict



def lower_svm_cell(mesh, *, budget: int = 16384, dim: int = 1024, batch: int = 8192,
                   method: str = "lookup-wd", layout: str = "replicated", n_classes: int = 8,
                   stream_steps: int = 0, step: str = "train", maintenance_engine: str = "xla",
                   step_engine: str = "composed", solver: str = "bsgd",
                   maintenance: str = "merge"):
    """Trace rank 0's step of the production-scale BSGD cell once on fake
    tensors; returns ``(record, cfg)``, the record a ``launch.roofline.Trace``.

    The reference's cell and defaults: budget 16k SVs, 1k features, an
    8k-row global minibatch, lambda 1e-6, gamma 2^-7, float32 arithmetic and
    bfloat16 SV rows.  ``mesh`` is a ``DeviceMesh`` over every rank of the
    running (fake) process group, and the layouts split over all of them (W
    ranks): ``replicated``, ``slots``, ``class`` (``n_classes`` one-vs-rest
    problems; a class count W does not divide keeps every class on every
    rank, as ``make_distributed_step`` does), ``stream_steps > 0`` the
    chunk program (``make_distributed_chunk_step``), ``step="predict"`` the
    serve cell (``make_distributed_predict``: the bfloat16 bank on every
    rank, the request rows split).  ``maintenance_engine``, ``step_engine``,
    ``solver`` and ``maintenance`` as ``BSGDConfig`` takes them (``bdca``,
    the fused engines and the projecting strategies imply the kernel cache).
    The tensors are fake ones on the mesh's device, so each kernel takes its
    planned branch (``kernels.planned``): on a cuda-typed mesh (which needs
    torch built with CUDA, else this raises) they are the card's; on a
    cpu-typed mesh fake CPU tensors stand for the card's
    (``kernels.planned.for_card``).

    What the trace assumes, stated here and in the record (``scaled``):
      * the steady state: a full budget, and every row of the minibatch
        inserted, so a step's maintenance retires ``batch`` SVs.  A step
        runs ``batch_size`` masked rounds whatever the data (the training
        step's ``unroll``), and a drain (``unroll=0``), which a real run
        reads from the card (``core.budget._events``), is stated to run
        ``batch`` (``kernels.planned.assume_excess``);
      * the rounds are alike in shape: one is traced and its work counted
        for every round (``kernels.planned.scaled``), so the trace's time
        does not grow with the batch;
      * a chunk's steps likewise: one is traced and counted ``stream_steps``
        times;
      * the kernels' work is their formulas' at the steady state (every
        active slot a valid candidate).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..kernels import planned
    from ..launch import inputs as inp
    from ..launch.roofline import Counters

    cfg = BSGDConfig(budget=budget, lambda_=1e-6, gamma=2.0 ** -7, method=method,
                     batch_size=batch, dtype="float32", sv_dtype="bfloat16",
                     use_kernel_cache=(solver == "bdca" or maintenance_engine == "pallas"
                                       or step_engine == "pallas"
                                       or maintenance in ("removal-project", "quantized")),
                     maintenance=maintenance, maintenance_engine=maintenance_engine,
                     step_engine=step_engine, solver=solver)
    if layout == "class":
        cfg = MulticlassSVMConfig(n_classes=n_classes, binary=cfg)
    b = cfg.binary if layout == "class" else cfg
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    if mesh.size() != world:
        raise ValueError(f"the mesh has {mesh.size()} ranks and the group {world}")
    dev = mesh.device_type
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a plan on a cuda-typed mesh needs torch built with CUDA; plan on a "
                           "cpu-typed mesh, whose fake CPU tensors stand for the card's")
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    scaled = {"maintenance_rounds": b.batch_size}
    with fm:
        if step == "predict":
            c = n_classes if layout == "class" else None
            sp = inp.svm_serve_specs(dim, batch, b.slots, n_classes=c,
                                     bank_dtype=b.sv_dtype or b.dtype, device=dev)
            model = ServeModel(sv_x=sp["sv_x"], alpha=sp["alpha"], count=sp["count"],
                               gamma=b.gamma, binary=c is None)
            fn = make_distributed_predict(group)
            args = (model, shard_rows(sp["x"], group).clone())
            scaled = {}
        else:
            table = cfg.table()
            whole = _abstract_state(b, dim, n_classes if layout == "class" else None, dev)
            state = SVMState(*(None if t is None else t.clone()
                               for t in shard_state(cfg, whole, group, layout)))
            del whole
            steps = max(stream_steps, 1)
            ch = inp.svm_chunk_specs(dim, steps, batch, n_classes=n_classes if layout == "class"
                                     else None, x_dtype=b.sv_dtype or b.dtype,
                                     y_dtype=b.dtype, device=dev)
            xc, yc = (shard_rows(ch[k], group, dim=1).clone() for k in ("xc", "yc"))
            if stream_steps > 0:
                chunk = make_distributed_chunk_step(cfg, group, table, layout=layout)
                scaled["chunk_steps"] = stream_steps

                def fn(state, xc, yc):
                    with planned.scaled(stream_steps):
                        return chunk(state, xc[:1], yc[:1])
                args = (state, xc, yc)
            else:
                fn = make_distributed_step(cfg, group, table, layout=layout)
                args = (state, xc[0], yc[0])
    counters = Counters(fm)
    counters.trace.scaled = scaled
    card = planned.for_card() if dev == "cpu" else contextlib.nullcontext()
    with card, planned.assume_excess(b.batch_size), counters, fm:
        counters.resident([_state_tensors(a) for a in args])
        out = fn(*args)
        counters.outputs(_state_tensors(out))
    return counters.trace, cfg


def _abstract_state(b: BSGDConfig, dim: int, n_classes, device) -> SVMState:
    """``init_state``'s (or, with ``n_classes``, ``init_multiclass_state``'s)
    shapes and dtypes, empty, on ``device``."""
    lead = () if n_classes is None else (n_classes,)

    def t(shape, dtype):
        return torch.empty(lead + shape, dtype=dtype, device=device)

    i32 = torch.int32
    return SVMState(sv_x=t((b.slots, dim), getattr(torch, b.sv_dtype or b.dtype)),
                    alpha=t((b.slots,), getattr(torch, b.dtype)), count=t((), i32),
                    step=t((), i32), n_inserts=t((), i32), n_merges=t((), i32),
                    kmat=t((b.slots, b.slots), torch.float32) if b.use_kernel_cache else None)


def _state_tensors(x):
    """The tensors of a step's argument or result (a ``ServeModel``'s too)."""
    if isinstance(x, ServeModel):
        return [x.sv_x, x.alpha, x.count]
    if isinstance(x, SVMState):
        return [t for t in x if t is not None]
    return x
