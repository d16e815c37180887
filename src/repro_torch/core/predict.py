"""Serving path: the fused serve cell and the batched request queues.

PyTorch counterpart of ``repro.core.predict``.  Merging exists so that the
SV bank stays small and prediction stays cheap; this module is the
inference half of that bargain:

  * ``ServeModel`` — the exported, inference-only view of a trained
    ``SVMState``: the (C, slots, dim) SV bank (optionally bf16), fp32
    alphas with the active-count mask folded in at export, and the kernel
    width.  Binary models export as C = 1 with ``binary=True`` (labels are
    ±1 signs instead of argmax ids).  Training updates its state in place,
    so the export copies every tensor: a served model never changes under
    its readers.
  * ``predict_labels`` — the serve cell (``kernels.ops.serve_cell``): the
    kernel block against the flattened (C * slots, dim) bank, the fp32
    contraction and the label, in one launch on the card.  Every sum has one order
    whatever the row count, so a row's scores depend only on that row and
    the bank.
  * ``BatchQueue`` / ``AsyncBatchQueue`` — microbatch assembly for a
    request stream: rows pack into ``max_batch`` microbatches in arrival
    order and the ragged tail pads up to a power-of-two bucket.  Queue
    labels are bitwise the labels of one direct ``predict_labels`` call on
    the same rows, for any arrival pattern and any bucket geometry.  Where
    the reference compiles one executable per bucket, the queues' warm-up
    runs every bucket once: after it, live traffic builds no kernel and
    reserves no new device memory.
  * ``load_serve_model`` — a ``ServeModel`` straight from a checkpoint in
    ``repro.checkpoint``'s format (either package's), the state template
    rebuilt from the manifest's shapes and dtypes.

Entry points run on the card unless the model lives on the CPU; serving
follows the model's device and never falls back.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from functools import partial

import numpy as np
import torch

from .bsgd import SVMState, resolve_device
from ..kernels import _build
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True, eq=False)
class ServeModel:
    """Inference-only view of a trained budgeted SVM.

    Attributes:
      sv_x: (C, slots, dim) SV bank in the serving dtype (bf16 halves it).
        Binary models are C = 1.
      alpha: (C, slots) float32 coefficients with inactive slots zeroed.
      count: (C,) int32 active-SV watermarks (reporting only).
      gamma: the RBF width, a Python float rounded to float32.
      binary: True when the model was a binary ``SVMState``; labels are then
        ±1 signs instead of argmax class ids.
    """

    sv_x: torch.Tensor
    alpha: torch.Tensor
    count: torch.Tensor
    gamma: float
    binary: bool = False

    @property
    def n_classes(self) -> int:
        return self.sv_x.shape[0]

    @property
    def dim(self) -> int:
        return self.sv_x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.sv_x.device

    @property
    def label_dtype(self):
        return np.float32 if self.binary else np.int32


def export_model(state: SVMState, gamma, *, bank_dtype=None) -> ServeModel:
    """Trained ``SVMState`` (binary or stacked multiclass) -> ``ServeModel``.

    ``bank_dtype`` (``"bfloat16"`` or a torch dtype) stores the bank in that dtype;
    alphas stay fp32 and scoring accumulates in fp32.  The active-count mask
    is folded into alpha here.  Every tensor is a copy: the training paths
    write their state in place."""
    binary = state.sv_x.dim() == 2
    sv_x, alpha, count = state.sv_x, state.alpha, state.count
    if binary:
        sv_x, alpha, count = sv_x[None], alpha[None], count.reshape(1)
    active = torch.arange(alpha.shape[-1], device=alpha.device)[None, :] < count[:, None]
    alpha = torch.where(active, alpha, 0.0).to(torch.float32)
    dtype = (sv_x.dtype if bank_dtype is None else bank_dtype
             if isinstance(bank_dtype, torch.dtype) else getattr(torch, bank_dtype))
    return ServeModel(sv_x=sv_x.to(dtype, copy=True).contiguous(), alpha=alpha,
                      count=count.to(torch.int32, copy=True),
                      gamma=float(np.float32(gamma)), binary=binary)


def _rows(model: ServeModel, x) -> torch.Tensor:
    return torch.as_tensor(x).to(model.device, torch.float32)


def serve_cell(model: ServeModel, x, *, impl: str = "auto"):
    """``(scores (C, n), labels (n,))`` for a request batch (n, d)."""
    return kops.serve_cell(_rows(model, x), model.sv_x, model.alpha, model.gamma,
                           binary=model.binary, impl=impl)


def serve_scores(model: ServeModel, x, *, impl: str = "auto") -> torch.Tensor:
    """Per-class decision scores for a request batch: (n, d) -> (C, n)."""
    return serve_cell(model, x, impl=impl)[0]


def predict_labels(model: ServeModel, x, *, impl: str = "auto") -> torch.Tensor:
    """The serve cell's labels: (n,) int32 class ids, or for a binary model
    the (n,) float32 ±1 signs of ``bsgd.predict`` (0 for a zero score)."""
    return serve_cell(model, x, impl=impl)[1]


def top_k_labels(model: ServeModel, x, *, k: int = 1, impl: str = "auto"):
    """Top-k class ids and decision scores per request row: ``(ids, scores)``,
    (n, k) each, best first, ties to the lower class id (as ``lax.top_k``),
    so ``ids[:, 0]`` is bitwise ``predict_labels``.  Multiclass models only."""
    if model.binary:
        raise ValueError("top_k_labels needs a multiclass model; binary models have a "
                         "single ±1 decision (predict_labels)")
    if not 1 <= k <= model.n_classes:
        raise ValueError(f"k={k} not in [1, n_classes={model.n_classes}]")
    scores = serve_scores(model, x, impl=impl)
    vals, ids = torch.sort(scores.T, dim=-1, descending=True, stable=True)
    return ids[:, :k].to(torch.int32), vals[:, :k]


def predict_proba(model: ServeModel, x, *, temperature: float = 1.0, impl: str = "auto"):
    """Softmax probabilities over the C class scores, (n, C):
    ``softmax(scores / temperature)`` a row (temperature scaling, the
    post-hoc calibration knob).  Multiclass models only."""
    if model.binary:
        raise ValueError("predict_proba needs a multiclass model")
    # T = 0 would be a silent NaN factory and T < 0 reverses the ranking
    if temperature <= 0:
        raise ValueError(f"temperature={temperature} must be > 0")
    return torch.softmax(serve_scores(model, x, impl=impl).T / temperature, dim=-1)


# ---------------------------------------------------------------------------
# Batched request queue
# ---------------------------------------------------------------------------

class ServeTimeout(TimeoutError):
    """``take``/``drain`` timed out waiting for resolution; the message names
    the ticket and the queue's in-flight depth."""


class ServeDeadline(TimeoutError):
    """A request's own ``deadline_s`` expired before its rows were
    dispatched: the queue shed it instead of serving stale results."""


class QueueFull(RuntimeError):
    """``submit`` refused because ``max_pending`` rows are already queued."""


def _validate_request(x: np.ndarray, dim: int | None) -> None:
    """Shared ``submit`` validation: a clear ``ValueError`` for malformed rows
    instead of a shape error (or a poisoned score) inside a microbatch."""
    if x.ndim != 2:
        raise ValueError(f"request must be (n, dim), got shape {x.shape}")
    if x.dtype == np.bool_ or not np.issubdtype(x.dtype, np.number):
        raise ValueError(f"request rows must be a numeric dtype, got {x.dtype}")
    if dim is not None and x.shape[1] != dim:
        raise ValueError(f"request dim {x.shape[1]} != model dim {dim}")
    if x.size and not np.isfinite(x).all():
        raise ValueError("request rows contain non-finite values — refused at submit so "
                         "a poisoned request can never surface as a non-finite score")


def default_buckets(max_batch: int, min_bucket: int = 8) -> tuple[int, ...]:
    """Power-of-two pad targets up to (and always including) ``max_batch``."""
    if min_bucket < 1:
        raise ValueError(f"min_bucket={min_bucket} < 1")
    buckets = []
    b = min_bucket
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def pad_bucket(n: int, buckets) -> int:
    """The smallest bucket that fits ``n`` rows (ascending ``buckets``; the
    largest for ``n > max``): the one pad-target rule of both queues and
    ``drive_trace``."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _host_labels(labels) -> np.ndarray:
    """Labels as a host numpy array (waits for the card)."""
    if isinstance(labels, torch.Tensor):
        return labels.cpu().numpy()
    return np.asarray(labels)


def _bump(stats: dict, pad_to: int, n_real: int) -> None:
    stats["rows"] += n_real
    stats["microbatches"] += 1
    stats["padded_rows"] += pad_to - n_real
    stats["bucket_counts"][pad_to] = stats["bucket_counts"].get(pad_to, 0) + 1
    stats["bucket_real_rows"][pad_to] = stats["bucket_real_rows"].get(pad_to, 0) + n_real


class BatchQueue:
    """Microbatch assembly over a request stream, one serve cell a batch.

    Requests (``(n_i, dim)`` row blocks) pack into ``max_batch``-row
    microbatches in arrival order; a full microbatch runs at ``submit``, and
    ``drain`` flushes the ragged remainder padded up to the smallest bucket
    that fits.  Pad rows are zeros and their labels are dropped; every real
    row's label is bitwise one direct ``predict_labels`` call's.

    ``predict_fn`` overrides the compute (it maps a (b, dim) numpy array to
    (b,) labels).  Per-microbatch wall times (launch, copies, host sync) land
    in ``latencies_s``.
    """

    def __init__(self, model: ServeModel, *, max_batch: int = 256, min_bucket: int = 8,
                 impl: str = "auto", predict_fn=None):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} < 1")
        self.model = model
        self.max_batch = max_batch
        self.buckets = default_buckets(max_batch, min_bucket)
        self._predict = (predict_fn if predict_fn is not None
                         else partial(predict_labels, model, impl=impl))
        self._pending: deque = deque()   # (ticket, rows ndarray, row_offset)
        self._pending_rows = 0
        self._need: dict[int, int] = {}
        self._parts: dict[int, list] = {}
        self._done: dict[int, np.ndarray] = {}
        self._next_ticket = 0
        self.warmed: set[int] = set()
        self.latencies_s: list[float] = []
        self.stats = {"rows": 0, "microbatches": 0, "padded_rows": 0,
                      "bucket_counts": {}, "bucket_real_rows": {}}

    def warmup(self, dtype=np.float32) -> None:
        """Run every bucket shape once through the queue's own compute, so
        live traffic builds no kernel and reserves no new device memory."""
        for b in self.buckets:
            _host_labels(self._predict(np.zeros((b, self.model.dim), dtype)))
            self.warmed.add(b)

    def _bucket_for(self, n: int) -> int:
        return pad_bucket(n, self.buckets)

    def submit(self, x) -> int:
        """Enqueue one request of rows; returns its ticket."""
        x = np.asarray(x)
        _validate_request(x, self.model.dim)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._need[ticket] = x.shape[0]
        self._parts[ticket] = []
        if x.shape[0] == 0:
            self._finish(ticket)
        else:
            self._pending.append((ticket, x, 0))
            self._pending_rows += x.shape[0]
        while self._pending_rows >= self.max_batch:
            self._run_microbatch(self.max_batch)
        return ticket

    def drain(self) -> None:
        """Flush the ragged tail (padded to its bucket); all tickets resolve."""
        while self._pending_rows >= self.max_batch:
            self._run_microbatch(self.max_batch)
        if self._pending_rows:
            self._run_microbatch(self._pending_rows)

    def take(self, ticket: int) -> np.ndarray:
        """Labels for a resolved ticket (``drain`` first for partial tails)."""
        if ticket not in self._done:
            raise KeyError(f"ticket {ticket} not resolved — drain() first")
        return self._done.pop(ticket)

    def _finish(self, ticket: int) -> None:
        parts = sorted(self._parts.pop(ticket), key=lambda p: p[0])
        got = (np.concatenate([p[1] for p in parts]) if parts
               else np.zeros((0,), self.model.label_dtype))
        assert got.shape[0] == self._need.pop(ticket)
        self._done[ticket] = got

    def _run_microbatch(self, n_real: int) -> None:
        pad_to = self._bucket_for(n_real)
        slices, rows = [], []
        need = n_real
        while need:
            ticket, x, off = self._pending.popleft()
            take = min(need, x.shape[0])
            rows.append(x[:take])
            slices.append((ticket, off, take))
            if take < x.shape[0]:
                self._pending.appendleft((ticket, x[take:], off + take))
            need -= take
        self._pending_rows -= n_real
        xb = np.zeros((pad_to, rows[0].shape[1]), np.float32)
        pos = 0
        for r in rows:
            xb[pos:pos + r.shape[0]] = r
            pos += r.shape[0]
        t0 = time.perf_counter()
        labels = _host_labels(self._predict(xb))
        self.latencies_s.append(time.perf_counter() - t0)
        _bump(self.stats, pad_to, n_real)
        pos = 0
        for ticket, off, take in slices:
            self._parts[ticket].append((off, labels[pos:pos + take]))
            pos += take
            if sum(p[1].shape[0] for p in self._parts[ticket]) == self._need[ticket]:
                self._finish(ticket)


def serve_requests(model: ServeModel, requests, **queue_kw) -> list[np.ndarray]:
    """Run a whole request list through a fresh ``BatchQueue``; per-request
    label arrays in submission order."""
    q = BatchQueue(model, **queue_kw)
    tickets = [q.submit(r) for r in requests]
    q.drain()
    return [q.take(t) for t in tickets]


# ---------------------------------------------------------------------------
# Versioned model bank + continuous-batching async queue
# ---------------------------------------------------------------------------

class ModelBank:
    """A versioned, atomically hot-swappable ``ServeModel`` slot.

    The seam between a trainer and a live serve queue: the trainer publishes
    snapshots and an ``AsyncBatchQueue`` over the bank picks up the newest
    version per microbatch without draining.  The slot is one ``(version,
    model)`` tuple swapped by a single reference assignment, so readers
    always see a consistent pair; versions are strictly monotone.  A
    published model must own its tensors (``export_model`` copies them):
    nothing may write them afterwards.
    """

    def __init__(self, model: ServeModel | None = None):
        self._slot = (1 if model is not None else 0, model)
        self._cv = threading.Condition()

    @property
    def version(self) -> int:
        """Version of the current model (0 = empty bank)."""
        return self._slot[0]

    def publish(self, model: ServeModel) -> int:
        """Swap in ``model`` as the new current version; returns it."""
        with self._cv:
            version = self._slot[0] + 1
            self._slot = (version, model)       # one atomic reference swap
            self._cv.notify_all()
        return version

    def current(self) -> tuple[int, ServeModel]:
        """The live ``(version, model)`` pair (lock-free hot path)."""
        slot = self._slot
        if slot[1] is None:
            raise LookupError("ModelBank is empty — publish() a model first")
        return slot

    def wait(self, version: int = 1, timeout: float | None = None) -> tuple[int, ServeModel]:
        """Block until the bank holds at least ``version``; returns the pair
        (raises TimeoutError on ``timeout``)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._slot[0] >= version, timeout):
                raise TimeoutError(f"ModelBank still at version {self._slot[0]} < {version} "
                                   f"after {timeout}s")
            return self._slot


class _Staging:
    """The async queue's two pinned host buffer pairs on the card: request
    rows (max_batch, dim) fp32 and labels (max_batch,).  Each in-flight
    microbatch owns one pair; the two alternate, so assembling the next
    microbatch never overwrites rows whose copy to the card has not ended."""

    def __init__(self, max_batch: int, dim: int, label_dtype):
        ldt = torch.float32 if label_dtype == np.float32 else torch.int32
        self.key = (dim, label_dtype)
        self.rows = [torch.empty((max_batch, dim), dtype=torch.float32, pin_memory=True)
                     for _ in range(2)]
        self.labels = [torch.empty((max_batch,), dtype=ldt, pin_memory=True) for _ in range(2)]
        self.next = 0

    def take(self):
        i, self.next = self.next, self.next ^ 1
        return self.rows[i], self.labels[i]


class _InFlight:
    """One launched microbatch: its labels land in ``host`` (a pinned
    buffer) when ``event`` completes, or are ``host`` already."""

    def __init__(self, host, event=None):
        self.host, self.event = host, event

    def result(self) -> np.ndarray:
        if self.event is None:
            return _host_labels(self.host)
        self.event.synchronize()
        return self.host.numpy().copy()   # the buffer is reused two launches on


class AsyncBatchQueue:
    """Continuous batching: a dispatcher thread owns the device, submitters
    never compute.

    ``submit`` is thread-safe and returns a ticket at once; the dispatcher
    assembles microbatches out of whatever is pending (up to ``max_batch``
    rows a launch, arrival order kept) and keeps two launches in flight:
    while microbatch i runs on the card, it assembles and launches i + 1,
    then resolves i.  On the card a launch does not wait: the rows go from a
    pinned staging buffer to the card with ``non_blocking=True``, the serve
    cell launches, the labels come back with ``non_blocking=True`` into
    pinned memory and a CUDA event is recorded, which resolving waits on.
    Dispatch is waiter-gated: a microbatch launches when a full
    ``max_batch`` pends, someone blocks in ``take``/``drain``, or the queue
    is closing.

    Labels are bitwise one direct ``predict_labels`` call on the same rows
    for any arrival pattern (same pad rule, ``pad_bucket``, as
    ``BatchQueue``).  ``model`` may be a ``ServeModel`` or a ``ModelBank``,
    re-read per microbatch (hot swap without a drain; ``stats["versions"]``
    records which version scored each microbatch).  ``predict_fn`` overrides
    compute as in ``BatchQueue`` (fixed model only).

    ``take``/``drain`` block until resolution (optional ``timeout``); a
    dispatcher failure re-raises on the caller's thread.  ``max_pending``
    bounds the pending rows (``QueueFull``); ``submit(..., deadline_s=)``
    sheds a request still undispatched at its deadline (``ServeDeadline``);
    timeouts raise ``ServeTimeout`` naming the ticket.  Use as a context
    manager or call ``close()``.
    """

    def __init__(self, model: ServeModel | ModelBank, *, max_batch: int = 256,
                 min_bucket: int = 8, impl: str = "auto", predict_fn=None,
                 max_pending: int | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} < 1")
        if max_pending is not None and max_pending < max_batch:
            raise ValueError(f"max_pending={max_pending} < max_batch={max_batch} could "
                             "never fill a full microbatch")
        self._bank = model if isinstance(model, ModelBank) else None
        self.model = None if self._bank is not None else model
        if self._bank is not None and predict_fn is not None:
            raise ValueError("predict_fn requires a fixed ServeModel — a ModelBank swaps "
                             "models per microbatch")
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.buckets = default_buckets(max_batch, min_bucket)
        self._impl = impl
        self._predict_fn = predict_fn
        self._staging: _Staging | None = None
        self.warmed: set[int] = set()
        self._cv = threading.Condition()
        self._pending: deque = deque()  # (ticket, rows, row_offset, deadline)
        self._pending_rows = 0
        self._need: dict[int, int] = {}
        self._parts: dict[int, list] = {}
        self._done: dict[int, np.ndarray] = {}
        self._dead: dict[int, str] = {}   # ticket -> shed reason
        self._next_ticket = 0
        self._unresolved = 0
        self._waiters = 0
        self._error: BaseException | None = None
        self._stop = False
        self.latencies_s: list[float] = []
        self.stats = {"rows": 0, "microbatches": 0, "padded_rows": 0,
                      "bucket_counts": {}, "bucket_real_rows": {}, "versions": {}}
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True,
                                        name="serve-dispatch")
        self._thread.start()

    # -- submitter side ------------------------------------------------------

    def submit(self, x, *, deadline_s: float | None = None) -> int:
        """Enqueue one request of rows; returns its ticket immediately.

        ``deadline_s``: seconds from now after which undispatched rows are
        shed (``take`` then raises ``ServeDeadline``).  Raises ``QueueFull``
        past ``max_pending`` pending rows."""
        x = np.asarray(x)
        try:
            dim = self._current()[1].dim
        except LookupError:
            dim = None                     # empty bank — no dim to pin yet
        _validate_request(x, dim)
        dl = None if deadline_s is None else time.monotonic() + float(deadline_s)
        with self._cv:
            self._check_error()
            if self._stop:
                raise RuntimeError("AsyncBatchQueue is closed")
            if (self.max_pending is not None and x.shape[0]
                    and self._pending_rows + x.shape[0] > self.max_pending):
                raise QueueFull(f"{self._pending_rows} rows pending + {x.shape[0]} new > "
                                f"max_pending={self.max_pending} — request shed")
            ticket = self._next_ticket
            self._next_ticket += 1
            if x.shape[0] == 0:
                self._done[ticket] = np.zeros((0,), self._label_dtype())
            else:
                self._need[ticket] = x.shape[0]
                self._parts[ticket] = []
                self._unresolved += 1
                self._pending.append((ticket, x, 0, dl))
                self._pending_rows += x.shape[0]
                # wake the dispatcher only when the gate is open
                if self._pending_rows >= self.max_batch or self._waiters:
                    self._cv.notify_all()
            return ticket

    def take(self, ticket: int, timeout: float | None = None) -> np.ndarray:
        """Labels for a ticket; blocks until its last microbatch resolves.

        Raises ``ServeDeadline`` if the ticket was shed, ``ServeTimeout`` on
        ``timeout``."""
        def ready():
            return ticket in self._done or ticket in self._dead

        def timed_out():
            raise ServeTimeout(f"ticket {ticket} unresolved after {timeout}s "
                               f"({self._unresolved} requests in flight, "
                               f"{self._pending_rows} rows pending)")

        self._await(ready, timeout, timed_out)
        with self._cv:
            if ticket in self._dead:
                raise ServeDeadline(f"ticket {ticket} shed: {self._dead.pop(ticket)}")
            return self._done.pop(ticket)

    def drain(self, timeout: float | None = None) -> None:
        """Block until every submitted row is scored, resolved or shed."""
        def ready():
            return self._unresolved == 0

        def timed_out():
            raise ServeTimeout(f"{self._unresolved} requests unresolved after {timeout}s "
                               f"({self._pending_rows} rows pending)")

        self._await(ready, timeout, timed_out)

    def _await(self, ready, timeout, timed_out) -> None:
        """Wait, as a gate-opening waiter, until ``ready()`` under the lock,
        re-checking at request deadlines; ``timed_out()`` past ``timeout``."""
        deadline_t = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._waiters += 1          # un-gate dispatch of partial batches
            self._cv.notify_all()
            try:
                while True:
                    self._purge_expired_locked()
                    self._check_error()
                    if ready():
                        return
                    now = time.monotonic()
                    if deadline_t is not None and now >= deadline_t:
                        timed_out()
                    bounds = [t for t in (deadline_t, self._earliest_deadline_locked())
                              if t is not None]
                    self._cv.wait(max(min(bounds) - now, 0.0) + 1e-3 if bounds else None)
            finally:
                self._waiters -= 1

    def close(self, timeout: float | None = 30.0) -> None:
        """Flush pending work, stop and join the dispatcher (idempotent)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def warmup(self) -> None:
        """Run every bucket through the queue's own launch path, two
        launches in flight as the dispatcher keeps them, so live traffic
        builds no kernel and reserves no new device memory.  Call it before
        submitting: it shares the staging buffers with the dispatcher."""
        _, model = self._current()
        for b in self.buckets:
            flights = []
            for _ in range(2):
                rows, labels = self._stage(model, b)
                rows.zero_()
                flights.append(self._score(model, rows, labels))
            for f in flights:
                f.result()
            self.warmed.add(b)

    # -- dispatcher side -----------------------------------------------------

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("AsyncBatchQueue dispatcher failed") from self._error

    def _label_dtype(self):
        try:
            return self._current()[1].label_dtype
        except LookupError:
            return np.int32

    def _current(self) -> tuple:
        if self._bank is not None:
            return self._bank.current()
        return None, self.model

    def _stage(self, model: ServeModel, b: int):
        """Host buffers for a microbatch of ``b`` rows: ``(rows (b, dim) fp32
        for the caller to fill, labels (b,) or None)``; on the card the next
        pinned pair of ``_Staging``."""
        if model.device.type != "cuda" or self._predict_fn is not None:
            return torch.empty((b, model.dim), dtype=torch.float32), None
        if self._staging is None or self._staging.key != (model.dim, model.label_dtype):
            self._staging = _Staging(self.max_batch, model.dim, model.label_dtype)
        rows, labels = self._staging.take()
        return rows[:b], labels[:b]

    def _score(self, model: ServeModel, rows: torch.Tensor, labels) -> _InFlight:
        """Launch one microbatch of staged rows; on the card nothing here
        waits for the device."""
        if self._predict_fn is not None:
            return _InFlight(self._predict_fn(rows.numpy()))
        if labels is None:
            return _InFlight(predict_labels(model, rows, impl=self._impl))
        dev = model.device
        with torch.cuda.device(dev):
            got = predict_labels(model, rows.to(dev, non_blocking=True), impl=self._impl)
            labels.copy_(got, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return _InFlight(labels, event)

    def _earliest_deadline_locked(self) -> float | None:
        dls = [e[3] for e in self._pending if e[3] is not None]
        return min(dls) if dls else None

    def _purge_expired_locked(self) -> None:
        """Shed pending requests whose deadline passed (caller holds the
        lock): the ticket is marked dead and its undispatched rows dropped;
        in-flight slices of a shed ticket resolve into the void."""
        if self._earliest_deadline_locked() is None:
            return
        now = time.monotonic()
        kept: deque = deque()
        shed = False
        for ticket, x, off, dl in self._pending:
            if dl is None or now < dl:
                kept.append((ticket, x, off, dl))
                continue
            shed = True
            self._pending_rows -= x.shape[0]
            self._dead[ticket] = f"deadline expired with {x.shape[0]} rows undispatched"
            self._need.pop(ticket, None)
            self._parts.pop(ticket, None)
            self._unresolved -= 1
        if shed:
            self._pending = kept
            self._cv.notify_all()

    def _pop_rows_locked(self):
        """Take up to ``max_batch`` live pending rows (caller holds the lock);
        expired requests are shed first, never launched."""
        self._purge_expired_locked()
        n_real = min(self._pending_rows, self.max_batch)
        rows, slices, need = [], [], n_real
        while need:
            ticket, x, off, dl = self._pending.popleft()
            take = min(need, x.shape[0])
            rows.append(x[:take])
            slices.append((ticket, off, take))
            if take < x.shape[0]:
                self._pending.appendleft((ticket, x[take:], off + take, dl))
            need -= take
        self._pending_rows -= n_real
        return rows, slices, n_real

    def _launch(self, rows, slices, n_real):
        """Assemble and launch one microbatch (outside the lock)."""
        pad_to = pad_bucket(n_real, self.buckets)
        version, model = self._current()
        staged, labels = self._stage(model, pad_to)
        xb = staged.numpy()
        pos = 0
        for r in rows:
            xb[pos:pos + r.shape[0]] = r
            pos += r.shape[0]
        xb[pos:] = 0.0                           # pad rows
        t0 = time.perf_counter()
        return self._score(model, staged, labels), slices, n_real, pad_to, version, t0

    def _resolve(self, inflight) -> None:
        """Wait for one launch, scatter its labels, resolve finished tickets."""
        pending, slices, n_real, pad_to, version, t0 = inflight
        labels = pending.result()
        lat = time.perf_counter() - t0
        parts_by_slice = []
        pos = 0
        for ticket, off, take in slices:
            parts_by_slice.append(labels[pos:pos + take])
            pos += take
        with self._cv:
            self.latencies_s.append(lat)
            _bump(self.stats, pad_to, n_real)
            if version is not None:
                self.stats["versions"][version] = self.stats["versions"].get(version, 0) + 1
            for (ticket, off, take), part in zip(slices, parts_by_slice):
                if ticket in self._dead:
                    continue   # shed mid-flight — drop its labels
                parts = self._parts[ticket]
                parts.append((off, part))
                if sum(p[1].shape[0] for p in parts) == self._need[ticket]:
                    parts.sort(key=lambda p: p[0])
                    self._done[ticket] = (parts[0][1] if len(parts) == 1
                                          else np.concatenate([p[1] for p in parts]))
                    self._need.pop(ticket)
                    self._parts.pop(ticket)
                    self._unresolved -= 1
            self._cv.notify_all()

    def _dispatch_loop(self) -> None:
        inflight = None
        try:
            while True:
                batch = None
                with self._cv:
                    # dispatchable: a full batch pends, or someone waits on a
                    # result (take/drain/close)
                    def dispatchable():
                        return self._pending_rows and (
                            self._pending_rows >= self.max_batch
                            or self._waiters or self._stop)
                    while not dispatchable() and not self._stop and inflight is None:
                        self._cv.wait()
                    if self._stop and not self._pending_rows and inflight is None:
                        return
                    if dispatchable():
                        batch = self._pop_rows_locked()
                # launch the NEXT microbatch before waiting on the previous one
                # (a purge can shed every pending row)
                launched = self._launch(*batch) if batch is not None and batch[2] else None
                if inflight is not None:
                    self._resolve(inflight)
                inflight = launched
        except BaseException as e:  # noqa: BLE001 — surfaced to callers
            with self._cv:
                self._error = e
                self._cv.notify_all()


def ragged_trace_sizes(total_rows: int, max_batch: int, rng) -> list[int]:
    """A deterministic ragged request-size trace summing to ``total_rows``
    (sizes drawn in [1, max_batch] from the caller's ``rng``)."""
    sizes, left = [], total_rows
    while left:
        s = int(min(left, rng.integers(1, max_batch + 1)))
        sizes.append(s)
        left -= s
    return sizes


def drive_trace(model, req_x, sizes, *, max_batch: int = 256, min_bucket: int = 8,
                impl: str = "auto", predict_fn=None, queue: str = "sync") -> dict:
    """Push one request trace through a fresh warmed queue and measure it.

    Submits ``sizes``-shaped requests from ``req_x`` in order, drains,
    ASSERTS the labels are bitwise one direct ``predict_labels`` call (with a
    ``ModelBank``, on its current model only), and returns rows/s, p50/p99
    microbatch latency and the queue's stats, with ``pad_waste_frac`` and
    per-bucket ``bucket_occupancy``.  For a model on the card it also
    reports what the live trace cost after the warm-up:
    ``live_library_loads`` (kernel libraries loaded, so built) and
    ``live_reserved_bytes`` (growth of ``torch.cuda.memory_reserved``).
    ``queue="async"`` drives an ``AsyncBatchQueue`` instead of a
    ``BatchQueue``."""
    bank = model if isinstance(model, ModelBank) else None
    if queue == "async":
        q = AsyncBatchQueue(model, max_batch=max_batch, min_bucket=min_bucket, impl=impl,
                            predict_fn=predict_fn)
    elif queue == "sync":
        if bank is not None:
            raise ValueError("queue='sync' needs a fixed ServeModel")
        q = BatchQueue(model, max_batch=max_batch, min_bucket=min_bucket, impl=impl,
                       predict_fn=predict_fn)
    else:
        raise ValueError(f"queue={queue!r}: expected 'sync' or 'async'")
    live = (bank.current()[1] if bank is not None else model)
    on_card = live.device.type == "cuda"
    try:
        q.warmup()
        if on_card:
            torch.cuda.synchronize(live.device)
            libs, reserved = _build.loaded(), torch.cuda.memory_reserved(live.device)
        t0 = time.perf_counter()
        tickets, off = [], 0
        for s in sizes:
            tickets.append(q.submit(req_x[off:off + s]))
            off += s
        q.drain()
        labels = np.concatenate([q.take(t) for t in tickets]) if tickets else \
            np.zeros((0,), live.label_dtype)
        wall = time.perf_counter() - t0
        if on_card:
            live_cost = {"live_library_loads": _build.loaded() - libs,
                         "live_reserved_bytes": torch.cuda.memory_reserved(live.device) - reserved}
    finally:
        if queue == "async":
            q.close()
    if bank is None:
        direct = _host_labels(predict_labels(model, req_x[:off], impl=impl))
        assert (labels == direct).all(), "queue/direct parity violated"
    lat = np.asarray(q.latencies_s)
    padded = q.stats["padded_rows"]
    occupancy = {b: round(q.stats["bucket_real_rows"].get(b, 0) / (n * b), 4)
                 for b, n in sorted(q.stats["bucket_counts"].items())}
    out = {
        "rows": off, "requests": len(sizes), "queue": queue,
        "bank_dtype": str((bank.current()[1] if bank is not None else model).sv_x.dtype
                          ).removeprefix("torch."),
        "rows_per_s": round(off / wall, 1),
        "microbatches": q.stats["microbatches"],
        "padded_rows": padded,
        "pad_waste_frac": round(padded / (off + padded), 4) if off else 0.0,
        "bucket_counts": q.stats["bucket_counts"],
        "bucket_occupancy": occupancy,
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3) if lat.size else 0.0,
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3) if lat.size else 0.0,
    }
    if on_card:
        out.update(live_cost)
    if queue == "async" and q.stats["versions"]:
        out["versions"] = {int(k): v for k, v in q.stats["versions"].items()}
    return out


# ---------------------------------------------------------------------------
# Checkpoint -> ServeModel
# ---------------------------------------------------------------------------

_STATE_LEAVES = ("sv_x", "alpha", "count", "step", "n_inserts", "n_merges")


def load_serve_model(ckpt_dir: str, gamma, *, step: int | None = None, bank_dtype=None,
                     device=None) -> ServeModel:
    """Export a ``ServeModel`` straight from a training checkpoint.

    Any checkpoint in ``repro.checkpoint``'s format whose tree carries an
    ``SVMState`` under ``state`` (what the streaming trainers write, in
    either package) serves; the other leaves are ignored.  The state
    template is rebuilt from the manifest's recorded shapes and dtypes, so
    no training config is needed; binary or multiclass follows the bank's
    rank.  ``gamma`` is not checkpointed: pass the training value.  The
    model lives on ``device`` (default the card)."""
    from .. import checkpoint as ckpt

    dev = resolve_device(device)
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise ValueError(f"{ckpt_dir}: no complete checkpoint found")
    manifest = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    try:
        with open(manifest) as f:
            leaves = json.load(f).get("leaves")
    except FileNotFoundError:
        raise ValueError(f"{ckpt_dir}: step {step} has no manifest — not a complete "
                         "checkpoint") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"{ckpt_dir}: step {step} manifest is corrupt ({e})") from None
    if not isinstance(leaves, dict):
        raise ValueError(f"{ckpt_dir}: step {step} manifest records no leaves — not a "
                         "checkpoint this library wrote")
    missing = [f"state/{k}" for k in _STATE_LEAVES if f"state/{k}" not in leaves]
    if missing:
        raise ValueError(f"{ckpt_dir}: step {step} is not an SVM training checkpoint "
                         f"(missing leaves {missing})")

    def spec(name):
        leaf = leaves[f"state/{name}"]
        return ckpt.ShapeDtype(tuple(leaf["shape"]), getattr(torch, leaf["dtype"]))

    template = SVMState(*(spec(k) for k in _STATE_LEAVES),
                        kmat=spec("kmat") if "state/kmat" in leaves else None)
    state = ckpt.load(ckpt_dir, step, {"state": template}, device=dev)["state"]
    return export_model(state, gamma, bank_dtype=bank_dtype)
