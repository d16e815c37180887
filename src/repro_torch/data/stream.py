"""Chunked host-side data pipeline for out-of-core (streaming) training.

Counterpart of ``repro.data.stream`` (numpy only).  The budgeted state is the
only thing that must stay resident during BSGD training (Zhao et al. 2012;
Picard 2018): the data itself can stream.  This module is the host side of
that: *chunk sources* exposing a dataset as ``n_chunks`` independently-loadable
``(x, y)`` numpy blocks, and the deterministic shuffle used by the streaming
trainers in ``core.bsgd`` / ``core.multiclass``.

Chunk sources (all share the same small interface: ``n_chunks``,
``chunk_lens``, ``n_rows``, ``dim``, ``load(i) -> (x, y)``, iteration):

  * ``ArrayChunks``  — view over in-memory arrays (no copy until a chunk is
    loaded);
  * ``FileChunks``   — sharded ``.npz`` files (keys ``x``/``y``) or
    ``(x.npy, y.npy)`` path pairs, one shard per chunk; only the shard being
    trained on is ever resident (``write_npz_chunks`` is the writer);
  * ``LibsvmChunks`` — incremental ``parse_libsvm`` straight from a LIBSVM
    text file: init scans the file once recording chunk byte offsets (and the
    feature count if not given), ``load(i)`` seeks and parses one chunk.

Deterministic shuffle contract (DESIGN.md §9): an epoch's order is the
composition of a *chunk-order* permutation and one *intra-chunk* permutation
per chunk, both derived from the epoch key: ``chunk_order(key, n_chunks)``
and ``intra_perm(key, chunk_id, len)``.  Intra-chunk permutations are keyed
by chunk *id*, not stream position, so the realized global row order
(``epoch_permutation``) depends only on the key.  This is what makes streamed
training reproducible, resumable from a chunk cursor, and comparable
row-for-row against the in-memory ``train_epoch``.

The key is the port's own: an ``EpochKey(seed, epoch)`` draws both
permutations from numpy with the reference's ``fold_in`` structure (stream 0
the chunk order, stream ``1 + chunk_id`` each chunk's rows).  The reference
draws them from ``jax.random``, which the port cannot reproduce, so a
streamed run equals the reference's only when its orders are passed in: any
object with ``chunk_order(n)`` and ``intra_perm(chunk_id, n)`` methods serves
as a key.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .libsvm import parse_libsvm


class ChunkSource:
    """Base chunk source: a dataset as independently-loadable (x, y) blocks.

    Subclasses populate ``chunk_lens`` (rows per chunk) and ``dim`` in
    ``__init__`` and implement ``load(i)``.  Iterating yields chunks in
    natural order; shuffled iteration is the trainers' job (``chunk_order`` /
    ``intra_perm``).
    """

    chunk_lens: list[int]
    dim: int

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_lens)

    @property
    def n_rows(self) -> int:
        return int(sum(self.chunk_lens))

    def load(self, i: int):
        """Return chunk ``i`` as ``(x (rows, dim) float32, y (rows,))``."""
        raise NotImplementedError

    def __iter__(self):
        for i in range(self.n_chunks):
            yield self.load(i)

    def chunk_offsets(self) -> np.ndarray:
        """Global row id of each chunk's first row; shape (n_chunks + 1,)."""
        return np.concatenate([[0], np.cumsum(self.chunk_lens)]).astype(np.int64)


class ArrayChunks(ChunkSource):
    """In-memory arrays viewed as ``ceil(n / chunk_rows)`` chunks (no copy)."""

    def __init__(self, x, y, chunk_rows: int):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows={chunk_rows} < 1")
        self.x, self.y = np.asarray(x), np.asarray(y)
        if self.x.shape[0] != self.y.shape[0]:
            raise ValueError(f"x rows {self.x.shape[0]} != y rows "
                             f"{self.y.shape[0]}")
        n = self.x.shape[0]
        self.chunk_rows = chunk_rows
        self.chunk_lens = [min(chunk_rows, n - s)
                           for s in range(0, n, chunk_rows)]
        self.dim = int(self.x.shape[1])

    def load(self, i: int):
        s = i * self.chunk_rows
        e = s + self.chunk_lens[i]
        return self.x[s:e], self.y[s:e]


class FileChunks(ChunkSource):
    """Sharded on-disk chunks: ``.npz`` paths (keys x/y) or (x.npy, y.npy)
    pairs, one shard per chunk; only one shard is resident at a time.

    Init reads each shard's ``y`` (tiny) for the chunk lengths and each
    shard's ``x`` .npy *header* for row/dim validation — the feature blocks
    stay on disk until ``load``.
    """

    def __init__(self, paths):
        if not paths:
            raise ValueError("FileChunks needs at least one shard path")
        self.paths = list(paths)
        self.chunk_lens = []
        self.dim = None
        for p in self.paths:
            _, y = self._read(p, y_only=True)
            x_shape = self._x_shape(p)      # header only, no data read
            if x_shape[0] != y.shape[0]:
                raise ValueError(f"{p}: x rows {x_shape[0]} != y rows "
                                 f"{y.shape[0]}")
            if self.dim is None:
                self.dim = int(x_shape[1])
            elif x_shape[1] != self.dim:
                raise ValueError(f"{p}: dim {x_shape[1]} != {self.dim}")
            self.chunk_lens.append(int(y.shape[0]))

    @staticmethod
    def _npy_shape(f) -> tuple:
        """Shape from an open .npy stream's header alone (no data read)."""
        from numpy.lib import format as npfmt

        ver = npfmt.read_magic(f)
        hdr = (npfmt.read_array_header_1_0 if ver == (1, 0)
               else npfmt.read_array_header_2_0)
        return hdr(f)[0]

    @classmethod
    def _x_shape(cls, p) -> tuple:
        if isinstance(p, (tuple, list)):
            with open(p[0], "rb") as f:
                return cls._npy_shape(f)
        import zipfile

        with zipfile.ZipFile(p) as z, z.open("x.npy") as f:
            return cls._npy_shape(f)

    @staticmethod
    def _read(p, *, y_only: bool = False):
        if isinstance(p, (tuple, list)):
            xp, yp = p
            y = np.load(yp, mmap_mode="r" if y_only else None)
            if y_only:
                return None, y
            return np.asarray(np.load(xp)), np.asarray(y)
        with np.load(p) as z:
            if y_only:
                return None, z["y"]
            return z["x"], z["y"]

    def load(self, i: int):
        x, y = self._read(self.paths[i])
        return np.asarray(x), np.asarray(y)


class LibsvmChunks(ChunkSource):
    """Incremental LIBSVM parsing: chunk byte offsets scanned once at init,
    ``load(i)`` seeks and parses ``chunk_rows`` lines with O(chunk) memory.

    ``n_features`` fixes the feature dimension across chunks (a chunk that
    happens to omit the trailing features must still produce full-width
    rows); when None, the init scan infers it from the whole file.
    ``binary`` follows ``parse_libsvm``: True maps labels to {-1, +1} by
    sign, False keeps raw (multi-class) labels.
    """

    def __init__(self, path: str, chunk_rows: int, n_features: int | None = None,
                 *, binary: bool = True):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows={chunk_rows} < 1")
        self.path, self.binary = path, binary
        self._offsets = [0]          # byte offset of each chunk's first line
        self.chunk_lens = []
        rows_in_chunk = 0
        n_rows = 0
        max_idx = 0
        pos = 0
        with open(path, "rb") as f:
            for line in f:
                pos += len(line)
                if not line.strip():
                    continue
                n_rows += 1
                rows_in_chunk += 1
                if n_features is None:
                    for tok in line.split()[1:]:
                        max_idx = max(max_idx, int(tok.split(b":")[0]))
                if rows_in_chunk == chunk_rows:
                    self.chunk_lens.append(rows_in_chunk)
                    self._offsets.append(pos)
                    rows_in_chunk = 0
        if rows_in_chunk:
            self.chunk_lens.append(rows_in_chunk)
            self._offsets.append(pos)
        if not self.chunk_lens:
            raise ValueError(f"{path}: no data rows")
        self.n_features = n_features if n_features is not None else max_idx
        self.dim = int(self.n_features)

    def load(self, i: int):
        start, end = self._offsets[i], self._offsets[i + 1]
        with open(self.path, "rb") as f:
            f.seek(start)
            blob = f.read(end - start)
        lines = blob.decode("utf-8").splitlines()
        return parse_libsvm(lines, n_features=self.n_features,
                            binary=self.binary)


class DriftChunks(ChunkSource):
    """Non-stationary view over any ``ChunkSource`` (zero-copy until load).

    Applies a drift schedule per chunk as the stream plays out — the online
    suite's data layer (DESIGN.md §15).  Two independent schedule kinds, any
    combination:

      * ``flip``  — ``(n_chunks,)`` per-chunk label-flip probabilities
        (``synthetic.label_flip_schedule``).  A flipped binary label
        negates; with ``n_classes`` set, a flipped class id rotates to
        ``(y + 1) % n_classes`` — both keep the label alphabet intact;
      * ``shift`` — ``(n_chunks, dim)`` additive input shifts
        (``synthetic.mean_shift_schedule``): covariate drift, labels
        untouched.

    Deterministic BY CONSTRUCTION: the rows flipped in chunk ``i`` are drawn
    from ``default_rng((seed, i))``, a pure function of ``(seed, chunk id)``
    — loading a chunk twice (or out of order, or under prefetch) yields
    bitwise-identical blocks, which is what makes single-pass regret
    reproducible (tests/test_torch_online.py checks it).
    Chunks are visited in natural order by the prequential driver; shuffling
    a drifted stream would average the schedule away.
    """

    def __init__(self, source: ChunkSource, *, flip=None, shift=None,
                 n_classes: int | None = None, seed: int = 0):
        if flip is None and shift is None:
            raise ValueError("DriftChunks without flip or shift is the "
                             "identity — pass at least one schedule")
        self.source = source
        self.chunk_lens = source.chunk_lens
        self.dim = source.dim
        self.n_classes = n_classes
        self.seed = int(seed)
        self.flip = None if flip is None else np.asarray(flip, np.float32)
        if self.flip is not None and self.flip.shape != (source.n_chunks,):
            raise ValueError(f"flip shape {self.flip.shape} != "
                             f"({source.n_chunks},) — one prob per chunk")
        self.shift = None if shift is None else np.asarray(shift, np.float32)
        if self.shift is not None and \
                self.shift.shape != (source.n_chunks, source.dim):
            raise ValueError(f"shift shape {self.shift.shape} != "
                             f"({source.n_chunks}, {source.dim})")

    def load(self, i: int):
        x, y = self.source.load(i)
        x, y = np.asarray(x), np.asarray(y)
        if self.shift is not None and self.shift[i].any():
            x = x + self.shift[i].astype(x.dtype)
        if self.flip is not None and self.flip[i] > 0:
            rng = np.random.default_rng((self.seed, int(i)))
            m = rng.random(y.shape[0]) < self.flip[i]
            if self.n_classes is not None:
                y = np.where(m, (y + 1) % self.n_classes, y).astype(y.dtype)
            else:
                y = np.where(m, -y, y).astype(y.dtype)
        return x, y


class PrefetchChunks(ChunkSource):
    """Background-thread readahead over any ``ChunkSource``.

    Keeps up to ``depth`` chunks loaded (parsed, in host memory) ahead of the
    consumer along a declared *plan* — the iteration order, which is exactly
    what ``load`` hides for the out-of-core sources: ``FileChunks`` pays a
    disk read and ``LibsvmChunks`` a pure-Python parse per chunk, both of
    which the wrapper overlaps with whatever the consumer does with chunk
    *i* while the worker readies *i+1*.

    ``plan(order)`` declares the upcoming load order and starts the worker;
    ``load(i)`` returns the staged block when ``i`` is planned (scheduling
    more readahead) and falls back to a synchronous load otherwise, so the
    wrapper is a drop-in ``ChunkSource`` even off-plan.  A ``load()`` that
    raised on the worker re-raises on the *caller's* thread (the future
    carries it) — the worker itself never hangs or dies silently.
    ``iter_epoch(prefetch=depth)`` wraps and plans automatically; the
    streaming trainers go further and stage whole assembled minibatch blocks
    (``bsgd._stage_chunks``).

    Teardown: ``cancel()`` drops the plan without waiting (the mid-epoch
    re-plan path); ``close()`` additionally JOINS the worker, guaranteeing
    no ``prefetch-*`` thread survives the call — ``iter_epoch`` closes its
    wrapper on every exit path (exhaustion, a consumer raise, or the
    generator being dropped and finalized), and ``__del__`` backstops a
    wrapper that is GC'd while planned, so an abandoned epoch can never
    strand the worker (tests/test_torch_stream_data.py checks it).
    """

    def __init__(self, source: ChunkSource, depth: int = 2, *, retry=None,
                 report=None):
        self._pool = None                    # first: __del__ may run on a
        if depth < 1:                        # partially-initialized instance
            raise ValueError(f"depth={depth} < 1")
        self.source = source
        self.depth = depth
        self.retry = retry                   # faults.RetryPolicy: loads (on
        self.report = report                 # the worker AND off-plan) retry
        self.chunk_lens = source.chunk_lens  # with backoff, quarantining on
        self.dim = source.dim                # exhaustion (DESIGN.md §16)
        self._futs: dict[int, object] = {}   # chunk id -> Future
        self._plan: list[int] = []           # upcoming ids, front first

    def plan(self, order) -> None:
        """Declare the upcoming load order; readahead follows it."""
        self.cancel()
        self._plan = [int(c) for c in order]
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="prefetch")
        self._fill()

    def cancel(self, wait: bool = False) -> None:
        """Drop the plan and stop the worker (idempotent); ``wait=True``
        joins the worker thread before returning."""
        self._plan = []
        self._futs.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=wait, cancel_futures=True)
            self._pool = None

    def close(self) -> None:
        """Tear down for good: cancel AND join the worker (idempotent)."""
        self.cancel(wait=True)

    def __del__(self):
        try:
            self.cancel()                    # no join inside the GC
        except Exception:                    # noqa: BLE001 — interpreter
            pass                             # shutdown half-torn state

    def _fill(self) -> None:
        while self._plan and len(self._futs) < self.depth:
            cid = self._plan.pop(0)
            self._futs[cid] = self._pool.submit(self._load_one, cid)

    def _load_one(self, cid: int):
        """One (possibly retried) source load — the worker's task body and
        the off-plan synchronous fallback share it, so retry/backoff runs on
        whichever thread performs the load."""
        if self.retry is None:
            return self.source.load(cid)
        from .faults import load_chunk_with_retry

        return load_chunk_with_retry(self.source, cid, self.retry,
                                     report=self.report,
                                     expected_rows=self.chunk_lens[cid],
                                     dim=self.dim)

    def load(self, i: int):
        fut = self._futs.pop(int(i), None)
        if fut is None:                      # off-plan: synchronous fallback
            return self._load_one(int(i))
        self._fill()                         # keep the window full
        return fut.result()                  # re-raises worker exceptions here


def write_npz_chunks(out_dir: str, x, y, chunk_rows: int, *,
                     prefix: str = "chunk") -> list[str]:
    """Shard (x, y) into ``.npz`` chunk files under ``out_dir``; returns the
    ordered shard paths (feed them to ``FileChunks``)."""
    x, y = np.asarray(x), np.asarray(y)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for c, s in enumerate(range(0, x.shape[0], chunk_rows)):
        p = os.path.join(out_dir, f"{prefix}_{c:05d}.npz")
        np.savez(p, x=x[s:s + chunk_rows], y=y[s:s + chunk_rows])
        paths.append(p)
    return paths


@dataclasses.dataclass(frozen=True)
class EpochKey:
    """The shuffle of one epoch, pure in ``(seed, epoch)``.

    ``chunk_order`` draws from ``default_rng((seed, epoch, 0))`` and chunk
    ``c``'s rows from ``default_rng((seed, epoch, 1 + c))``: the reference's
    ``fold_in(key, 0)`` / ``fold_in(key, 1 + c)`` structure, drawn with numpy.
    """

    seed: int
    epoch: int

    def chunk_order(self, n_chunks: int) -> np.ndarray:
        return np.random.default_rng((self.seed, self.epoch, 0)).permutation(n_chunks)

    def intra_perm(self, chunk_id: int, n: int) -> np.ndarray:
        return np.random.default_rng((self.seed, self.epoch, 1 + int(chunk_id))).permutation(n)


def chunk_order(key, n_chunks: int) -> np.ndarray:
    """The epoch's chunk-order permutation (position -> chunk id); ``key`` is
    an ``EpochKey`` or any object with its two methods."""
    return np.asarray(key.chunk_order(n_chunks))


def intra_perm(key, chunk_id: int, n: int) -> np.ndarray:
    """The intra-chunk row permutation for chunk ``chunk_id`` (keyed by id,
    not stream position: the realized order depends only on the key)."""
    return np.asarray(key.intra_perm(int(chunk_id), n))


def epoch_permutation(source: ChunkSource, key) -> np.ndarray:
    """The global row order one shuffled streamed epoch realizes.

    Feeding this to the in-memory ``train_epoch`` reproduces the streamed
    pass row-for-row (tests/test_torch_stream_train.py checks it).
    ``key=None`` is the natural (unshuffled) order.
    """
    offs = source.chunk_offsets()
    if key is None:
        return np.arange(source.n_rows, dtype=np.int64)
    order = chunk_order(key, source.n_chunks)
    parts = [offs[c] + intra_perm(key, int(c), source.chunk_lens[c])
             for c in order]
    return np.concatenate(parts).astype(np.int64)


def iter_epoch(source: ChunkSource, key=None, *, start_chunk: int = 0,
               end_chunk: int | None = None, prefetch: int = 0,
               retry=None, report=None, skip_chunks=()):
    """Yield ``(position, x, y)`` chunks for one epoch in shuffled order.

    ``key`` derives both permutations of the shuffle contract (None = natural
    order); ``start_chunk`` skips already-trained stream positions — the
    resume path (checkpoint cursor) of the streaming trainers — and
    ``end_chunk`` stops before that position (exclusive; chunks past it are
    never read from the source).  ``prefetch > 0`` reads ahead that many
    chunks on a background thread (``PrefetchChunks`` along the epoch's
    realized order) — the yielded blocks are bitwise identical to the
    synchronous path, chunk ``i+1``'s load just overlaps the consumer's work
    on chunk ``i``.  A source that is already a ``PrefetchChunks`` is planned
    directly (no double wrap).

    Resilience (DESIGN.md §16): ``retry`` (a ``faults.RetryPolicy``) retries
    transient load failures with bounded backoff — on the prefetch worker
    when one is planned, else inline — and QUARANTINES a chunk that exhausts
    its budget: the chunk is skipped (its position yields nothing), recorded
    in ``report`` (a ``faults.ResilienceReport``), and the epoch continues.
    ``skip_chunks`` (chunk *ids*) are excluded up front as if they never
    existed — the construction used to prove that quarantine leaves the
    surviving sequence bitwise identical.  With ``retry=None`` (default) the
    path is exactly the pre-resilience one: any load failure propagates.
    """
    skip = frozenset(int(c) for c in skip_chunks)
    order = (chunk_order(key, source.n_chunks) if key is not None
             else np.arange(source.n_chunks))
    end = source.n_chunks if end_chunk is None else min(end_chunk,
                                                        source.n_chunks)
    planned = None
    if prefetch and not isinstance(source, PrefetchChunks):
        source = PrefetchChunks(source, depth=prefetch, retry=retry,
                                report=report)
    if isinstance(source, PrefetchChunks):
        source.plan([c for c in order[start_chunk:end] if int(c) not in skip])
        planned = source
    # retried loads: on the planned worker (its own retry/report), or inline
    worker_retries = planned is not None and source.retry is not None
    resilient = retry is not None or worker_retries
    if resilient:
        from .faults import ChunkQuarantined, load_chunk_with_retry
    try:
        for pos in range(start_chunk, end):
            cid = int(order[pos])
            if cid in skip:
                continue
            try:
                if retry is not None and not worker_retries:
                    x, y = load_chunk_with_retry(
                        source, cid, retry, report=report,
                        expected_rows=source.chunk_lens[cid], dim=source.dim)
                else:
                    x, y = source.load(cid)
            except Exception as e:  # noqa: BLE001 — quarantine-only filter
                if not (resilient and isinstance(e, ChunkQuarantined)):
                    raise
                if report is not None:
                    report.note_quarantine(e)
                continue                 # skip: surviving sequence unchanged
            if key is not None:
                p = intra_perm(key, cid, x.shape[0])
                x, y = x[p], y[p]
            yield pos, x, y
    finally:
        if planned is not None:
            planned.close()              # abandoned epochs leave no worker:
                                         # close() joins, and generator
                                         # finalization (GC'd or consumer
                                         # raise) runs this same branch
