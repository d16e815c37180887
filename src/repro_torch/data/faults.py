"""Deterministic fault injection + the ingest resilience primitives.

The port's own copy of ``repro.data.faults`` (numpy only).  Every schedule
is pure in ``(seed, chunk_id)``, so a schedule resolves to the same faults
in both packages.

Production streams are not clean: loaders throw transient IO errors, chunks
arrive truncated or with non-finite rows, and whole shards go bad.  This
module makes those failures a first-class, *injectable*, reproducible input
(DESIGN.md §16):

  * ``FaultSchedule`` — a seeded per-chunk fault plan.  Like ``DriftChunks``,
    every decision is a pure function of ``(seed, chunk_id)`` (drawn from
    ``np.random.default_rng((seed, chunk_id))``), so prefetched /
    out-of-order / repeated loads reproduce bitwise and a resumed run replays
    the exact same faults;
  * ``FaultyChunks`` — a drop-in ``ChunkSource`` wrapper that executes the
    schedule: transient ``TransientIOError``s for the first N attempts,
    stalls, truncated first reads, deterministic NaN/Inf row poisoning,
    persistent ``CorruptChunkError``s (quarantine drill) and a crash-once
    ``TrainerCrash`` (supervisor drill).  Attempt counters are thread-safe —
    the prefetch worker and the consumer may both load;
  * ``RetryPolicy`` + ``load_chunk_with_retry`` — bounded exponential
    backoff with transient-vs-fatal classification and a per-chunk attempt
    budget.  A chunk that exhausts its budget (or raises a fatal-but-
    quarantinable error) raises ``ChunkQuarantined``; the streaming drivers
    catch it, SKIP the chunk, and record it — one bad shard never kills an
    epoch.  The loader also validates chunk geometry against the source's
    advertised ``chunk_lens``/``dim``, so a torn/truncated read surfaces as
    a retryable ``TruncatedChunkError`` instead of a silent short batch;
  * ``ResilienceReport`` — a thread-safe tally of retries, recoveries,
    quarantines, guard rollbacks and trainer restarts, shared across the
    ingest, training and supervisor layers of one run.

Quarantine preserves the surviving sequence bitwise: a quarantined chunk
contributes no rows and its stream position is simply skipped, so the
realized batch sequence of the surviving chunks is identical to a run where
those chunks never existed (``iter_epoch(skip_chunks=...)`` constructs that
comparison run; tests/test_torch_stream_train.py holds the port to it).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from .stream import ChunkSource


class TransientIOError(IOError):
    """An injected (or genuinely flaky) IO failure that a retry may clear."""


class TruncatedChunkError(IOError):
    """A chunk came back with the wrong geometry (short rows / wrong dim).

    Raised by the retry loader's validation, not by sources themselves — a
    truncated read (e.g. a file caught mid-write) often succeeds on re-read,
    so this classifies as transient.
    """


class CorruptChunkError(ValueError):
    """Persistent, unrecoverable chunk corruption — not worth retrying.

    The retry policy classifies this as quarantinable: the chunk is skipped
    immediately (no backoff attempts burned) and reported.
    """


class TrainerCrash(RuntimeError):
    """An injected hard crash (neither transient nor quarantinable).

    Propagates through the retry layer and kills the epoch — the fault kind
    that exercises the serve supervisor's restart-from-checkpoint path.
    ``FaultyChunks`` raises it only on a chunk's FIRST in-process load
    attempt, so a restarted trainer gets past it.
    """


class ChunkQuarantined(RuntimeError):
    """A chunk exhausted its retry budget (or corrupted persistently).

    The streaming drivers catch this, skip the chunk, and record it in the
    run's ``ResilienceReport`` — quarantine is a skip, never a crash.
    """

    def __init__(self, chunk_id: int, attempts: int, cause: BaseException):
        self.chunk_id = int(chunk_id)
        self.attempts = int(attempts)
        self.cause = cause
        super().__init__(f"chunk {chunk_id} quarantined after {attempts} "
                         f"attempt(s): {cause!r}")


@dataclasses.dataclass(frozen=True)
class ChunkFaults:
    """The resolved fault plan for ONE chunk (see ``FaultSchedule.for_chunk``)."""

    io_attempts: int = 0     # first N load attempts raise TransientIOError
    stall_s: float = 0.0     # sleep injected into the first attempt
    truncate: bool = False   # first otherwise-successful read comes back short
    nan: bool = False        # deterministic NaN/Inf rows poison the data
    fatal: bool = False      # EVERY attempt raises CorruptChunkError
    crash: bool = False      # first in-process attempt raises TrainerCrash

    @property
    def any(self) -> bool:
        return bool(self.io_attempts or self.stall_s or self.truncate
                    or self.nan or self.fatal or self.crash)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded, per-chunk fault plan — pure in ``(seed, chunk_id)``.

    Probabilistic knobs (``p_*``) draw one uniform per fault kind from
    ``np.random.default_rng((seed, chunk_id))`` in a FIXED order, and the
    explicit ``*_chunks`` tuples force a fault on named chunk ids regardless
    of the draw.  Because nothing depends on load order or attempt history,
    the schedule reproduces bitwise under prefetch, out-of-order loads and
    kill-and-resume (the same determinism contract as ``DriftChunks``).

    ``fatal_chunks`` and ``crash_chunks`` are explicit-only: persistent
    corruption and hard crashes are targeted drills, not background noise.
    """

    seed: int = 0
    p_io: float = 0.0          # P(chunk's first io_attempts loads fail)
    io_attempts: int = 1       # consecutive failing attempts for an io fault
    p_stall: float = 0.0       # P(first attempt sleeps stall_s)
    stall_s: float = 0.002
    p_truncate: float = 0.0    # P(first good read returns a short chunk)
    p_nan: float = 0.0         # P(chunk data carries NaN/Inf rows)
    nan_rows: int = 4          # poisoned rows per NaN chunk
    io_chunks: tuple = ()
    stall_chunks: tuple = ()
    truncate_chunks: tuple = ()
    nan_chunks: tuple = ()
    fatal_chunks: tuple = ()   # persistent CorruptChunkError -> quarantine
    crash_chunks: tuple = ()   # crash-once TrainerCrash -> supervisor drill

    def for_chunk(self, chunk_id: int) -> ChunkFaults:
        """Resolve the plan for one chunk (pure in ``(seed, chunk_id)``)."""
        i = int(chunk_id)
        rng = np.random.default_rng((self.seed, i))
        draw = rng.random(4)                 # io, stall, truncate, nan
        return ChunkFaults(
            io_attempts=(self.io_attempts
                         if (i in self.io_chunks or draw[0] < self.p_io)
                         else 0),
            stall_s=(self.stall_s
                     if (i in self.stall_chunks or draw[1] < self.p_stall)
                     else 0.0),
            truncate=(i in self.truncate_chunks or draw[2] < self.p_truncate),
            nan=(i in self.nan_chunks or draw[3] < self.p_nan),
            fatal=i in self.fatal_chunks,
            crash=i in self.crash_chunks)

    @staticmethod
    def chaos(seed: int = 0, *, nan_chunk: int = 2,
              crash_chunk: int | None = None,
              fatal_chunk: int | None = None) -> "FaultSchedule":
        """The demo/CI chaos mix: background transient IO errors, stalls and
        truncations, one NaN chunk, and (optionally) one quarantined shard +
        one crash-once chunk for the supervisor drill."""
        return FaultSchedule(
            seed=seed, p_io=0.2, io_attempts=1, p_stall=0.1, stall_s=0.002,
            p_truncate=0.1, nan_chunks=(nan_chunk,),
            fatal_chunks=() if fatal_chunk is None else (fatal_chunk,),
            crash_chunks=() if crash_chunk is None else (crash_chunk,))


class FaultyChunks(ChunkSource):
    """Execute a ``FaultSchedule`` over any ``ChunkSource`` (drop-in wrapper).

    Data-level faults (NaN/Inf rows) are pure in ``(seed, chunk_id)`` —
    loading a poisoned chunk twice yields bitwise-identical blocks.  Attempt-
    level faults (transient IO, stalls, truncation, crash-once) consult a
    thread-safe per-chunk attempt counter, which is what makes them
    *transient*: the injected error clears after ``io_attempts`` retries.
    ``chunk_lens``/``dim`` mirror the wrapped source (truncation deliberately
    violates them — that is how the retry validator catches it).
    """

    def __init__(self, source: ChunkSource, schedule: FaultSchedule):
        self.source = source
        self.schedule = schedule
        self.chunk_lens = source.chunk_lens
        self.dim = source.dim
        self._lock = threading.Lock()
        self._attempts: dict[int, int] = {}

    def attempts(self, i: int) -> int:
        """In-process load attempts made against chunk ``i`` so far."""
        with self._lock:
            return self._attempts.get(int(i), 0)

    def load(self, i: int):
        i = int(i)
        f = self.schedule.for_chunk(i)
        with self._lock:
            attempt = self._attempts.get(i, 0)
            self._attempts[i] = attempt + 1
        if f.crash and attempt == 0:
            raise TrainerCrash(f"injected crash on chunk {i} load")
        if f.fatal:
            raise CorruptChunkError(
                f"injected persistent corruption on chunk {i}")
        if f.stall_s and attempt == 0:
            time.sleep(f.stall_s)
        if attempt < f.io_attempts:
            raise TransientIOError(
                f"injected transient IO failure on chunk {i} "
                f"(attempt {attempt + 1}/{f.io_attempts} failing)")
        x, y = self.source.load(i)
        x, y = np.asarray(x), np.asarray(y)
        if f.nan:
            x = (x.astype(np.float32) if not np.issubdtype(x.dtype, np.floating)
                 else x.copy())
            rng = np.random.default_rng((self.schedule.seed, i, 1))
            n = min(self.schedule.nan_rows, x.shape[0])
            rows = rng.choice(x.shape[0], size=n, replace=False)
            x[rows[: n // 2 + n % 2]] = np.nan
            x[rows[n // 2 + n % 2:]] = np.inf
        if f.truncate and attempt == f.io_attempts:
            # the first read that would otherwise succeed comes back short
            # (a file caught mid-write); the re-read sees the full chunk
            k = max(1, x.shape[0] // 2)
            return x[:k], y[:k]
        return x, y


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-backoff retry with transient-vs-fatal classification.

    ``transient`` exception types are retried up to ``max_attempts`` total
    loads with exponential backoff (``base_delay_s * 2^attempt``, clipped to
    ``max_delay_s``); exhausting the budget raises ``ChunkQuarantined``.
    ``quarantine`` types skip the retries and quarantine immediately
    (corruption that cannot clear).  Anything else — a genuine bug —
    propagates unchanged.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.005
    max_delay_s: float = 0.25
    transient: tuple = (OSError, TimeoutError, ConnectionError)
    quarantine: tuple = (CorruptChunkError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts={self.max_attempts} < 1")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt + 1`` (attempt is 0-based)."""
        return min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)

    def classify(self, exc: BaseException) -> str:
        """``'transient'`` | ``'quarantine'`` | ``'propagate'``."""
        if isinstance(exc, self.quarantine):
            return "quarantine"
        if isinstance(exc, self.transient):
            return "transient"
        return "propagate"


class ResilienceReport:
    """Thread-safe tally of one run's faults and recoveries.

    Shared across the ingest retry layer (possibly on a prefetch worker
    thread), the training guard and the serve supervisor; ``as_dict()`` is
    the JSON-able summary the benchmarks and the live serve driver record.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.retries = 0           # failed attempts that were retried
        self.recovered = []        # (chunk_id, failed_attempts_before_success)
        self.quarantined = []      # (chunk_id, attempts, repr(cause))
        self.rollbacks = []        # stream positions rolled back by the guard
        self.restarts = 0          # supervisor trainer restarts

    def note_retry(self, chunk_id: int) -> None:
        with self._lock:
            self.retries += 1

    def note_recovered(self, chunk_id: int, failed_attempts: int) -> None:
        with self._lock:
            self.recovered.append((int(chunk_id), int(failed_attempts)))

    def note_quarantine(self, q: ChunkQuarantined) -> None:
        with self._lock:
            self.quarantined.append((q.chunk_id, q.attempts, repr(q.cause)))

    def note_rollback(self, pos: int) -> None:
        with self._lock:
            self.rollbacks.append(int(pos))

    def note_restart(self) -> None:
        with self._lock:
            self.restarts += 1

    def quarantined_chunks(self) -> list[int]:
        """Chunk ids skipped by quarantine, in the order they were skipped."""
        with self._lock:
            return [cid for cid, _, _ in self.quarantined]

    def as_dict(self) -> dict:
        with self._lock:
            return {"retries": self.retries,
                    "recovered": list(self.recovered),
                    "quarantined": list(self.quarantined),
                    "rollbacks": list(self.rollbacks),
                    "restarts": self.restarts}

    def __repr__(self):
        d = self.as_dict()
        return (f"ResilienceReport(retries={d['retries']}, "
                f"recovered={len(d['recovered'])}, "
                f"quarantined={len(d['quarantined'])}, "
                f"rollbacks={len(d['rollbacks'])}, "
                f"restarts={d['restarts']})")


def load_chunk_with_retry(source: ChunkSource, chunk_id: int,
                          policy: RetryPolicy, *, report=None,
                          expected_rows: int | None = None,
                          dim: int | None = None, sleep=time.sleep):
    """Load one chunk under ``policy``; the single retry path of the stream.

    Validates the returned geometry against ``expected_rows``/``dim`` (a
    short or mis-shaped chunk raises a retryable ``TruncatedChunkError``).
    Transient failures back off and retry up to ``policy.max_attempts``
    total attempts; exhaustion or a quarantinable error raises
    ``ChunkQuarantined``; anything else propagates.  ``report`` (a
    ``ResilienceReport``) tallies retried attempts and eventual recoveries —
    quarantines are tallied by the CALLER that skips the chunk, so a
    quarantine is counted exactly once however many layers re-raise it.
    """
    cid = int(chunk_id)
    cause = None
    for attempt in range(policy.max_attempts):
        try:
            x, y = source.load(cid)
            x, y = np.asarray(x), np.asarray(y)
            if expected_rows is not None and x.shape[0] != expected_rows:
                raise TruncatedChunkError(
                    f"chunk {cid}: got {x.shape[0]} rows, source advertises "
                    f"{expected_rows} — truncated read")
            if dim is not None and x.ndim == 2 and x.shape[1] != dim:
                raise TruncatedChunkError(
                    f"chunk {cid}: got dim {x.shape[1]}, source advertises "
                    f"{dim}")
            if y.shape[0] != x.shape[0]:
                raise TruncatedChunkError(
                    f"chunk {cid}: x rows {x.shape[0]} != y rows {y.shape[0]}")
            if attempt and report is not None:
                report.note_recovered(cid, attempt)
            return x, y
        except ChunkQuarantined:
            raise                         # an inner retry layer already decided
        except Exception as e:  # noqa: BLE001 — classified below
            kind = policy.classify(e)
            if kind == "propagate":
                raise
            if kind == "quarantine":
                raise ChunkQuarantined(cid, attempt + 1, e) from e
            cause = e
            if report is not None:
                report.note_retry(cid)
            if attempt + 1 < policy.max_attempts:
                sleep(policy.delay_s(attempt))
    raise ChunkQuarantined(cid, policy.max_attempts, cause) from cause
