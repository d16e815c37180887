"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its own
into ``build/repro_torch/<name>-<digest>.so`` at the repository root
(``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared``).
The digest covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and a stale library is never
loaded.  ``build()`` starts one ``nvcc`` per source,
all at once, and waits for every one of them; ``load()`` builds what is
missing and opens it with ``ctypes``; ``function()`` binds one C entry point
once, with its argument types, for the launch wrappers' per-call path.

Nothing here runs at import: the CPU-only test environment imports every
module and has no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# Kernels whose float comparisons must round exactly as the plain PyTorch
# versions do: no multiply-add contraction.
SOURCES = {
    "rbf_kernel": (),
    "merge_lookup": ("-fmad=false",),
    "gss": ("-fmad=false",),
    "merge_multi": ("-fmad=false",),
    "merge_event": ("-fmad=false",),
    "train_step": ("-fmad=false",),
    "class_scores": ("-fmad=false",),
    "bdca_ascent": ("-fmad=false",),
}

# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
# blocks in a class's thread-block cluster (csrc/cluster.cuh), largest first;
# 16 is above the portable cluster size of 8
CLUSTER_SIZES = (16, 8, 4, 2, 1)

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# a trainer thread and a serving thread may ask for a library at once
_LOAD_LOCK = threading.Lock()
# ... and launch kernels at once: the wrappers' launch counters move under a
# lock.  A thread capturing a CUDA graph records its launches in a tally of
# its own instead (``recording``); they are counted at each replay.
_COUNT_LOCK = threading.Lock()
_CAPTURE = threading.local()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                           "machine with the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _flags(name: str) -> tuple[str, ...]:
    return _COMMON_FLAGS + SOURCES[name]


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every missing library in ``names`` (default: all), one ``nvcc``
    per source, all started together.  Returns ``{name: ptxas report}`` for
    what was compiled; raises ``RuntimeError`` with the compiler's output if
    any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def loaded() -> int:
    """How many kernel libraries this process has loaded (serving checks that
    live traffic after its warm-up loads, and so builds, none)."""
    return len(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: str, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its arguments
    declared (``argtypes``: one letter each, ``p`` a pointer or stream, ``i``
    an int, ``f`` a float) and its result (an int status unless
    ``restype`` says otherwise); bound once, so a launch pays one dictionary
    lookup for it."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        fn.argtypes = [kinds[a] for a in argtypes]
        fn.restype = restype
        _FNS[(name, symbol)] = fn
    return fn


def choose_cluster(c: int, resident: dict) -> int:
    """The largest K in ``CLUSTER_SIZES`` for which ``resident[K]`` (clusters
    of K blocks the card keeps resident at once, from
    ``cudaOccupancyMaxActiveClusters``) holds all ``c`` classes' clusters;
    1 when none does (one block a class needs no co-residency)."""
    for k in CLUSTER_SIZES:
        if resident.get(k, 0) >= c:
            return k
    return 1


def resident_clusters(name: str, symbol: str, sizes, *args) -> dict:
    """``{K: clusters of K resident at once}`` for each K of ``sizes`` from the
    C entry ``symbol`` of ``csrc/<name>.cu``, called as ``symbol(K, *args)``;
    raises on a CUDA error."""
    fn = function(name, symbol, "i" * (1 + len(args)))
    counts = {}
    for k in sizes:
        n = fn(k, *args)
        if n < 0:
            raise RuntimeError(f"{symbol}: cudaOccupancyMaxActiveClusters failed for K={k} "
                               f"with error {-n}")
        counts[k] = n
    return counts


def pair_choice_bytes(p: int) -> int:
    """Shared-memory bytes of a multi-merge event's pair lists for ``p`` pairs
    (csrc/multi_merge_choice.cuh ``pair_choice_bytes``: five 4-byte words and
    three bools a pair, rounded up to 16)."""
    return (p * (5 * 4 + 3) + 15) // 16 * 16


def dense(t):
    """``t`` itself when contiguous, else a contiguous copy (the kernels read
    dense row-major buffers)."""
    return t if t.is_contiguous() else t.contiguous()


def stream(device_index: int) -> int:
    """PyTorch's current stream on the card ``device_index`` as a raw
    ``cudaStream_t``, without building a ``torch.cuda.Stream`` (``chip_smoke.py``
    holds it equal to ``torch.cuda.current_stream(dev).cuda_stream``)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def count(scope: dict, counter: str) -> None:
    """One launch on the wrapper counter ``counter``, a global of the module
    whose ``globals()`` is ``scope``.  On a thread inside ``recording()`` the
    launch only enters that tally: a graph capture launches nothing."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        key = (id(scope), counter)
        tally[key] = (scope, counter, tally[key][2] + 1 if key in tally else 1)
        return
    with _COUNT_LOCK:
        scope[counter] += 1


@contextlib.contextmanager
def recording():
    """Collect this thread's launches (a CUDA graph capture) in a tally
    instead of the counters; ``add_counts(tally)`` counts them once."""
    tally: dict = {}
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None


def add_counts(tally: dict) -> None:
    """Count a recorded tally's launches once (a graph replay launches them)."""
    with _COUNT_LOCK:
        for scope, counter, n in tally.values():
            scope[counter] += n


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")

