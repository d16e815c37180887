"""Planned launches: the kernels' branch for fake tensors.

A dry run (``launch.steps.lower_cell``, ``core.distributed.lower_svm_cell``)
runs a step once on ``FakeTensor``s, which hold no memory.  A fake tensor on
a CUDA device (or a fake CPU tensor inside ``for_card()``) reaches a kernel's
wrapper with ``planned=True`` (``ops._use_kernel`` decides it, once a call):
the wrapper checks its inputs (not their device) and allocates its outputs
exactly as for a launch, then calls ``record``
with the kernel's work (``kernels.work``'s formulas) instead
of launching.  ``launches`` counts planned launches, apart from the wrappers'
real counters; each listener (``launch.roofline.Counters``) gets the work.

``scaled(r)`` marks a region run once in place of ``r`` identical rounds:
what it records counts ``r`` times.  ``assume_excess(n)`` states the drain's
round count that a real run reads from the card (``core.budget._events``).
"""
from __future__ import annotations

import contextlib

from torch._subclasses.fake_tensor import FakeTensor

launches: dict[str, int] = {}
# set inside for_card(): fake CPU tensors stand for the card's
FOR_CARD = [False]
_SCALE = [1]
_LISTENERS: list = []
_EXCESS: list = []


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (a tensor of a dry run)."""
    return isinstance(t, FakeTensor)


def scale() -> int:
    return _SCALE[-1]


def record(name: str, work) -> None:
    """One planned launch of kernel ``name`` doing ``work`` = (bytes, fp32
    operations), counted ``scale()`` times."""
    r = _SCALE[-1]
    launches[name] = launches.get(name, 0) + r
    for sink in _LISTENERS:
        sink.kernel(name, float(work[1]), float(work[0]), r)


def counts() -> dict[str, int]:
    return dict(launches)


def reset() -> None:
    launches.clear()


@contextlib.contextmanager
def listen(sink):
    """Send every planned launch's work to ``sink.kernel(name, flops, bytes, scale)``."""
    _LISTENERS.append(sink)
    try:
        yield sink
    finally:
        _LISTENERS.remove(sink)


@contextlib.contextmanager
def scaled(r: int):
    """What runs inside stands for ``r`` identical rounds."""
    _SCALE.append(_SCALE[-1] * int(r))
    try:
        yield
    finally:
        _SCALE.pop()


def rounds(r: int):
    """The loop of ``r`` rounds under a plan: one round, traced inside
    ``scaled(r)`` (a generator, so the loop's body runs inside it)."""
    if r <= 0:
        return
    with scaled(r):
        yield 0


@contextlib.contextmanager
def for_card():
    """Fake CPU tensors stand for the card's: the kernels take their planned
    branch (``ops._use_kernel``).  For a plan of the card made where torch
    has no CUDA, whose fake CUDA tensors cannot be indexed."""
    prev, FOR_CARD[0] = FOR_CARD[0], True
    try:
        yield
    finally:
        FOR_CARD[0] = prev


@contextlib.contextmanager
def assume_excess(n: int):
    """State that a drain (``unroll=0``) runs ``n`` rounds, the count a real
    run reads from the card."""
    _EXCESS.append(int(n))
    try:
        yield
    finally:
        _EXCESS.pop()


def excess() -> int:
    if not _EXCESS:
        raise RuntimeError("a planned drain reads its round count from the card: state it "
                           "with kernels.planned.assume_excess(n)")
    return _EXCESS[-1]
