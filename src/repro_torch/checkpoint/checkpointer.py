"""Atomic, checksummed, keep-last-k checkpoints in the reference's on-disk format.

Counterpart of ``repro.checkpoint.checkpointer``, byte-compatible with it, so a
checkpoint either package writes loads in the other:

  * ``<dir>/step_<N>/`` holds ``arrays.npz`` (leaf key -> numpy array) and
    ``manifest.json`` (``step``; per leaf its shape, dtype name and the crc32
    of its raw row-major bytes; the caller's ``metadata``).
  * A save writes ``step_<N>.tmp``, fsyncs both files and the directory,
    renames it to ``step_<N>`` and fsyncs the parent: a crash leaves the old
    state or the complete new one.
  * Leaf keys are the tree paths joined with ``/``: a dict gives its key
    (keys in sorted order, as JAX flattens dicts), a list or tuple its index,
    a ``NamedTuple`` such as ``SVMState`` its field name; a ``None`` leaf
    (``kmat=None``) is left out.
  * A bf16 leaf is stored as raw two-byte records (numpy ``|V2``; numpy has
    no bf16) with ``"bfloat16"`` in the manifest, as the JAX package writes
    it; this module reads and writes it through an int16 view.

``load`` re-hashes every leaf it reads and refuses a corrupt one;
``verify_step`` / ``latest_verifiable_step`` / ``restore_latest`` walk back
past a torn or bit-flipped newest step.  Restored leaves go to the card
unless the caller passes ``device="cpu"``.

The format is mesh-free.  A DTensor leaf (a model laid out on a
``DeviceMesh``) is saved whole: every rank of its mesh gathers it
(``full_tensor``, a collective), rank 0 alone writes, and every rank waits
for the write.  ``load`` and ``restore_latest`` take the reference's
``shardings=``, a tree of ``sharding.specs.NamedSharding`` beside the
target's leaves (a DTensor target leaf names its own): each such leaf is
restored onto its mesh at its placements, which need not be the saving
mesh's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import zipfile
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..sharding.specs import NamedSharding, from_full

_SEP = "/"
_BF16 = "bfloat16"


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A restore target that is not a tensor yet: its shape and torch dtype
    (the counterpart of ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _walk(tree, fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; ``None`` stays None.

    Containers: dicts (visited in sorted key order), NamedTuples (field
    names), lists and tuples (indices).  Anything else is a leaf."""
    def key(part) -> str:
        return f"{prefix}{_SEP}{part}" if prefix else str(part)

    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: _walk(tree[k], fn, key(k)) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_walk(v, fn, key(f)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, key(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _flatten(tree) -> dict[str, Any]:
    flat: dict[str, Any] = {}

    def put(k, leaf):
        flat[k] = leaf

    _walk(tree, put)
    return flat


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as stored in ``arrays.npz`` and its manifest
    dtype name: a bf16 tensor becomes raw ``|V2`` records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _leaf_crc(arr: np.ndarray) -> int:
    """crc32 of the leaf's row-major bytes (dtype and shape live next to it
    in the manifest, so the bytes alone pin the value)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (a directory fsync commits the
    creation or rename of its entries on POSIX)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3,
         metadata: dict | None = None) -> str:
    """Atomic synchronous save; returns the final directory path.

    With DTensor leaves every rank calls it: each leaf is gathered whole
    into host memory in turn, rank 0 writes, and a barrier holds every rank
    until the step is on disk."""
    flat = _flatten(tree)
    if not any(isinstance(v, DTensor) for v in flat.values()):
        return _write(ckpt_dir, step, flat, keep_last, metadata)
    flat = {k: v.full_tensor().cpu() if isinstance(v, DTensor) else v for k, v in flat.items()}
    final = _step_dir(ckpt_dir, step)
    if dist.get_rank() == 0:
        final = _write(ckpt_dir, step, flat, keep_last, metadata)
    dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, flat: dict, keep_last: int, metadata) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _to_numpy(v) for k, v in flat.items()}
    arrays_path = os.path.join(tmp, "arrays.npz")
    np.savez(arrays_path, **{k: arr for k, (arr, _) in flat.items()})
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(arr.shape), "dtype": name, "crc32": _leaf_crc(arr)}
                   for k, (arr, name) in flat.items()},
        "metadata": metadata or {},
    }
    manifest_path = os.path.join(tmp, "manifest.json")
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # file contents and the tmp dir's entries before the rename, the parent
    # after it: a power cut leaves the old state or the complete new one
    _fsync_path(arrays_path)
    _fsync_path(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_path(ckpt_dir)
    _cleanup(ckpt_dir, keep_last)
    return final


def save_async(ckpt_dir: str, step: int, tree, **kw) -> threading.Thread:
    """Copy every leaf to host memory now, write in a background thread.

    The copy is taken before this returns, so training may go on updating
    the state in place."""
    host = _walk(tree, lambda _k, leaf: (leaf.detach().to("cpu", copy=True)
                                         if isinstance(leaf, torch.Tensor) else np.array(leaf)))
    t = threading.Thread(target=save, args=(ckpt_dir, step, host), kwargs=kw, daemon=True)
    t.start()
    return t


def _cleanup(ckpt_dir: str, keep_last: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", name)))


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_manifest(ckpt_dir: str, step: int) -> dict:
    """The step's manifest; ``ValueError`` when it is missing or corrupt."""
    path = os.path.join(_step_dir(ckpt_dir, step), "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise ValueError(f"{ckpt_dir}: step {step} has no manifest ({path} missing) — a torn "
                         "write, or not a checkpoint written by repro.checkpoint") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"{ckpt_dir}: step {step} manifest is corrupt ({e}) — the "
                         "checkpoint directory was tampered with or truncated outside "
                         "the atomic-rename path") from None


def _read_arrays(ckpt_dir: str, step: int) -> dict[str, np.ndarray]:
    path = os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise ValueError(f"{ckpt_dir}: step {step} has no arrays.npz — a torn write (atomic "
                         "saves always write one)") from None
    except (ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
        raise ValueError(f"{ckpt_dir}: step {step} arrays.npz is unreadable ({e}) — "
                         "truncated or corrupt tree") from None


def load_metadata(ckpt_dir: str, step: int) -> dict:
    """The ``metadata`` dict passed to ``save`` for this step; ``ValueError``
    when the step has no manifest or a corrupt one."""
    return _read_manifest(ckpt_dir, step).get("metadata", {})


def _check_crcs(ckpt_dir: str, step: int, stored: dict[str, np.ndarray], leaves: dict) -> None:
    """Stored leaves against the manifest's crc32 (a leaf without one, from a
    checkpoint written before checksums, passes); ``ValueError`` on a mismatch."""
    for key, arr in stored.items():
        spec = leaves.get(key)
        if spec is None or "crc32" not in spec:
            continue
        got = _leaf_crc(arr)
        if got != int(spec["crc32"]):
            raise ValueError(
                f"{ckpt_dir}: step {step} leaf {key!r} fails its checksum (crc32 {got:#010x} "
                f"!= manifest {int(spec['crc32']):#010x}) — silent corruption, refuse to restore")


def _stored_dtype_ok(arr: np.ndarray, name: str) -> bool:
    # a bf16 leaf is stored as raw two-byte records
    return str(arr.dtype) == name or (name == _BF16 and arr.dtype == np.dtype("V2"))


def _to_torch(arr: np.ndarray, name: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor of its manifest dtype and shape (a 0-d
    leaf stays 0-d: ``np.ascontiguousarray`` alone returns at least 1-d)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if name == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load(ckpt_dir: str, step: int, target_tree, *, shardings=None, device=None):
    """Restore into the structure of ``target_tree``.

    Its leaves are tensors or ``ShapeDtype`` specs; each restored leaf takes
    the target's dtype (a cast, as the reference's ``astype``) and goes to
    ``device`` (default the card; ``"cpu"`` for the host).  A leaf with a
    ``NamedSharding`` in ``shardings`` (a tree beside the target's, None
    where a leaf has none), or a DTensor target leaf, comes back a DTensor
    on that mesh at those placements; every rank reads the whole leaf and
    moves only its own block to the device."""
    dev = torch.device("cuda" if device is None else device)
    placed = {k: s for k, s in _flatten(shardings).items() if isinstance(s, NamedSharding)}
    stored = _read_arrays(ckpt_dir, step)
    keys = list(_flatten(target_tree))
    missing = [k for k in keys if k not in stored]
    if missing:
        raise ValueError(f"{ckpt_dir}: step {step} checkpoint is missing leaves {missing[:5]} "
                         "— truncated tree or a different state layout")
    leaves = _read_manifest(ckpt_dir, step).get("leaves", {})
    _check_crcs(ckpt_dir, step, stored, leaves)

    def restore(key, ref):
        arr = stored[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {arr.shape} != target {tuple(ref.shape)}")
        name = leaves.get(key, {}).get("dtype", str(arr.dtype))
        full = _to_torch(arr, name).to(ref.dtype)
        shd = placed.get(key)
        if shd is None and isinstance(ref, DTensor):
            shd = NamedSharding(ref.device_mesh, tuple(ref.placements))
        return full.to(dev) if shd is None else from_full(full, shd.mesh, shd.placements)

    return _walk(target_tree, restore)


def verify_step(ckpt_dir: str, step: int) -> None:
    """Full integrity check of one step: a readable manifest and arrays.npz,
    every manifest leaf present with its recorded shape and dtype, and (when
    recorded) a matching crc32.  Raises ``ValueError`` naming the first
    problem."""
    leaves = _read_manifest(ckpt_dir, step).get("leaves", {})
    stored = _read_arrays(ckpt_dir, step)
    for key, spec in leaves.items():
        if key not in stored:
            raise ValueError(f"{ckpt_dir}: step {step} is missing leaf {key!r} — truncated tree")
        arr = stored[key]
        if list(arr.shape) != list(spec["shape"]):
            raise ValueError(f"{ckpt_dir}: step {step} leaf {key!r} shape {list(arr.shape)} != "
                             f"manifest {spec['shape']}")
        if not _stored_dtype_ok(arr, spec["dtype"]):
            raise ValueError(f"{ckpt_dir}: step {step} leaf {key!r} dtype {arr.dtype} != "
                             f"manifest {spec['dtype']}")
    _check_crcs(ckpt_dir, step, stored, leaves)


def latest_verifiable_step(ckpt_dir: str) -> int | None:
    """Newest step that passes ``verify_step``, walking back past torn or
    corrupt steps; None when no step verifies."""
    for step in reversed(all_steps(ckpt_dir)):
        try:
            verify_step(ckpt_dir, step)
        except ValueError:
            continue
        return step
    return None


def restore_latest(ckpt_dir: str, target_tree, *, shardings=None, device=None):
    """``(step, tree)`` of the newest step that verifies; ``(None, None)``
    without any step; ``ValueError`` when steps exist and none verifies."""
    steps = all_steps(ckpt_dir)
    if not steps:
        return None, None
    step = latest_verifiable_step(ckpt_dir)
    if step is None:
        raise ValueError(f"{ckpt_dir}: checkpoint steps {steps} exist but none verify — "
                         "refusing to restore from corrupt state")
    return step, load(ckpt_dir, step, target_tree, shardings=shardings, device=device)
