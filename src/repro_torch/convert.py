"""Move models between the JAX reference and the port as numpy arrays.

``state_from_numpy`` takes the leaves of a ``repro`` ``SVMState`` (for
example ``{k: np.asarray(v) for k, v in state._asdict().items()}``) and
``state_to_numpy`` gives them back, so a model trained in one package
decides the same way in the other.  bf16 leaves travel as float32 (numpy
has no bf16): widening is exact, and ``state_from_numpy`` narrows to the
dtype asked for.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.bsgd import SVMState, resolve_device
from .core.lookup import MergeLookupTable


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def state_from_numpy(arrays: Mapping[str, np.ndarray], *, device=None) -> SVMState:
    """An ``SVMState`` on ``device`` (default the card) from numpy leaves.

    ``kmat`` (the kernel cache) may be missing or None.  Stacked states (a
    leading class axis on every leaf) convert the same way."""
    dev = resolve_device(device)
    return SVMState(*(None if arrays.get(name) is None else _from_numpy(arrays[name]).to(dev)
                      for name in SVMState._fields))


def state_to_numpy(state: SVMState) -> dict[str, np.ndarray]:
    """``{field: numpy array}`` on the host; bf16 leaves become float32, and
    ``kmat`` is left out when the state has no cache."""
    return {name: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
            for name, t in zip(SVMState._fields, state) if t is not None}


def table_from_numpy(h, wd) -> MergeLookupTable:
    """A ``MergeLookupTable`` (float32, on the CPU) from the h and WD_norm arrays."""
    return MergeLookupTable(h_table=_from_numpy(h).to(torch.float32),
                            wd_table=_from_numpy(wd).to(torch.float32))
