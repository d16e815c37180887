"""Move models between the JAX reference and the port as numpy arrays.

``state_from_numpy`` takes the leaves of a ``repro`` ``SVMState`` (for
example ``{k: np.asarray(v) for k, v in state._asdict().items()}``) and
``state_to_numpy`` gives them back, so a model trained in one package
decides the same way in the other.  bf16 leaves travel as float32 (numpy
has no bf16): widening is exact, and ``state_from_numpy`` narrows to the
dtype asked for.

The language models travel the same way: ``lm_params_from_numpy`` takes the
reference's params tree (nested dicts and lists of numpy arrays, as
``repro.models.init_lm`` builds it) and fills an ``LM``, unstacking the
``body`` group axis into layer ``prefix + g * unit + j``;
``lm_cache_from_numpy`` does the same for a cache, ``kv_state_from_numpy``
for a budgeted KV cache, ``opt_state_from_numpy`` for the optimizer's
state; the ``*_to_numpy`` functions go back.  ``lm_tree`` and ``lm_flat``
move a dict of tensors by parameter name to the reference's tree layout
and back (the trainer's checkpoints).  A DTensor leaf (a model laid out on
a ``DeviceMesh``) goes out whole: ``full_tensor``, which every rank of its
mesh must call.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .core.bsgd import SVMState, resolve_device
from .core.budgeted_kv import KVBudgetState
from .core.lookup import MergeLookupTable


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


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
    return {name: _numpy(t) for name, t in zip(SVMState._fields, state) if t is not None}


def table_from_numpy(h, wd) -> MergeLookupTable:
    """A ``MergeLookupTable`` (float32, on the CPU) from the h and WD_norm arrays."""
    return MergeLookupTable(h_table=_from_numpy(h).to(torch.float32),
                            wd_table=_from_numpy(wd).to(torch.float32))


def _flat(tree, prefix=""):
    """{dotted name: leaf} of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (Mapping, list, tuple)):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    """The inverse of ``_flat`` for dict-only trees."""
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _layer_names(cfg, flat: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The reference's ``prefix``/``body`` leaves renamed ``layers.<i>.*``
    (numpy arrays or tensors; a body leaf's groups are views of it)."""
    pref, unit = cfg.prefix_layers, cfg.scan_unit
    out = {}
    for name, leaf in flat.items():
        head, _, rest = name.partition(".")
        if head == "prefix":
            out[f"layers.{rest}"] = leaf
        elif head == "body":
            j, _, rest = rest.partition(".")
            leaf = leaf if hasattr(leaf, "shape") else np.asarray(leaf)
            for g in range(leaf.shape[0]):
                out[f"layers.{pref + g * unit + int(j[1:])}.{rest}"] = leaf[g]
        else:
            out[name] = leaf
    return out


def _body_names(cfg, flat: Mapping[str, np.ndarray], stack=np.stack) -> dict[str, np.ndarray]:
    """``layers.<i>.*`` leaves back into the reference's ``prefix`` list and
    ``body`` groups joined by ``stack``."""
    pref, unit = cfg.prefix_layers, cfg.scan_unit
    out, body = {}, {}
    for name, leaf in flat.items():
        head, _, rest = name.partition(".")
        if head != "layers":
            out[name] = leaf
            continue
        i, _, rest = rest.partition(".")
        i = int(i)
        if i < pref:
            out[f"prefix.{i}.{rest}"] = leaf
        else:
            g, j = divmod(i - pref, unit)
            body.setdefault(f"body.l{j}.{rest}", {})[g] = leaf
    for name, groups in body.items():
        out[name] = stack([groups[g] for g in range(len(groups))])
    tree = _nest(out)
    if "prefix" in tree:
        tree["prefix"] = [tree["prefix"][str(i)] for i in range(pref)]
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = _whole(t.detach())
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def lm_params_from_numpy(cfg, params, *, device=None):
    """An ``LM`` on ``device`` (default the card) holding the reference's
    params tree ``params`` (numpy leaves; float32 leaves narrow to the
    parameter's dtype).  Every parameter must be given, and nothing else."""
    from .models.lm import LM

    dev = resolve_device(device)
    model = LM(cfg, dev)
    flat = _layer_names(cfg, _flat(params))
    names = {name for name, _ in model.named_parameters()}
    if set(flat) != names:
        raise ValueError(f"params tree does not match {cfg.name}: missing "
                         f"{sorted(names - set(flat))}, unknown {sorted(set(flat) - names)}")
    with torch.no_grad():
        for name, leaf in flat.items():
            p = model.get_parameter(name)
            src = _from_numpy(leaf)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} against {tuple(p.shape)}")
            p.copy_(src.to(dev))
    return model


def lm_params_to_numpy(model) -> dict:
    """The reference's params tree of ``model`` (bf16 as float32)."""
    flat = {name: _numpy(p) for name, p in model.named_parameters()}
    return _body_names(model.cfg, flat)


def lm_tree(cfg, flat: Mapping, *, stack=torch.stack) -> dict:
    """``{parameter name: leaf}`` (``model.named_parameters()``'s names) as the
    reference's params tree: the ``prefix`` list and each scanned unit's
    layers joined along a leading group dim by ``stack``.  The trainer's
    checkpoints hold parameters and moments in this layout, as the
    reference's do."""
    return _body_names(cfg, flat, stack)


def lm_flat(cfg, tree) -> dict:
    """The reference's params tree (numpy or tensor leaves) as ``{parameter
    name: leaf}``, each body group a view of its stacked leaf."""
    return _layer_names(cfg, _flat(tree))


def opt_state_from_numpy(cfg, state, *, device=None):
    """The reference's ``OptState`` (``step``, ``m``, ``v``: a NamedTuple or a
    dict, numpy leaves) as the port's ``train.optimizer.OptState`` on
    ``device`` (default the card), moments keyed by parameter name."""
    from .train.optimizer import OptState

    dev = resolve_device(device)
    step, m, v = ((state["step"], state["m"], state["v"]) if isinstance(state, Mapping)
                  else tuple(state))

    def moments(tree):
        return {k: _from_numpy(a).to(dev) for k, a in lm_flat(cfg, tree).items()}

    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                    m=moments(m), v=moments(v))


def opt_state_to_numpy(cfg, state) -> dict:
    """The port's ``OptState`` as the reference's fields: ``{"step": int32,
    "m": tree, "v": tree}`` (``repro.train.optimizer.OptState(**...)``)."""
    def tree(moments):
        return _body_names(cfg, {k: _numpy(t) for k, t in moments.items()})

    return {"step": np.asarray(int(state.step), np.int32), "m": tree(state.m), "v": tree(state.v)}


def lm_cache_from_numpy(cfg, cache, *, device=None) -> list:
    """The reference's cache tree (``{"prefix": [...], "body": {...}}`` with
    ``{"mixer": {...}}`` a layer) as the port's list of per-layer dicts."""
    dev = resolve_device(device)
    flat = _layer_names(cfg, _flat(cache))
    layers: list[dict] = [{} for _ in range(cfg.n_layers)]
    for name, leaf in flat.items():
        _, i, mixer, key = name.split(".")
        layers[int(i)][key] = _from_numpy(leaf).to(dev)
    return layers


def lm_cache_to_numpy(cfg, cache) -> dict:
    """The port's cache as the reference's tree (bf16 as float32)."""
    flat = {f"layers.{i}.mixer.{k}": _numpy(t) for i, entry in enumerate(cache)
            for k, t in entry.items()}
    return _body_names(cfg, flat)


def kv_state_from_numpy(arrays: Mapping[str, np.ndarray], *, device=None) -> KVBudgetState:
    """A ``KVBudgetState`` from the reference's ``k``, ``v`` and ``count``."""
    dev = resolve_device(device)
    return KVBudgetState(k=_from_numpy(arrays["k"]).to(dev), v=_from_numpy(arrays["v"]).to(dev),
                         count=int(arrays["count"]))


def kv_state_to_numpy(state: KVBudgetState) -> dict[str, np.ndarray]:
    """``{"k", "v", "count"}`` as the reference holds them (count int32)."""
    return {"k": _numpy(state.k), "v": _numpy(state.v),
            "count": np.asarray(state.count, np.int32)}
