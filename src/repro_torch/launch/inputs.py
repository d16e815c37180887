"""Abstract stand-ins for every (arch x shape) dry-run cell.

PyTorch counterpart of ``repro.launch.inputs``: the reference's
``ShapeDtypeStruct`` trees become tensors with the reference's shapes and
dtypes and no memory, on the ``meta`` device by default, or fake tensors
(``FakeTensorMode``) on ``device`` when called inside a fake mode, as
``launch.steps.plan_cell`` calls them.  Nothing here draws a number or
allocates device memory.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs import SHAPES
from ..models import LM, init_cache
from ..models.lm import model_dtype
from ..train.optimizer import AdamW

META = "meta"


def sds(shape, dtype, device=META) -> torch.Tensor:
    """An empty tensor of ``shape`` and ``dtype`` (the reference's ``sds``)."""
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def batch_specs(cfg, shape_name: str, *, device=META) -> dict:
    """Abstract training/serving batch for one shape cell."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    step = sh["step"]
    if step == "decode":
        return {"tokens": sds((b, 1), torch.int32, device)}
    if cfg.input_kind == "frames":
        spec = {"frames": sds((b, s, cfg.frame_dim), getattr(torch, cfg.dtype), device)}
        if step == "train":
            spec["labels"] = sds((b, s), torch.int32, device)
            spec["mask"] = sds((b, s), torch.bool, device)
        return spec
    spec = {"tokens": sds((b, s), torch.int32, device)}
    if step == "train":
        spec["labels"] = sds((b, s), torch.int32, device)
        spec["mask"] = sds((b, s), torch.float32, device)
    return spec


def svm_chunk_specs(dim: int, chunk_steps: int, batch_size: int, *,
                    n_classes: int | None = None, x_dtype="float32", y_dtype="float32",
                    device=META) -> dict:
    """Abstract streamed chunk for the SVM cells: x ``(chunk_steps, batch,
    dim)`` in the SV storage dtype, y ``(chunk_steps, batch)`` (float ±1
    targets for binary, int32 class ids when ``n_classes`` is set), as
    ``core.distributed.make_distributed_chunk_step``'s chunk takes them
    (each rank passes its rows of the batch axis)."""
    return {
        "xc": sds((chunk_steps, batch_size, dim), getattr(torch, x_dtype), device),
        "yc": sds((chunk_steps, batch_size),
                  torch.int32 if n_classes else getattr(torch, y_dtype), device),
    }


def svm_serve_specs(dim: int, batch: int, slots: int, *, n_classes: int | None = None,
                    bank_dtype="bfloat16", device=META) -> dict:
    """Abstract serving inputs for the SVM predict cell: a ``(batch, dim)``
    float32 request block against a ``(C, slots, dim)`` bank in
    ``bank_dtype`` with fp32 alphas (``core.predict.ServeModel``);
    ``n_classes=None`` is the binary C = 1 bank."""
    c = 1 if n_classes is None else n_classes
    return {
        "sv_x": sds((c, slots, dim), getattr(torch, bank_dtype), device),
        "alpha": sds((c, slots), torch.float32, device),
        "count": sds((c,), torch.int32, device),
        "gamma": sds((), torch.float32, device),
        "x": sds((batch, dim), torch.float32, device),
    }


def abstract_params(cfg, *, mesh=None, strategy: str = "tp", device=META) -> LM:
    """An ``LM`` whose parameters hold no numbers (the reference's ``(params,
    axes)``: each parameter carries its ``axes``).

    Built on ``meta`` (``LM(cfg, torch.device("meta"))``); with ``device``
    every parameter is replaced by an empty tensor there (a fake one inside a
    ``FakeTensorMode``); with a ``DeviceMesh`` by a DTensor at its spec's
    placements whose local block is an empty tensor of this rank's shape on
    the mesh's device.  Nothing is drawn: ``init_plan`` is not run and no
    whole tensor is made (``sharding.specs.from_full`` would make one)."""
    model = LM(cfg, torch.device(META))
    if mesh is None and torch.device(device).type == META:
        return model
    from torch.distributed.tensor import DTensor

    from ..sharding import specs as sh

    shardings = sh.param_shardings(model, mesh, strategy) if mesh is not None else None
    for name, p in list(model.named_parameters()):
        if mesh is None:
            t = sds(p.shape, p.dtype, device)
        else:
            places = shardings[name].placements
            local = sds(_local_shape(p.shape, mesh, places), p.dtype, mesh.device_type)
            t = DTensor.from_local(local, mesh, places, run_check=False, shape=p.shape,
                                   stride=_contiguous_stride(p.shape))
        new = nn.Parameter(t, requires_grad=p.requires_grad)
        for attr in sh.CARRIED:
            if hasattr(p, attr):
                setattr(new, attr, getattr(p, attr))
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, new)
    return model


def _local_shape(shape, mesh, places) -> tuple:
    """A rank's block of ``shape`` at ``places`` (every ``Shard`` divides its
    dim, as ``sharding.specs.resolve_spec`` makes it)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for mdim, pl in enumerate(places):
        if isinstance(pl, Shard):
            out[pl.dim] //= mesh.size(mdim)
    return tuple(out)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def abstract_opt_state(cfg, params: dict, optimizer=None):
    """The optimizer's state for ``params`` (a dict of abstract parameters):
    float32 moments of the parameters' shapes and placements, a 0-d int32
    step."""
    return (optimizer or AdamW()).init(params)


def abstract_cache(cfg, shape_name: str, *, device=META) -> list:
    """The decode cache of one shape cell, one dict a layer, in the model's dtype."""
    sh = SHAPES[shape_name]
    return init_cache(cfg, sh["global_batch"], sh["seq_len"], dtype=model_dtype(cfg),
                      device=device)
