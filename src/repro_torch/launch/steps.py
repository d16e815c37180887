"""Step functions of the language models: train, prefill and decode.

PyTorch counterpart of ``repro.launch.steps``.  ``make_train_step`` takes
gradients of ``models.loss_fn`` by autograd and updates the model and the
optimizer state in place; with a process group of W ranks each rank takes
its W-th of the batch's rows and the gradients and the loss are averaged
by one all-reduce each (DDP's mean: the global batch's loss when every
rank's rows carry the same mask weight, as the token streams' rows do).
With a ``DeviceMesh`` the parameters are DTensors (``sharding.specs.
distribute_model``) and the batch's rows shard over the mesh's data axes;
see ``make_train_step``.
``plan_cell`` and ``lower_cell``, the reference's AOT lowering of a TPU
mesh for its dry run, stay with that tooling (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models import decode_step, encode_step, loss_fn, prefill
from ..train.optimizer import AdamW


def _rows(batch: dict, rank: int, world: int) -> dict:
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"batch of {v.shape[0]} rows does not split over {world} ranks")
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def _all_reduce_mean(tensors: list, group, world: int) -> list:
    """The ranks' float32 mean of each tensor, in one all-reduce."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= world
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


class _LossAndGrads(nn.Module):
    """The loss of ``lm`` and its gradients in one call, so that
    ``torch.func.functional_call`` keeps the tensors it puts in place of the
    parameters there for the backward too (remat runs each layer's forward
    again inside it)."""

    def __init__(self, cfg, lm):
        super().__init__()
        self.cfg, self.lm = cfg, lm

    def forward(self, batch, wrt: list):
        loss = loss_fn(self.cfg, self.lm, batch)
        return loss, torch.autograd.grad(loss, wrt, allow_unused=True)


def _mesh_train_step(cfg, optimizer, mesh, strategy: str):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from ..sharding import specs as sh

    sh.rules_for(strategy)                  # refuses an unknown strategy now
    loss_places = (Replicate(),) * mesh.ndim

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if strategy == "fsdp":              # a parameter's placements at use
            use = {n: sh.placements(s, mesh) for n, s in sh.param_specs(model, mesh).items()}
        batch = {k: sh.from_full(v, mesh, sh.placements(s, mesh))
                 for (k, v), s in zip(batch.items(), sh.batch_spec(mesh, batch).values())}
        with implicit_replication():
            used = params if strategy == "tp" else {
                n: p.redistribute(mesh, use[n]) for n, p in params.items()}
            loss, grads = torch.func.functional_call(
                _LossAndGrads(cfg, model), {f"lm.{n}": t for n, t in used.items()},
                (batch, list(used.values())))
            # partial sums over the data axes reduce (scatter) to the stored placements
            grads = {n: torch.zeros_like(p) if g is None else g.redistribute(mesh, p.placements)
                     for (n, p), g in zip(params.items(), grads)}
            opt_state = optimizer.update(grads, opt_state, params)
            return opt_state, loss.detach().redistribute(mesh, loss_places)

    return train_step


def make_train_step(cfg, optimizer=None, *, group=None, mesh=None, strategy: str = "tp"):
    """``train_step(model, opt_state, batch) -> (opt_state, loss)``: one
    optimizer step on ``model`` in place; ``loss`` is a 0-d float32 tensor
    on the model's device, nothing is read back to the host.

    ``mesh``, a ``DeviceMesh`` with a ``data`` dim (and ``pod``, ``model``),
    takes a model whose parameters are DTensors laid out by ``strategy``
    (``sharding.specs.distribute_model``) and the whole batch on every rank;
    each rank keeps its rows (the batch dim over ``dp_axes(mesh)``), the loss
    and its backward run under ``implicit_replication``, and the loss comes
    back as a replicated 0-d DTensor.  Under ``"fsdp"`` a parameter stored
    sharded over ``data`` is gathered to its ``tp`` placements at use and
    its gradient reduce-scattered back to the stored placements (ZeRO-3);
    the moments share the stored placements."""
    optimizer = optimizer or AdamW()
    if mesh is not None:
        if group is not None:
            raise ValueError("pass a process group or a mesh, not both")
        return _mesh_train_step(cfg, optimizer, mesh, strategy)
    rank, world = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if world > 1:
            batch = _rows(batch, rank, world)
        loss = loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
        loss = loss.detach()
        if world > 1:
            *grads, loss = _all_reduce_mean(grads + [loss], group, world)
        opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
        return opt_state, loss

    return train_step


def make_decode_fn(cfg):
    def serve_step(model, cache, tokens, cache_pos):
        return decode_step(cfg, model, cache, tokens, cache_pos)
    return serve_step


def make_prefill_fn(cfg):
    if cfg.is_encoder:
        def encode(model, batch):
            return encode_step(cfg, model, batch)
        return encode

    def prefill_fn(model, batch):
        return prefill(cfg, model, batch["tokens"])
    return prefill_fn
