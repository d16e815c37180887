"""Step functions of the language models: train, prefill and decode.

PyTorch counterpart of ``repro.launch.steps``.  ``make_train_step`` takes
gradients of ``models.loss_fn`` by autograd and updates the model and the
optimizer state in place; with a process group of W ranks each rank takes
its W-th of the batch's rows and the gradients and the loss are averaged
by one all-reduce each (DDP's mean: the global batch's loss when every
rank's rows carry the same mask weight, as the token streams' rows do).
``plan_cell`` and ``lower_cell``, the reference's AOT lowering of a TPU
mesh for its dry run, stay with that tooling (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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


def make_train_step(cfg, optimizer=None, *, group=None):
    """``train_step(model, opt_state, batch) -> (opt_state, loss)``: one
    optimizer step on ``model`` in place; ``loss`` is a 0-d float32 tensor
    on the model's device, nothing is read back to the host."""
    optimizer = optimizer or AdamW()
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
