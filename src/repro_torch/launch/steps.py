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

``plan_cell`` is what the dry run, the trainer and the server share: for
(cfg, shape, mesh, strategy) it gives the step callable, its abstract
arguments (fake tensors, DTensors with fake blocks on a mesh) and their
placements.  ``lower_cell`` runs that step once inside
``launch.roofline.Counters``: the counterpart of the reference's AOT
lowering, with nothing allocated on a device and no collective moving data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

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


@dataclasses.dataclass
class CellPlan:
    """A cell's step and its abstract arguments.  ``in_shardings`` and
    ``out_shardings`` are ``sharding.specs.NamedSharding`` trees of the
    arguments and results (None without a mesh); ``fake_mode`` made the
    arguments, and the step must run under it."""

    step_fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: tuple = ()
    kind: str = "train"
    fake_mode: Any = None


def _on_mesh(fn, mesh, specs: tuple):
    """``fn`` with its plain tensor arguments laid out on ``mesh`` at ``specs``
    (one spec tree an argument, None to pass it as it is) and run under
    ``implicit_replication``, as the mesh's train step runs its loss."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..sharding import specs as sh

    def place(x, spec):
        if spec is None:
            return x
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, list):
            return [place(v, sp) for v, sp in zip(x, spec)]
        return sh.from_full(x, mesh, sh.placements(spec, mesh))

    def step(*args):
        with implicit_replication():
            return fn(*(place(a, sp) for a, sp in zip(args, specs)))

    return step


def plan_cell(cfg, shape_name: str, mesh, *, strategy: str = "tp", optimizer=None,
              device=None) -> CellPlan:
    """The step of one (arch x shape) cell on ``mesh`` (a ``DeviceMesh``, or
    None for one device) with abstract arguments made under a new
    ``FakeTensorMode``: on the mesh's device, else on ``device`` (default
    the card).  Train: ``make_train_step(mesh=, strategy=)`` on ``(model,
    opt_state, batch)``, the whole batch on every rank.  Prefill (encoder
    or decoder) and decode: ``make_prefill_fn`` / ``make_decode_fn`` with
    the batch laid out over the data axes and decode's cache at
    ``cache_specs``: ``"sequence"`` when the global batch is smaller than
    the ``data`` axis (one long context), else ``"batch"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import SHAPES
    from ..sharding import specs as sh
    from . import inputs as inp

    step = SHAPES[shape_name]["step"]
    dev = mesh.device_type if mesh is not None else ("cuda" if device is None else device)
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fm:
        model = inp.abstract_params(cfg, mesh=mesh, strategy=strategy, device=dev)
        batch = inp.batch_specs(cfg, shape_name, device=dev)
        p_shard = sh.param_shardings(model, mesh, strategy) if mesh is not None else None
        b_spec = sh.batch_spec(mesh, batch) if mesh is not None else None
        if step == "train":
            optimizer = optimizer or AdamW()
            opt_state = optimizer.init(dict(model.named_parameters()))
            fn = make_train_step(cfg, optimizer, mesh=mesh, strategy=strategy)
            shard = None if mesh is None else (p_shard, (None, p_shard, p_shard),
                                               sh.to_shardings(b_spec, mesh))
            return CellPlan(step_fn=fn, args=(model, opt_state, batch), in_shardings=shard,
                            out_shardings=None if mesh is None else (shard[1], None),
                            donate_argnums=(0, 1), kind="train", fake_mode=fm)
        if step == "prefill":
            fn = make_prefill_fn(cfg)
            if mesh is not None:
                fn = _on_mesh(fn, mesh, (None, b_spec))
            shard = None if mesh is None else (p_shard, sh.to_shardings(b_spec, mesh))
            return CellPlan(step_fn=fn, args=(model, batch), in_shardings=shard,
                            out_shardings=None, kind="prefill", fake_mode=fm)
        sh_ = SHAPES[shape_name]
        policy = ("sequence" if mesh is not None
                  and sh_["global_batch"] < sh.mesh_shape(mesh).get("data", 1) else "batch")
        cache = inp.abstract_cache(cfg, shape_name, device=dev)
        tokens = batch["tokens"]
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        fn = make_decode_fn(cfg)
        shard = None
        if mesh is not None:
            c_spec = sh.cache_specs(cache, mesh, policy=policy)
            t_spec = (b_spec["tokens"] if policy == "batch" else (None, None))
            fn = _on_mesh(fn, mesh, (None, c_spec, t_spec, ()))
            shard = (p_shard, sh.to_shardings(c_spec, mesh), sh.to_shardings(t_spec, mesh),
                     sh.to_shardings((), mesh))
        return CellPlan(step_fn=fn, args=(model, cache, tokens, pos), in_shardings=shard,
                        out_shardings=None, donate_argnums=(1,), kind="decode", fake_mode=fm)


def lower_cell(cfg, shape_name: str, mesh, *, strategy: str = "tp", optimizer=None,
               device=None):
    """Trace one cell's step once on ``mesh``; returns ``(record, plan)``, the
    record a ``launch.roofline.Trace`` (``roofline.analyze`` takes it)."""
    from .roofline import Counters

    plan = plan_cell(cfg, shape_name, mesh, strategy=strategy, optimizer=optimizer,
                     device=device)
    counters = Counters(plan.fake_mode)
    with counters, plan.fake_mode:
        counters.resident(_arg_tensors(plan))
        out = plan.step_fn(*plan.args)
        counters.outputs(out)
        if plan.kind == "train":           # the parameters are written in place
            counters.outputs(list(plan.args[0].parameters()))
    return counters.trace, plan


def _arg_tensors(plan: CellPlan) -> list:
    """The tensors a plan's arguments hold (a model's by its parameters)."""
    out = []
    for a in plan.args:
        out.append(list(a.parameters()) if isinstance(a, nn.Module) else a)
    return out
