"""Optimizers (AdamW, momentum SGD) and the cosine schedule, with the
reference's arithmetic in the reference's order.

PyTorch counterpart of ``repro.train.optimizer``.  Parameters, gradients and
moments are dicts keyed by the model's parameter names
(``model.named_parameters()``, the names ``convert`` maps the reference's
tree to).  An update writes the parameters and moments in place under
``torch.no_grad()`` and returns the new ``OptState``:

  * moments in float32, no float32 master copy of a bf16 parameter (the
    reference keeps none);
  * clipping by the float32 global norm of every gradient,
    ``scale = min(1, clip / max(gn, 1e-9))``;
  * bias corrections ``1 - b ** step`` in float32, ``delta = mhat /
    (sqrt(vhat) + eps)``;
  * decoupled weight decay added to ``delta`` on parameters of 2 or more
    dims only, then ``p = (float32(p) - lr * delta)`` narrowed to p's dtype.
    The reference counts the dims of its tree's leaves, where a scanned
    layer's parameter carries a leading layer-group dim: a parameter the
    model marks ``scanned`` (``models.lm.LM``) counts that dim too, so the
    norm gains of the scanned layers decay here as they do there.

``torch.optim.AdamW`` decays every parameter by ``p * (1 - lr * wd)`` before
the step, so its results differ; it is not used.  The step counter is a 0-d
int32 tensor on the parameters' device and a schedule's learning rate is
computed from it there in float32, so an update reads nothing back to the
host.

On DTensor parameters (a model laid out on a ``DeviceMesh``) the moments
take the parameters' placements and the update is shard-local; the global
norm sums every rank's squares, so clipping binds as in one process.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor.experimental import implicit_replication


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine down to
    ``min_frac * base_lr`` at ``total``; ``lr(step)`` takes an int or a tensor
    and returns a float32 tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(1.0, warmup)
        t = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over every leaf of its float32 sum of squares (leaves in
    the dict's order); over DTensor leaves a replicated DTensor, the sum
    over every rank's blocks."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


class OptState(NamedTuple):
    """``step``: a 0-d int32 tensor; ``m``, ``v``: float32 moments by
    parameter name (SGD's ``v`` is empty)."""
    step: torch.Tensor
    m: dict
    v: dict


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _step0(params: dict) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def decays(p: torch.Tensor) -> bool:
    """Whether AdamW's weight decay applies to ``p``: 2 or more dims in the
    reference's tree (``scanned`` adds the layer-group dim)."""
    return p.dim() + int(getattr(p, "scanned", False)) >= 2


def _lr(lr, step):
    return lr(step) if callable(lr) else lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params: dict) -> OptState:
        return OptState(step=_step0(params), m=_zeros(params), v=_zeros(params))

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict) -> OptState:
        """One AdamW step: ``params``, ``state.m`` and ``state.v`` are written
        in place; returns the state with the new step."""
        with implicit_replication():        # the step and the schedule are plain tensors
            return self._update(grads, state, params)

    def _update(self, grads: dict, state: OptState, params: dict) -> OptState:
        step = state.step + 1
        lr = _lr(self.lr, step)
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.pow(b1, step.to(torch.float32))
        bc2 = 1 - torch.pow(b2, step.to(torch.float32))
        for name, p in params.items():
            g32 = grads[name].float()
            if scale is not None:
                g32 = g32 * scale
            m, v = state.m[name], state.v[name]
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32 * g32)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if decays(p):                  # decoupled weight decay on matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return OptState(step=step, m=state.m, v=state.v)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Callable | float = 1e-2
    momentum: float = 0.9

    def init(self, params: dict) -> OptState:
        return OptState(step=_step0(params), m=_zeros(params), v={})

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict) -> OptState:
        """One heavy-ball step, ``m = momentum * m + g``, ``p -= lr * m``, in place."""
        with implicit_replication():
            return self._update(grads, state, params)

    def _update(self, grads: dict, state: OptState, params: dict) -> OptState:
        step = state.step + 1
        lr = _lr(self.lr, step)
        for name, p in params.items():
            m = state.m[name]
            m.copy_(self.momentum * m + grads[name].float())
            p.copy_(p.float() - lr * m)
        return OptState(step=step, m=state.m, v={})
