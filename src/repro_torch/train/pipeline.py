"""GPipe-style pipeline over the ranks of a ``torch.distributed`` group.

PyTorch counterpart of ``repro.train.pipeline``.  The layer groups split
into ``n_stages`` runs of consecutive groups, rank s owning run s, and
microbatches flow through the stages on the reference's schedule:
``n_micro + n_stages - 1`` ticks, at tick t stage s works on microbatch
``t - s`` when that is in range, stage 0 taking microbatch t fresh.  After
each tick every rank passes its activations to the next rank (the
reference's ring ``ppermute``, its wrap ignored) by one
``dist.batch_isend_irecv``; gloo sends host tensors only, so a CUDA
activation goes through host memory there.  The last stage's finished
microbatches reach every rank through a sum all-reduce of the outputs,
zero on the other ranks (the reference's masked ``psum``).

Forward only, as the reference's test runs it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _leading(tree) -> int:
    if isinstance(tree, dict):
        return _leading(next(iter(tree.values())))
    return tree.shape[0]


def _ring_pass(y: torch.Tensor, rank: int, n: int, group) -> torch.Tensor:
    """``y`` to rank + 1, the activations of rank - 1 back (mod n)."""
    host = dist.get_backend(group) == "gloo" and y.is_cuda
    send = y.cpu() if host else y.contiguous()
    recv = torch.empty_like(send)
    peer = lambda r: dist.get_global_rank(group, r) if group is not None else r  # noqa: E731
    ops = [dist.P2POp(dist.isend, send, peer((rank + 1) % n), group),
           dist.P2POp(dist.irecv, recv, peer((rank - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(y.device) if host else recv


def pipeline_forward(body_fn, n_stages: int, params_stacked, x_micro: torch.Tensor, group=None):
    """Run ``body_fn(unit_params, x) -> x`` over the stages on ``group``.

    ``params_stacked``: a tensor or a dict of tensors with leading dim
    ``n_groups`` (every rank passes the whole stack and runs its own
    ``n_groups / n_stages`` consecutive groups); ``x_micro``: ``(n_micro,
    micro_batch, ...)`` activations, the same on every rank.  Returns the
    final stage's activations in the same layout on every rank."""
    n = dist.get_world_size(group)
    if n != n_stages:
        raise ValueError(f"{n_stages} stages on a group of {n} ranks")
    n_groups = _leading(params_stacked)
    if n_groups % n_stages:
        raise ValueError(f"{n_groups} layer groups do not split into {n_stages} stages")
    stage = dist.get_rank(group)
    per = n_groups // n_stages
    local = [_index(params_stacked, stage * per + j) for j in range(per)]
    n_micro = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        if 0 <= t - stage < n_micro:           # this stage works on microbatch t - stage
            y = x_micro[t] if stage == 0 else buf
            for unit in local:
                y = body_fn(unit, y)
            if stage == n_stages - 1:
                outs[t - stage] = y
        else:
            y = buf
        buf = _ring_pass(y, stage, n, group) if n > 1 else y
    dist.all_reduce(outs, group=group)         # zeros except on the last stage
    return outs
