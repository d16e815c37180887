"""Gradient compression for the data-parallel all-reduce: int8 with error feedback.

PyTorch counterpart of ``repro.train.grad_compress``.  Each tensor is
quantized symmetrically to int8 with one float32 scale (``absmax / 127``);
what rounding loses is kept as a residual and added to the next step's
gradient (error feedback).  Trees are dicts of tensors.  ``torch.round``
rounds half to even, as ``jnp.round`` does.

``compressed_psum`` is the all-reduce over a ``torch.distributed`` group:
one ``all_reduce(MAX)`` of every tensor's local absmax gives a scale shared
by the ranks, so the int8 payloads add exactly; they are summed as int32
(int8 would overflow) in one ``all_reduce(SUM)`` and dequantized into the
mean.  On the wire: 4 bytes an element as int32 here (the reference's
``psum`` of int32 is the same), one float a tensor for the scales.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns ``(q, scale)``, scale a 0-d float32."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _corrected(grads: dict, residual: dict | None) -> dict:
    if residual is None:
        return {k: g.float() for k, g in grads.items()}
    return {k: g.float() + residual[k] for k, g in grads.items()}


def compress_tree(grads: dict, residual: dict | None):
    """Quantize ``grads + residual``; returns ``(payload, new_residual)`` with
    payload ``{"q": {name: int8}, "scale": {name: float32}}``."""
    corrected = _corrected(grads, residual)
    q, scale = {}, {}
    for k, c in corrected.items():
        q[k], scale[k] = quantize_int8(c)
    new_residual = {k: c - dequantize_int8(q[k], scale[k]) for k, c in corrected.items()}
    return {"q": q, "scale": scale}, new_residual


def decompress_tree(payload: dict) -> dict:
    return {k: dequantize_int8(q, payload["scale"][k]) for k, q in payload["q"].items()}


def compressed_psum(grads: dict, residual: dict | None, group=None):
    """Error-feedback int8 mean of ``grads`` over the ranks of ``group``.

    Every rank calls it with the same names and shapes.  Returns ``(mean,
    new_residual)``: ``mean`` float32, equal on every rank; the residual
    is this rank's rounding error, to pass in at the next step."""
    corrected = _corrected(grads, residual)
    names = list(corrected)
    absmax = torch.stack([torch.clamp(torch.max(torch.abs(corrected[k])), min=1e-12)
                          for k in names])
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scales = absmax / 127.0
    q, new_residual = {}, {}
    for i, k in enumerate(names):
        c, s = corrected[k], scales[i]
        q[k] = torch.clamp(torch.round(c / s), -127, 127).to(torch.int8)
        new_residual[k] = c - q[k].float() * s
    payload = torch.cat([q[k].reshape(-1).to(torch.int32) for k in names])
    dist.all_reduce(payload, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    mean, start = {}, 0
    for i, k in enumerate(names):
        size = corrected[k].numel()
        summed = payload[start:start + size].reshape(corrected[k].shape)
        mean[k] = summed.float() * scales[i] / n
        start += size
    return mean, new_residual
