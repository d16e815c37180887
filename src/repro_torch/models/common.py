"""Shared model pieces: the parameter init, norms, RoPE, activations, the loss.

PyTorch counterpart of ``repro.models.common``.  Parameters are drawn as the
reference draws them (a standard normal truncated to [-2, 2], times
``scale``, default 1/sqrt(fan_in), in float32, then narrowed to the
parameter's dtype), from an explicit ``torch.Generator``; the streams are
torch's, so the values are not the reference's.  Large tensors are drawn a
block of leading rows at a time, so the float32 temporary stays near
``DRAW_BLOCK`` elements whatever the tensor's size.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

DRAW_BLOCK = 1 << 28           # float32 elements drawn at once (1 GiB)
_TRUNC = math.erf(2.0 / math.sqrt(2.0))   # P(|z| < 2) mapped to erf's range


def empty_param(shape, dtype, device=None, *, axes: tuple) -> nn.Parameter:
    """An uninitialised parameter; the modules' ``init_`` draws it.

    ``axes`` names each dim's logical axis, the names the reference passes
    to ``repro.models.common.param`` (None for a dim never sharded); it is
    kept as the parameter's ``axes`` attribute, which
    ``sharding.specs.param_specs`` resolves against a mesh."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not name the dims of shape {tuple(shape)}")
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    p.axes = tuple(axes)
    return p


def trunc_normal_(t: torch.Tensor, gen: torch.Generator, scale: float | None = None):
    """Fill ``t`` in place with ``scale`` times a standard normal truncated to
    [-2, 2], drawn in float32 (inverse erf of a uniform) and then narrowed.
    The default scale is the reference's 1/sqrt(fan_in), fan_in the first
    dim (a vector's only dim)."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(1, t.shape[0] if t.dim() > 1 else t.shape[-1]))
    rows = t.reshape(-1, *t.shape[1:]) if t.dim() else t.reshape(1)
    per_row = max(1, math.prod(rows.shape[1:]))
    for block in rows.split(max(1, DRAW_BLOCK // per_row)):
        u = torch.empty(block.shape, dtype=torch.float32, device=t.device)
        u.uniform_(-_TRUNC, _TRUNC, generator=gen)
        block.copy_(torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale))
    return t


def normal(scale: float | None = None):
    """An ``init_plan`` fill: ``trunc_normal_`` at ``scale``."""
    return lambda t, gen: trunc_normal_(t, gen, scale)


def ones(t, gen):
    t.fill_(1.0)


def zeros(t, gen):
    t.zero_()


class Drawn(nn.Module):
    """A module whose weights are drawn by ``init_plan()``: ``(parameter, fill)``
    pairs in drawing order, ``fill(tensor, generator)`` writing the values in
    place.  ``init_`` fills the module's own parameters; a sharded init
    (``sharding.specs.distribute_model``) fills a host tensor a parameter at
    a time in the same order."""

    def init_plan(self) -> list:
        raise NotImplementedError

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for p, fill in self.init_plan():
            fill(p, gen)


def placed_like(src, dst):
    """``src`` at ``dst``'s placements when ``dst`` is a DTensor (a plain
    ``src`` taken as replicated), for an in-place copy into ``dst``: DTensor
    would otherwise take the source's placements for ``dst`` without moving
    its data.  ``src`` itself otherwise."""
    if not isinstance(dst, DTensor):
        return src
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return src.redistribute(mesh, dst.placements)


def replicated(x, axes=("model",), *, always: bool = False):
    """``x`` with the mesh dims named in ``axes`` replicated when ``x`` is a
    DTensor (a gather, or the reduction of a partial result; any partial sum
    on another dim reduced too), and its gradient at those placements;
    ``x`` itself otherwise, so a model on one device runs the same ops as
    without a mesh.  A DTensor already at them passes as it is, unless
    ``always`` asks for its gradient to be replicated all the same.

    The model calls it where DTensor's own placements fail an op: an
    embedding lookup on a vocab-sharded table (a masked partial sum that a
    second consumer cannot reduce, nor a partial gradient go back to), the
    gather of the gold logit over a vocab-sharded row, and around each
    matmul of a layer whose residual is sequence-sharded (torch 2.11's
    DTensor will not flatten a sharded sequence dim, in either pass)."""
    if not isinstance(x, DTensor):
        return x
    mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names
    places = tuple(Replicate() if n in axes or p.is_partial() else p
                   for n, p in zip(names, x.placements))
    if places == tuple(x.placements):
        if not always:
            return x
        out = x
    else:
        out = x.redistribute(mesh, places)
    return DTensor.from_local(out.to_local(grad_placements=places), mesh, places,
                              run_check=False, shape=out.shape, stride=out.stride())


def rms_norm(x, gamma, eps: float = 1e-5):
    """Normalise in float32, narrow to x's dtype, then multiply by gamma."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * gamma


def rope_angles(positions, dim: int, theta: float):
    """positions: (...,) -> cos/sin of shape (..., dim//2)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """Rotary embedding, rotate-half on the two halves.  x: (B, S, H, D),
    positions: (B, S) or (S,)."""
    b, s, h, d = x.shape
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, s)
    cos, sin = rope_angles(positions, d, theta)           # (B, S, D/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: (x) -> silu(x Wg) * (x Wu) Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def softmax_xent(logits, labels, weight=None):
    """Mean cross-entropy in float32.  logits: (..., V), labels: (...) int."""
    logits = replicated(logits).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if weight is None:
        return torch.mean(nll)
    w = weight.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
