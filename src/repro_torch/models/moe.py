"""Mixture-of-Experts FFN: shared experts plus routed top-k with capacity dispatch.

PyTorch counterpart of ``repro.models.moe``.  Each (token, choice) copy gets a
position inside its expert's capacity buffer from a cumulative sum over the
flattened routing one-hot (GShard), in the order ``topk`` returns the
choices (descending score, as ``jax.lax.top_k``); copies past the capacity
are dropped and contribute exactly 0.  The kept copies are scattered into an
(E, C, D) buffer, the experts run as one batched SwiGLU, and each choice's
output is gathered back and weighted by its gate.  The router is float32
whatever the model's dtype.  Every shape is static: nothing reads the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Drawn, empty_param, normal


class SharedExperts(Drawn):
    """The always-on experts as one SwiGLU of width ``n_shared * d_expert``."""

    def __init__(self, d: int, width: int, dtype, device=None):
        super().__init__()
        self.w_gate = empty_param((d, width), dtype, device, axes=("embed", "ffn"))
        self.w_up = empty_param((d, width), dtype, device, axes=("embed", "ffn"))
        self.w_down = empty_param((width, d), dtype, device, axes=("ffn", "embed"))

    def init_plan(self) -> list:
        return [(w, normal()) for w in (self.w_gate, self.w_up, self.w_down)]

    def forward(self, xf):
        return (F.silu(xf @ self.w_gate) * (xf @ self.w_up)) @ self.w_down


class MoE(Drawn):
    """``router`` (d, E) float32; ``w_gate``/``w_up`` (E, d, f), ``w_down``
    (E, f, d); ``shared`` with ``n_shared``."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        m, d = cfg.moe, cfg.d_model
        self.router = empty_param((d, m.num_experts), torch.float32, device, axes=("embed", None))
        self.w_gate = empty_param((m.num_experts, d, m.d_expert), dtype, device,
                                  axes=("experts", "embed", "expert_ffn"))
        self.w_up = empty_param((m.num_experts, d, m.d_expert), dtype, device,
                                axes=("experts", "embed", "expert_ffn"))
        self.w_down = empty_param((m.num_experts, m.d_expert, d), dtype, device,
                                  axes=("experts", "expert_ffn", "embed"))
        if m.n_shared:
            self.shared = SharedExperts(d, m.n_shared * m.d_expert, dtype, device)

    def init_plan(self) -> list:
        plan = [(w, normal()) for w in (self.router, self.w_gate, self.w_up, self.w_down)]
        return plan + (self.shared.init_plan() if self.cfg.moe.n_shared else [])

    def forward(self, x):
        """x: (B, S, D) -> (B, S, D)."""
        m = self.cfg.moe
        bsz, s, d = x.shape
        t, k, e = bsz * s, m.top_k, m.num_experts
        c = capacity(m, t)
        xf = x.reshape(t, d)
        gate, _, _, keep, slot = route(m, self.router, xf, c)

        # dispatch: scatter the kept copies into the (E*C, D) buffer; dropped
        # copies land in one extra row that is cut off
        tok_idx = torch.arange(t * k, device=x.device) // k
        buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
        # out of place: a DTensor cannot be copied into a plain buffer in place
        buf = buf.index_copy(0, slot, xf.index_select(0, tok_idx))
        buf = buf[:e * c].reshape(e, c, d)

        # grouped expert SwiGLU
        out = torch.bmm(F.silu(torch.bmm(buf, self.w_gate)) * torch.bmm(buf, self.w_up),
                        self.w_down)                                     # (E, C, D)

        # combine: gather each choice's output back, weight, sum over k
        y_rep = out.reshape(e * c, d).index_select(0, torch.where(keep, slot, 0)) \
            * keep[:, None].to(x.dtype)
        y = (y_rep.reshape(t, k, d) * gate.reshape(t, k, 1).to(x.dtype)).sum(dim=1)
        if m.n_shared:
            y = y + self.shared(xf)
        return y.reshape(bsz, s, d)


def capacity(m, n_tokens: int) -> int:
    """Copies each expert's buffer holds."""
    return max(m.min_capacity, int(n_tokens * m.top_k * m.capacity_factor) // m.num_experts)


def route(m, router, xf, c: int):
    """The routing decisions for tokens xf (T, D) at capacity ``c``.

    Returns ``(gate, sel, pos, keep, slot)``: the renormalised and scaled
    gates (T, k) and chosen experts (T, k) in descending score order, and for
    each flattened (token, choice) copy its position in its expert's buffer,
    whether it fits, and its row of the (E*C) buffer (E*C when dropped)."""
    e = m.num_experts
    logits = (xf.float() @ router).float()
    scores = torch.sigmoid(logits) if m.router == "sigmoid" else torch.softmax(logits, dim=-1)
    gate, sel = torch.topk(scores, m.top_k, dim=-1, sorted=True)          # (T, k)
    gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9)
    gate = gate * m.routed_scale

    flat = sel.reshape(-1)
    onehot = (flat[:, None] == torch.arange(e, device=xf.device)).to(torch.int64)  # (T*k, E)
    pos_all = torch.cumsum(onehot, dim=0) - onehot                         # preceding count
    pos = torch.gather(pos_all, 1, flat[:, None])[:, 0]
    keep = pos < c
    slot = torch.where(keep, flat * c + pos, e * c)
    return gate, sel, pos, keep, slot
