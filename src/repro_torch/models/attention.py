"""GQA attention: RoPE, sliding window, bidirectional, qk-norm, KV cache.

PyTorch counterpart of ``repro.models.attention``.  Three modes:

  * ``full``    — training / encoder forward over the whole sequence;
  * ``prefill`` — like full, and returns the populated KV cache;
  * ``decode``  — one new token against the cache (a ring buffer for
    sliding-window archs), written into the cache in place.

Sequences longer than ``cfg.attn_chunk`` (and a multiple of it) use the
KV-chunked online softmax, so activation memory scales with the chunk, as
the reference computes it in plain JAX.  Every cast sits where the
reference has it: scores in the input dtype cast to float32, probabilities
back to the value dtype; the chunked path in float32 throughout.
"""
from __future__ import annotations

import torch
from torch import nn

from .common import apply_rope, empty_param, rms_norm, trunc_normal_

NEG = -1e30


class Attention(nn.Module):
    """Grouped-query attention with the reference's parameters: ``wq`` (d, h,
    hd), ``wk``/``wv`` (d, hkv, hd), ``wo`` (h, hd, d) and, with qk-norm,
    ``q_norm``/``k_norm`` (hd,)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.wq = empty_param((d, h, hd), dtype, device, axes=("embed", "q_heads", "head"))
        self.wk = empty_param((d, hkv, hd), dtype, device, axes=("embed", "kv_heads", "head"))
        self.wv = empty_param((d, hkv, hd), dtype, device, axes=("embed", "kv_heads", "head"))
        self.wo = empty_param((h, hd, d), dtype, device, axes=("q_heads", "head", "embed"))
        if cfg.qk_norm:
            self.q_norm = empty_param((hd,), dtype, device, axes=("head",))
            self.k_norm = empty_param((hd,), dtype, device, axes=("head",))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            trunc_normal_(w, gen)
        if self.cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)

    def forward(self, x, positions, *, mode: str = "full", cache=None, cache_pos=None):
        """Returns (y, new_cache).  x: (B, S, D); positions: (S,) absolute.

        decode: S == 1, ``cache`` = {"k", "v", "pos"} ring buffers, updated in
        place and returned; ``cache_pos`` = tokens already in the cache (a 0-d
        int tensor on x's device)."""
        cfg = self.cfg
        b, s, d = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        g = h // hkv
        scale = 1.0 / float(hd) ** 0.5
        causal = cfg.causal and not cfg.is_encoder
        window = cfg.sliding_window

        q = (x @ self.wq.reshape(d, h * hd)).reshape(b, s, h, hd)
        k = (x @ self.wk.reshape(d, hkv * hd)).reshape(b, s, hkv, hd)
        v = (x @ self.wv.reshape(d, hkv * hd)).reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)

        if mode == "decode":
            pos = cache_pos
            ck, cv, cp = cache["k"], cache["v"], cache["pos"]
            w = ck.shape[1]
            steps = torch.arange(s, dtype=torch.int32, device=x.device)
            abs_pos = pos + steps
            q = apply_rope(q, abs_pos, cfg.rope_theta)
            k = apply_rope(k, abs_pos, cfg.rope_theta)
            # the reference's dynamic_update_slice at pos % w (ring buffer)
            idx = (torch.clamp(pos % w, max=w - s) + steps).long()
            ck.index_copy_(1, idx, k.to(ck.dtype))
            cv.index_copy_(1, idx, v.to(cv.dtype))
            cp.index_copy_(1, idx, abs_pos[None, :].expand(b, s).to(cp.dtype))
            ok = (cp >= 0) & (cp <= pos)                       # (B, W)
            if window is not None:
                ok &= cp > pos - window
            bias = torch.where(ok, 0.0, NEG)[:, None, None, :]  # (B,1,Sq=1,W)
            q5 = q.reshape(b, s, hkv, g, hd)
            ctx = _sdpa(q5, ck.to(q.dtype), cv.to(q.dtype), bias, scale)
            new_cache = cache
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            q5 = q.reshape(b, s, hkv, g, hd)
            if s > cfg.attn_chunk and s % cfg.attn_chunk == 0:
                ctx = _chunked_sdpa(q5, k, v, positions, causal=causal, window=window,
                                    scale=scale, chunk=cfg.attn_chunk)
            else:
                ok = _mask(positions, positions, causal, window)
                bias = torch.where(ok, 0.0, NEG)[None, None]   # (1,1,S,S)
                ctx = _sdpa(q5, k, v, bias, scale)
            new_cache = None
            if mode == "prefill":
                new_cache = {"k": k, "v": v,
                             "pos": positions[None, :].to(torch.int32).repeat(b, 1)}

        y = ctx.reshape(b, s, h * hd) @ self.wo.reshape(h * hd, d)
        return y, new_cache


def _mask(q_pos, k_pos, causal: bool, window):
    """(Sq, Sk) bool: key j visible from query i."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def _sdpa(q5, k, v, bias, scale):
    """q5: (B,Sq,Hkv,G,hd); k/v: (B,Sk,Hkv,hd); bias: (B|1, 1, Sq, Sk)."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q5, k).float() * scale
    scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _chunked_sdpa(q5, k, v, positions, *, causal, window, scale, chunk):
    """Online-softmax attention over key/value chunks of length ``chunk``.

    Self-attention layout: q positions == k positions == ``positions`` (S,).
    Peak activation is O(S * chunk) per head instead of O(S^2)."""
    b, sq, hkv, g, hd = q5.shape
    sk = k.shape[1]
    hd_v = v.shape[-1]          # MLA: value head dim != qk head dim
    q32 = q5.float()
    f32 = dict(dtype=torch.float32, device=q5.device)
    m = torch.full((b, hkv, g, sq), NEG, **f32)
    l = torch.zeros((b, hkv, g, sq), **f32)
    acc = torch.zeros((b, hkv, g, sq, hd_v), **f32)
    for c0 in range(0, sk, chunk):
        kc, vc, kpc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], positions[c0:c0 + chunk]
        bias = torch.where(_mask(positions, kpc, causal, window), 0.0, NEG)   # (Sq, chunk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kc.float()) * scale
        s = s + bias[None, None, None, :, :]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc.float())
        m = m_new
    ctx = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,Hkv,G,Sq,hd)
    return ctx.permute(0, 3, 1, 2, 4).to(q5.dtype)            # (B,Sq,Hkv,G,hd)


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device=None):
    """Zeroed K/V ring buffers of ``min(window, max_len)`` slots, positions -1."""
    w = max_len if cfg.sliding_window is None else min(cfg.sliding_window, max_len)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, w, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, w, hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, w), -1, dtype=torch.int32, device=device),
    }
