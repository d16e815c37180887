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
from torch.distributed.tensor import DTensor, Partial

from .common import (Drawn, apply_rope, empty_param, normal, ones, placed_like, replicated,
                     rms_norm)

NEG = -1e30


class Attention(Drawn):
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

    def init_plan(self) -> list:
        plan = [(w, normal()) for w in (self.wq, self.wk, self.wv, self.wo)]
        if self.cfg.qk_norm:
            plan += [(self.q_norm, ones), (self.k_norm, ones)]
        return plan

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
            ck.index_copy_(1, idx, placed_like(k.to(ck.dtype), ck))
            cv.index_copy_(1, idx, placed_like(v.to(cv.dtype), cv))
            cp.index_copy_(1, idx, placed_like(abs_pos[None, :].expand(b, s).to(cp.dtype), cp))
            ok = (cp >= 0) & (cp <= pos)                       # (B, W)
            if window is not None:
                ok &= cp > pos - window
            bias = torch.where(ok, 0.0, NEG)[:, None, None, :]  # (B,1,Sq=1,W)
            q5 = _grouped(q, hkv, g)
            ctx = _sdpa(q5, ck.to(q.dtype), cv.to(q.dtype), bias, scale)
            new_cache = cache
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            q5 = _grouped(q, hkv, g)

            def attend(q5, k, v, q_pos):
                if s > cfg.attn_chunk and s % cfg.attn_chunk == 0:
                    return _chunked_sdpa(q5, k, v, positions, causal=causal, window=window,
                                         scale=scale, chunk=cfg.attn_chunk, q_pos=q_pos)
                ok = _mask(q_pos, positions, causal, window)
                bias = torch.where(ok, 0.0, NEG)[None, None]   # (1,1,Sq,S)
                return _sdpa(q5, k, v, bias, scale)

            seq = seq_sharded(cfg, q5)
            if seq is None:
                ctx = attend(q5, k, v, positions)
            else:
                # context parallelism: queries sharded along S over `model`,
                # keys and values whole along S on every rank of `model`;
                # the context is gathered for the output projection (torch
                # 2.11's DTensor will not flatten a sequence-sharded dim)
                ctx = replicated(_query_blocks(attend, seq(q5, 1), seq(k), seq(v), positions))
            new_cache = None
            if mode == "prefill":
                new_cache = {"k": k, "v": v,
                             "pos": positions[None, :].to(torch.int32).repeat(b, 1)}

        y = ctx.reshape(b, s, h * hd) @ self.wo.reshape(h * hd, d)
        return y, new_cache


def seq_sharded(cfg, x):
    """Context parallelism under a mesh (``cfg.seq_shard_attn``, the batch's
    mesh axes, and ``x`` a DTensor): ``place(t, seq_dim=None)`` lays ``t``
    out with its batch dim over those axes and ``seq_dim``, if given, over
    ``model``; None otherwise, so that nothing changes without a mesh."""
    if cfg.seq_shard_attn is None or not isinstance(x, DTensor):
        return None
    from ..sharding.specs import placements

    mesh = x.device_mesh

    def place(t, seq_dim=None):
        spec = [tuple(cfg.seq_shard_attn)] + [None] * (t.dim() - 1)
        if seq_dim is not None:
            spec[seq_dim] = "model"
        return t.redistribute(mesh, placements(tuple(spec), mesh))

    return place


def _query_blocks(attend, q5, k, v, positions):
    """Context-parallel attention on each rank's blocks: ``q5``'s rows along
    S (sharded over ``model``) against the whole keys and values of the
    same batch rows, ``attend(q5, k, v, q_pos)`` on the local tensors with
    the block's query positions.  The context keeps ``q5``'s placements;
    each rank's share of the keys' and values' gradients is partial over
    ``model``."""
    mesh = q5.device_mesh
    m = mesh.mesh_dim_names.index("model")
    n, c = mesh.size(m), mesh.get_local_rank(m)
    if q5.shape[1] % n:
        raise ValueError(f"sequence of {q5.shape[1]} does not split over {n} ranks of `model`")
    kv_grad = tuple(Partial() if i == m else p for i, p in enumerate(k.placements))
    ctx = attend(q5.to_local(), k.to_local(grad_placements=kv_grad),
                 v.to_local(grad_placements=kv_grad), positions.chunk(n)[c])
    return DTensor.from_local(ctx, mesh, q5.placements, run_check=False)


def _grouped(q, hkv: int, g: int):
    """(B, S, H, hd) -> (B, S, Hkv, G, hd).  A DTensor whose heads shard over
    more ranks than there are KV heads (jamba's 2 over 4) cannot be split so:
    its heads are gathered first."""
    if isinstance(q, DTensor) and any(
            p.is_shard(2) and hkv % q.device_mesh.size(i) for i, p in enumerate(q.placements)):
        q = replicated(q)
    b, s, _, hd = q.shape
    return q.reshape(b, s, hkv, g, hd)


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


def _chunked_sdpa(q5, k, v, positions, *, causal, window, scale, chunk, q_pos=None):
    """Online-softmax attention over key/value chunks of length ``chunk``.

    ``positions`` (S,) are the keys', ``q_pos`` the queries' (default the
    same: self-attention; a block of them under context parallelism).
    Peak activation is O(S * chunk) per head instead of O(S^2)."""
    q_pos = positions if q_pos is None else q_pos
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
        bias = torch.where(_mask(q_pos, kpc, causal, window), 0.0, NEG)   # (Sq, chunk)
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
