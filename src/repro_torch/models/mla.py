"""Multi-head Latent Attention (DeepSeek-V2/V3) with decoupled RoPE.

PyTorch counterpart of ``repro.models.mla``.  The cache holds only the
compressed latent per token, ``ckv`` (kv_lora_rank), and the shared rotary
key ``krope`` (qk_rope_dim).  Decode is the weight-absorbed form over the
latent cache, in float32:

    q'_nope = q_nope @ W_kvb_k            (B, 1, H, kv_lora)
    scores  = q'_nope . c_kv + q_rope . k_rope
    ctx_lat = softmax(scores) @ c_kv      (B, 1, H, kv_lora), narrowed
    ctx     = ctx_lat @ W_kvb_v           (B, 1, H, v_dim)

Full and prefill expand the latents into per-head K/V; above
``cfg.attn_chunk`` the shared rotary key is folded into per-head K and the
chunked online softmax of ``attention`` runs with one query per group.
"""
from __future__ import annotations

import torch

from .attention import NEG, _chunked_sdpa, _mask
from .common import Drawn, apply_rope, empty_param, normal, ones, placed_like, rms_norm


class MLA(Drawn):
    """Parameters as the reference's: ``wq_a`` (d, q_lora), ``q_norm``,
    ``wq_b`` (q_lora, h, nope + rope) (or ``wq`` (d, h, nope + rope) without a
    q LoRA), ``wkv_a`` (d, kv_lora + rope), ``kv_norm``, ``wkv_b`` (kv_lora,
    h, nope + v) and ``wo`` (h, v, d)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        if m.q_lora_rank:
            self.wq_a = empty_param((d, m.q_lora_rank), dtype, device, axes=("embed", "q_lora"))
            self.q_norm = empty_param((m.q_lora_rank,), dtype, device, axes=("q_lora",))
            self.wq_b = empty_param((m.q_lora_rank, h, qk_dim), dtype, device,
                                    axes=("q_lora", "q_heads", "head"))
        else:
            self.wq = empty_param((d, h, qk_dim), dtype, device, axes=("embed", "q_heads", "head"))
        self.wkv_a = empty_param((d, m.kv_lora_rank + m.qk_rope_dim), dtype, device,
                                 axes=("embed", "kv_lora"))
        self.kv_norm = empty_param((m.kv_lora_rank,), dtype, device, axes=("kv_lora",))
        self.wkv_b = empty_param((m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim), dtype, device,
                                 axes=("kv_lora", "q_heads", "head"))
        self.wo = empty_param((h, m.v_head_dim, d), dtype, device,
                              axes=("q_heads", "head", "embed"))

    def init_plan(self) -> list:
        if self.cfg.mla.q_lora_rank:
            plan = [(self.wq_a, normal()), (self.q_norm, ones), (self.wq_b, normal())]
        else:
            plan = [(self.wq, normal())]
        return plan + [(self.wkv_a, normal()), (self.kv_norm, ones), (self.wkv_b, normal()),
                       (self.wo, normal())]

    def _project_q(self, x):
        cfg, m = self.cfg, self.cfg.mla
        if m.q_lora_rank:
            q_lat = rms_norm(x @ self.wq_a, self.q_norm, cfg.norm_eps)
            q = torch.einsum("bsr,rhe->bshe", q_lat, self.wq_b)
        else:
            q = torch.einsum("bsd,dhe->bshe", x, self.wq)
        return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]

    def forward(self, x, positions, *, mode: str = "full", cache=None, cache_pos=None):
        """Returns (y, new_cache).  Cache = {"ckv": (B,S,r), "krope": (B,S,rd)},
        written in place in decode."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, d = x.shape
        h = cfg.n_heads
        scale = 1.0 / float(m.qk_nope_dim + m.qk_rope_dim) ** 0.5
        causal = cfg.causal and not cfg.is_encoder

        q_nope, q_rope = self._project_q(x)                    # (B,S,H,*)
        kv_a = x @ self.wkv_a                                  # (B,S,r+rd)
        c_kv = rms_norm(kv_a[..., :m.kv_lora_rank], self.kv_norm, cfg.norm_eps)
        k_rope = kv_a[..., m.kv_lora_rank:]                    # (B,S,rd) shared by heads

        if mode == "decode":
            pos = cache_pos
            ckv, krope = cache["ckv"], cache["krope"]
            steps = torch.arange(s, dtype=torch.int32, device=x.device)
            abs_pos = pos + steps
            q_rope = apply_rope(q_rope, abs_pos, cfg.rope_theta)
            k_rope = apply_rope(k_rope[:, :, None, :], abs_pos, cfg.rope_theta)[:, :, 0]
            w = ckv.shape[1]
            idx = (torch.clamp(pos, max=w - s) + steps).long()
            ckv.index_copy_(1, idx, placed_like(c_kv.to(ckv.dtype), ckv))
            krope.index_copy_(1, idx, placed_like(k_rope.to(krope.dtype), krope))
            valid = torch.arange(w, device=x.device) <= pos     # (W,)
            bias = torch.where(valid, 0.0, NEG)[None, None, None, :]

            wkvb_k = self.wkv_b[..., :m.qk_nope_dim]           # (r, H, nope)
            wkvb_v = self.wkv_b[..., m.qk_nope_dim:]           # (r, H, v)
            q_lat = torch.einsum("bshe,rhe->bshr", q_nope, wkvb_k)      # (B,1,H,r)
            ckv32 = ckv.float()
            s_lat = torch.einsum("bshr,bwr->bhsw", q_lat.float(), ckv32)
            s_rope = torch.einsum("bshe,bwe->bhsw", q_rope.float(), krope.float())
            probs = torch.softmax((s_lat + s_rope) * scale + bias, dim=-1)
            ctx_lat = torch.einsum("bhsw,bwr->bshr", probs, ckv32)
            ctx = torch.einsum("bshr,rhe->bshe", ctx_lat.to(x.dtype), wkvb_v)
            new_cache = cache
        else:
            q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
            k_rope_r = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
            kv = torch.einsum("bsr,rhe->bshe", c_kv, self.wkv_b)
            k_nope = kv[..., :m.qk_nope_dim]
            v = kv[..., m.qk_nope_dim:]
            if s > cfg.attn_chunk and s % cfg.attn_chunk == 0:
                # fold the shared rotary key into per-head K and reuse the
                # chunked core (MHA layout: hkv = H, group = 1)
                k_full = torch.cat(
                    [k_nope, k_rope_r[:, :, None, :].expand(b, s, h, m.qk_rope_dim)], dim=-1)
                q_full = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]
                ctx = _chunked_sdpa(q_full, k_full, v, positions, causal=causal, window=None,
                                    scale=scale, chunk=cfg.attn_chunk)[:, :, :, 0, :]
            else:
                bias = torch.where(_mask(positions, positions, causal, None), 0.0, NEG)
                s_nope = torch.einsum("bqhe,bkhe->bhqk", q_nope, k_nope).float()
                s_rope = torch.einsum("bqhe,bke->bhqk", q_rope, k_rope_r).float()
                scores = (s_nope + s_rope) * scale + bias[None, None]
                probs = torch.softmax(scores, dim=-1).to(v.dtype)
                ctx = torch.einsum("bhqk,bkhe->bqhe", probs, v)
            new_cache = None
            if mode == "prefill":
                new_cache = {"ckv": c_kv.to(x.dtype).contiguous(),
                             "krope": k_rope_r.to(x.dtype).contiguous()}

        y = torch.einsum("bshe,hed->bsd", ctx, self.wo)
        return y, new_cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device=None):
    """Zeroed latent and rotary-key caches of ``max_len`` positions."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype, device=device),
    }
