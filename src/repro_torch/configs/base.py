"""Architecture config schema for the language-model families (the port's copy
of ``repro.configs.base``).

One frozen dataclass describes every supported family: dense GQA decoders,
encoder-only (hubert), SSM (mamba2), hybrid interleave (jamba), MLA + MoE
(deepseek v2/v3), early-fusion VLM backbones (chameleon).  ``layer_plan()``
expands the per-layer (mixer, ffn) kinds; ``scan_unit``/``prefix_layers``
derive how the reference groups layers into a repeating unit plus a prefix
(e.g. deepseek-v3's first 3 dense layers); the port's model is one list of
layers in the same order.

``remat`` recomputes each layer's forward in the backward of a training
forward (``models.lm.forward``, the reference's ``jax.checkpoint`` of each
scanned unit).  ``seq_shard_attn`` (the batch's mesh axes, e.g.
``("data",)``) turns on context-parallel attention for a model laid out on
a ``DeviceMesh``: queries and the residual after an attention layer
sharded along the sequence over ``model`` (``models.attention.
seq_sharded``); without a mesh it does nothing.  ``scan_unroll`` is a
setting of the JAX package's scans (unrolled for cost accounting); it stays
so that a config compares field by field with the reference's and does
nothing here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0              # per-expert FFN hidden size
    capacity_factor: float = 1.25
    min_capacity: int = 4
    router: str = "softmax"        # softmax | sigmoid (v3 aux-free style)
    layer_period: int = 1          # MoE FFN on layers with i % period == offset
    layer_offset: int = 0
    first_dense: int = 0           # first N layers use the dense FFN
    routed_scale: float = 1.0      # scaling factor on routed output (deepseek)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256               # SSD chunk length (must divide seq len)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    absorb_decode: bool = False    # weight-absorbed decode path (perf option)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # mixer selection
    attn_kind: str = "gqa"         # gqa | mla
    attn_layer_period: int = 1     # hybrid: attn on i % period == offset, else mamba
    attn_layer_offset: int = 0
    pure_ssm: bool = False         # all layers mamba (attn_* ignored)
    # attention details
    causal: bool = True
    is_encoder: bool = False
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # inputs
    input_kind: str = "tokens"     # tokens | frames (audio stub frontend)
    frame_dim: int = 512
    # submodules
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # output / misc
    mlp_act: str = "swiglu"        # swiglu (3-matrix) | gelu (2-matrix, hubert)
    dense_ff: Optional[int] = None  # FFN width on dense layers of MoE archs
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mtp_depth: int = 0             # deepseek-v3 multi-token prediction blocks
    dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: bool = False      # unroll layer groups (dry-run cost accounting:
                                   # XLA counts while-loop bodies once, so the
                                   # roofline lowers the unrolled form)
    seq_shard_attn: Optional[tuple] = None
                                   # context-parallel attention: when head
                                   # counts don't divide the model axis, shard
                                   # the QUERY sequence dim over `model`
                                   # instead of replicating attention compute.
                                   # Value = the batch (dp) mesh axes, e.g.
                                   # ("data",).  §Perf hillclimb lever.
    attn_chunk: int = 2048         # KV-chunked (online-softmax) attention above this
    notes: str = ""

    # ------------------------------------------------------------------ #
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 128) * 128  # a multiple of 128, as the reference pads

    def mixer_kind(self, i: int) -> str:
        if self.pure_ssm:
            return "mamba"
        if self.attn_layer_period == 1:
            return "attn"
        return "attn" if i % self.attn_layer_period == self.attn_layer_offset else "mamba"

    def ffn_kind(self, i: int) -> str:
        m = self.moe
        if m is None:
            return "dense" if self.d_ff > 0 else "none"   # mamba2: mixer-only
        if i < m.first_dense:
            return "dense"
        return "moe" if i % m.layer_period == m.layer_offset else "dense"

    def layer_plan(self) -> tuple[tuple[str, str], ...]:
        return tuple((self.mixer_kind(i), self.ffn_kind(i)) for i in range(self.n_layers))

    @property
    def prefix_layers(self) -> int:
        """Unrolled prefix (layers that break the repeating pattern)."""
        return self.moe.first_dense if self.moe is not None else 0

    @property
    def scan_unit(self) -> int:
        """Smallest repeating unit among the post-prefix layers."""
        plan = self.layer_plan()[self.prefix_layers:]
        n = len(plan)
        for unit in range(1, n + 1):
            if n % unit:
                continue
            if all(plan[i] == plan[i % unit] for i in range(n)):
                return unit
        return n

    @property
    def n_scan_groups(self) -> int:
        return (self.n_layers - self.prefix_layers) // self.scan_unit

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Analytic parameter count (for 6*N*D roofline bookkeeping)."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab_padded * d  # embed
        if not self.tie_embeddings and self.input_kind == "tokens":
            total += d * self.vocab_padded  # lm head
        if self.input_kind == "frames":
            total += self.frame_dim * d + d * self.vocab_padded
        for kind, ffn in self.layer_plan():
            total += 2 * d  # norms
            if kind == "attn":
                if self.attn_kind == "mla":
                    m = self.mla
                    q_in = m.q_lora_rank if m.q_lora_rank else d
                    total += (d * m.q_lora_rank if m.q_lora_rank else 0)
                    total += q_in * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    total += d * (m.kv_lora_rank + m.qk_rope_dim)
                    total += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    total += self.n_heads * hd * d
            else:
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                conv_ch = d_in + 2 * s.n_groups * s.d_state
                total += d * 2 * d_in            # z, x projections
                total += d * 2 * s.n_groups * s.d_state   # B, C projections
                total += d * n_h + 2 * n_h       # dt proj + A_log + dt_bias
                total += conv_ch * s.d_conv + conv_ch     # conv + bias
                total += n_h                      # D skip
                total += d_in                     # gate norm
                total += d_in * d                 # out proj
            if ffn == "dense":
                ff = self.d_ff if self.moe is None else (self.moe_dense_ff())
                total += (3 if self.mlp_act == "swiglu" else 2) * d * ff
            elif ffn == "moe":
                m = self.moe
                total += d * m.num_experts        # router
                total += m.num_experts * 3 * d * m.d_expert
                total += m.n_shared * 3 * d * m.d_expert
        total += d  # final norm
        return total

    def moe_dense_ff(self) -> int:
        """Dense-FFN width used on non-MoE layers of MoE archs."""
        return self.dense_ff if self.dense_ff is not None else self.d_ff

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        inactive = sum(1 for _, f in self.layer_plan() if f == "moe") * \
            (m.num_experts - m.top_k) * per_expert
        return self.param_count() - inactive

    def scaled_down(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        defaults = dict(
            n_layers=max(2, self.scan_unit) + self.prefix_layers if self.moe else min(2, self.n_layers),
            d_model=64, n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128, vocab_size=128, head_dim=16,
            dtype="float32", attn_chunk=64,
        )
        if self.moe is not None:
            defaults["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=32,
                n_shared=min(self.moe.n_shared, 1))
        if self.dense_ff is not None:
            defaults["dense_ff"] = 128
        if self.mla is not None:
            defaults["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=32, q_lora_rank=32, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16)
        if self.ssm is not None:
            defaults["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.sliding_window is not None:
            defaults["sliding_window"] = 32
        defaults.update(overrides)
        return dataclasses.replace(self, **defaults)
