"""DeepSeek-V2 (236B total / 21B active): MLA (kv_lora=512) + MoE 160e top-6,
2 shared experts.  [arXiv:2405.04434; hf]"""
from .base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek_v2_236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab_size=102400,
    attn_kind="mla",
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
               qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(num_experts=160, top_k=6, n_shared=2, d_expert=1536,
               first_dense=1),
    dense_ff=12288,
    notes="MLA latent cache; long_500k skipped (full attention)",
)
