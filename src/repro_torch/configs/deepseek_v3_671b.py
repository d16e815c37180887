"""DeepSeek-V3 (671B total / 37B active): MLA + MoE 256e top-8 (sigmoid
router, 1 shared), MTP depth 1.  [arXiv:2412.19437; hf]"""
from .base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek_v3_671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab_size=129280,
    attn_kind="mla",
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
               qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(num_experts=256, top_k=8, n_shared=1, d_expert=2048,
               first_dense=3, router="sigmoid"),
    dense_ff=18432, mtp_depth=1,
    notes="MTP implemented as one extra depth-1 prediction block (simplified)",
)
