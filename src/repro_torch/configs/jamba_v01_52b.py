"""Jamba-v0.1 (52B total / 12B active): hybrid Mamba+attention 1:7 with MoE.
[arXiv:2403.19887; hf]  Layer unit of 8: attention at offset 4, mamba
elsewhere; MoE (16 experts, top-2) on every other layer.  The mamba mixer is
realized with the SSD (mamba-2) formulation at d_state=16 (DESIGN.md notes
this substitution; the assignment targets the hybrid structure)."""
from .base import ArchConfig, MoECfg, SSMCfg

CONFIG = ArchConfig(
    name="jamba_v01_52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    attn_layer_period=8, attn_layer_offset=4,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    moe=MoECfg(num_experts=16, top_k=2, d_expert=14336, layer_period=2,
               layer_offset=1),
    notes="hybrid: mamba layers O(1) decode; 4 attn layers carry the 500k cache",
)
