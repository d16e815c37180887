"""Mamba2-130m: 24 SSD layers, d=768, attention-free, no FFN. [arXiv:2405.21060]"""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2_130m",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
    vocab_size=50280, head_dim=64,
    pure_ssm=True, tie_embeddings=True,
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    notes="SSD state-space duality; O(1)-state decode makes long_500k native",
)
