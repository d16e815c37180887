"""Chameleon-34B: early-fusion VLM backbone, qk-norm. [arXiv:2405.09818]
VQ image tokenizer is a stub: inputs are already token ids in the shared
65536 vocab (text + image codes)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon_34b",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=65536, head_dim=128, qk_norm=True,
    notes="early-fusion: frontend stubbed to token ids; long_500k skipped",
)
