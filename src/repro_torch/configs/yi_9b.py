"""Yi-9B: llama-arch GQA (kv=4). [arXiv:2403.04652; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi_9b",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000, head_dim=128, rope_theta=5_000_000.0,
    notes="pure full attention: long_500k skipped; kv=4 < model axis -> KV replicated",
)
