"""SmolLM-360M: small llama-arch (15 heads / 5 kv). [hf:HuggingFaceTB/SmolLM]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm_360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49152, head_dim=64, tie_embeddings=True,
    notes="15 heads not divisible by model axis -> head dims replicated, ffn sharded",
)
