"""HuBERT-XLarge backbone: 48L encoder, d=1280, 16H, ff=5120, 504 clusters.

[arXiv:2106.07447]  Audio frontend (CNN feature extractor + k-means targets)
is a stub per the assignment: inputs are precomputed 512-d frame embeddings.
Positional information comes from RoPE instead of HuBERT's conv-pos embedding
(noted hardware adaptation: RoPE composes with the shared attention core).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert_xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, head_dim=80,
    is_encoder=True, causal=False, input_kind="frames", frame_dim=512,
    mlp_act="gelu",
    notes="encoder-only; decode shapes skipped",
)
