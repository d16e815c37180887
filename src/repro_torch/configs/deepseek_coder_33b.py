"""DeepSeek-Coder-33B: llama-arch dense GQA. [arXiv:2401.14196; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_coder_33b",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab_size=32256, head_dim=128, rope_theta=100000.0,
    notes="pure full attention: long_500k skipped",
)
