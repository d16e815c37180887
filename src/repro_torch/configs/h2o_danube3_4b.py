"""H2O-Danube3-4B: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]  SWA window 4096 -> ring-buffer KV cache, so long_500k
decode is sub-quadratic (cache bounded at the window size)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o_danube3_4b",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab_size=32000, head_dim=120, sliding_window=4096,
    notes="SWA ring cache bounds long-context decode memory",
)
