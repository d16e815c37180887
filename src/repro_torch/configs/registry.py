"""Registry of the language-model architectures and their shape sets (the
port's copy of ``repro.configs.registry``)."""
from __future__ import annotations

import importlib

from .base import ArchConfig

ARCH_NAMES = (
    "hubert_xlarge", "mamba2_130m", "deepseek_coder_33b", "h2o_danube3_4b",
    "yi_9b", "smollm_360m", "jamba_v01_52b", "chameleon_34b",
    "deepseek_v2_236b", "deepseek_v3_671b",
)

# Assigned input shapes: (seq_len, global_batch) per workload.
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, step="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, step="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, step="decode"),
}


def get(name: str) -> ArchConfig:
    name = name.replace("-", "_")
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def get_smoke(name: str, **overrides) -> ArchConfig:
    return get(name).scaled_down(**overrides)


def cell_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """Whether (arch x shape) is runnable, with the DESIGN.md skip reason."""
    shape = SHAPES[shape_name]
    if shape["step"] == "decode":
        if cfg.is_encoder:
            return False, "encoder-only: no decode step"
        if shape_name == "long_500k":
            has_subquadratic = (cfg.pure_ssm or cfg.attn_layer_period > 1
                                or cfg.sliding_window is not None)
            if not has_subquadratic:
                return False, "pure full attention: long_500k skipped (assignment rule)"
    return True, ""


def all_cells():
    """Yield (arch_name, shape_name, applicable, reason) for all 40 cells."""
    for a in ARCH_NAMES:
        cfg = get(a)
        for s in SHAPES:
            ok, reason = cell_applicable(cfg, s)
            yield a, s, ok, reason
