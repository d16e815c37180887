"""Architecture configs of the language-model families: one module an
architecture and the registry (the port's copy of ``repro.configs``)."""
from .base import ArchConfig, MLACfg, MoECfg, SSMCfg
from .registry import ARCH_NAMES, SHAPES, all_cells, cell_applicable, get, get_smoke

__all__ = ["ArchConfig", "MLACfg", "MoECfg", "SSMCfg", "ARCH_NAMES", "SHAPES",
           "all_cells", "cell_applicable", "get", "get_smoke"]
