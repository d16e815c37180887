"""The paper's training loop in PyTorch: merge math, lookup tables, budget
maintenance and binary BSGD (counterpart of ``repro.core``)."""
from .bsgd import (BSGDConfig, SVMState, accuracy, decision_function, drain_budget, fit,
                   init_state, insert_from_rows, predict, resolve_device, train_epoch,
                   train_step, train_step_from_rows)
from .budget import (METHODS, STRATEGIES, MaintenanceInfo, candidate_scores,
                     maintenance_step, run_maintenance)
from .lookup import MergeLookupTable, build_merge_tables, default_table

__all__ = [
    "BSGDConfig", "METHODS", "MaintenanceInfo", "MergeLookupTable", "STRATEGIES", "SVMState",
    "accuracy", "build_merge_tables", "candidate_scores", "decision_function", "default_table",
    "drain_budget", "fit", "init_state", "insert_from_rows", "maintenance_step", "predict",
    "resolve_device", "run_maintenance", "train_epoch", "train_step", "train_step_from_rows",
]
