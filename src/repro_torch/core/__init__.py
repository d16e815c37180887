"""The paper's training loop in PyTorch: merge math, lookup tables, the kernel
cache, budget maintenance, binary BSGD and the one-vs-rest class axis
(counterpart of ``repro.core``)."""
from .bsgd import (BSGDConfig, SVMState, accuracy, decision_function, drain_budget, fit,
                   init_state, insert_from_rows, predict, resolve_device, train_epoch,
                   train_step, train_step_from_rows)
from .budget import (METHODS, STRATEGIES, MaintenanceInfo, candidate_scores, kmeans_codebook,
                     maintenance_step, run_maintenance, run_maintenance_classes, seed_codebook)
from .lookup import MergeLookupTable, build_merge_tables, default_table
from .multiclass import (MulticlassSVMConfig, accuracy_multiclass, class_kernel_rows,
                         decision_function_multiclass, fit_multiclass, fit_multiclass_loop,
                         init_multiclass_state, ovr_targets, predict_multiclass,
                         train_epoch_multiclass, train_step_multiclass)

__all__ = [
    "BSGDConfig", "METHODS", "MaintenanceInfo", "MergeLookupTable", "MulticlassSVMConfig",
    "STRATEGIES", "SVMState", "accuracy", "accuracy_multiclass", "build_merge_tables",
    "candidate_scores", "class_kernel_rows", "decision_function", "decision_function_multiclass",
    "default_table", "drain_budget", "fit", "fit_multiclass", "fit_multiclass_loop",
    "init_multiclass_state", "init_state", "insert_from_rows", "kmeans_codebook",
    "maintenance_step", "ovr_targets", "predict", "predict_multiclass", "resolve_device",
    "run_maintenance", "run_maintenance_classes", "seed_codebook", "train_epoch",
    "train_epoch_multiclass", "train_step", "train_step_from_rows", "train_step_multiclass",
]
