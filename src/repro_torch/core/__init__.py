"""The paper's training loop in PyTorch: merge math, lookup tables, the kernel
cache, budget maintenance, binary BSGD, the BDCA dual solver, the one-vs-rest
class axis, streaming, prequential evaluation and serving (counterpart of
``repro.core``)."""
# the serving module imports first: importing it binds the package attribute
# ``predict`` to the module, and the ``from .bsgd import`` below then makes
# ``repro_torch.core.predict`` the binary predict function again (as in
# ``repro.core``) — import serving names from ``repro_torch.core`` itself
from . import budget, kernel_cache, merge_math
from .predict import (AsyncBatchQueue, BatchQueue, ModelBank, QueueFull, ServeDeadline, ServeModel,
                      ServeTimeout, default_buckets, drive_trace, export_model, load_serve_model,
                      pad_bucket, predict_labels, predict_proba, ragged_trace_sizes, serve_requests,
                      serve_scores, top_k_labels)
from .bsgd import (BSGDConfig, SVMState, accuracy, decision_function, drain_budget, fit,
                   fit_stream, init_state, insert_from_rows, predict, resolve_device, train_chunk,
                   train_epoch, train_epoch_stream, train_step, train_step_from_rows)
from . import bdca
from .bdca import box_from_lambda
from .budget import (METHODS, STRATEGIES, MaintenanceInfo, candidate_scores, kmeans_codebook,
                     maintenance_step, run_maintenance, run_maintenance_classes, seed_codebook)
from .lookup import (MergeLookupTable, bilinear_lookup, build_lookup_table, build_merge_tables,
                     default_table)
from .merge_math import (EPS_PRECISE, EPS_STANDARD, KAPPA_UNIMODAL, golden_section_search,
                         gss_num_iters, merge_alpha_z, merge_point, s_objective, solve_merge,
                         wd_norm_at, weight_degradation)
from .multiclass import (MulticlassSVMConfig, accuracy_multiclass, check_labels, class_kernel_rows,
                         decision_function_multiclass, fit_multiclass, fit_multiclass_loop,
                         fit_multiclass_stream, init_multiclass_state, ovr_targets,
                         predict_multiclass, train_chunk_multiclass, train_epoch_multiclass,
                         train_epoch_multiclass_stream, train_step_multiclass)
from .online import prequential_stream

__all__ = [
    "AsyncBatchQueue", "BatchQueue", "ModelBank", "QueueFull", "ServeDeadline", "ServeModel",
    "ServeTimeout", "default_buckets", "drive_trace", "export_model", "load_serve_model",
    "pad_bucket", "predict_labels", "predict_proba", "ragged_trace_sizes", "serve_requests",
    "serve_scores", "top_k_labels",
    "BSGDConfig", "METHODS", "MaintenanceInfo", "MergeLookupTable", "MulticlassSVMConfig",
    "STRATEGIES", "SVMState", "accuracy", "accuracy_multiclass", "bdca", "box_from_lambda",
    "build_merge_tables",
    "candidate_scores", "check_labels", "class_kernel_rows", "decision_function",
    "decision_function_multiclass", "default_table", "drain_budget", "fit", "fit_multiclass",
    "fit_multiclass_loop", "fit_multiclass_stream", "fit_stream", "init_multiclass_state",
    "init_state", "insert_from_rows", "kmeans_codebook", "maintenance_step", "ovr_targets",
    "predict", "predict_multiclass", "prequential_stream", "resolve_device", "run_maintenance",
    "run_maintenance_classes", "seed_codebook", "train_chunk", "train_chunk_multiclass",
    "train_epoch", "train_epoch_multiclass", "train_epoch_multiclass_stream",
    "train_epoch_stream", "train_step", "train_step_from_rows", "train_step_multiclass",
    "bilinear_lookup", "budget", "build_lookup_table", "kernel_cache", "merge_math",
    "EPS_PRECISE", "EPS_STANDARD", "KAPPA_UNIMODAL", "golden_section_search", "gss_num_iters",
    "merge_alpha_z", "merge_point", "s_objective", "solve_merge", "wd_norm_at",
    "weight_degradation",
]
