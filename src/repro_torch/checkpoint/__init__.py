"""Atomic keep-last-k checkpoints in ``repro.checkpoint``'s on-disk format
(see ``checkpointer`` for the layout)."""
from .checkpointer import (ShapeDtype, all_steps, latest_step, latest_verifiable_step, load,
                           load_metadata, restore_latest, save, save_async, verify_step)

__all__ = ["ShapeDtype", "all_steps", "latest_step", "latest_verifiable_step", "load",
           "load_metadata", "restore_latest", "save", "save_async", "verify_step"]
