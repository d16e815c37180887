"""Data for the port: synthetic generators over a numpy ``Generator``."""
from .synthetic import (make_blobs, make_blobs_multiclass, make_susy_like, make_two_moons,
                        train_test_split)

__all__ = ["make_blobs", "make_blobs_multiclass", "make_susy_like", "make_two_moons",
           "train_test_split"]
