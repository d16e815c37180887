"""Data for the port (counterpart of ``repro.data``): synthetic generators over
a numpy ``Generator``, LIBSVM parsing, chunked streaming sources with the
port's own shuffle (``EpochKey``), fault injection, and the language
models' token streams (``tokens``)."""
from .faults import (ChunkQuarantined, CorruptChunkError, FaultSchedule, FaultyChunks, ResilienceReport,
                     RetryPolicy, TrainerCrash, TransientIOError, TruncatedChunkError, load_chunk_with_retry)
from .libsvm import dump_libsvm, iter_libsvm_chunks, parse_libsvm
from .stream import (ArrayChunks, ChunkSource, DriftChunks, EpochKey, FileChunks, LibsvmChunks,
                     PrefetchChunks, chunk_order, epoch_permutation, intra_perm, iter_epoch,
                     write_npz_chunks)
from .synthetic import (label_flip_schedule, make_blobs, make_blobs_multiclass, make_susy_like,
                        make_two_moons, mean_shift_schedule, train_test_split)
from .tokens import BigramStream, frames_batch, random_batch, step_generator

__all__ = ["ArrayChunks", "BigramStream", "ChunkQuarantined", "ChunkSource", "CorruptChunkError",
           "DriftChunks", "EpochKey", "FaultSchedule", "FaultyChunks", "FileChunks",
           "LibsvmChunks", "PrefetchChunks", "ResilienceReport", "RetryPolicy", "TrainerCrash",
           "TransientIOError", "TruncatedChunkError", "chunk_order", "dump_libsvm",
           "epoch_permutation", "frames_batch", "intra_perm", "iter_epoch", "iter_libsvm_chunks",
           "label_flip_schedule", "load_chunk_with_retry", "make_blobs", "make_blobs_multiclass",
           "make_susy_like", "make_two_moons", "mean_shift_schedule", "parse_libsvm",
           "random_batch", "step_generator", "train_test_split", "write_npz_chunks"]
