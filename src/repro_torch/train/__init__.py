"""Training pieces of the port (counterpart of ``repro.train``): the
optimizers and schedule, int8 gradient compression over a process group,
and the GPipe schedule over ranks."""
from . import grad_compress, optimizer, pipeline
from .grad_compress import (compress_tree, compressed_psum, decompress_tree, dequantize_int8,
                            quantize_int8)
from .optimizer import SGD, AdamW, OptState, cosine_schedule, global_norm
from .pipeline import pipeline_forward

__all__ = ["grad_compress", "optimizer", "pipeline", "SGD", "AdamW", "OptState",
           "compress_tree", "compressed_psum", "cosine_schedule", "decompress_tree",
           "dequantize_int8", "global_norm", "pipeline_forward", "quantize_int8"]
