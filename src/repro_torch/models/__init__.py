"""The language-model zoo of the port (counterpart of ``repro.models``):
GQA and MLA attention, the Mamba-2 mixer, the MoE FFN and the model with its
serving steps, as ``nn.Module``s and functions on tensors."""
from . import attention, common, lm, mamba2, mla, moe
from .lm import LM, decode_step, encode_step, forward, init_cache, init_lm, loss_fn, prefill

__all__ = ["attention", "common", "lm", "mamba2", "mla", "moe", "LM", "decode_step",
           "encode_step", "forward", "init_cache", "init_lm", "loss_fn", "prefill"]
