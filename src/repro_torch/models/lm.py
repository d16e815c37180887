"""Model assembly: embedding -> layers -> head, and the serving steps.

PyTorch counterpart of ``repro.models.lm``.  The reference groups layers into
an unrolled prefix and a ``lax.scan`` over a repeating unit; here the model
is one ``nn.ModuleList`` in the same layer order (layer ``prefix + g * unit
+ j`` is the reference's ``body`` group g, unit layer j), and a cache is a
list with one entry a layer: the mixer's dict.

Entry points (the reference's names):
  * ``init_lm``     -> an ``LM`` with drawn weights, on the card by default;
  * ``forward``     -> logits (and the caches for prefill and decode);
  * ``prefill``     -> the last position's logits and the cache;
  * ``decode_step`` -> one serving step against a cache, written in place;
  * ``encode_step`` -> encoder logits (hubert);
  * ``loss_fn``     -> the LM loss's value (causal shift, the MTP term);
  * ``init_cache``  -> zeroed caches for (batch, max_len).

No step reads the device: a decode position is a 0-d tensor on the card (a
Python int is filled into one), every shape is static, and the argmax of a
greedy loop stays on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.bsgd import resolve_device
from .attention import Attention, init_attn_cache, seq_sharded
from .common import (Drawn, empty_param, normal, ones, replicated, rms_norm, softmax_xent,
                     swiglu)
from .mamba2 import Mamba2, init_mamba_cache
from .mla import MLA, init_mla_cache
from .moe import MoE


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class DenseFFN(Drawn):
    """``w_gate`` (SwiGLU only), ``w_up`` (d, width), ``w_down`` (width, d)."""

    def __init__(self, cfg, width: int, dtype, device=None):
        super().__init__()
        self.swiglu = cfg.mlp_act == "swiglu"
        d = cfg.d_model
        self.w_up = empty_param((d, width), dtype, device, axes=("embed", "ffn"))
        self.w_down = empty_param((width, d), dtype, device, axes=("ffn", "embed"))
        if self.swiglu:
            self.w_gate = empty_param((d, width), dtype, device, axes=("embed", "ffn"))

    def init_plan(self) -> list:
        return [(w, normal()) for w in ([self.w_gate] if self.swiglu else [])
                + [self.w_up, self.w_down]]

    def forward(self, h):
        if self.swiglu:
            return swiglu(h, self.w_gate, self.w_up, self.w_down)
        return F.gelu(h @ self.w_up, approximate="tanh") @ self.w_down   # jax.nn.gelu


class Layer(Drawn):
    """One pre-norm layer: ``ln1`` and a mixer (attention, MLA or mamba),
    then, unless the layer is mixer-only, ``ln2`` and an FFN (dense or MoE)."""

    def __init__(self, cfg, index: int, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.kind, self.ffn_kind = cfg.mixer_kind(index), cfg.ffn_kind(index)
        self.ln1 = empty_param((cfg.d_model,), dtype, device, axes=("embed",))
        if self.kind == "attn":
            self.mixer = (MLA if cfg.attn_kind == "mla" else Attention)(cfg, dtype, device)
        else:
            self.mixer = Mamba2(cfg, dtype, device)
        if self.ffn_kind != "none":
            self.ln2 = empty_param((cfg.d_model,), dtype, device, axes=("embed",))
        if self.ffn_kind == "dense":
            width = cfg.moe_dense_ff() if cfg.moe is not None else cfg.d_ff
            self.ffn = DenseFFN(cfg, width, dtype, device)
        elif self.ffn_kind == "moe":
            self.ffn = MoE(cfg, dtype, device)

    def init_plan(self) -> list:
        plan = [(self.ln1, ones)] + self.mixer.init_plan()
        if self.ffn_kind != "none":
            plan += [(self.ln2, ones)] + self.ffn.init_plan()
        return plan

    def forward(self, x, positions, *, mode: str, cache=None, cache_pos=None):
        seq = seq_sharded(self.cfg, x) if mode == "full" else None
        h = self._gathered(rms_norm(x, self.ln1, self.cfg.norm_eps), seq)
        if self.kind == "attn":
            y, new_cache = self.mixer(h, positions, mode=mode, cache=cache, cache_pos=cache_pos)
        else:
            y, new_cache = self.mixer(h, mode=mode, cache=cache)
        x = x + self._gathered(y, seq)
        if seq is not None and self.kind == "attn":   # the residual sequence-sharded
            x = seq(x, 1)
        if self.ffn_kind == "none":
            return x, new_cache
        y = self.ffn(self._gathered(rms_norm(x, self.ln2, self.cfg.norm_eps), seq))
        return x + self._gathered(y, seq), new_cache

    @staticmethod
    def _gathered(t, seq):
        """Under ``seq_shard_attn`` (``seq`` not None) a matmul's input or output
        whole over `model`, its gradient too: torch 2.11's DTensor will not
        flatten the sequence-sharded residual's dim in a matmul, forward or
        backward.  Otherwise ``t`` itself."""
        return t if seq is None else replicated(t, always=True)


class MTP(Drawn):
    """DeepSeek-V3's depth-1 multi-token prediction block: ``proj`` (2d, d),
    a ``block`` built as the last layer, ``norm``."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.proj = empty_param((2 * cfg.d_model, cfg.d_model), dtype, device,
                                axes=("embed", "embed_out"))
        self.block = Layer(cfg, cfg.n_layers - 1, dtype, device)
        self.norm = empty_param((cfg.d_model,), dtype, device, axes=("embed",))

    def init_plan(self) -> list:
        return [(self.proj, normal())] + self.block.init_plan() + [(self.norm, ones)]


class LM(Drawn):
    """The whole model, every parameter in the reference's dtype (the MoE
    router and mamba's ``A_log``/``dt_bias`` float32, the rest ``cfg.dtype``).
    Built empty; ``init_lm`` draws the weights."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, d = model_dtype(cfg), cfg.d_model
        if cfg.input_kind == "frames":
            self.frame_proj = empty_param((cfg.frame_dim, d), dtype, device,
                                          axes=("frame", "embed"))
            self.mask_embed = empty_param((d,), dtype, device, axes=("embed",))
        self.embed = empty_param((cfg.vocab_padded, d), dtype, device, axes=("vocab", "embed"))
        self.final_norm = empty_param((d,), dtype, device, axes=("embed",))
        if not cfg.tie_embeddings:
            self.lm_head = empty_param((d, cfg.vocab_padded), dtype, device,
                                       axes=("embed", "vocab"))
        self.layers = nn.ModuleList(Layer(cfg, i, dtype, device) for i in range(cfg.n_layers))
        for layer in self.layers[cfg.prefix_layers:]:
            for p in layer.parameters():
                # the reference stacks these along a leading layer-group dim
                # (its ``body``), which its optimizer counts
                p.scanned = True
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, dtype, device)

    def init_plan(self) -> list:
        cfg, plan = self.cfg, []
        if cfg.input_kind == "frames":
            plan += [(self.frame_proj, normal()), (self.mask_embed, normal(0.02))]
        plan += [(self.embed, normal(cfg.d_model ** -0.5)), (self.final_norm, ones)]
        if not cfg.tie_embeddings:
            plan.append((self.lm_head, normal()))
        for layer in self.layers:
            plan += layer.init_plan()
        if cfg.mtp_depth:
            plan += self.mtp.init_plan()
        return plan

    def head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_lm(cfg, *, seed: int = 0, device=None, mesh=None, strategy: str = "tp") -> LM:
    """An ``LM`` on ``device`` (default the card) with weights drawn from a
    ``torch.Generator`` on that device seeded with ``seed``.

    With a ``DeviceMesh`` the parameters are DTensors laid out by
    ``strategy`` on the mesh's device (``sharding.specs.distribute_model``):
    drawn on the host a parameter at a time from a CPU generator seeded with
    ``seed``, only each rank's block reaching the device.  On the CPU both
    draw the same weights."""
    if mesh is not None:
        from ..sharding.specs import distribute_model

        return distribute_model(LM(cfg, torch.device("meta")), mesh, strategy, seed=seed)
    dev = resolve_device(device)
    model = LM(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.init_(gen)
    return model


def _check(cfg, model: LM) -> None:
    if cfg is not model.cfg and cfg != model.cfg:
        raise ValueError(f"the model was built for {model.cfg.name} with another config")


def _embed_inputs(cfg, model: LM, batch):
    if cfg.input_kind == "frames":
        x = batch["frames"].to(model.frame_proj.dtype) @ model.frame_proj
        if "mask" in batch:       # hubert-style masked prediction: replace frames
            x = torch.where(batch["mask"][..., None], model.mask_embed, x)
        return x
    tok = batch["tokens"] if isinstance(batch, dict) else batch
    return replicated(F.embedding(tok, model.embed))


def _as_pos(cache_pos, device) -> torch.Tensor:
    """A decode position as a 0-d int32 tensor on ``device``; a Python int is
    filled in on the device (no copy from the host)."""
    if isinstance(cache_pos, torch.Tensor):
        return cache_pos.to(device=device, dtype=torch.int32)
    return torch.full((), int(cache_pos), dtype=torch.int32, device=device)


def _layer_full(layer: Layer, x, positions):
    return layer(x, positions, mode="full")[0]


def forward(cfg, model: LM, batch, *, mode: str = "full", cache=None, cache_pos=None,
            return_hidden: bool = False):
    """Returns (logits, new_cache[, hidden]).

    batch: {"tokens": (B, S)} (or the tokens tensor) or {"frames", "mask"}
    for encoders; in decode, tokens is (B, 1) and ``cache``/``cache_pos``
    must be given (the caches are updated in place and returned).  With
    ``cfg.remat`` and grad enabled, a full forward recomputes each layer in
    the backward instead of keeping its activations."""
    _check(cfg, model)
    x = _embed_inputs(cfg, model, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    if mode == "decode":
        cache_pos = _as_pos(cache_pos, x.device)
    new_caches = []
    if mode == "full" and cfg.remat and torch.is_grad_enabled():
        # the reference's jax.checkpoint of each scanned unit, a layer at a
        # time here: the backward keeps only each layer's input and runs
        # the layer's forward again
        for layer in model.layers:
            x = checkpoint(_layer_full, layer, x, positions, use_reentrant=False)
    else:
        for i, layer in enumerate(model.layers):
            x, layer_cache = layer(x, positions, mode=mode,
                                   cache=None if cache is None else cache[i], cache_pos=cache_pos)
            new_caches.append(layer_cache)
    hidden = x
    logits = replicated(rms_norm(x, model.final_norm, cfg.norm_eps)) @ model.head()
    new_cache = new_caches if mode in ("prefill", "decode") else None
    if return_hidden:
        return logits, new_cache, hidden
    return logits, new_cache


def loss_fn(cfg, model: LM, batch):
    """Causal-LM (or masked-encoder) cross-entropy; adds the MTP loss if enabled."""
    if cfg.is_encoder:
        logits, _ = forward(cfg, model, batch, mode="full")
        return softmax_xent(logits, batch["labels"], batch.get("mask"))

    tokens, labels = batch["tokens"], batch["labels"]      # labels: next-token ids (B, S)
    weight = batch.get("mask")
    logits, _, hidden = forward(cfg, model, batch, mode="full", return_hidden=True)
    loss = softmax_xent(logits, labels, weight)
    if cfg.mtp_depth:
        # multi-token prediction (deepseek-v3, depth 1): the hidden state with
        # the embedding of the NEXT token predicts t+2
        mtp = model.mtp
        emb_next = replicated(F.embedding(labels, model.embed))
        h = torch.cat([replicated(rms_norm(hidden, mtp.norm, cfg.norm_eps)), emb_next],
                      dim=-1) @ mtp.proj
        positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=h.device)
        h, _ = mtp.block(h, positions, mode="full")
        logits2 = replicated(rms_norm(h, model.final_norm, cfg.norm_eps)) @ model.head()
        labels2 = torch.roll(labels, -1, dims=1)
        w2 = torch.ones(labels2.shape, dtype=torch.float32, device=labels2.device)
        w2[:, -1] = 0.0
        if weight is not None:
            w2 = w2 * weight
        loss = loss + 0.3 * softmax_xent(logits2, labels2, w2)
    return loss


@torch.no_grad()
def decode_step(cfg, model: LM, cache, tokens, cache_pos):
    """One serving step: tokens (B, 1) -> (logits (B, V), cache), the cache
    written in place."""
    logits, new_cache = forward(cfg, model, {"tokens": tokens}, mode="decode", cache=cache,
                                cache_pos=cache_pos)
    return logits[:, -1, :], new_cache


@torch.no_grad()
def prefill(cfg, model: LM, tokens):
    """Full-sequence prefill: returns (last-position logits, cache)."""
    logits, cache = forward(cfg, model, {"tokens": tokens}, mode="prefill")
    return logits[:, -1, :], cache


@torch.no_grad()
def encode_step(cfg, model: LM, batch):
    """Encoder inference (hubert): frames -> logits over the cluster vocabulary."""
    logits, _ = forward(cfg, model, batch, mode="full")
    return logits


def _layer_cache(cfg, index: int, batch: int, max_len: int, dtype, device):
    if cfg.mixer_kind(index) == "attn":
        if cfg.attn_kind == "mla":
            return init_mla_cache(cfg, batch, max_len, dtype, device)
        return init_attn_cache(cfg, batch, max_len, dtype, device)
    return init_mamba_cache(cfg, batch, dtype, device)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zeroed caches, one entry a layer, on ``device`` (default the card)."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg) if dtype is None else dtype
    return [_layer_cache(cfg, i, batch, max_len, dtype, dev) for i in range(cfg.n_layers)]
