"""Synthetic language-model data with learnable structure (a random bigram chain).

PyTorch counterpart of ``repro.data.tokens``.  Tokens follow a fixed random
Markov chain, so a model that learns the transition table beats the uniform
baseline: the trainer's tests ask the loss to drop below ``log(vocab)``
less a margin, which random tokens never allow.

The draws are the port's own (``torch.Generator`` streams, not
``jax.random``'s); the layouts are the reference's: ``labels`` is the
tokens rolled left by one, and the mask is 1 except in its last column.
``step_generator(seed, step, device)`` seeds a generator from ``(seed,
step)`` alone, so a batch depends on its step and nothing before it and a
resumed run sees the batches an uninterrupted one sees (``EpochKey``'s
rule for the SVM streams).  The transition table lives on the stream's
device as row-wise cumulative sums (``vocab**2`` float32: 9.7 GB at
smollm's 49,152), drawn a block of rows at a time; sampling walks the
sequence with one ``searchsorted`` a position for the whole batch.
"""
from __future__ import annotations

import numpy as np
import torch

DRAW_BLOCK = 1 << 26           # table elements drawn at once (256 MiB of float32)


def step_generator(seed: int, step: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default the card) seeded from ``(seed, step)``."""
    from ..core.bsgd import resolve_device

    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    return gen


def _labels_mask(toks: torch.Tensor):
    mask = torch.ones(toks.shape, dtype=torch.float32, device=toks.device)
    mask[:, -1] = 0.0
    return torch.roll(toks, -1, dims=1), mask


class BigramStream:
    """A random bigram chain over ``vocab`` tokens: row i of the transition
    table is ``softmax(normal / concentration)``, drawn on ``device`` (default
    the card) from a generator seeded with ``seed``."""

    def __init__(self, vocab: int, *, seed: int = 0, concentration: float = 0.3, device=None):
        from ..core.bsgd import resolve_device

        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.vocab = vocab
        self.cdf = torch.empty((vocab, vocab), dtype=torch.float32, device=dev)
        entropy = torch.zeros((), dtype=torch.float32, device=dev)
        rows = max(1, DRAW_BLOCK // vocab)
        for lo in range(0, vocab, rows):
            hi = min(vocab, lo + rows)
            logits = torch.randn((hi - lo, vocab), generator=gen, device=dev) / concentration
            trans = torch.softmax(logits, dim=-1)
            entropy += -torch.sum(trans * torch.log(trans + 1e-12))
            torch.cumsum(trans, dim=-1, out=self.cdf[lo:hi])
        self._entropy = float(entropy) / vocab

    def batch(self, gen: torch.Generator, batch: int, seq: int) -> dict:
        """``{"tokens", "labels", "mask"}`` of ``(batch, seq)`` chains drawn
        from ``gen`` (on the stream's device)."""
        dev = self.cdf.device
        toks = torch.empty((batch, seq), dtype=torch.int64, device=dev)
        toks[:, 0] = torch.randint(0, self.vocab, (batch,), generator=gen, device=dev)
        u = torch.rand((seq - 1, batch, 1), generator=gen, device=dev)
        for t in range(seq - 1):
            nxt = torch.searchsorted(self.cdf[toks[:, t]], u[t], right=True)
            toks[:, t + 1] = nxt[:, 0].clamp_(max=self.vocab - 1)
        labels, mask = _labels_mask(toks)
        return {"tokens": toks, "labels": labels, "mask": mask}

    def bigram_entropy(self) -> float:
        """The achievable loss floor: the mean entropy of the table's rows."""
        return self._entropy


def random_batch(gen: torch.Generator, vocab: int, batch: int, seq: int) -> dict:
    """Uniform tokens in the reference's layout, on ``gen``'s device."""
    toks = torch.randint(0, vocab, (batch, seq), generator=gen, device=gen.device)
    labels, mask = _labels_mask(toks)
    return {"tokens": toks, "labels": labels, "mask": mask}


def frames_batch(gen: torch.Generator, batch: int, seq: int, frame_dim: int, vocab: int) -> dict:
    """An encoder batch: normal ``frames``, uniform ``labels`` and a boolean
    ``mask`` true with probability 0.3, on ``gen``'s device."""
    dev = gen.device
    return {"frames": torch.randn((batch, seq, frame_dim), generator=gen, device=dev),
            "labels": torch.randint(0, vocab, (batch, seq), generator=gen, device=dev),
            "mask": torch.rand((batch, seq), generator=gen, device=dev) < 0.3}
