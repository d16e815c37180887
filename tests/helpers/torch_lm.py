"""Shared pieces of the language-model parity tests (``tests/test_torch_lm_*.py``).

The reference runs jitted, as its own tests run it; the port runs on the
CPU from the reference's weights (``convert.lm_params_from_numpy``).  Every
array crosses as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import lm as jlm
from repro_torch import convert

from .torch_threads import one_thread  # noqa: F401 (autouse fixture, re-exported)

B, S, STEPS = 2, 16, 8


def np_tree(tree):
    """A JAX tree as numpy leaves (bf16 stays bf16; the converters widen it)."""
    return jax.tree.map(np.asarray, tree)


def f32(a) -> np.ndarray:
    """A JAX array or a tensor as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def scale_err(got, want) -> float:
    """max |got - want| over max(1, max |want|): the error on the logits' scale."""
    got, want = f32(got), f32(want)
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def reference_model(jcfg, tcfg, seed: int = 0):
    """The reference's params (``init_lm(PRNGKey(seed), jcfg)``) and the
    port's model (config ``tcfg``) holding them on the CPU."""
    params, _ = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return params, convert.lm_params_from_numpy(tcfg, np_tree(params), device="cpu")


def place_reference(cache, pf_cache):
    """The reference serve's ``place``: the prefill cache at offset 0."""
    def place(dst, src):
        if src.shape == dst.shape:
            return src
        return jax.lax.dynamic_update_slice(dst, src.astype(dst.dtype), (0,) * dst.ndim)
    return jax.tree.map(place, cache, pf_cache)


def tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def no_drop(cfg):
    """The MoE capacity of the reference's decode test (no copy dropped)."""
    if cfg.moe is None:
        return cfg
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                                            min_capacity=64))


def run_reference(jcfg, params, seed: int = 0):
    """The reference's outputs at the smoke shapes, jitted: for a decoder
    the prefill of (B, S) tokens, STEPS decode steps of given tokens from the
    prefill cache placed in an (S + STEPS + 1)-position cache, and the loss;
    for the encoder ``encode_step`` and the loss on masked frames."""
    rng = np.random.default_rng(seed)
    out = {}
    if jcfg.input_kind == "frames":
        frames = rng.standard_normal((B, S, jcfg.frame_dim)).astype(np.float32)
        mask = rng.random((B, S)) < 0.4
        labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"frames": jnp.asarray(frames), "mask": jnp.asarray(mask),
                 "labels": jnp.asarray(labels)}
        out["batch"] = {"frames": frames, "mask": mask, "labels": labels}
        out["logits"] = jax.jit(lambda p, b: jlm.encode_step(jcfg, p, b))(params, batch)
        out["loss"] = jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b))(params, batch)
        return jax.tree.map(np.asarray, out)
    toks = tokens(jcfg, seed, (B, S + STEPS))
    prompt = jnp.asarray(toks[:, :S])
    last, pf_cache = jax.jit(lambda p, t: jlm.prefill(jcfg, p, t))(params, prompt)
    cache = place_reference(jlm.init_cache(jcfg, B, S + STEPS + 1), pf_cache)
    step = jax.jit(lambda p, c, t, i: jlm.decode_step(jcfg, p, c, t, i))
    steps = []
    for i in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[:, S + i:S + i + 1]), jnp.int32(S + i))
        steps.append(lg)
    batch = {"tokens": prompt, "labels": jnp.roll(prompt, -1, 1),
             "mask": jnp.ones((B, S), jnp.float32)}
    loss = jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b))(params, batch)
    out.update(tokens=toks, last=last, prefill_cache=pf_cache, steps=jnp.stack(steps, 1),
               cache=cache, loss=loss)
    return jax.tree.map(np.asarray, out)


def run_port(tcfg, model, ref):
    """The port's outputs on the reference's inputs (see ``run_reference``)."""
    from repro_torch.launch.serve import _place
    from repro_torch.models import decode_step, encode_step, init_cache, loss_fn, prefill

    out = {}
    with torch.no_grad():
        if tcfg.input_kind == "frames":
            batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
            out["logits"] = encode_step(tcfg, model, batch)
            out["loss"] = loss_fn(tcfg, model, batch)
            return out
        toks = torch.from_numpy(ref["tokens"])
        prompt = toks[:, :S]
        out["last"], pf_cache = prefill(tcfg, model, prompt)
        out["prefill_cache"] = [{k: v.clone() for k, v in c.items()} for c in pf_cache]
        cache = init_cache(tcfg, B, S + STEPS + 1, device="cpu")
        cache = [{k: _place(c[k], p[k]) for k in c} for c, p in zip(cache, pf_cache)]
        steps = []
        for i in range(STEPS):
            lg, cache = decode_step(tcfg, model, cache, toks[:, S + i:S + i + 1], S + i)
            steps.append(lg)
        out.update(steps=torch.stack(steps, 1), cache=cache)
        out["loss"] = loss_fn(tcfg, model, {"tokens": prompt, "labels": torch.roll(prompt, -1, 1),
                                            "mask": torch.ones(B, S)})
    return out
