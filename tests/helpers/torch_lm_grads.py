"""The gradient parity cases, shared by ``tests/test_torch_lm_grads.py`` and
``tests/test_torch_lm_grads_moe.py`` (each defines the module-scoped
``grad_run`` fixture over its architectures, so ``--dist loadfile`` spreads
the reference's compiles over two workers).

At ``get_smoke`` (float32) the port holds the reference's weights
(``init_lm(PRNGKey(0))``) and takes the reference's batch; the loss and
every gradient of ``loss_fn`` (autograd, the layers recomputed under the
config's ``remat``) are held to ``jax.value_and_grad`` of the reference's
``loss_fn``: the loss within ``LOSS_TOL`` relative, each gradient within
``GRAD_TOL`` of its leaf's max |g|.  The port's gradients with ``remat`` on
and off are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import loss_fn

from .torch_lm import B, S, no_drop, np_tree

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def lm_batch(cfg, seed: int = 0) -> dict:
    """A numpy training batch of (B, S): tokens with their next-token labels
    and the last column masked, or masked frames for the encoder."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "frames":
        return {"frames": rng.standard_normal((B, S, cfg.frame_dim)).astype(np.float32),
                "mask": rng.random((B, S)) < 0.4,
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": toks, "labels": np.roll(toks, -1, 1), "mask": mask}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def reference_grads(jcfg, params, batch):
    """The reference's loss and gradients (jitted ``value_and_grad``), the
    gradients as ``{parameter name: numpy}``."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(jcfg, p, b)))
    loss, grads = fn(params, jax.tree.map(jnp.asarray, batch))
    return float(loss), convert.lm_flat(jcfg, np_tree(grads))


def port_grads(tcfg, model, batch):
    """The port's loss and ``{parameter name: gradient}`` by autograd."""
    params = dict(model.named_parameters())
    loss = loss_fn(tcfg, model, torch_batch(batch))
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(p) if g is None else g
                         for (n, p), g in zip(params.items(), grads)}


def make_grad_run(arch: str, capacity: str = "no_drop"):
    """Both packages' loss and gradients for ``arch`` at its smoke config;
    ``capacity="default"`` keeps the MoE capacity where copies drop."""
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    if capacity == "no_drop":
        jcfg, tcfg = no_drop(jcfg), no_drop(tcfg)
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    nparams = np_tree(params)
    model = convert.lm_params_from_numpy(tcfg, nparams, device="cpu")
    batch = lm_batch(tcfg)
    ref_loss, ref_grads = reference_grads(jcfg, params, batch)
    loss, grads = port_grads(tcfg, model, batch)
    return dict(arch=arch, tcfg=tcfg, nparams=nparams, batch=batch, ref_loss=ref_loss,
                ref_grads=ref_grads, loss=loss, grads=grads)


def test_loss_matches(grad_run):
    got, want = grad_run["loss"], grad_run["ref_loss"]
    assert np.isfinite(got) and abs(got - want) <= LOSS_TOL * abs(want), (got, want)


def test_grads_match(grad_run):
    got, want = grad_run["grads"], grad_run["ref_grads"]
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        assert tuple(g.shape) == w.shape, name
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_remat_bit_equal(grad_run):
    """Recomputing each layer in the backward changes no bit on the CPU."""
    tcfg = grad_run["tcfg"]
    assert tcfg.remat
    plain = dataclasses.replace(tcfg, remat=False)
    model = convert.lm_params_from_numpy(plain, grad_run["nparams"], device="cpu")
    loss, grads = port_grads(plain, model, grad_run["batch"])
    assert loss == grad_run["loss"]
    for name, g in grads.items():
        assert torch.equal(g, grad_run["grads"][name]), name
