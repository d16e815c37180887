"""The port's optimizers, schedule and int8 gradient compression against the
reference's (``repro.train``), and one train step against the reference's
``make_train_step`` (CPU, float32 unless a case says bf16).

Each update starts from the reference's gradients and state, carried over
by ``convert``: params, ``m`` and ``v`` within ``UPDATE_TOL`` of each leaf's
scale.  The two differ in the last bits only: XLA contracts a multiply and
an add into one fused multiply-add on the CPU, the global norm sums in
another order, ``1 - b ** step`` may round differently.  The bf16 params
are equal after the cast but where that last bit lands on a rounding
boundary of bf16 (``BF16_PARTED`` of the elements at most).  The schedule
is within ``UPDATE_TOL`` of the reference's, and bit-equal at most steps (XLA's ``cos`` and torch's differ
in the last bit at some).  Compression is array-equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_lm import f32, np_tree, one_thread  # noqa: F401 (autouse fixture)
from helpers.torch_lm_grads import GRAD_TOL, LOSS_TOL, lm_batch, torch_batch

from repro.configs import get_smoke as jget_smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.launch.steps import make_train_step
from repro_torch.train import (SGD, AdamW, compress_tree, cosine_schedule, decompress_tree,
                               global_norm, quantize_int8)
from repro_torch.train.optimizer import decays

UPDATE_TOL = 1e-6
BF16_PARTED = 1e-4
STEP_TOL = 1e-3            # of a step (lr), for the train step's params
TINY_GRAD = 1e-3           # of a leaf's max |g|: below it Adam's step is sign-sensitive


@pytest.mark.parametrize("warmup,total", [(20, 100), (3, 20), (0, 7)])
def test_cosine_schedule_matches_reference(warmup, total):
    want, got = jopt.cosine_schedule(3e-3, warmup, total), cosine_schedule(3e-3, warmup, total)
    equal = 0
    for step in range(total + 6):
        w = np.asarray(want(jnp.int32(step)))
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.dim() == 0
        assert abs(float(g) - float(w)) <= UPDATE_TOL * abs(float(w)), (step, float(g), float(w))
        assert float(got(step)) == float(g)             # a Python int gives the same
        equal += float(g) == float(w)
    assert equal >= 0.9 * (total + 6)


def _tree(seed: int, shapes: dict, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}


def test_global_norm_matches_reference():
    tree = _tree(0, {"a": (7, 5), "b": (3,), "c": (2, 3, 4)})
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6 * want


@functools.lru_cache(maxsize=None)
def _smoke(dtype: str = "float32", scale: float = 1.0):
    """The reference's smoke smollm params (scanned body: its ln1/ln2 decay
    there) and ``scale`` times the gradients of its loss (JAX arrays,
    immutable, so the tests share one compile of each)."""
    jcfg = dataclasses.replace(jget_smoke("smollm_360m"), dtype=dtype)
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = jax.tree.map(jnp.asarray, lm_batch(jcfg))
    grads = jax.jit(jax.grad(lambda p: scale * jlm.loss_fn(jcfg, p, batch)))(params)
    return jcfg, params, grads


def _port_state(cfg, jparams, jstate):
    model = convert.lm_params_from_numpy(cfg, np_tree(jparams), device="cpu")
    state = convert.opt_state_from_numpy(cfg, np_tree(jstate), device="cpu")
    return model, dict(model.named_parameters()), state


def _port_grads(cfg, jgrads) -> dict:
    return {k: torch.from_numpy(np.array(v))
            for k, v in convert.lm_flat(cfg, np_tree(jgrads)).items()}


def _leaf_errs(cfg, got: dict, want_tree) -> dict:
    want = convert.lm_flat(cfg, np_tree(want_tree))
    assert got.keys() == want.keys()
    return {k: float(np.max(np.abs(f32(got[k]) - f32(want[k])))
                     / max(float(np.max(np.abs(f32(want[k])))), 1e-30)) for k in want}


@pytest.mark.parametrize("schedule", [False, True], ids=["constant-lr", "cosine-clipped"])
def test_adamw_update_matches_reference(schedule):
    """Two updates from the reference's gradients: the first from zero state,
    the second from the reference's first (carried over); clipped or under
    the clip."""
    jcfg, jparams, jgrads = _smoke(scale=1.0 if schedule else 0.25)
    cfg = get_smoke("smollm_360m")
    kw = dict(lr=cosine_schedule(3e-3, 1, 10), clip_norm=0.05) if schedule else dict(lr=3e-3)
    jkw = dict(kw, lr=jopt.cosine_schedule(3e-3, 1, 10)) if schedule else kw
    jo, to = jopt.AdamW(**jkw), AdamW(**kw)
    if not schedule:           # under the clip: the clip's scale is exactly 1
        assert float(jopt.global_norm(jgrads)) < to.clip_norm
    jstate = jo.init(jparams)
    p1, s1 = jax.jit(jo.update)(jgrads, jstate, jparams)
    p2, s2 = jax.jit(jo.update)(jgrads, s1, p1)
    model, params, state = _port_state(cfg, p1, s1)
    new = to.update(_port_grads(cfg, jgrads), state, params)
    assert new.step.dtype == torch.int32 and int(new.step) == 2
    for got, want in ((params, p2), (new.m, s2.m), (new.v, s2.v)):
        errs = _leaf_errs(cfg, got, want)
        worst = max(errs.values())
        assert worst <= UPDATE_TOL, (worst, max(errs, key=errs.get))


def test_adamw_bf16_params_equal_after_the_cast():
    jcfg, jparams, jgrads = _smoke("bfloat16", scale=0.25)
    cfg = dataclasses.replace(get_smoke("smollm_360m"), dtype="bfloat16")
    jo, to = jopt.AdamW(lr=3e-3), AdamW(lr=3e-3)
    assert float(jopt.global_norm(jgrads)) < to.clip_norm
    jstate = jo.init(jparams)
    want, _ = jax.jit(jo.update)(jgrads, jstate, jparams)
    model, params, state = _port_state(cfg, jparams, jstate)
    grads = {k: torch.from_numpy(np.array(v.astype(np.float32))).to(torch.bfloat16)
             for k, v in convert.lm_flat(cfg, np_tree(jgrads)).items()}
    to.update(grads, state, params)
    wflat = convert.lm_flat(cfg, np_tree(want))
    parted = total = 0
    for k, p in params.items():
        assert p.dtype == torch.bfloat16, k
        got, w = f32(p), f32(wflat[k])
        parted += int(np.sum(got != w))
        total += got.size
        # a parted element is one bf16 step away, never more
        assert np.all(np.abs(got - w) <= np.abs(w) * 2.0 ** -7), k
    assert parted <= BF16_PARTED * total, (parted, total)


def test_sgd_update_matches_reference():
    jcfg, jparams, jgrads = _smoke()
    cfg = get_smoke("smollm_360m")
    jo, to = jopt.SGD(lr=1e-2), SGD(lr=1e-2)
    p1, s1 = jax.jit(jo.update)(jgrads, jo.init(jparams), jparams)
    p2, s2 = jax.jit(jo.update)(jgrads, s1, p1)
    model, params, state = _port_state(cfg, p1, s1)
    assert state.v == {}
    new = to.update(_port_grads(cfg, jgrads), state, params)
    assert int(new.step) == 2 and new.v == {}
    for got, want in ((params, p2), (new.m, s2.m)):
        assert max(_leaf_errs(cfg, got, want).values()) <= UPDATE_TOL


def test_weight_decay_only_on_two_or_more_dims():
    """Zero gradients leave ``delta`` 0: only the decay moves a parameter, on
    matrices and on parameters the model marks ``scanned`` (the reference's
    stacked body leaves), not on plain vectors."""
    w, b, s = torch.ones(3, 2), torch.ones(4), torch.ones(4)
    s.scanned = True
    params = {"w": w, "b": b, "s": s}
    opt = AdamW(lr=0.5, weight_decay=0.1)
    opt.update({k: torch.zeros_like(v) for k, v in params.items()}, opt.init(params), params)
    assert torch.equal(w, torch.full((3, 2), 0.95)) and torch.equal(s, torch.full((4,), 0.95))
    assert torch.equal(b, torch.ones(4))
    model = convert.lm_params_from_numpy(
        get_smoke("deepseek_v3_671b"),
        np_tree(jlm.init_lm(jax.random.PRNGKey(0), jget_smoke("deepseek_v3_671b"))[0]),
        device="cpu")
    marked = {n for n, p in model.named_parameters() if decays(p) and p.dim() < 2}
    # v3's first 3 layers are the reference's unstacked prefix, MTP is unstacked
    assert marked and all(n.startswith("layers.") and int(n.split(".")[1]) >= 3 for n in marked)


# --- the reference's optimizer tests (tests/train/test_optimizer_and_ckpt.py), mirrored
def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(120):
        state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_sgd_momentum_minimizes():
    opt = SGD(lr=0.02)
    params = {"w": torch.tensor([2.0])}
    state = opt.init(params)
    for _ in range(300):
        state = opt.update({"w": 2 * params["w"]}, state, params)
    assert abs(float(params["w"][0])) < 5e-2


def test_grad_clip_bounds_update():
    opt = AdamW(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt.update({"w": torch.full((4,), 1e6)}, opt.init(params), params)
    assert float(torch.max(torch.abs(params["w"]))) <= 1.0 + 1e-5


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100, min_frac=0.1)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert float(lr(100)) <= 0.1 + 1e-6
    assert float(lr(55)) < float(lr(20))


def test_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(tree)) - 5.0) < 1e-6


# --- int8 compression
def test_quantize_and_trees_equal_reference():
    tree = _tree(1, {"w": (256,), "m": (16, 9), "z": (5,)})
    tree["z"][:] = 0.0                                   # the 1e-12 floor of an all-zero tensor
    tree["m"][0, :4] = [0.5, -0.5, 1.5, 2.5]             # halves round to even in both
    resid = _tree(2, {k: v.shape for k, v in tree.items()}, 0.01)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    for k in tree:
        jq, js = jgc.quantize_int8(jt[k])
        q, s = quantize_int8(tt[k])
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq)), k
        assert float(s) == float(js), k
    for r in (None, resid):
        jpay, jres = jgc.compress_tree(jt, None if r is None else jax.tree.map(jnp.asarray, r))
        tr = None if r is None else {k: torch.from_numpy(v) for k, v in r.items()}
        pay, res = compress_tree(tt, tr)
        for k in tree:
            assert np.array_equal(pay["q"][k].numpy(), np.asarray(jpay["q"][k])), k
            assert float(pay["scale"][k]) == float(jpay["scale"][k]), k
            assert np.array_equal(res[k].numpy(), np.asarray(jres[k])), k
        jdec, dec = jgc.decompress_tree(jpay), decompress_tree(pay)
        for k in tree:
            assert np.array_equal(dec[k].numpy(), np.asarray(jdec[k])), k


def test_int8_compression_roundtrip_error_and_feedback():
    """The reference's test, mirrored."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))}
    payload, resid = compress_tree(g, None)
    decoded = decompress_tree(payload)
    scale = float(payload["scale"]["w"])
    assert float(torch.max(torch.abs(decoded["w"] - g["w"]))) <= 0.5 * scale + 1e-7
    np.testing.assert_allclose(resid["w"].numpy(), (g["w"] - decoded["w"]).numpy(), atol=1e-7)
    payload2, _ = compress_tree(g, resid)
    two_step = (decoded["w"] + decompress_tree(payload2)["w"]) / 2.0
    assert float(torch.max(torch.abs(two_step - g["w"]))) <= 0.3 * scale + 1e-7


# --- one train step against the reference's make_train_step
def test_train_step_matches_reference():
    """The loss, ``m`` and ``v`` at the gradients' tolerance; the params
    within ``STEP_TOL`` of a step (the learning rate) wherever the two
    gradients' signs agree and |g| is at least ``TINY_GRAD`` of its leaf's
    max.  Adam's first step moves a weight by ``lr * g / (|g| + eps)``,
    about lr * sign(g), so a gradient near 0 whose last bits differ moves it
    by up to two steps: such elements stay within that, and those whose
    signs part are counted, and must be few."""
    jcfg, cfg = jget_smoke("smollm_360m"), get_smoke("smollm_360m")
    jparams, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = lm_batch(cfg, seed=4)
    jo = jopt.AdamW(lr=jopt.cosine_schedule(3e-3, 2, 20))
    p1, s1, jloss = jax.jit(jmake_train_step(jcfg, jo))(jparams, jo.init(jparams),
                                                         jax.tree.map(jnp.asarray, batch))
    jgrads = jax.jit(jax.grad(lambda p: jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))))(
        jparams)
    model = convert.lm_params_from_numpy(cfg, np_tree(jparams), device="cpu")
    opt = AdamW(lr=cosine_schedule(3e-3, 2, 20))
    lr1 = float(opt.lr(1))
    state = opt.init(dict(model.named_parameters()))
    state, loss = make_train_step(cfg, opt)(model, state, torch_batch(batch))
    assert loss.dim() == 0 and not loss.requires_grad
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    for got, want in ((state.m, s1.m), (state.v, s1.v)):
        assert max(_leaf_errs(cfg, got, want).values()) <= GRAD_TOL
    want = convert.lm_flat(cfg, np_tree(p1))
    grads = convert.lm_flat(cfg, np_tree(jgrads))
    flipped = total = 0
    for k, p in model.named_parameters():
        g = f32(grads[k])
        port_g = f32(state.m[k]) / 0.1                   # m = (1 - b1) g after one step
        agree = np.sign(port_g) == np.sign(g)
        flipped += int(np.sum(~agree))
        total += g.size
        err = np.abs(f32(p) - f32(want[k])) / lr1
        firm = agree & (np.abs(g) >= TINY_GRAD * np.max(np.abs(g)))
        assert float(err[firm].max(initial=0.0)) <= STEP_TOL, k
        assert float(err.max()) <= 2.0 + STEP_TOL, k
    assert flipped <= total * 1e-3, (flipped, total)
