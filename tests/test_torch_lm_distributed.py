"""The port's data-parallel train step, int8 compressed all-reduce and
pipeline schedule on 2 gloo ranks (CPU).

One spawn of two CPU processes (``helpers.torch_lm_dist_worker``, a gloo
group on a ``FileStore`` under the module's temporary directory, every
collective under a timeout, the join under a deadline) runs every case;
each test reads its case's results.

  * ``make_train_step(..., group=)`` on ``yi_9b``'s smoke config, batch 8
    split 4/4, from the reference's weights: against the port's one process
    within ``DP_TOL`` (the loss, and ``m`` and ``v``, which are the
    gradients' moments), and against the reference's single-device
    ``make_train_step`` at the reference's own tolerances (loss 1e-3,
    params 5e-2: ``tests/distributed/test_distributed.py``);
  * ``compressed_psum`` of each rank's gradients within one quantization
    step (the largest |g| over 127) of their mean;
  * ``pipeline_forward`` over 2 stages at the reference test's shape (8
    groups, 6 microbatches, d 16) within 1e-4 of the sequential loop.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from helpers import torch_lm_dist_worker as W
from helpers.torch_lm import np_tree
from helpers.torch_lm_grads import lm_batch, torch_batch

from repro.configs import get_smoke as jget_smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.launch.steps import make_train_step
from repro_torch.train import AdamW

WORLD = 2
JOIN_DEADLINE_S = 300.0
DP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg):
    """8 rows of 16 tokens: two of ``lm_batch``'s (2, 16) batches' seeds a rank."""
    parts = [lm_batch(cfg, seed=s) for s in range(4)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the reference's single-device step, and the two ranks'
    results (spawned once for the module)."""
    out = tmp_path_factory.mktemp("lmdist")
    jcfg, cfg = jget_smoke(W.ARCH), get_smoke(W.ARCH)
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params_from_numpy(cfg, np_tree(params), device="cpu")
    batch = _batch(cfg)
    rng = np.random.default_rng(0)
    grads = {"a": torch.from_numpy(rng.standard_normal((WORLD, 64)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal((WORLD, 3, 5)).astype(np.float32) * 4)}
    ws = torch.from_numpy((rng.standard_normal((W.N_GROUPS, W.D, W.D)) * 0.3).astype(np.float32))
    x_micro = torch.from_numpy(rng.standard_normal((W.N_MICRO, W.MICRO, W.D)).astype(np.float32))
    torch.save({"state_dict": model.state_dict(), "batch": torch_batch(batch), "grads": grads,
                "ws": ws, "x_micro": x_micro}, out / "inputs.pt")
    ctx = mp.start_processes(W.run, args=(WORLD, str(out / "store"), str(out)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_DEADLINE_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"distributed workers did not finish in {JOIN_DEADLINE_S} s")
    ranks = {name: [dict(np.load(out / f"{name}-{r}.npz")) for r in range(WORLD)]
             for name in ("dp", "compressed", "pipeline")}
    for name, results in ranks.items():
        for r in results:
            assert "error" not in r, f"{name}: {r['error']}"
    jo = jopt.AdamW(lr=W.LR)
    jp, js, jloss = jax.jit(jmake_train_step(jcfg, jo))(params, jo.init(params),
                                                         jax.tree.map(jnp.asarray, batch))
    single = convert.lm_params_from_numpy(cfg, np_tree(params), device="cpu")
    opt = AdamW(lr=W.LR)
    state, loss = make_train_step(cfg, opt)(single, opt.init(dict(single.named_parameters())),
                                            torch_batch(batch))
    return dict(cfg=cfg, ranks=ranks, grads=grads, ws=ws, x_micro=x_micro,
                single=(single, state, float(loss)),
                reference=(convert.lm_flat(cfg, np_tree(jp)), float(jloss)))


def _leaf_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def test_dp_step_ranks_agree(setup):
    r0, r1 = setup["ranks"]["dp"]
    assert r0.keys() == r1.keys()
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), k


def test_dp_step_matches_one_process(setup):
    r0 = setup["ranks"]["dp"][0]
    single, state, loss = setup["single"]
    assert abs(float(r0["loss"]) - loss) <= DP_TOL * abs(loss)
    for k in state.m:
        assert _leaf_err(r0[f"m.{k}"], state.m[k].numpy()) <= DP_TOL, k
        assert _leaf_err(r0[f"v.{k}"], state.v[k].numpy()) <= 2 * DP_TOL, k


def test_dp_step_matches_reference_single_device(setup):
    """The reference's ``test_dp_tp_train_step_matches_single_device``
    tolerances: loss 1e-3, every param within 5e-2."""
    r0 = setup["ranks"]["dp"][0]
    want, jloss = setup["reference"]
    assert abs(float(r0["loss"]) - jloss) < 1e-3
    err = max(float(np.max(np.abs(r0[f"p.{k}"] - np.asarray(v, np.float32))))
              for k, v in want.items())
    assert err < 5e-2, err


def test_compressed_psum_within_quantization_step(setup):
    ranks, grads = setup["ranks"]["compressed"], setup["grads"]
    for k, g in grads.items():
        want = g.mean(0).numpy()
        scale = float(g.abs().max()) / 127.0
        got = ranks[0][f"mean.{k}"]
        assert np.array_equal(got, ranks[1][f"mean.{k}"]), k
        assert float(np.max(np.abs(got - want))) <= scale, k
        # error feedback: what the ranks sent plus what they kept is their gradient
        kept = sum(r[f"resid.{k}"] for r in ranks) / WORLD
        np.testing.assert_allclose(got + kept, want, atol=1e-6)


def test_pipeline_forward_matches_sequential(setup):
    ws, x = setup["ws"], setup["x_micro"]
    want = x
    for i in range(W.N_GROUPS):
        want = W.body(ws[i], want)
    for r in setup["ranks"]["pipeline"]:
        assert float(np.max(np.abs(r["out"] - want.numpy()))) < 1e-4
        assert np.array_equal(r["dict_params"], r["out"])
