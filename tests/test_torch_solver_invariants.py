"""The §14 solver contract on the port: the twin of ``tests/core/test_solver_invariants.py``.

A fixture trains one port model per valid ``(solver, maintenance, engine, C)``
cell (both solvers, the five strategies, the two maintenance engines where
they compose, two box strengths) on the CPU, and every check runs against
every cell, through ``tests/helpers/invariants.py`` on
``convert.state_to_numpy`` views:

  * the carried cache equals a rebuild (I1 within 5e-5), exactly symmetric,
    with a unit diagonal;
  * the integer state is consistent (count <= budget, alpha zero past the
    watermark, counters non-negative, a finite cache);
  * from an over-budget state reached through either solver's own insert,
    the drain under the bsgd and under the bdca config is bit for bit the
    same, and the two maintenance engines agree (integers exact, floats
    within fp32 round-off): maintenance never reads the solver;
  * the serving export scores as the training-side decision functions
    (within 1e-5: two summation orders) and labels as they do.

A few cells are also held against the reference's epoch on the same
permutation (each new JAX config compiles anew, so only a few): integers
exact, floats within ``atol_float=3e-5, rtol=1e-5`` (ROADMAP.md Queue 3).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity, check_cache_invariants, check_integer_state
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import bdca as tbdca
from repro_torch.core import bsgd as tbsgd
from repro_torch.core import multiclass as tmc
from repro_torch.data import make_blobs, make_blobs_multiclass
from repro_torch.kernels import ops

CPU = "cpu"
BUDGET, BATCH, DIM, GAMMA = 10, 4, 4, 0.7
N, MC_N = 160, 240

# every valid (maintenance, engine) pair: the event engine is the fused
# lookup-wd merge engine, so only merge composes with it
MAINT_ENGINE = [("merge", "xla"), ("merge", "pallas"), ("multi-merge", "xla"),
                ("removal", "xla"), ("removal-project", "xla"), ("quantized", "xla")]
CELLS = [(solver, maint, engine, C) for solver in ("bsgd", "bdca")
         for maint, engine in MAINT_ENGINE for C in (0.5, 4.0)]
MC_CELLS = [(solver, maint, engine) for solver in ("bsgd", "bdca")
            for maint, engine in (("merge", "xla"), ("merge", "pallas"), ("removal", "xla"),
                                  ("quantized", "xla"))]


def _cell_kw(solver, maint, engine, C, n):
    # one parameterization for both solvers: lambda = 1/(nC) drives the
    # Pegasos step, bdca_C bounds the dual box
    return dict(solver=solver, lambda_=1.0 / (n * C), bdca_C=C, budget=BUDGET, gamma=GAMMA,
                batch_size=BATCH, method="lookup-wd", use_kernel_cache=True, maintenance=maint,
                maintenance_engine=engine, unroll_maintenance=True)


def _view(state):
    """The port's state as the reference's NamedTuple of numpy leaves."""
    return jbsgd.SVMState(**convert.state_to_numpy(state))


def _blobs():
    x, y = make_blobs(np.random.default_rng(3), N, DIM, sep=1.2)
    return x, y, np.random.default_rng(4).permutation(N)


@pytest.fixture(scope="module", params=CELLS, ids=[f"{s}-{m}-{e}-C{c}" for s, m, e, c in CELLS])
def cell(request):
    """One trained cell: config, final state and the training rows."""
    kw = _cell_kw(*request.param, N)
    cfg = tbsgd.BSGDConfig(**kw)
    x, y, perm = _blobs()
    state = tbsgd.train_epoch(cfg, cfg.table(), tbsgd.init_state(cfg, DIM, device=CPU), x, y,
                              perm, device=CPU)
    assert int(state.n_merges) > 0, "cell never exercised maintenance"
    return cfg, state, x, y


def test_cache_matches_rebuild(cell):
    cfg, state, _, _ = cell
    check_cache_invariants(_view(state), cfg.gamma)


def test_integer_state_consistent(cell):
    cfg, state, _, _ = cell
    check_integer_state(_view(state), cfg.budget)


def _serve_roundtrip(state, gamma, x):
    """``export_model`` scores and labels as the training-side functions."""
    model = tcore.export_model(state, gamma)
    xt = torch.tensor(x)
    scores = tcore.serve_scores(model, xt).numpy()
    labels = tcore.predict_labels(model, xt).numpy()
    if state.sv_x.dim() == 2:
        want = tbsgd.decision_function(state, x, gamma, device=CPU).numpy()[None]
        want_labels = tbsgd.predict(state, x, gamma, device=CPU).numpy()
    else:
        want = tmc.decision_function_multiclass(state, x, gamma, device=CPU).numpy()
        want_labels = tmc.predict_multiclass(state, x, gamma, device=CPU).numpy()
    # the serve cell sums each score in its fixed lane order, the decision
    # functions in a matrix product's: fp32 sums of up to ``slots`` products
    # in two orders, whose terms reach ~10 under removal-project
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(labels, want_labels)


def test_serve_export_roundtrip(cell):
    cfg, state, x, _ = cell
    _serve_roundtrip(state, cfg.gamma, x[:32])


def _over_budget(cfg, state, seed=9):
    """The cell's state pushed over budget through its own solver's insert: a
    far-away batch violates every margin, so count lands at budget + batch."""
    rng = np.random.default_rng(seed)
    xb = torch.tensor(rng.normal(8.0, 0.1, (cfg.batch_size, DIM)), dtype=torch.float32)
    yb = torch.ones(cfg.batch_size)
    k_b = ops.rbf_matrix(xb, state.sv_x, cfg.gamma)
    k_bb = ops.rbf_matrix(xb, xb, cfg.gamma)
    insert = tbdca.insert_from_rows if cfg.solver == "bdca" else tbsgd.insert_from_rows
    over = insert(cfg, state, xb, yb, k_b, k_bb)
    assert int(over.count) > cfg.budget
    return over


def test_maintenance_decisions_solver_agnostic(cell):
    """From one over-budget state the drain under the bsgd and under the bdca
    config is bit for bit the same: maintenance never reads the solver."""
    cfg, state, _, _ = cell
    over = _over_budget(cfg, state)
    other = dataclasses.replace(cfg, solver="bsgd" if cfg.solver == "bdca" else "bdca")
    table = cfg.table()
    drained = tbsgd.drain_budget(cfg, table, over)
    assert int(drained.count) <= cfg.budget
    assert_state_parity(_view(drained), _view(tbsgd.drain_budget(other, table, over)),
                        bitwise=True)


def test_maintenance_engines_agree_from_either_solver(cell):
    """For merge cells the two engines drain the same over-budget state to
    the same decisions (integer state exact, floats within fp32 round-off),
    also when that state came from bdca."""
    cfg, state, _, _ = cell
    if cfg.maintenance != "merge":
        return                    # the event engine is merge-only
    over = _over_budget(cfg, state)
    table = cfg.table()
    st_x = tbsgd.drain_budget(dataclasses.replace(cfg, maintenance_engine="xla"), table, over)
    st_p = tbsgd.drain_budget(dataclasses.replace(cfg, maintenance_engine="pallas"), table, over)
    assert_state_parity(_view(st_x), _view(st_p))


def test_quantized_codebook_slots_fixed_after_drain(cell):
    """Quantized maintenance absorbs fresh violators into the codebook: the
    first ``budget`` rows and cache block are untouched, only alphas move."""
    cfg, state, _, _ = cell
    if cfg.maintenance != "quantized":
        return
    over = _over_budget(cfg, state)
    drained = tbsgd.drain_budget(cfg, cfg.table(), over)
    assert int(drained.count) == cfg.budget
    assert torch.equal(drained.sv_x[:cfg.budget], over.sv_x[:cfg.budget])
    assert torch.equal(drained.kmat[:cfg.budget, :cfg.budget],
                       over.kmat[:cfg.budget, :cfg.budget])
    assert int(drained.n_merges) == int(over.n_merges) + 1


@pytest.mark.parametrize("solver,maint,engine,C", [("bdca", "merge", "xla", 0.5),
                                                   ("bdca", "merge", "pallas", 4.0),
                                                   ("bdca", "quantized", "xla", 4.0),
                                                   ("bsgd", "removal-project", "xla", 0.5)])
def test_cell_equals_reference_epoch(solver, maint, engine, C):
    """A few cells against the reference's epoch on the same permutation."""
    kw = _cell_kw(solver, maint, engine, C, N)
    x, y, perm = _blobs()
    jcfg = jbsgd.BSGDConfig(**kw)
    js = jbsgd.train_epoch(jcfg, jcfg.table(), jbsgd.init_state(jcfg, DIM), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(perm), impl="ref")
    tcfg = tbsgd.BSGDConfig(**kw)
    ts = tbsgd.train_epoch(tcfg, tcfg.table(), tbsgd.init_state(tcfg, DIM, device=CPU), x, y,
                           perm, device=CPU)
    assert_state_parity(js, _view(ts), atol_float=3e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the same contract through the one-vs-rest class axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MC_CELLS, ids=[f"{s}-{m}-{e}" for s, m, e in MC_CELLS])
def mc_cell(request):
    solver, maint, engine = request.param
    cfg = tmc.MulticlassSVMConfig(n_classes=3, binary=tbsgd.BSGDConfig(
        **_cell_kw(solver, maint, engine, 1.0, MC_N)))
    x, y = make_blobs_multiclass(np.random.default_rng(5), MC_N, DIM, 3, sep=1.2)
    state = tmc.fit_multiclass(cfg, x, y, epochs=1, seed=0, device=CPU)
    assert int(state.n_merges.sum()) > 0
    return cfg, state, x, y


def test_mc_cache_matches_rebuild(mc_cell):
    cfg, state, _, _ = mc_cell
    check_cache_invariants(_view(state), cfg.binary.gamma)


def test_mc_integer_state_consistent(mc_cell):
    cfg, state, _, _ = mc_cell
    check_integer_state(_view(state), cfg.binary.budget)


def test_mc_serve_export_roundtrip(mc_cell):
    cfg, state, x, _ = mc_cell
    _serve_roundtrip(state, cfg.binary.gamma, x[:32])
