"""Binary BSGD in the port against the JAX reference on one data set (CPU).

The same two-moons data and the same permutation (numpy, from a seed) go
through ``repro.core.bsgd.train_epoch`` and its port.  Integer state must be
equal; float state agrees within the tolerance stated at each check, which
is no tighter than the ~3e-5 by which the reference's own engines differ
(ROADMAP.md Queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro.core import budget as jbudget
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import bsgd as tbsgd
from repro_torch.core import budget as tbudget
from repro_torch.data import make_two_moons, train_test_split

CPU = "cpu"
# ~400 Pegasos steps, budget 16: 60+ merge events on this data
BASE = dict(budget=16, lambda_=1e-3, gamma=2.0)


@pytest.fixture(scope="module")
def data():
    x, y = make_two_moons(np.random.default_rng(1), 500, noise=0.3)
    (xtr, ytr), (xte, yte) = train_test_split(x, y)
    perm = np.random.default_rng(2).permutation(xtr.shape[0])
    return xtr, ytr, xte, yte, perm


def _jax_epoch(kw, data, perm=None):
    xtr, ytr, _, _, p = data
    cfg = jbsgd.BSGDConfig(**kw)
    return jbsgd.train_epoch(cfg, cfg.table(), jbsgd.init_state(cfg, xtr.shape[1]),
                             jnp.asarray(xtr), jnp.asarray(ytr),
                             jnp.asarray(p if perm is None else perm), impl="ref")


def _torch_epoch(kw, data, perm=None):
    xtr, ytr, _, _, p = data
    cfg = tbsgd.BSGDConfig(**kw)
    return tbsgd.train_epoch(cfg, cfg.table(), tbsgd.init_state(cfg, xtr.shape[1], device=CPU),
                             xtr, ytr, p if perm is None else perm, device=CPU)


def _as_jax(state):
    """The port's state as the reference's NamedTuple of numpy leaves."""
    return jbsgd.SVMState(**convert.state_to_numpy(state), kmat=None)


def _n_correct(acc, n):
    return round(float(acc) * n)


@pytest.mark.parametrize("kw", [
    dict(method="lookup-wd"),
    dict(method="lookup-h"),
    dict(method="lookup-wd", batch_size=4),
    dict(method="lookup-wd", maintenance="removal"),
], ids=["lookup-wd", "lookup-h", "lookup-wd-batch4", "removal"])
def test_train_epoch_matches_reference(kw, data):
    kw = {**BASE, **kw}
    js, ts = _jax_epoch(kw, data), _torch_epoch(kw, data)
    assert int(ts.n_merges) >= 50
    # integers bitwise (every insert and maintenance decision the same);
    # alpha grows to ~1e2 here, so fp32 round-off is relative
    assert_state_parity(js, _as_jax(ts), atol_float=3e-5, rtol=1e-5, context=str(kw))
    _, _, xte, yte, _ = data
    n = xte.shape[0]
    jacc = jbsgd.accuracy(js, jnp.asarray(xte), jnp.asarray(yte), kw["gamma"], impl="ref")
    tacc = tbsgd.accuracy(ts, xte, yte, kw["gamma"], device=CPU)
    assert _n_correct(tacc, n) == _n_correct(jacc, n)
    assert _n_correct(tacc, n) >= 0.8 * n          # removal is the weakest strategy


@pytest.mark.parametrize("method", ["gss", "gss-precise"])
def test_gss_epoch_reaches_mirror_mode_tie(method, data):
    """The searches agree until two same-sign SVs of equal |alpha| meet.

    There m = 1/2 and, for kappa < e^-2, the merge objective has two mirror
    maxima h and 1 - h of equal weight degradation (paper Lemma 1).  Which
    one golden section search climbs is decided by the last bit of float32
    exp, where PyTorch and XLA differ, so from that event on the two
    trajectories may part (ROADMAP.md Queue 3).  On this data the tie is
    the maintenance event of step 42.
    """
    kw = {**BASE, "method": method}
    xtr, ytr, _, _, perm = data
    js, ts = _jax_epoch(kw, data, perm[:42]), _torch_epoch(kw, data, perm[:42])
    assert_state_parity(js, _as_jax(ts), atol_float=3e-5, rtol=1e-5)
    # insert step 42's row, then the tied event in both packages
    row = perm[42:43]
    jcfg, tcfg = jbsgd.BSGDConfig(**kw), tbsgd.BSGDConfig(**kw)
    xb, yb = xtr[row], ytr[row]
    jins = jbsgd.insert_from_rows(jcfg, js, jnp.asarray(xb), jnp.asarray(yb),
                                  jops.rbf_matrix(jnp.asarray(xb), js.sv_x, 2.0, impl="ref"))
    tins = tbsgd.insert_from_rows(tcfg, ts, torch.tensor(xb), torch.tensor(yb),
                                  tbsgd.kops.rbf_matrix(torch.tensor(xb), ts.sv_x, 2.0))
    assert int(jins.count) == int(tins.count) == kw["budget"] + 1
    _, _, _, ji = jbudget.maintenance_step(jins.sv_x, jins.alpha, jins.count, 2.0, method=method)
    _, _, _, ti = tbudget.maintenance_step(tins.sv_x, tins.alpha, tins.count, 2.0, method=method)
    i, j = int(ji.i_min), int(ji.j_star)
    assert (int(ti.i_min), int(ti.j_star)) == (i, j)
    a = tins.alpha.numpy()
    assert abs(abs(a[i]) - abs(a[j])) <= 1e-5 * abs(a[i])           # m = 1/2
    h_t, h_j = float(ti.h_star), float(ji.h_star)
    assert min(abs(h_t - h_j), abs(h_t - (1.0 - h_j))) <= 1e-2        # same or mirror mode
    np.testing.assert_allclose(float(ti.wd_star), float(ji.wd_star), rtol=1e-4)


def test_convert_round_trip_gives_equal_predictions(data):
    xtr, ytr, xte, yte, _ = data
    kw = {**BASE, "method": "lookup-wd"}
    js = _jax_epoch(kw, data)
    leaves = {k: (None if v is None else np.asarray(v)) for k, v in js._asdict().items()}
    ts = convert.state_from_numpy(leaves, device=CPU)
    want = np.asarray(jbsgd.predict(js, jnp.asarray(xte), 2.0, impl="ref"))
    got = tbsgd.predict(ts, xte, 2.0, device=CPU).numpy()
    np.testing.assert_array_equal(got, want)
    back = convert.state_to_numpy(ts)
    assert "kmat" not in back and ts.kmat is None          # no cache, none carried
    for name in back:
        np.testing.assert_array_equal(back[name], leaves[name])
    # a cached state carries its kernel cache both ways
    jc = _jax_epoch({**kw, "use_kernel_cache": True}, data)
    cached = {k: np.asarray(v) for k, v in jc._asdict().items()}
    back = convert.state_to_numpy(convert.state_from_numpy(cached, device=CPU))
    assert back.keys() == cached.keys()
    for name in back:
        np.testing.assert_array_equal(back[name], cached[name])


def test_fit_trains_on_cpu_when_asked(data):
    xtr, ytr, xte, yte, _ = data
    cfg = tbsgd.BSGDConfig(**BASE)
    st = tbsgd.fit(cfg, xtr, ytr, epochs=2, seed=0, device=CPU)
    assert int(st.count) <= cfg.budget and int(st.n_merges) > 0
    assert int(st.step) == 2 * xtr.shape[0] + 1
    assert float(tbsgd.accuracy(st, xte, yte, cfg.gamma, device=CPU)) > 0.85
    again = tbsgd.fit(cfg, xtr, ytr, epochs=2, seed=0, device=CPU)
    assert torch.equal(again.alpha, st.alpha)           # the seed fixes the permutations


@pytest.mark.parametrize("entry", ["init_state", "fit", "train_epoch", "decision_function",
                                   "accuracy", "state_from_numpy"])
def test_no_cuda_without_explicit_cpu_raises(entry, data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xtr, ytr, xte, yte, perm = data
    cfg = tbsgd.BSGDConfig(**BASE)
    st = tbsgd.init_state(cfg, 2, device=CPU)
    calls = {
        "init_state": lambda: tbsgd.init_state(cfg, 2),
        "fit": lambda: tbsgd.fit(cfg, xtr, ytr),
        "train_epoch": lambda: tbsgd.train_epoch(cfg, cfg.table(), st, xtr, ytr, perm),
        "decision_function": lambda: tbsgd.decision_function(st, xte, 2.0),
        "accuracy": lambda: tbsgd.accuracy(st, xte, yte, 2.0),
        "state_from_numpy": lambda: convert.state_from_numpy(convert.state_to_numpy(st)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("knob,item", [
    (dict(use_kernel_cache=True, solver="bdca"), "Queue 1 item 9"),
    (dict(use_kernel_cache=True, solver="bdca", maintenance_engine="pallas"), "Queue 1 item 9"),
])
def test_unported_knobs_raise_not_implemented(knob, item):
    """The knobs that raised ``NotImplementedError`` naming ``item`` until
    that ROADMAP item was ported now construct and train in the port: no
    valid setting of the reference is refused any more."""
    jbsgd.BSGDConfig(**knob)                 # valid in the reference
    cfg = tbsgd.BSGDConfig(**knob)
    x = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    st = tbsgd.train_step(cfg, cfg.table(), tbsgd.init_state(cfg, 2, device=CPU), x[:1],
                          torch.ones(1))
    assert int(st.count) == 1 and int(st.step) == 2


@pytest.mark.parametrize("knob", [
    dict(use_kernel_cache=True), dict(use_kernel_cache=True, maintenance="multi-merge"),
    dict(use_kernel_cache=True, maintenance="quantized"),
    dict(use_kernel_cache=True, maintenance="removal-project"),
    dict(use_kernel_cache=True, maintenance_engine="pallas"), dict(maintenance="multi-merge"),
    dict(use_kernel_cache=True, step_engine="pallas"),
    dict(use_kernel_cache=True, step_engine="pallas", maintenance="multi-merge"),
])
def test_ported_knobs_construct(knob):
    cfg = tbsgd.BSGDConfig(**knob)
    st = tbsgd.init_state(cfg, 3, device=CPU)
    assert (st.kmat is not None) == cfg.use_kernel_cache
    if st.kmat is not None:
        assert st.kmat.shape == (cfg.slots, cfg.slots) and st.kmat.dtype == torch.float32


@pytest.mark.parametrize("knob", [
    dict(maintenance="nope"), dict(maintenance_engine="pallas"),
    dict(maintenance="quantized"), dict(solver="bdca"), dict(step_engine="fused"),
])
def test_invalid_configs_raise_value_error_in_both(knob):
    with pytest.raises(ValueError):
        jbsgd.BSGDConfig(**knob)
    with pytest.raises(ValueError):
        tbsgd.BSGDConfig(**knob)
