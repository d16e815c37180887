"""The port's one-vs-rest class axis against the JAX reference (CPU).

The same blobs and the same permutation (numpy, from a seed) go through
``repro.core.multiclass.train_epoch_multiclass`` (the reference's ``vmap``
over classes, its kernels through ``impl="ref"``, maintenance unrolled) and
the port's batched class axis, under each maintenance engine.  Integer state
must be equal in every class; floats agree within 3e-5, no tighter than the
reference's own engines agree with each other (ROADMAP.md Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro.core import budget as jbudget
from repro.core import multiclass as jmc
from repro_torch import convert
from repro_torch.core import bsgd as tbsgd
from repro_torch.core import budget as tbudget
from repro_torch.core import kernel_cache as tkc
from repro_torch.core import multiclass as tmc
from repro_torch.data import make_blobs_multiclass

CPU = "cpu"
C, DIM = 3, 6
BASE = dict(budget=10, lambda_=1e-3, gamma=0.25, batch_size=4, unroll_maintenance=True)


@pytest.fixture(scope="module")
def data():
    x, y = make_blobs_multiclass(np.random.default_rng(0), 240, DIM, C, sep=1.0, noise=1.0)
    return x, y, np.random.default_rng(1).permutation(240)


def _as_jax(state):
    return jbsgd.SVMState(**convert.state_to_numpy(state))


def _jax_epoch(kw, data, perm=None, impl="ref"):
    x, y, p = data
    cfg = jmc.MulticlassSVMConfig.create(C, **kw)
    return jmc.train_epoch_multiclass(cfg, cfg.table(), jmc.init_multiclass_state(cfg, DIM),
                                      jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(p if perm is None else perm), impl=impl)


def _torch_epoch(kw, data, perm=None):
    x, y, p = data
    cfg = tmc.MulticlassSVMConfig.create(C, **kw)
    return tmc.train_epoch_multiclass(cfg, cfg.table(),
                                      tmc.init_multiclass_state(cfg, DIM, device=CPU), x, y,
                                      p if perm is None else perm, device=CPU)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_kernel_cache=True),
    dict(use_kernel_cache=True, maintenance="multi-merge"),
    dict(maintenance="multi-merge"),
    dict(use_kernel_cache=True, maintenance_engine="pallas"),
    dict(use_kernel_cache=True, maintenance="removal-project"),
    dict(use_kernel_cache=True, maintenance="quantized"),
], ids=["merge", "merge-cache", "multi-merge-cache", "multi-merge", "engine-pallas",
        "removal-project", "quantized"])
def test_train_epoch_multiclass_matches_reference(kw, data):
    kw = {**BASE, **kw}
    js, ts = _jax_epoch(kw, data), _torch_epoch(kw, data)
    assert ts.alpha.shape == (C, 14) and (ts.n_merges > 5).all()
    assert_state_parity(js, _as_jax(ts), atol_float=3e-5, rtol=1e-5, context=str(kw))
    if ts.kmat is not None:
        tkc.check_invariants(ts.kmat, ts.sv_x, ts.count, kw["gamma"])
    x, y, _ = data
    jacc = jmc.accuracy_multiclass(js, jnp.asarray(x), jnp.asarray(y), kw["gamma"], impl="ref")
    tacc = tmc.accuracy_multiclass(ts, x, y, kw["gamma"], device=CPU)
    assert round(float(tacc) * 240) == round(float(jacc) * 240)
    assert float(tacc) > 0.6


def test_reference_plain_rbf_squares_a_bf16_bank_in_bf16():
    """Why a bf16 bank is not held to the reference's plain path: its
    ``ref.rbf_matrix`` forms ||y||^2 in bf16, ~4e-3 off the fp32 sum that its
    Pallas kernel and the port's kernel and plain version accumulate (ROADMAP.md
    Queue 3).  Both caches then part before the first merge."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, DIM)).astype(np.float32)
    y = np.asarray(jnp.asarray(rng.standard_normal((9, DIM)), jnp.bfloat16).astype(jnp.float32))
    j16 = np.asarray(jref.rbf_matrix(jnp.asarray(x), jnp.asarray(y, jnp.bfloat16), 0.25))
    j32 = np.asarray(jref.rbf_matrix(jnp.asarray(x), jnp.asarray(y), 0.25))
    t16 = tbsgd.kops.rbf_matrix(torch.tensor(x), torch.tensor(y).to(torch.bfloat16), 0.25)
    assert np.abs(j16 - j32).max() > 1e-4
    np.testing.assert_array_equal(t16.numpy(), tbsgd.kops.rbf_matrix(
        torch.tensor(x), torch.tensor(y), 0.25).numpy())
    np.testing.assert_allclose(t16.numpy(), j32, rtol=1e-5, atol=1e-6)


def test_engine_trains_bf16_bank_multiclass(data):
    """The fused engine end to end on a bf16 SV bank (fp32 cache), against the
    reference's same epoch through its Pallas kernels in interpret mode (whose
    RBF, like the port's, sums a bf16 bank in fp32), and against the port's
    own run on an fp32 bank."""
    x, y, _ = data
    kw = {**BASE, "use_kernel_cache": True, "maintenance_engine": "pallas"}
    kw16 = {**kw, "sv_dtype": "bfloat16"}
    j16 = _jax_epoch(kw16, data, impl="pallas_interpret")
    t16 = _torch_epoch(kw16, data)
    assert t16.sv_x.dtype == torch.bfloat16 and t16.kmat.dtype == torch.float32
    assert (t16.count <= kw["budget"]).all() and (t16.n_merges > 5).all()
    got = {k: np.asarray(v, np.float32) if k in ("sv_x", "alpha", "kmat") else v
           for k, v in convert.state_to_numpy(t16).items()}
    want = {k: np.asarray(v, np.float32) if k in ("sv_x", "alpha", "kmat") else np.asarray(v)
            for k, v in j16._asdict().items()}
    for name in ("count", "step", "n_inserts", "n_merges"):           # exactly
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # sv_x within one bf16 rounding (2^-7 relative): a merged z whose fp32
    # value differs in its last bits may round to the neighbouring bf16 value
    assert (np.abs(got["sv_x"] - want["sv_x"]) <= 2.0 ** -7 * np.abs(want["sv_x"])).all()
    # such a row moves every kernel value it enters: alpha within 1e-3
    # relative, the cache within 5e-4 (the reference's tolerance for a cache
    # carried through training, tests/core/test_event_engine.py)
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=1e-3, atol=3e-5)
    np.testing.assert_allclose(got["kmat"], want["kmat"], rtol=0, atol=5e-4)
    # I2 and I3 exactly; I1 within bf16 storage: the cache keeps k of the
    # rows before they are rounded to 8 mantissa bits in sv_x
    tkc.check_invariants(t16.kmat, t16.sv_x, t16.count, kw["gamma"], tol=2e-2)
    t32 = _torch_epoch(kw, data)
    a16 = float(tmc.accuracy_multiclass(t16, x, y, kw["gamma"], device=CPU))
    a32 = float(tmc.accuracy_multiclass(t32, x, y, kw["gamma"], device=CPU))
    assert a16 > 0.6 and abs(a16 - a32) <= 0.05


def test_fit_multiclass_loop_trains_the_same_model(data):
    x, y, _ = data
    cfg = tmc.MulticlassSVMConfig.create(C, **BASE, use_kernel_cache=True)
    batched = tmc.fit_multiclass(cfg, x, y, epochs=1, seed=3, device=CPU)
    looped = tmc.fit_multiclass_loop(cfg, x, y, epochs=1, seed=3, device=CPU)
    assert_state_parity(_as_jax(batched), _as_jax(looped), atol_float=3e-5, rtol=1e-5)
    assert int(batched.step[0]) == 240 // BASE["batch_size"] + 1


def test_class_kernel_rows_and_scores_match_reference(data):
    x, y, _ = data
    kw = {**BASE, "use_kernel_cache": True}
    js = _jax_epoch(kw, data)
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                  device=CPU)
    want = np.asarray(jmc.class_kernel_rows(js.sv_x, jnp.asarray(x[:9]), 0.25, impl="ref"))
    got = tmc.class_kernel_rows(ts.sv_x, torch.tensor(x[:9]), 0.25).numpy()
    assert got.shape == (C, 9, 14)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want = np.asarray(jmc.decision_function_multiclass(js, jnp.asarray(x), 0.25, impl="ref"))
    got = tmc.decision_function_multiclass(ts, x, 0.25, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tmc.predict_multiclass(ts, x, 0.25, device=CPU).numpy(),
        np.asarray(jmc.predict_multiclass(js, jnp.asarray(x), 0.25, impl="ref")))


def test_ovr_targets_labels_and_init():
    y = np.array([0, 2, 1, 2], np.int32)
    np.testing.assert_array_equal(tmc.ovr_targets(torch.tensor(y), 3).numpy(),
                                  np.asarray(jmc.ovr_targets(jnp.asarray(y), 3)))
    tmc.check_labels(y, 3)
    with pytest.raises(ValueError, match="1-based"):
        tmc.check_labels(y + 1, 3)
    with pytest.raises(ValueError):
        tmc.MulticlassSVMConfig.create(1)
    st = tmc.init_multiclass_state(tmc.MulticlassSVMConfig.create(3, **BASE,
                                                                  use_kernel_cache=True), 5,
                                   device=CPU)
    assert st.sv_x.shape == (3, 14, 5) and st.kmat.shape == (3, 14, 14)
    assert st.count.shape == (3,) and (st.step == 1).all()
    st.kmat[0, 0, 0] = 1.0                      # each class owns its memory
    assert st.kmat[1, 0, 0] == 0.0


def test_make_blobs_multiclass():
    x, y = make_blobs_multiclass(np.random.default_rng(5), 300, 12, 4, sep=2.0)
    assert x.shape == (300, 12) and x.dtype == np.float32
    assert y.dtype == np.int32 and set(np.unique(y)) == {0, 1, 2, 3}
    x2, y2 = make_blobs_multiclass(np.random.default_rng(5), 300, 12, 4, sep=2.0)
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(y, y2)


def test_jax_trained_cached_state_makes_the_same_next_merge(data):
    """A cached multiclass state trained by the reference moves into the port
    and both packages then make the same next merge decision in every class."""
    x, y, perm = data
    kw = {**BASE, "use_kernel_cache": True}
    js = _jax_epoch(kw, data, perm[:160])
    leaves = {k: np.asarray(v) for k, v in js._asdict().items()}
    ts = convert.state_from_numpy(leaves, device=CPU)
    for name, arr in convert.state_to_numpy(ts).items():
        np.testing.assert_array_equal(arr, leaves[name])
    tkc.check_invariants(ts.kmat, ts.sv_x, ts.count, kw["gamma"])
    # the next minibatch: insert in both packages, then one merge per class
    jcfg = jmc.MulticlassSVMConfig.create(C, **kw)
    tcfg = tmc.MulticlassSVMConfig.create(C, **kw)
    xb, yb = x[perm[160:164]], y[perm[160:164]]
    k_b = jmc.class_kernel_rows(js.sv_x, jnp.asarray(xb), kw["gamma"], impl="ref")
    k_bb = jnp.asarray(np.asarray(tbsgd.kops.rbf_matrix(torch.tensor(xb), torch.tensor(xb),
                                                         kw["gamma"])))
    y_ovr = jmc.ovr_targets(jnp.asarray(yb), C)
    jmid = jax.vmap(lambda st, yc, kc: jbsgd.insert_from_rows(jcfg.binary, st, jnp.asarray(xb),
                                                               yc, kc, k_bb))(js, y_ovr, k_b)
    tmid = tbsgd.insert_from_rows(tcfg.binary, ts, torch.tensor(xb),
                                  tmc.ovr_targets(torch.tensor(yb), C),
                                  tmc.class_kernel_rows(ts.sv_x, torch.tensor(xb), kw["gamma"]),
                                  torch.tensor(np.asarray(k_bb)))
    assert_state_parity(jmid, _as_jax(tmid), atol_float=3e-5, rtol=1e-5)
    table = jcfg.table()
    merge_once = jax.jit(jbudget._merge_once, static_argnums=(5,))
    _, _, _, _, tinfo = tbudget._merge_once(tmid.sv_x, tmid.alpha, tmid.kmat, tmid.count,
                                            kw["gamma"], "lookup-wd", tcfg.table())
    for q in range(C):
        *_, jinfo = merge_once(jmid.sv_x[q], jmid.alpha[q], jmid.kmat[q], jmid.count[q],
                               kw["gamma"], "lookup-wd", table)
        assert (int(tinfo.i_min[q]), int(tinfo.j_star[q]), bool(tinfo.merged[q])) == \
            (int(jinfo.i_min), int(jinfo.j_star), bool(jinfo.merged)), f"class {q}"
