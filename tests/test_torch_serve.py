"""The port's serving path against the JAX reference (CPU).

  * export, scores, labels, top-k and probabilities agree with
    ``repro.core.predict`` on the same states (numpy leaves handed to both):
    scores within atol 1e-5, probabilities within 1e-6, ids equal where the
    top-two score gap exceeds 1e-4 (a last-bit difference may legally flip
    a closer tie);
  * a bf16 bank is held to the reference's ``impl="pallas_interpret"``,
    whose RBF sums a bf16 bank in fp32 as the port does (its plain RBF
    squares the bank in bf16, ROADMAP.md Queue 3);
  * the plain serve cell gives a row the same bits in a batch of any size,
    which is what makes queue labels equal direct labels;
  * the reference's serving tests (``tests/core/test_serve_predict.py``,
    ``test_serve_property.py``) in the port: queue == direct bit for bit for
    any arrival pattern, padding only to buckets, the queue's errors;
  * an exported model does not change when training goes on in place;
  * ``python -m repro_torch.launch.serve --arch svm_bsgd``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.hypothesis_compat import given, settings, st
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro.core import (export_model as jexport, predict_labels as jlabels,
                        predict_proba as jproba, serve_scores as jscores,
                        top_k_labels as jtopk)
from repro_torch import convert
from repro_torch.core import (BSGDConfig, BatchQueue, MulticlassSVMConfig, SVMState,
                              decision_function, drive_trace, export_model, fit, fit_multiclass,
                              predict, predict_labels, predict_multiclass, predict_proba,
                              ragged_trace_sizes, serve_requests, serve_scores, top_k_labels)
from repro_torch.core import multiclass as tmc
from repro_torch.data import make_blobs, make_blobs_multiclass
from repro_torch.kernels import ops, ref

CPU = "cpu"
GAMMA = 0.5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _leaves(seed, c, slots, dim, *, binary=False, kmat=False):
    """numpy leaves of a trained-looking state: random bank and alphas,
    active counts anywhere in [0, slots] (binary: one class, unstacked)."""
    rng = np.random.default_rng(seed)
    z = np.zeros((c,), np.int32)
    out = dict(sv_x=rng.standard_normal((c, slots, dim)).astype(np.float32),
               alpha=(0.5 * rng.standard_normal((c, slots))).astype(np.float32),
               count=rng.integers(0, slots + 1, c).astype(np.int32),
               step=np.ones((c,), np.int32), n_inserts=z, n_merges=z)
    if binary:
        out = {k: v[0] for k, v in out.items()}
        out["count"] = np.int32(max(int(out["count"]), 1))
    if kmat:
        shape = out["alpha"].shape + out["alpha"].shape[-1:]
        out["kmat"] = rng.random(shape).astype(np.float32)
    return out


def _pair(leaves):
    """The same state in both packages: (JAX SVMState, port SVMState on the CPU)."""
    js = jbsgd.SVMState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return js, convert.state_from_numpy(leaves, device=CPU)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _clear(scores, gap=1e-4):
    """Rows (columns of (C, n) scores) whose top-two gap exceeds ``gap``."""
    top2 = np.sort(scores, axis=0)[-2:]
    return (top2[1] - top2[0]) > gap


@pytest.fixture(scope="module")
def mc_model():
    """A port-trained 5-class model with its data (numpy, seed 0)."""
    cfg = MulticlassSVMConfig.create(5, budget=24, lambda_=1e-3, gamma=GAMMA, batch_size=8)
    x, y = make_blobs_multiclass(np.random.default_rng(0), 640, 8, 5, sep=2.0)
    return cfg, fit_multiclass(cfg, x, y, epochs=1, seed=0, device=CPU), x, y


@pytest.fixture(scope="module")
def bin_model():
    cfg = BSGDConfig(budget=16, lambda_=1e-3, gamma=GAMMA, batch_size=8)
    x, y = make_blobs(np.random.default_rng(1), 320, 6, sep=2.0)
    return cfg, fit(cfg, x, y, epochs=1, seed=0, device=CPU), x, y


# ---- the reference's numbers ----------------------------------------------


@pytest.mark.parametrize("binary", [False, True], ids=["multiclass", "binary"])
@pytest.mark.parametrize("bank_dtype", [None, "bfloat16"])
def test_export_matches_reference(binary, bank_dtype):
    js, ts = _pair(_leaves(3, 1 if binary else 4, 12, 5, binary=binary, kmat=True))
    jm, tm = jexport(js, GAMMA, bank_dtype=bank_dtype), export_model(ts, GAMMA,
                                                                     bank_dtype=bank_dtype)
    assert tm.binary is jm.binary is binary and tm.n_classes == jm.n_classes
    assert tm.sv_x.dtype == (torch.bfloat16 if bank_dtype else torch.float32)
    assert tm.alpha.dtype == torch.float32 and tm.count.dtype == torch.int32
    np.testing.assert_array_equal(_np(tm.sv_x), np.asarray(jm.sv_x.astype(jnp.float32)))
    np.testing.assert_array_equal(tm.alpha.numpy(), np.asarray(jm.alpha))
    np.testing.assert_array_equal(tm.count.numpy(), np.asarray(jm.count))
    assert tm.gamma == float(jm.gamma)


@pytest.mark.parametrize("seed,c,slots,dim", [(0, 4, 16, 6), (1, 3, 37, 5), (2, 2, 64, 16),
                                              (3, 4, 8, 1)])
@pytest.mark.parametrize("bank_dtype", [None, "bfloat16"])
def test_scores_labels_topk_proba_match_reference(seed, c, slots, dim, bank_dtype):
    js, ts = _pair(_leaves(seed, c, slots, dim))
    jm, tm = jexport(js, GAMMA, bank_dtype=bank_dtype), export_model(ts, GAMMA,
                                                                     bank_dtype=bank_dtype)
    x = np.random.default_rng(seed + 10).standard_normal((33, dim)).astype(np.float32)
    impl = "pallas_interpret" if bank_dtype else "ref"
    want = np.asarray(jscores(jm, jnp.asarray(x), impl=impl))
    got = serve_scores(tm, x)
    assert got.shape == (c, 33) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    clear = _clear(want)
    assert clear.sum() > 20
    np.testing.assert_array_equal(predict_labels(tm, x).numpy()[clear],
                                  np.asarray(jlabels(jm, jnp.asarray(x), impl=impl))[clear])
    k = min(3, c)
    ids, vals = top_k_labels(tm, x, k=k)
    jids, jvals = jtopk(jm, jnp.asarray(x), k=k, impl=impl)
    np.testing.assert_array_equal(ids.numpy()[clear, 0], np.asarray(jids)[clear, 0])
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0, atol=1e-5)
    np.testing.assert_allclose(predict_proba(tm, x, temperature=2.0).numpy(),
                               np.asarray(jproba(jm, jnp.asarray(x), temperature=2.0,
                                                 impl=impl)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_labels_match_reference(seed):
    js, ts = _pair(_leaves(seed, 1, 20, 4, binary=True))
    jm, tm = jexport(js, GAMMA), export_model(ts, GAMMA)
    x = np.random.default_rng(seed + 5).standard_normal((40, 4)).astype(np.float32)
    want = np.asarray(jscores(jm, jnp.asarray(x), impl="ref"))[0]
    got = predict_labels(tm, x)
    assert got.dtype == torch.float32 and set(np.unique(got.numpy())) <= {-1.0, 0.0, 1.0}
    clear = np.abs(want) > 1e-4
    np.testing.assert_array_equal(got.numpy()[clear],
                                  np.asarray(jlabels(jm, jnp.asarray(x), impl="ref"))[clear])


# ---- the plain serve cell ---------------------------------------------------


@pytest.mark.parametrize("binary", [False, True], ids=["multiclass", "binary"])
@pytest.mark.parametrize("bank_dtype", [None, "bfloat16"])
def test_plain_serve_cell_is_row_independent(binary, bank_dtype):
    """A row's scores and label are the same bits in a batch of any size and
    at any offset: the serve cell sums in one order whatever n."""
    _, ts = _pair(_leaves(7, 1 if binary else 4, 40, 12, binary=binary))
    tm = export_model(ts, GAMMA, bank_dtype=bank_dtype)
    x = np.random.default_rng(8).standard_normal((96, 12)).astype(np.float32)
    scores, labels = ops.serve_cell(torch.tensor(x), tm.sv_x, tm.alpha, tm.gamma, binary=binary)
    for b in (1, 3, 8, 16, 32, 64):
        for off in (0, 5):
            rows = np.zeros((b, 12), np.float32)
            n = min(b, 96 - off)
            rows[:n] = x[off:off + n]
            s_b, l_b = ops.serve_cell(torch.tensor(rows), tm.sv_x, tm.alpha, tm.gamma,
                                      binary=binary)
            assert torch.equal(s_b[:, :n], scores[:, off:off + n]), (b, off)
            assert torch.equal(l_b[:n], labels[off:off + n]), (b, off)


def test_class_scores_labels_ties_zeros_and_nans_follow_jnp():
    """Labels: the first maximum wins and a NaN counts as the maximum
    (``jnp.argmax``); binary signs keep 0 and NaN (``jnp.sign``)."""
    c, s = 3, 37
    rng = np.random.default_rng(4)
    alpha = torch.tensor(rng.standard_normal((c, s)), dtype=torch.float32)
    alpha[1] = alpha[0]                                   # classes 0 and 1 tie exactly
    k = torch.tensor(rng.random((6, c * s)), dtype=torch.float32)
    k[:, s:2 * s] = k[:, :s]
    k[4, 2 * s] = float("nan")                            # row 4: class 2 scores NaN
    k[5, :] = float("nan")                                # row 5: every class NaN
    scores, labels = ref.class_scores_labels(k, alpha)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jnp.argmax(scores.numpy(), 0)))
    assert labels[4] == 2 and labels[5] == 0 and (labels[:4] != 1).all()
    kb = torch.tensor([[0.0, 0.0], [0.5, 0.25], [float("nan"), 1.0], [0.5, 0.5]])
    ab = torch.tensor([[1.0, -2.0]])
    sb, lb = ref.class_scores_labels(kb, ab, binary=True)
    np.testing.assert_array_equal(sb[0].numpy(), [0.0, 0.0, np.nan, -0.5])
    np.testing.assert_array_equal(lb.numpy(), np.asarray(jnp.sign(sb[0].numpy())))


@pytest.mark.parametrize("c,s", [(1, 1), (3, 37), (10, 508), (2, 64)])
def test_class_scores_labels_agree_with_the_einsum(c, s):
    rng = np.random.default_rng(c * 100 + s)
    k = torch.tensor(rng.random((9, c * s)), dtype=torch.float32)
    alpha = torch.tensor(rng.standard_normal((c, s)), dtype=torch.float32)
    scores, labels = ref.class_scores_labels(k, alpha)
    want = torch.einsum("ncs,cs->cn", k.double().view(9, c, s), alpha.double())
    torch.testing.assert_close(scores.double(), want, rtol=0, atol=1e-5 * max(1, s / 64))
    np.testing.assert_array_equal(labels.numpy(), scores.argmax(0).numpy())


def test_rbf_matrix_rows_matches_the_matmul_form():
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((13, 9)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((21, 9)), dtype=torch.float32)
    torch.testing.assert_close(ref.rbf_matrix_rows(x, y, 0.3), ref.rbf_matrix(x, y, 0.3),
                               rtol=0, atol=1e-6)
    yb = y.to(torch.bfloat16)
    torch.testing.assert_close(ref.rbf_matrix_rows(x, yb, 0.3), ref.rbf_matrix(x, yb, 0.3),
                               rtol=0, atol=1e-6)


def test_decision_function_multiclass_reads_the_serve_cell(mc_model):
    """Train-side scores come from the same route as the serve cell."""
    cfg, state, x, _ = mc_model
    got = tmc.decision_function_multiclass(state, x[:50], GAMMA, device=CPU)
    assert torch.equal(got, serve_scores(export_model(state, GAMMA), x[:50]))


# ---- the reference's serving tests, in the port ------------------------------


def test_export_folds_count_mask_and_quantizes_bank_only(mc_model):
    _, state, _, _ = mc_model
    model = export_model(state, GAMMA, bank_dtype="bfloat16")
    assert model.sv_x.dtype == torch.bfloat16 and model.alpha.dtype == torch.float32
    assert not model.binary and model.n_classes == 5
    for c in range(5):
        n = int(model.count[c])
        assert (model.alpha[c, n:] == 0).all()
        assert torch.equal(model.alpha[c, :n], state.alpha[c, :n])


def test_binary_export_is_c1_bank(bin_model):
    _, state, x, _ = bin_model
    model = export_model(state, GAMMA)
    assert model.binary and model.sv_x.shape[0] == 1
    labels = predict_labels(model, x)
    assert labels.dtype == torch.float32
    assert torch.equal(labels, predict(state, x, GAMMA, device=CPU))


def test_fused_serve_cell_matches_train_side_predict(mc_model):
    _, state, x, y = mc_model
    got = predict_labels(export_model(state, GAMMA), x)
    assert torch.equal(got, predict_multiclass(state, x, GAMMA, device=CPU))
    assert (got.numpy() == y).mean() > 0.9          # the model is real


@pytest.mark.parametrize("k", [1, 2, 5])
def test_top_k_rank1_is_argmax_and_scores_sorted(mc_model, k):
    _, state, x, _ = mc_model
    model = export_model(state, GAMMA)
    ids, vals = top_k_labels(model, x[:100], k=k)
    assert ids.shape == vals.shape == (100, k) and ids.dtype == torch.int32
    assert torch.equal(ids[:, 0], predict_labels(model, x[:100]))
    assert (vals.diff(dim=1) <= 0).all()
    assert all(len(set(r)) == k for r in ids.tolist())
    scores = serve_scores(model, x[:100]).T
    assert torch.equal(scores.gather(1, ids.long()), vals)


def test_top_k_breaks_exact_ties_to_the_lower_class():
    leaves = _leaves(9, 3, 10, 4)
    for name in ("sv_x", "alpha"):
        leaves[name][2] = leaves[name][0]
    leaves["count"][2] = leaves["count"][0] = 10
    _, ts = _pair(leaves)
    model = export_model(ts, GAMMA)
    x = np.random.default_rng(1).standard_normal((20, 4)).astype(np.float32)
    ids, vals = top_k_labels(model, x, k=3)
    tied = (ids[:, 0] == 0) | (ids[:, 0] == 2)
    assert tied.any()
    first = ids[tied]
    assert ((first[:, 0] == 0) & (first[:, 1] == 2)).all()
    assert torch.equal(ids[:, 0], predict_labels(model, x))


def test_predict_proba_calibrated_softmax(mc_model):
    _, state, x, _ = mc_model
    model = export_model(state, GAMMA)
    probs = predict_proba(model, x[:100])
    assert probs.shape == (100, 5)
    torch.testing.assert_close(probs.sum(1), torch.ones(100), rtol=0, atol=1e-5)
    assert torch.equal(probs.argmax(1).to(torch.int32), predict_labels(model, x[:100]))
    hot = predict_proba(model, x[:100], temperature=10.0)
    assert torch.equal(probs.argmax(1), hot.argmax(1))
    assert (hot.max(1).values <= probs.max(1).values + 1e-6).all()


def test_top_k_and_proba_reject_binary_and_bad_k(bin_model, mc_model):
    bmodel = export_model(bin_model[1], GAMMA)
    mmodel, mx = export_model(mc_model[1], GAMMA), mc_model[2]
    with pytest.raises(ValueError):
        top_k_labels(bmodel, bin_model[2][:4])
    with pytest.raises(ValueError):
        predict_proba(bmodel, bin_model[2][:4])
    for k in (0, 6):
        with pytest.raises(ValueError):
            top_k_labels(mmodel, mx[:4], k=k)
    for t in (0.0, -1.0):
        with pytest.raises(ValueError):
            predict_proba(mmodel, mx[:4], temperature=t)


def test_bf16_bank_matches_fp32_on_margin_separated_rows(mc_model):
    _, state, x, _ = mc_model
    fp32, bf16 = export_model(state, GAMMA), export_model(state, GAMMA, bank_dtype="bfloat16")
    sep = _clear(serve_scores(fp32, x).numpy(), gap=0.05)
    assert sep.mean() > 0.8
    np.testing.assert_array_equal(predict_labels(bf16, x).numpy()[sep],
                                  predict_labels(fp32, x).numpy()[sep])


@pytest.mark.parametrize("step_engine", ["composed", "pallas"])
def test_export_is_isolated_from_in_place_training(step_engine):
    """The fused step and the event rounds update a state in place: a model
    exported from that state must own its tensors and not move with it."""
    from repro_torch.core import budget
    cfg = MulticlassSVMConfig.create(3, budget=10, lambda_=1e-3, gamma=GAMMA, batch_size=4,
                                     use_kernel_cache=True, step_engine=step_engine,
                                     maintenance_engine="xla" if step_engine == "pallas"
                                     else "pallas")
    x, y = make_blobs_multiclass(np.random.default_rng(2), 96, 5, 3, sep=2.0)
    state = tmc._owned(fit_multiclass(cfg, x, y, epochs=1, seed=0, device=CPU))
    xb, yb = torch.tensor(x[:4]), torch.tensor(y[:4]).long()
    if step_engine == "composed":
        # the class-axis step's insert, then its event rounds in place
        state = tmc.insert_from_rows(cfg.binary, state, xb, tmc.ovr_targets(yb, 3),
                                     tmc.class_kernel_rows(state.sv_x, xb, GAMMA),
                                     ops.rbf_matrix(xb, xb, GAMMA))
    model = export_model(state, GAMMA)
    before = [t.clone() for t in (model.sv_x, model.alpha, model.count)]
    labels = predict_labels(model, x)
    alpha0 = state.alpha.clone()
    if step_engine == "pallas":
        tmc._fused_step_multiclass_(cfg, cfg.table(), state, xb, yb)
    else:
        budget.event_rounds_(state.sv_x, state.alpha, state.kmat, state.count, state.n_merges,
                             cfg.table(), budget=10, unroll=4)
    assert not torch.equal(state.alpha, alpha0)          # training did move the state
    for got, want in zip((model.sv_x, model.alpha, model.count), before):
        assert torch.equal(got, want)
    assert torch.equal(predict_labels(model, x), labels)


ARRIVALS = [
    [640],                                # one big request, spans microbatches
    [1] * 37,                             # tiny requests packed together
    [3, 50, 1, 0, 17, 120, 5, 200, 31],   # ragged mix with an empty request
    [63, 64, 65],                         # straddling the microbatch size
]


@pytest.mark.parametrize("sizes", ARRIVALS)
def test_queue_bitwise_parity_multiclass(mc_model, sizes):
    _, state, x, _ = mc_model
    model = export_model(state, GAMMA)
    direct = predict_labels(model, x).numpy()
    reqs, off = [], 0
    for s in sizes:
        reqs.append(x[off:off + s])
        off += s
    labels = serve_requests(model, reqs, max_batch=64)
    assert [len(lab) for lab in labels] == sizes
    np.testing.assert_array_equal(np.concatenate(labels), direct[:off])


@pytest.mark.parametrize("sizes", ARRIVALS)
def test_queue_bitwise_parity_binary(bin_model, sizes):
    _, state, x, _ = bin_model
    sizes = [min(s, 40) for s in sizes]
    model = export_model(state, GAMMA)
    direct = predict_labels(model, x).numpy()
    reqs, off = [], 0
    for s in sizes:
        reqs.append(x[off:off + s])
        off += s
    labels = serve_requests(model, reqs, max_batch=32, min_bucket=4)
    assert all(lab.dtype == np.float32 for lab in labels)
    np.testing.assert_array_equal(np.concatenate(labels), direct[:off])


def test_queue_pads_to_buckets_only(mc_model):
    _, state, x, _ = mc_model
    model = export_model(state, GAMMA)
    q = BatchQueue(model, max_batch=32, min_bucket=8)
    assert q.buckets == (8, 16, 32)
    t1 = q.submit(x[:70])                 # 2 full microbatches run now
    assert q.stats["microbatches"] == 2 and q._pending_rows == 6
    t2 = q.submit(x[70:75])
    q.drain()                             # ragged 11 -> bucket 16
    assert q.stats["bucket_counts"] == {32: 2, 16: 1}
    assert q.stats["padded_rows"] == 5
    np.testing.assert_array_equal(np.concatenate([q.take(t1), q.take(t2)]),
                                  predict_labels(model, x[:75]).numpy())


def test_queue_take_before_drain_raises(mc_model):
    q = BatchQueue(export_model(mc_model[1], GAMMA), max_batch=64)
    t = q.submit(mc_model[2][:3])
    with pytest.raises(KeyError, match="drain"):
        q.take(t)
    q.drain()
    assert q.take(t).shape == (3,)


def test_queue_rejects_bad_geometry_and_rows(mc_model):
    model = export_model(mc_model[1], GAMMA)
    with pytest.raises(ValueError, match="max_batch"):
        BatchQueue(model, max_batch=0)
    with pytest.raises(ValueError, match="min_bucket"):
        BatchQueue(model, max_batch=8, min_bucket=0)
    q = BatchQueue(model, max_batch=64)
    with pytest.raises(ValueError, match="non-finite"):
        q.submit(np.full((2, 8), np.nan, np.float32))
    with pytest.raises(ValueError, match="request dim"):
        q.submit(np.zeros((2, 9), np.float32))


def test_sync_warmup_covers_every_bucket(mc_model):
    model = export_model(mc_model[1], GAMMA)
    q = BatchQueue(model, max_batch=64, min_bucket=8)
    q.warmup()
    assert q.warmed == set(q.buckets) == {8, 16, 32, 64}
    for s in (3, 9, 17, 64, 130):
        q.submit(mc_model[2][:s])
    q.drain()
    assert set(q.stats["bucket_counts"]) <= q.warmed


def test_drive_trace_max_batch_one(mc_model):
    model = export_model(mc_model[1], GAMMA)
    sizes = ragged_trace_sizes(8, 1, np.random.default_rng(0))
    assert sizes == [1] * 8
    stats = drive_trace(model, mc_model[2][:8], sizes, max_batch=1, min_bucket=1)
    assert stats["rows"] == 8 and stats["microbatches"] == 8
    assert "live_reserved_bytes" not in stats      # a CPU model has no card to account


def test_drive_trace_reports_pad_waste(mc_model):
    model = export_model(mc_model[1], GAMMA)
    sizes = ragged_trace_sizes(300, 64, np.random.default_rng(3))
    stats = drive_trace(model, mc_model[2][:300], sizes, max_batch=64)
    assert stats["rows"] == 300 and sum(sizes) == 300
    assert stats["padded_rows"] == sum(b * n for b, n in stats["bucket_counts"].items()) - 300
    assert 0 <= stats["pad_waste_frac"] < 0.5 and stats["p99_ms"] >= stats["p50_ms"]


# ---- properties (the reference's test_serve_property.py) --------------------

COMMON = dict(deadline=None, max_examples=8)


@given(seed=st.integers(0, 2**30), c=st.integers(2, 4), slots=st.integers(2, 24),
       dim=st.integers(1, 8))
@settings(**COMMON)
def test_fused_cell_decision_identical_to_class_loop(seed, c, slots, dim):
    _, ts = _pair(_leaves(seed, c, slots, dim))
    x = np.random.default_rng(seed + 1).standard_normal((17, dim)).astype(np.float32)
    model = export_model(ts, GAMMA)
    loop = torch.stack([decision_function(SVMState(*(t[q] for t in ts[:6])), x, GAMMA,
                                          device=CPU) for q in range(c)])
    fused = serve_scores(model, x)
    torch.testing.assert_close(fused, loop, rtol=1e-5, atol=1e-5)
    clear = _clear(loop.numpy())
    np.testing.assert_array_equal(predict_labels(model, x).numpy()[clear],
                                  loop.argmax(0).numpy()[clear])


@given(seed=st.integers(0, 2**30), sizes=st.lists(st.integers(0, 40), min_size=1, max_size=12),
       max_batch=st.integers(1, 48), min_bucket=st.integers(1, 8))
@settings(**COMMON)
def test_queue_bitwise_parity_any_arrival_pattern(seed, sizes, max_batch, min_bucket):
    _, ts = _pair(_leaves(seed, 3, 8, 4))
    model = export_model(ts, GAMMA)
    n = sum(sizes)
    x = np.random.default_rng(seed + 2).standard_normal((n + 1, 4)).astype(np.float32)
    reqs, off = [], 0
    for s in sizes:
        reqs.append(x[off:off + s])
        off += s
    labels = serve_requests(model, reqs, max_batch=max_batch, min_bucket=min_bucket)
    assert [len(lab) for lab in labels] == sizes
    if n:
        np.testing.assert_array_equal(np.concatenate(labels), predict_labels(model, x[:n]).numpy())


# ---- the entry point ----------------------------------------------------------


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_serve_cli_smoke_on_the_cpu():
    out = _cli("--arch", "svm_bsgd", "--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "queue == direct predict (bitwise)" in out.stdout
    assert "rank 1 == argmax labels (bitwise)" in out.stdout


def test_serve_cli_needs_the_card_unless_told_otherwise():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is reachable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "svm_bsgd", "--smoke"])


@pytest.mark.parametrize("argv,match", [
    (["--arch", "smollm_360m", "--smoke", "--live"], "--live and --model are svm_bsgd options"),
    (["--arch", "hubert_xlarge", "--smoke"], "encoder.*encode_step")])
def test_serve_cli_unported_arms_raise(argv, match):
    """The arms the port refuses: train-while-serve is the SVM arm's alone,
    and the encoder has no decode step (the reference's ``serve`` fails on
    it with a KeyError)."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match=match):
        serve.main(argv + ["--device", "cpu"])
