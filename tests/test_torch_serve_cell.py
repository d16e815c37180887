"""The serve cell's one-launch wrapper and its plain path (CPU).

  * ``class_scores.serve_cell_cuda`` refuses what its kernel does not take
    (CPU tensors, wrong dtypes, shapes that do not pair, a binary model with
    C != 1) before it reaches the compiled library;
  * the plain serve cell gives a row the same bits in every bucket of
    ``default_buckets(256)`` and at the ragged trace's offsets, fp32 and
    bf16 banks, binary and multiclass (what makes queue labels direct
    labels, on the card as here);
  * rows and banks holding NaN and Inf get the labels of the reference's
    ``predict_labels`` (``jnp.argmax``: a NaN counts as the maximum;
    ``jnp.sign``: NaN stays NaN).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro.core import export_model as jexport, predict_labels as jlabels
from repro_torch import convert
from repro_torch.core import default_buckets, export_model, pad_bucket, ragged_trace_sizes
from repro_torch.kernels import _build, class_scores, ops

GAMMA = 0.5


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0, so that the wrapper's checks
    past the device check run here (the compiled library is never reached)."""

    def get_device(self):
        return 0


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def _state(seed, c, slots, dim, *, binary=False):
    """numpy leaves of a trained-looking state (every slot active), in both
    packages: (JAX SVMState, port SVMState on the CPU)."""
    rng = np.random.default_rng(seed)
    z = np.zeros((c,), np.int32)
    leaves = dict(sv_x=rng.standard_normal((c, slots, dim)).astype(np.float32),
                  alpha=(0.5 * rng.standard_normal((c, slots))).astype(np.float32),
                  count=np.full((c,), slots, np.int32), step=np.ones((c,), np.int32),
                  n_inserts=z, n_merges=z)
    if binary:
        leaves = {k: v[0] for k, v in leaves.items()}
    return leaves


def _pair(leaves):
    js = jbsgd.SVMState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return js, convert.state_from_numpy(leaves, device="cpu")


# ---- the wrapper's checks ---------------------------------------------------


def test_serve_cell_cuda_refuses_what_its_kernel_does_not_take(monkeypatch):
    def touched(*_a, **_k):
        raise AssertionError("the wrapper reached the compiled library")

    monkeypatch.setattr(_build, "function", touched)
    monkeypatch.setattr(_build, "load", touched)
    x, bank, alpha = torch.zeros(5, 12), torch.zeros(3 * 7, 12), torch.zeros(3, 7)
    card = [_card(t) for t in (x, bank, alpha)]
    with pytest.raises(ValueError, match="CUDA"):                  # CPU tensors
        class_scores.serve_cell_cuda(x, bank, alpha, GAMMA)
    with pytest.raises(ValueError, match="CUDA"):                  # one input left on the CPU
        class_scores.serve_cell_cuda(card[0], bank, card[2], GAMMA)
    for i, bad in ((0, x.double()), (1, bank.half()), (2, alpha.bfloat16())):
        args = list(card)
        args[i] = _card(bad)
        with pytest.raises(TypeError):                             # a dtype it does not take
            class_scores.serve_cell_cuda(*args, GAMMA)
    for shapes in (((5, 12), (20, 12), (3, 7)), ((5, 11), (21, 12), (3, 7)),
                   ((5, 12), (21, 12), (21,)), ((5, 12), (0, 12), (3, 0))):
        args = [_card(torch.zeros(*s)) for s in shapes]
        with pytest.raises(ValueError, match="pair"):              # shapes that do not pair
            class_scores.serve_cell_cuda(*args, GAMMA)
    with pytest.raises(ValueError, match="one class"):             # binary needs C = 1
        class_scores.serve_cell_cuda(*card, GAMMA, binary=True)
    with pytest.raises(ValueError, match="CUDA"):                  # the dispatch, impl="cuda"
        ops.serve_cell(x, bank.view(3, 7, 12), alpha, GAMMA, impl="cuda")


def test_serve_cell_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    x, sv = torch.rand(9, 4), torch.rand(2, 5, 4)
    scores, labels = ops.serve_cell(x, sv, torch.ones(2, 5), GAMMA)
    assert scores.shape == (2, 9) and labels.dtype == torch.int32
    assert set(ops.launch_counts().values()) == {0}


# ---- row independence at the queue's buckets ---------------------------------


@pytest.mark.parametrize("binary", [False, True], ids=["multiclass", "binary"])
@pytest.mark.parametrize("bank_dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_plain_serve_cell_keeps_a_rows_bits_in_every_bucket(binary, bank_dtype):
    """Every bucket of ``default_buckets(256)`` and the ragged trace's
    requests, each padded to its bucket with zero rows as the queues pad:
    the scores and labels of each real row are the direct call's bits."""
    _, ts = _pair(_state(3, 1 if binary else 3, 24, 6, binary=binary))
    model = export_model(ts, GAMMA, bank_dtype=bank_dtype)
    n = 300
    x = torch.tensor(np.random.default_rng(4).standard_normal((n, 6)), dtype=torch.float32)
    cell = lambda rows: ops.serve_cell(rows, model.sv_x, model.alpha, model.gamma, binary=binary)
    scores, labels = cell(x)
    buckets = default_buckets(256)
    sizes = ragged_trace_sizes(n, 256, np.random.default_rng(5))
    spans = {b: [(o, min(b, n - o)) for o in range(0, n, b)] for b in buckets}
    spans["ragged"] = list(zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes))
    for b, pieces in spans.items():
        for off, m in pieces:
            rows = torch.zeros(pad_bucket(m, buckets), 6)
            rows[:m] = x[off:off + m]
            s_b, l_b = cell(rows)
            assert torch.equal(s_b[:, :m], scores[:, off:off + m]), (b, off)
            assert torch.equal(l_b[:m], labels[off:off + m]), (b, off)


# ---- NaN and Inf -------------------------------------------------------------


@pytest.mark.parametrize("binary", [False, True], ids=["multiclass", "binary"])
def test_nan_and_inf_rows_get_the_references_labels(binary):
    """Rows holding a NaN, an Inf or a -Inf, and a bank whose class 2 holds a
    NaN: the port's labels are the reference's ``predict_labels``, and they
    are ``jnp.argmax`` / ``jnp.sign`` of the port's own scores."""
    leaves = _state(6, 1 if binary else 4, 20, 5, binary=binary)
    x = np.random.default_rng(7).standard_normal((8, 5)).astype(np.float32)
    x[1, 2], x[2, 0], x[3, 4] = np.nan, np.inf, -np.inf
    x[4, :] = np.inf
    cases = [leaves]
    if not binary:
        poisoned = {k: v.copy() for k, v in leaves.items()}
        poisoned["sv_x"][2, 3, 1] = np.nan                 # every row's class 2 scores NaN
        cases.append(poisoned)
    for case in cases:
        js, ts = _pair(case)
        jm, tm = jexport(js, GAMMA), export_model(ts, GAMMA)
        scores, labels = ops.serve_cell(torch.tensor(x), tm.sv_x, tm.alpha, tm.gamma,
                                        binary=binary)
        want = np.asarray(jlabels(jm, jnp.asarray(x)))
        np.testing.assert_array_equal(labels.numpy(), want)
        rule = jnp.sign(scores[0].numpy()) if binary else jnp.argmax(scores.numpy(), axis=0)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(rule))
        assert bool(torch.isnan(scores[:, 1]).all())           # a NaN feature: every score NaN
        if binary:
            assert torch.isnan(labels[1])
        else:
            assert labels[1] == 0
        if case is not leaves:
            assert bool((labels[[0, 5, 6, 7]] == 2).all())     # the NaN class wins finite rows
