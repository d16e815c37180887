"""The port's fused GSS choice (``gss_pick``) on the CPU.

On the CPU ``ops.gss_pick`` runs its plain version (``kernels.ref.gss_pick``);
the CUDA kernel (``csrc/gss.cu``) is held against that on the card by
``chip_smoke.py``.  Here the plain version must equal, bit for bit, the
sequence of operations that ``core.budget`` ran before it (restated below
as ``_old_*``), for ``gss`` (10 bracket steps) and ``gss-precise`` (48), with
exact ties and rows without a valid candidate; its choice must agree with
the JAX reference's ``candidate_scores`` and argmin (the partner exactly,
the WD within rtol 1e-4 and atol 1e-6, h* within the search's eps 1e-2);
and a short binary GSS epoch, which now chooses through it, must keep the reference's
integer state on the same permutation.  The wrapper must refuse what its
kernel does not take before it touches any compiled library.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.invariants import assert_state_parity
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import bsgd as jbsgd
from repro.core import budget as jbudget
from repro_torch import convert
from repro_torch.core import bsgd as tbsgd
from repro_torch.core import budget as tbudget
from repro_torch.core import merge_math as tmm
from repro_torch.data import make_two_moons, train_test_split
from repro_torch.kernels import _build, gss as gss_kernel, ops, ref

NO_PARTNER = ref.NO_PARTNER
ITERS = {"gss": tmm.gss_num_iters(tmm.EPS_STANDARD),
         "gss-precise": tmm.gss_num_iters(tmm.EPS_PRECISE)}


def _row(rng, s, neg=0.4):
    return ((np.abs(rng.standard_normal(s)) * 0.2 + 0.01)
            * np.where(rng.random(s) < neg, -1.0, 1.0)).astype(np.float32)


def _fixed(alpha, count):
    """The active min-|alpha| slot (first on ties) and its alpha, per row."""
    idx = torch.arange(alpha.shape[-1])
    i_min = torch.argmin(torch.where(idx < count[..., None], alpha.abs(), torch.inf), dim=-1)
    i_min = i_min.reshape(-1)
    return i_min, alpha.reshape(-1, alpha.shape[-1]).gather(1, i_min[:, None])[:, 0]


def _old_pick_binary(alpha, kappa, count, i_min, a_min, method):
    """``core.budget._merge_once_binary`` step 3 under gss before ``gss_pick``."""
    idx = torch.arange(alpha.shape[0])
    valid = (idx < count) & (alpha * a_min > 0) & (idx != i_min)
    wd, h = tbudget._scores(alpha, kappa, a_min, valid, method, None, impl="auto")
    j_star = torch.argmin(wd).reshape(1)
    return j_star, wd.index_select(0, j_star), h.index_select(0, j_star)


def _old_pick_rows(alpha, kappa, count, i_min, a_min, method):
    """``core.budget._merge_once`` step 3 under gss before ``gss_pick``."""
    ar, idx = torch.arange(alpha.shape[0]), torch.arange(alpha.shape[1])
    valid = (idx < count[:, None]) & (alpha * a_min[:, None] > 0) & (idx != i_min[:, None])
    wd, h = tbudget._scores(alpha, kappa, a_min, valid, method, None, impl="auto")
    j_star = torch.argmin(wd, dim=1)
    return j_star, wd[ar, j_star], h[ar, j_star]


def _pick_case(case, rng):
    """(alpha, kappa, count) of shape (R, s), (R, s), (R,) for one named case."""
    r, s = {"random": (1, 501), "rows": (10, 508), "ties": (3, 64), "all-invalid": (2, 40),
            "s=1": (1, 1)}[case]
    alpha = np.stack([_row(rng, s) for _ in range(r)])
    kappa = rng.random((r, s)).astype(np.float32)
    count = rng.integers(max(s // 2, 1), s + 1, r).astype(np.int32)
    if case == "ties":
        # slots 5 and 9 carry the same (alpha, kappa) and the least WD of
        # their row: the lower slot must win
        kappa *= 0.5
        for q in range(r):
            alpha[q] = np.abs(alpha[q]) + 0.3
            alpha[q, 2] = 0.05                     # the fixed partner
            alpha[q, [5, 9]] = 0.06
            kappa[q, [5, 9]] = 0.999
        count[:] = s
    if case == "all-invalid":
        alpha = -np.abs(alpha)
        alpha[:, 0] = 0.001                        # a lone positive fixed partner
    return torch.tensor(alpha), torch.tensor(kappa), torch.tensor(count)


@pytest.mark.parametrize("method", ["gss", "gss-precise"])
@pytest.mark.parametrize("case", ["random", "rows", "ties", "all-invalid", "s=1"])
def test_gss_pick_equals_the_old_sequence(case, method):
    alpha, kappa, count = _pick_case(case, np.random.default_rng(len(case)))
    i_min, a_min = _fixed(alpha, count)
    got = ops.gss_pick(alpha, kappa, count, i_min, a_min, n_iters=ITERS[method])
    want = _old_pick_rows(alpha, kappa, count, i_min, a_min, method)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    if alpha.shape[0] == 1:      # the binary form: one row without the row axis
        got_b = ops.gss_pick(alpha[0], kappa[0], count[0], i_min, a_min, n_iters=ITERS[method])
        for g, w in zip(got_b, _old_pick_binary(alpha[0], kappa[0], count[0], i_min, a_min,
                                                method)):
            assert g.shape == w.shape and torch.equal(g, w)
    j_star, wd_j, _ = got
    if case == "ties":
        assert (j_star == 5).all() and (wd_j < NO_PARTNER).all()
    if case in ("all-invalid", "s=1"):
        assert (j_star == 0).all() and (wd_j >= NO_PARTNER).all()


@pytest.mark.parametrize("method", ["gss", "gss-precise"])
def test_gss_pick_matches_the_reference_scores(method):
    """Against the reference's ``candidate_scores`` and argmin on the same
    kappa row: partner and merge-or-remove exactly, the WD within rtol 1e-4
    and atol 1e-6 (a WD near 0 is a difference of near-equal terms), h*
    within the runtime search's eps (``test_torch_merge``'s bounds)."""
    rng = np.random.default_rng(11)
    for trial in range(6):
        s, count = 40, 33 + trial
        alpha = _row(rng, s)
        alpha[count:] = 0.0
        kappa = rng.random(s).astype(np.float32)
        t_alpha, t_count = torch.tensor(alpha), torch.tensor(count, dtype=torch.int32)
        i_min, a_min = _fixed(t_alpha, t_count)
        idx = np.arange(s)
        valid = (idx < count) & (alpha * alpha[int(i_min)] > 0) & (idx != int(i_min))
        j_wd, j_h = jbudget.candidate_scores(jnp.asarray(alpha), jnp.asarray(kappa),
                                             jnp.int32(int(i_min)), jnp.asarray(valid), method,
                                             None)
        j_star = int(jnp.argmin(j_wd))
        got = ops.gss_pick(t_alpha, torch.tensor(kappa), t_count, i_min, a_min,
                           n_iters=ITERS[method])
        assert int(got[0][0]) == j_star
        assert bool(got[1][0] < NO_PARTNER) == bool(valid.any())
        if valid.any():
            np.testing.assert_allclose(float(got[1][0]), float(j_wd[j_star]), rtol=1e-4,
                                       atol=1e-6)
            assert abs(float(got[2][0]) - float(j_h[j_star])) <= tmm.EPS_STANDARD


@pytest.fixture(scope="module")
def moons():
    x, y = make_two_moons(np.random.default_rng(1), 500, noise=0.3)
    (xtr, ytr), _ = train_test_split(x, y)
    return xtr, ytr, np.random.default_rng(2).permutation(xtr.shape[0])


@pytest.mark.parametrize("method", ["gss", "gss-precise"])
def test_gss_epoch_through_gss_pick_matches_reference(method, moons, monkeypatch):
    """A short binary epoch (budget 8, gamma 0.5, 150 steps, 42 merges; on
    this data and permutation it meets no mirror-mode tie, unlike
    ``test_torch_bsgd``'s at gamma 2) chooses every partner through ``ops.gss_pick``
    and keeps the reference's integer state.  Floats within 2e-2, the bound
    ``test_torch_merge`` holds a GSS event's state to: the searches end where
    flat objectives let float32 exp's last bit steer them."""
    xtr, ytr, perm = moons
    steps = 150
    kw = dict(budget=8, lambda_=1e-3, gamma=0.5, method=method)
    calls = []
    orig = ops.gss_pick
    monkeypatch.setattr(ops, "gss_pick", lambda *a, **k: calls.append(1) or orig(*a, **k))
    tcfg, jcfg = tbsgd.BSGDConfig(**kw), jbsgd.BSGDConfig(**kw)
    ts = tbsgd.train_epoch(tcfg, tcfg.table(), tbsgd.init_state(tcfg, 2, device="cpu"), xtr,
                           ytr, perm[:steps], device="cpu")
    js = jbsgd.train_epoch(jcfg, jcfg.table(), jbsgd.init_state(jcfg, 2), jnp.asarray(xtr),
                           jnp.asarray(ytr), jnp.asarray(perm[:steps]), impl="ref")
    assert int(ts.n_merges) >= 40 and len(calls) == steps   # one pick a step (batch 1)
    assert_state_parity(js, jbsgd.SVMState(**convert.state_to_numpy(ts), kmat=None),
                        atol_float=2e-2, rtol=1e-3, context=method)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0, so that a wrapper's checks past
    the device check run here (the compiled library is never reached)."""

    def get_device(self):
        return 0


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def test_gss_pick_wrapper_refuses_what_its_kernel_does_not_take(monkeypatch):
    def touched(*_a, **_k):
        raise AssertionError("a wrapper reached the compiled library")

    monkeypatch.setattr(_build, "function", touched)
    monkeypatch.setattr(_build, "load", touched)
    f = lambda *shape: torch.zeros(*shape)
    args = [f(2, 8), f(2, 8), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int64), f(2)]
    card = [_card(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):          # CPU tensors
        gss_kernel.gss_pick_cuda(*args, 10)
    with pytest.raises(ValueError, match="CUDA"):          # one input left on the CPU
        gss_kernel.gss_pick_cuda(args[0], *card[1:], 10)
    for k, bad in ((1, card[1].double()), (2, card[3]), (3, card[2])):   # wrong dtypes
        wrong = list(card)
        wrong[k] = _card(bad)
        with pytest.raises(TypeError):
            gss_kernel.gss_pick_cuda(*wrong, 10)
    with pytest.raises(ValueError, match="pair"):          # mismatched shapes
        gss_kernel.gss_pick_cuda(card[0], card[1], _card(torch.zeros(3, dtype=torch.int32)),
                                 *card[3:], 10)
    with pytest.raises(ValueError, match="n_iters"):
        gss_kernel.gss_pick_cuda(*card, -1)


def test_gss_pick_counter_and_cpu_dispatch():
    assert "gss_pick" in ops.launch_counts()
    gss_kernel.pick_launches = 4
    assert ops.launch_counts()["gss_pick"] == 4
    ops.reset_launch_counts()
    alpha, kappa, count = _pick_case("rows", np.random.default_rng(0))
    i_min, a_min = _fixed(alpha, count)
    ops.gss_pick(alpha, kappa, count, i_min, a_min, n_iters=10)
    assert set(ops.launch_counts().values()) == {0}    # the CPU path launches nothing
    with pytest.raises(ValueError, match="CUDA"):
        ops.gss_pick(alpha, kappa, count, i_min, a_min, n_iters=10, impl="cuda")
