"""Each kernel's plain PyTorch version against the JAX reference's ``ops`` (CPU).

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against these plain versions there.  Here the plain versions are held
against the JAX wrappers in both of the reference's CPU modes (its pure-jnp
oracle and its Pallas kernel in interpret mode), on inputs made with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core.lookup import default_table as jax_default_table
from repro.kernels import ops as jops
from repro_torch.core import merge_math as tmm
from repro_torch.kernels import ops, ref

JAX_IMPLS = ["ref", "pallas_interpret"]


@pytest.fixture(scope="module")
def wd_table():
    return jax_default_table().wd_table


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("n,m,d", [(1, 501, 123), (7, 33, 5), (40, 130, 123)])
@pytest.mark.parametrize("gamma", [2.0**-7, 1.0, 30.0])
def test_rbf_matrix_matches_reference(impl, n, m, d, gamma):
    rng = np.random.default_rng(n * 1000 + m)
    x = (0.3 * rng.standard_normal((n, d))).astype(np.float32)
    y = (0.3 * rng.standard_normal((m, d))).astype(np.float32)
    got = ops.rbf_matrix(torch.tensor(x), torch.tensor(y), gamma).numpy()
    want = np.asarray(jops.rbf_matrix(jnp.asarray(x), jnp.asarray(y), gamma, impl=impl))
    assert got.shape == (n, m) and got.dtype == np.float32
    # fp32 sums in another order; exp amplifies d^2 error by ~gamma (the
    # reference's own kernel test scales its tolerance the same way)
    tol = max(1e-6, 3e-6 * gamma)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("s,d", [(501, 123), (57, 9)])
def test_rbf_row_matches_reference(impl, s, d):
    rng = np.random.default_rng(s)
    sv = (0.3 * rng.standard_normal((s, d))).astype(np.float32)
    x = (0.3 * rng.standard_normal((d,))).astype(np.float32)
    got = ops.rbf_row(torch.tensor(sv), torch.tensor(x), 0.7).numpy()
    want = np.asarray(jops.rbf_row(jnp.asarray(sv), jnp.asarray(x), 0.7, impl=impl))
    # direct-difference form here; the reference's Pallas path is the
    # matmul form, so the two agree to fp32 round-off, not bitwise
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rbf_bf16_inputs_widen_to_fp32():
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((3, 17)), dtype=torch.bfloat16)
    y = torch.tensor(rng.standard_normal((11, 17)), dtype=torch.bfloat16)
    got = ops.rbf_matrix(x, y, 0.05)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.rbf_matrix(x.float(), y.float(), 0.05), rtol=0, atol=0)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("s", [16, 501])
def test_merge_scores_matches_reference(impl, s, wd_table):
    rng = np.random.default_rng(s)
    alpha = (np.abs(rng.standard_normal(s)) * 0.2 + 0.01).astype(np.float32)
    kappa = rng.random(s).astype(np.float32)
    valid = rng.random(s) < 0.8
    a_min = np.float32(0.05)
    twd, tint = ops.merge_scores(torch.tensor(alpha), torch.tensor(kappa), torch.tensor(valid),
                                 torch.tensor([a_min]), torch.tensor(np.asarray(wd_table)))
    jwd, jint = jops.merge_scores(jnp.asarray(alpha), jnp.asarray(kappa), jnp.asarray(valid),
                                  a_min, wd_table, impl=impl)
    jwd, jint = np.asarray(jwd), np.asarray(jint)
    # gather form here; the reference's Pallas path interpolates with a
    # hat-basis matmul, so its own test allows rtol 1e-4 against its oracle
    np.testing.assert_allclose(twd.numpy()[valid], jwd[valid], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tint.numpy(), jint, rtol=1e-4, atol=1e-6)
    assert int(torch.argmin(twd)) == int(np.argmin(jwd))
    assert (twd.numpy()[~valid] >= ref.NO_PARTNER).all()
    assert (jwd[~valid] >= ref.NO_PARTNER).all()


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("n_iters", [10, 48])
def test_gss_matches_reference(impl, n_iters):
    rng = np.random.default_rng(n_iters)
    m = rng.uniform(0.01, 0.99, (8, 512)).astype(np.float32)
    kappa = rng.uniform(0.15, 0.999, (8, 512)).astype(np.float32)
    got = ops.gss_solve(torch.tensor(m), torch.tensor(kappa), n_iters=n_iters)
    want = np.asarray(jops.gss_solve(jnp.asarray(m), jnp.asarray(kappa), n_iters=n_iters,
                                     impl=impl))
    # The bracket follows strict s(c) > s(d) comparisons, and PyTorch's and
    # XLA's float32 exp differ in the last bit, so where s is flat near its
    # maximum the two searches end in different (equally good) places.  The
    # objective they reach agrees to float32 round-off, and h to within the
    # runtime search's own precision (eps 1e-2).
    assert np.abs(got.numpy() - want).max() <= tmm.EPS_STANDARD
    tm, tk = torch.tensor(m), torch.tensor(kappa)
    s_got = tmm.s_objective(got, tm, tk)
    s_want = tmm.s_objective(torch.tensor(want), tm, tk)
    torch.testing.assert_close(s_got, s_want, rtol=0, atol=1e-6)


def test_golden_section_search_is_the_kernel_oracle():
    rng = np.random.default_rng(11)
    m = torch.tensor(rng.uniform(0.01, 0.99, 300), dtype=torch.float32)
    k = torch.tensor(rng.uniform(0.15, 0.999, 300), dtype=torch.float32)
    for eps in (tmm.EPS_STANDARD, tmm.EPS_PRECISE):
        torch.testing.assert_close(tmm.golden_section_search(m, k, eps),
                                   ref.gss(m, k, tmm.gss_num_iters(eps)), rtol=0, atol=0)


@pytest.mark.parametrize("op", ["rbf_matrix", "merge_scores", "gss_solve"])
def test_cuda_impl_on_cpu_tensors_raises(op):
    x = torch.zeros(4, 3)
    a = torch.zeros(4)
    calls = {
        "rbf_matrix": lambda: ops.rbf_matrix(x, x, 1.0, impl="cuda"),
        "merge_scores": lambda: ops.merge_scores(a, a, a > 0, a[:1], torch.zeros(5, 5),
                                                 impl="cuda"),
        "gss_solve": lambda: ops.gss_solve(a, a, n_iters=10, impl="cuda"),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[op]()
    with pytest.raises(ValueError, match="impl"):
        ops.rbf_matrix(x, x, 1.0, impl="pallas")


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.zeros(4, 3)
    ops.rbf_matrix(x, x, 1.0)
    ops.gss_solve(torch.rand(5), torch.rand(5), n_iters=10)
    ops.class_scores(x, torch.zeros(2, 5, 3), torch.ones(2, 5), 1.0)
    ops.bdca_ascent(torch.ones(4), torch.eye(4), torch.tensor(4, dtype=torch.int32), 1.0, 2)
    assert ops.launch_counts() == {"rbf_matrix": 0, "merge_scores": 0, "merge_pick": 0,
                                   "gss": 0, "gss_pick": 0, "multi_merge_scores": 0,
                                   "multi_merge_choose": 0,
                                   "merge_event": 0, "merge_event_rounds": 0, "train_step": 0,
                                   "class_scores": 0, "bdca_ascent": 0}


@pytest.fixture(scope="module")
def tables():
    from repro_torch.core.lookup import default_table as torch_default_table
    return jax_default_table(), torch_default_table()


def _multi_inputs(seed, c, p, s):
    rng = np.random.default_rng(seed)
    alpha = (np.abs(rng.standard_normal((c, s))) * 0.2 + 0.01).astype(np.float32)
    alpha *= np.where(rng.random((c, s)) < 0.3, -1.0, 1.0).astype(np.float32)
    kappa = rng.random((c, p, s)).astype(np.float32)
    valid = rng.random((c, p, s)) < 0.8
    a_min = alpha[:, :p] * 0.5
    return alpha, kappa, valid, a_min


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("c,p,s", [(1, 4, 33), (3, 4, 40), (2, 1, 129)])
def test_multi_merge_scores_matches_reference(impl, c, p, s, tables):
    jt, tt = tables
    alpha, kappa, valid, a_min = _multi_inputs(c * 100 + s, c, p, s)
    j = jnp.asarray
    t = torch.tensor
    # class-batched form
    jwd, jh = jops.multi_merge_scores(j(alpha), j(kappa), j(valid), j(a_min), jt, impl=impl)
    twd, th = ops.multi_merge_scores(t(alpha), t(kappa), t(valid), t(a_min), tt)
    assert twd.shape == th.shape == (c, p, s)
    jwd = np.asarray(jwd)
    # XLA may contract the products into multiply-adds, and the reference's
    # Pallas path interpolates with a hat-basis matmul: its own test allows
    # rtol 1e-4 against its oracle, as test_merge_scores_matches_reference does
    np.testing.assert_allclose(twd.numpy()[valid], jwd[valid], rtol=1e-4, atol=1e-7)
    assert (twd.numpy()[~valid] >= ref.NO_PARTNER).all() and (jwd[~valid] >= ref.NO_PARTNER).all()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(twd.numpy().argmin(-1), jwd.argmin(-1))
    # within the port the three layouts are the same arithmetic: bit for bit
    # flat form: P partners sharing one alpha, and the row-wise plain version
    fwd, fh = ops.multi_merge_scores(t(alpha[0]), t(kappa[0]), t(valid[0]), t(a_min[0]), tt)
    np.testing.assert_array_equal(fwd.numpy(), twd[0].numpy())
    np.testing.assert_array_equal(fh.numpy(), th[0].numpy())
    rwd, rh = ref.multi_merge_scores_rows(t(np.repeat(alpha[:1], p, 0)), t(kappa[0]),
                                          t(valid[0]), t(a_min[0]), tt.h_table, tt.wd_table)
    np.testing.assert_array_equal(rwd.numpy(), twd[0].numpy())
    np.testing.assert_array_equal(rh.numpy(), th[0].numpy())


def _event_inputs(seed, c, s, d, *, sv_dtype=np.float32, removal_class=None):
    """Over-budget stacked states with a consistent cache, mixed signs and
    ``over`` flags; ``removal_class`` gets one positive SV among negatives
    at its min-|alpha| slot, so its event must fall back to removal."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(seed)
    sv = (0.5 * rng.standard_normal((c, s, d))).astype(np.float32)
    if sv_dtype != np.float32:
        sv = np.asarray(jnp.asarray(sv, sv_dtype).astype(jnp.float32))   # bf16-representable
    count = rng.integers(s // 2, s, c).astype(np.int32)
    alpha = (np.abs(rng.standard_normal((c, s))) + 0.05).astype(np.float32)
    alpha *= np.where(rng.random((c, s)) < 0.4, -1.0, 1.0).astype(np.float32)
    if removal_class is not None:
        alpha[removal_class] = -np.abs(alpha[removal_class])
        alpha[removal_class, 2] = 0.01
    for q in range(c):
        alpha[q, count[q]:] = 0.0
    kmat = np.stack([np.asarray(jref.rbf_matrix(jnp.asarray(sv[q]), jnp.asarray(sv[q]), 0.5))
                     for q in range(c)]).astype(np.float32)
    kmat = np.where(np.eye(s, dtype=bool), 1.0, 0.5 * (kmat + kmat.transpose(0, 2, 1)))
    over = np.arange(c) % 3 != 1
    return sv, alpha, kmat.astype(np.float32), count, over


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("sv_dtype", ["float32", "bfloat16"])
def test_merge_event_matches_reference(impl, sv_dtype, tables):
    jt, tt = tables
    c, s, d = 4, 24, 6
    sv, alpha, kmat, count, over = _event_inputs(7, c, s, d, sv_dtype=getattr(jnp, sv_dtype),
                                                 removal_class=2)
    jsv, jal, jkm = jops.merge_event(jnp.asarray(sv, getattr(jnp, sv_dtype)), jnp.asarray(alpha),
                                     jnp.asarray(kmat), jnp.asarray(count), jnp.asarray(over),
                                     jt, impl=impl)
    tsv_in = torch.tensor(sv).to(getattr(torch, sv_dtype))
    ins = [tsv_in.clone(), torch.tensor(alpha), torch.tensor(kmat)]
    tsv, tal, tkm = ops.merge_event(*ins, torch.tensor(count), torch.tensor(over), tt)
    assert tsv is ins[0] and tal is ins[1] and tkm is ins[2]          # in place
    # classes not over budget come back bit for bit
    for q in np.nonzero(~over)[0]:
        assert torch.equal(tsv[q], tsv_in[q])
        np.testing.assert_array_equal(tal[q].numpy(), alpha[q])
        np.testing.assert_array_equal(tkm[q].numpy(), kmat[q])
    # exp/log of XLA and of PyTorch may differ in the last bit: 1e-6 on the
    # unit-scale cache and alpha; sv_x takes one rounding to its dtype more
    sv_tol = 1e-6 if sv_dtype == "float32" else 1e-2
    np.testing.assert_allclose(tsv.float().numpy(), np.asarray(jsv.astype(jnp.float32)),
                               atol=sv_tol, rtol=0)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tkm.numpy(), np.asarray(jkm), atol=1e-6, rtol=0)
    # decisions: the same slots written in every class (removal in class 2)
    changed_t = (tal.numpy() != alpha)
    changed_j = (np.asarray(jal) != alpha)
    np.testing.assert_array_equal(changed_t, changed_j)
    assert changed_t[2].sum() == 2                    # removal: i_min <- last, last <- 0
    km = tkm.numpy()
    for q in range(c):                                # I2, I3 exactly
        n = count[q] - over[q]
        np.testing.assert_array_equal(km[q, :n, :n], km[q, :n, :n].T)
        np.testing.assert_array_equal(np.diag(km[q, :n, :n]), np.ones(n, np.float32))


def test_merge_event_matches_merge_once_per_class(tables):
    """The fused event against the single-class cached merge, class by class:
    the same decisions and the same state, element by element."""
    from repro_torch.core import budget as tbudget
    _, tt = tables
    sv, alpha, kmat, count, over = _event_inputs(11, 5, 30, 7, removal_class=4)
    decisions = torch.full((5, 3), -1, dtype=torch.int32)
    sv_e, al_e, km_e = ops.merge_event(torch.tensor(sv), torch.tensor(alpha), torch.tensor(kmat),
                                       torch.tensor(count), torch.tensor(over), tt,
                                       decisions=decisions)
    assert (decisions[~torch.tensor(over)] == -1).all()       # only executing classes write
    for q in np.nonzero(over)[0]:
        sv1, al1, km1, c1, info = tbudget._merge_once(
            torch.tensor(sv[q:q + 1]), torch.tensor(alpha[q:q + 1]), torch.tensor(kmat[q:q + 1]),
            torch.tensor(count[q:q + 1]), 0.0, "lookup-wd", tt)
        assert int(c1[0]) == count[q] - 1
        assert bool(info.merged[0]) == (q != 4)
        assert decisions[q].tolist() == [int(info.i_min[0]), int(info.j_star[0]),
                                         int(info.merged[0])]
        np.testing.assert_array_equal(al_e[q].numpy(), al1[0].numpy())
        np.testing.assert_array_equal(sv_e[q].numpy(), sv1[0].numpy())
        np.testing.assert_array_equal(km_e[q].numpy(), km1[0].numpy())


def test_class_scores_folds_the_class_axis():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((9, 5)), dtype=torch.float32)
    sv = torch.tensor(rng.standard_normal((3, 11, 5)), dtype=torch.float32)
    al = torch.tensor(rng.standard_normal((3, 11)), dtype=torch.float32)
    got = ops.class_scores(x, sv, al, 0.3)
    want = np.asarray(jops.class_scores(jnp.asarray(x.numpy()), jnp.asarray(sv.numpy()),
                                        jnp.asarray(al.numpy()), 0.3, impl="ref"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, ref.class_scores(x, sv, al, 0.3), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["multi_merge_scores", "merge_event"])
def test_new_cuda_ops_on_cpu_tensors_raise(op, tables):
    _, tt = tables
    a = torch.zeros(2, 4)
    calls = {
        "multi_merge_scores": lambda: ops.multi_merge_scores(a[0], a, a > 0, a[:, 0], tt,
                                                             impl="cuda"),
        "merge_event": lambda: ops.merge_event(torch.zeros(2, 4, 3), a, torch.zeros(2, 4, 4),
                                               torch.zeros(2, dtype=torch.int32),
                                               torch.zeros(2, dtype=torch.bool), tt, impl="cuda"),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[op]()
