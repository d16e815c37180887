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
    assert ops.launch_counts() == {"rbf_matrix": 0, "merge_scores": 0, "gss": 0}
