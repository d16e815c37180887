"""The port's public core API against the reference's (CPU).

``repro_torch.core`` exports every name of ``repro.core.__all__`` (the
exclusions, none today, would be listed with their reason), and the merge
math and table residue (``solve_merge``, ``KAPPA_UNIMODAL``,
``brute_force_h``, ``s_second_derivative_at_half``, ``build_lookup_table``)
matches the reference on the cases of ``tests/core/test_merge_math.py`` and
``tests/core/test_lookup.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import lookup as jlookup
from repro.core import merge_math as jmm
from repro_torch.core import lookup as tlookup
from repro_torch.core import merge_math as tmm

# names of repro.core.__all__ the port leaves out on purpose: {name: reason}
EXCLUDED: dict[str, str] = {}
GRID_POINTS = [(m, k) for m in (0.01, 0.2, 0.45, 0.5, 0.55, 0.8, 0.99)
               for k in (0.01, 0.1, float(np.exp(-2)), 0.2, 0.5, 0.9, 0.999)]


def s_np(h, m, k):
    k = max(k, 1e-30)
    return m * k ** ((1.0 - h) ** 2) + (1.0 - m) * k ** (h**2)


def test_core_exports_every_reference_name():
    missing = set(jcore.__all__) - set(tcore.__all__)
    assert missing == set(EXCLUDED), sorted(missing - set(EXCLUDED))
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
    for sub in ("budget", "kernel_cache", "merge_math"):
        assert getattr(tcore, sub).__name__ == f"repro_torch.core.{sub}"
    assert callable(tcore.predict) and tcore.bilinear_lookup is tlookup.bilinear_lookup


def test_constants_match():
    for name in ("KAPPA_UNIMODAL", "KAPPA_MIN", "EPS_STANDARD", "EPS_PRECISE", "INVPHI"):
        assert getattr(tmm, name) == getattr(jmm, name), name
    assert tmm.gss_num_iters(1e-2) == jmm.gss_num_iters(1e-2) == 10
    assert tmm.gss_num_iters(1e-10) == jmm.gss_num_iters(1e-10) == 48


@pytest.mark.parametrize("m,k", GRID_POINTS)
def test_brute_force_and_solve_merge_match_the_reference(m, k):
    """The dense-grid oracle is the reference's bit for bit; ``solve_merge``'s
    h reaches its maximum (argmax may differ on Lemma 1's tie set), and its
    WD_norm is the reference's within float32 round-off."""
    h_bf = tmm.brute_force_h(m, k, n_grid=100_001)
    assert h_bf == jmm.brute_force_h(m, k, n_grid=100_001)
    h, wd = tmm.solve_merge(torch.tensor(m, dtype=torch.float32),
                            torch.tensor(k, dtype=torch.float32), eps=1e-10)
    jh, jwd = jmm.solve_merge(jnp.float32(m), jnp.float32(k), eps=1e-10)
    assert s_np(float(h), m, k) >= s_np(h_bf, m, k) - 1e-5
    np.testing.assert_allclose(float(wd), float(jwd), rtol=0, atol=2e-6)
    assert abs(s_np(float(h), m, k) - s_np(float(jh), m, k)) <= 2e-6


def test_solve_merge_broadcasts_at_the_runtime_precision():
    rng = np.random.default_rng(0)
    m, k = rng.uniform(0, 1, (2, 64)).astype(np.float32)
    h, wd = tmm.solve_merge(torch.tensor(m), torch.tensor(k))
    jh, jwd = jmm.solve_merge(jnp.asarray(m), jnp.asarray(k))
    assert h.shape == wd.shape == (64,) and h.dtype == torch.float32
    np.testing.assert_allclose(wd.numpy(), np.asarray(jwd), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(wd.numpy(), tmm.wd_norm_at(h, torch.tensor(m),
                                                             torch.tensor(k)).numpy())


@pytest.mark.parametrize("k", [0.05, 0.10, 0.13, 0.14, 0.3, 0.9, 1e-40, 1.0])
def test_s_second_derivative_at_half_matches_the_reference(k):
    """Lemma 1: positive (two modes) iff kappa < e^-2, the reference's value."""
    got = float(tmm.s_second_derivative_at_half(k))
    np.testing.assert_allclose(got, float(jmm.s_second_derivative_at_half(jnp.float32(k))),
                               rtol=1e-6, atol=1e-12)
    if 1e-30 < k < 1.0:
        assert (got > 0) == (k < tmm.KAPPA_UNIMODAL)


@pytest.mark.parametrize("grid", [5, 11, 64])
def test_build_lookup_table_matches_the_reference(grid):
    f = lambda u, v: 2.0 * u - 3.0 * v + 0.5 * u * v          # noqa: E731
    got = tlookup.build_lookup_table(f, grid_size=grid)
    want = np.asarray(jlookup.build_lookup_table(f, grid_size=grid))
    assert got.shape == (grid, grid) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_bilinear_lookup_of_a_built_table():
    """Exact at the grid nodes; a linear function interpolates exactly."""
    g = torch.linspace(0, 1, 5)
    tbl = torch.arange(25.0).reshape(5, 5)
    for i in range(5):
        for j in range(5):
            assert float(tcore.bilinear_lookup(tbl, g[i], g[j])) == float(tbl[i, j])
    f = lambda u, v: 2.0 * u - 3.0 * v + 0.5                   # noqa: E731
    tbl = tcore.build_lookup_table(f, grid_size=11)
    u, v = np.random.default_rng(0).uniform(0, 1, (2, 100)).astype(np.float32)
    got = tcore.bilinear_lookup(tbl, torch.tensor(u), torch.tensor(v))
    np.testing.assert_allclose(got.numpy(), f(u, v), rtol=2e-5, atol=2e-5)


def test_build_lookup_table_of_the_merge_problem_is_the_wd_table():
    """Tabulating WD_norm at the float64 GSS optimum reproduces
    ``build_merge_tables``' interior cells (both ends of kappa are analytic)."""
    def wd(mm, kk):
        h = tmm.gss_numpy(mm.double().numpy(), kk.double().numpy())
        kk_safe = np.clip(kk.double().numpy(), tmm.KAPPA_MIN, 1.0)
        s = mm.double().numpy() * kk_safe ** ((1 - h) ** 2) + (1 - mm.double().numpy()) * \
            kk_safe ** (h**2)
        m, k = mm.double().numpy(), kk.double().numpy()
        return torch.from_numpy((m**2 + (1 - m) ** 2 + 2 * m * (1 - m) * k - s**2)
                                .astype(np.float32))
    got = tcore.build_lookup_table(wd, grid_size=21)
    _, want = tcore.build_merge_tables(grid_size=21)
    np.testing.assert_allclose(got[:, 1:-1].numpy(), want[:, 1:-1].numpy(), rtol=0, atol=1e-6)
