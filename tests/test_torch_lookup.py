"""The port's merge tables and bilinear lookup against the JAX reference (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_thread  # noqa: F401 (autouse fixture)

from repro.core import lookup as jlookup
from repro.core import merge_math as jmm
from repro_torch.core import lookup as tlookup
from repro_torch.core import merge_math as tmm
from repro_torch.convert import table_from_numpy


@pytest.fixture(scope="module")
def tables():
    return tlookup.build_merge_tables(400), jlookup.build_merge_tables(400)


def test_build_merge_tables_bit_identical(tables):
    (th, twd), (jh, jwd) = tables
    assert th.dtype == torch.float32 and th.shape == (400, 400)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(twd.numpy(), np.asarray(jwd))


@pytest.mark.parametrize("eps", [1e-2, 1e-10])
def test_gss_numpy_and_iteration_count_match(eps):
    rng = np.random.default_rng(3)
    m, k = rng.random(257), rng.random(257)
    assert tmm.gss_num_iters(eps) == jmm.gss_num_iters(eps)
    np.testing.assert_array_equal(tmm.gss_numpy(m, k, eps), jmm.gss_numpy(m, k, eps))


@pytest.mark.parametrize("which", [0, 1])
def test_bilinear_lookup_random_points_and_edges(tables, which):
    (t_tabs, j_tabs) = tables
    rng = np.random.default_rng(4)
    u = rng.random(2000).astype(np.float32)
    v = rng.random(2000).astype(np.float32)
    # corners, edges, exact grid nodes and out-of-square points (clipped)
    edge_u = np.array([0, 1, 0, 1, 0.5, 1, 0, 398 / 399, 1 / 399, -0.2, 1.3], np.float32)
    edge_v = np.array([0, 0, 1, 1, 1, 0.5, 0.25, 1, 2 / 399, 0.5, -1.0], np.float32)
    u, v = np.concatenate([u, edge_u]), np.concatenate([v, edge_v])
    got = tlookup.bilinear_lookup(t_tabs[which], torch.tensor(u), torch.tensor(v)).numpy()
    want = np.asarray(jlookup.bilinear_lookup(j_tabs[which], jnp.asarray(u), jnp.asarray(v)))
    # the same float32 operations in the same order: equal to the last bit
    np.testing.assert_array_equal(got, want)


def test_table_save_load_interchange(tmp_path, tables):
    (th, twd), _ = tables
    port = tlookup.MergeLookupTable(th, twd)
    port.save(str(tmp_path / "port.npz"))
    jt = jlookup.MergeLookupTable.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(jt.wd_table), twd.numpy())
    jt.save(str(tmp_path / "jax.npz"))
    back = tlookup.MergeLookupTable.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(back.h_table.numpy(), th.numpy())
    conv = table_from_numpy(np.asarray(jt.h_table), np.asarray(jt.wd_table))
    np.testing.assert_array_equal(conv.wd_table.numpy(), twd.numpy())


def test_default_table_cached_per_build_parameters():
    a = tlookup.default_table(64)
    assert tlookup.default_table(64) is a
    b = tlookup.default_table(64, eps=1e-3)
    assert b is not a and not torch.equal(a.h_table, b.h_table)
    assert tlookup.default_table(64, dtype=torch.float64).h_table.dtype == torch.float64


def test_table_lookups_match_reference_methods(tables):
    (th, twd), (jh, jwd) = tables
    rng = np.random.default_rng(5)
    m, k = rng.random(300).astype(np.float32), rng.random(300).astype(np.float32)
    aa, ab = rng.random(300).astype(np.float32), rng.random(300).astype(np.float32)
    tt, jt = tlookup.MergeLookupTable(th, twd), jlookup.MergeLookupTable(jh, jwd)
    tm, tk = torch.tensor(m), torch.tensor(k)
    np.testing.assert_array_equal(tt.lookup_h(tm, tk).numpy(), np.asarray(jt.lookup_h(m, k)))
    # (a + b)^2 * interp: one product may be contracted differently; 1 ulp
    np.testing.assert_allclose(tt.lookup_wd(torch.tensor(aa), torch.tensor(ab), tm, tk).numpy(),
                               np.asarray(jt.lookup_wd(aa, ab, m, k)), rtol=2.4e-7, atol=0)
