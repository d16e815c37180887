"""Precomputed merge tables with bilinear interpolation (the paper's contribution).

``h(m, kappa)`` and ``WD_norm(m, kappa)`` are solved once on a ``G x G``
grid over the unit square with float64 golden section search (eps 1e-10),
then read at run time by bilinear interpolation instead of a search per
candidate.  PyTorch counterpart of ``repro.core.lookup``; the build is the
same float64 numpy code, so both packages hold bit-identical tables, and
``save``/``load`` share the reference's ``.npz`` format.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import merge_math
from ..kernels.ref import bilinear_lookup

DEFAULT_GRID = 400  # paper: "in our experiments we use a grid of size 400x400"

__all__ = ["DEFAULT_GRID", "MergeLookupTable", "bilinear_lookup", "build_merge_tables",
           "default_table"]


def build_merge_tables(grid_size: int = DEFAULT_GRID, eps: float = merge_math.EPS_PRECISE):
    """``(h_table, wd_table)``, float32 tensors of shape (G, G) indexed
    ``[i_m, j_kappa]`` on ``linspace(0, 1, G)`` in both axes, solved in float64.

    The kappa = 1 column is analytic (h = m, no degradation) and so is the
    kappa = 0 column (removal of the smaller point: h in {0, 1},
    WD_norm = min(m, 1-m)^2)."""
    g = np.linspace(0.0, 1.0, grid_size)
    mm, kk = np.meshgrid(g, g, indexing="ij")
    h = merge_math.gss_numpy(mm, kk, eps=eps)
    kk_safe = np.clip(kk, merge_math.KAPPA_MIN, 1.0)
    s = mm * kk_safe ** ((1.0 - h) ** 2) + (1.0 - mm) * kk_safe ** (h**2)
    wd = mm**2 + (1.0 - mm) ** 2 + 2.0 * mm * (1.0 - mm) * kk - s**2
    h[:, -1] = g
    wd[:, -1] = 0.0
    h[:, 0] = np.where(g >= 0.5, 1.0, 0.0)
    wd[:, 0] = np.minimum(g, 1.0 - g) ** 2
    return (torch.from_numpy(h.astype(np.float32)),
            torch.from_numpy(wd.astype(np.float32)))


@dataclass
class MergeLookupTable:
    """Precomputed h / WD_norm tables (paper's Lookup-h / Lookup-WD)."""

    h_table: torch.Tensor
    wd_table: torch.Tensor

    @classmethod
    def create(cls, grid_size: int = DEFAULT_GRID, eps: float = merge_math.EPS_PRECISE,
               dtype=torch.float32) -> "MergeLookupTable":
        h, wd = build_merge_tables(grid_size=grid_size, eps=eps)
        return cls(h_table=h.to(dtype), wd_table=wd.to(dtype))

    def to(self, device) -> "MergeLookupTable":
        return MergeLookupTable(self.h_table.to(device), self.wd_table.to(device))

    def lookup_h(self, m, kappa):
        return bilinear_lookup(self.h_table, m, kappa)

    def lookup_wd_norm(self, m, kappa):
        return bilinear_lookup(self.wd_table, m, kappa)

    def lookup_wd(self, alpha_a, alpha_b, m, kappa):
        """Denormalized weight degradation (alpha_a + alpha_b)^2 * WD_norm."""
        s = alpha_a + alpha_b
        return s * s * self.lookup_wd_norm(m, kappa)

    def save(self, path: str) -> None:
        tmp = path + ".tmp.npz"  # .npz suffix stops np.savez appending another
        np.savez(tmp, h_table=self.h_table.cpu().numpy(), wd_table=self.wd_table.cpu().numpy())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "MergeLookupTable":
        with np.load(path) as z:
            return cls(h_table=torch.from_numpy(z["h_table"]),
                       wd_table=torch.from_numpy(z["wd_table"]))


_TABLE_CACHE: dict[tuple, MergeLookupTable] = {}


def default_table(grid_size: int = DEFAULT_GRID, eps: float = merge_math.EPS_PRECISE,
                  dtype=torch.float32) -> MergeLookupTable:
    """Process-wide cached tables on the CPU, keyed by every build parameter."""
    key = (int(grid_size), float(eps), str(dtype))
    table = _TABLE_CACHE.get(key)
    if table is None:
        table = _TABLE_CACHE[key] = MergeLookupTable.create(grid_size=grid_size, eps=eps,
                                                            dtype=dtype)
    return table
