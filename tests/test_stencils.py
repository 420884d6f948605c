"""Slope / TWI / GFI / ln(hl/H) kernels vs the NumPy oracles."""

import numpy as np
import pytest

from descriptools_jax import oracle
from descriptools_jax.constants import NODATA
from descriptools_jax.ops import (
    gfi_calculator,
    ln_hl_h,
    modified_topographic_index,
    slope,
    topographic_index,
)
from descriptools_jax.utils.synthetic import synthetic_basin, synthetic_dem

PX = 12.5


@pytest.fixture(scope="module")
def basin():
    return synthetic_basin(96, 130, seed=3)


def test_slope_matches_oracle(basin):
    dem, _, _, _ = basin
    got = np.asarray(slope(dem, PX))
    want = oracle.slope_oracle(dem, PX)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_slope_nodata_and_border():
    dem = synthetic_dem(17, 23, seed=9)
    got = np.asarray(slope(dem, PX))
    want = oracle.slope_oracle(dem, PX)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    assert (got[dem == NODATA] == NODATA).all()
    # Border cells get real values from available in-bounds neighbours.
    assert got[0, -1] != NODATA


def test_slope_all_uphill_is_zero():
    dem = np.full((8, 8), 100.0)
    dem[4, 4] = 50.0  # pit: all neighbours higher -> slope 0
    got = np.asarray(slope(dem, PX))
    assert got[4, 4] == 0.0


def test_topographic_index_matches_oracle(basin):
    dem, _, _, fac = basin
    sl = oracle.slope_oracle(dem, PX)
    sl_rad = np.where(dem == NODATA, NODATA, np.arctan(sl / 100))
    got = np.asarray(topographic_index(fac, sl_rad, PX))
    want = oracle.topographic_index_oracle(fac, sl_rad, PX)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_modified_topographic_index_matches_oracle(basin):
    dem, _, _, fac = basin
    sl = oracle.slope_oracle(dem, PX)
    sl_rad = np.where(dem == NODATA, NODATA, np.arctan(sl / 100))
    got = np.asarray(modified_topographic_index(fac, sl_rad, PX, 0.1))
    want = oracle.modified_topographic_index_oracle(fac, sl_rad, PX, 0.1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_gfi_and_lnhlh_match_oracle(basin):
    dem, fdr, river, fac = basin
    fdist, indices = oracle.flow_distance_index_oracle(fdr, river, PX)
    hand = oracle.hand_oracle(dem.astype(np.int32), indices)
    rfac = oracle.river_accumulation_oracle(fac, indices)

    got = np.asarray(gfi_calculator(hand, fac, indices, 0.4, 0.1, PX))
    want = oracle.gfi_oracle(hand, rfac, 0.4, 0.1, PX)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)

    got2 = np.asarray(ln_hl_h(hand, fac, 0.4, 0.1, PX))
    want2 = oracle.ln_hl_h_oracle(hand, fac, 0.4, 0.1, PX)
    np.testing.assert_allclose(got2, want2, rtol=2e-5, atol=1e-4)
