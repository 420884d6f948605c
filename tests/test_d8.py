"""D8 decode / successor / flow-direction utilities."""

import numpy as np

from descriptools_jax import d8
from descriptools_jax.constants import D8_CODES, D8_DX, D8_DY, NODATA
from descriptools_jax.utils.synthetic import d8_from_dem, synthetic_dem


def test_decode_all_codes():
    fdr = np.array([[1, 2, 4, 8], [16, 32, 64, 128], [0, 3, 255, 7]], np.uint8)
    dy, dx, step, valid = d8.decode(fdr)
    dy, dx, step, valid = map(np.asarray, (dy, dx, step, valid))
    for k, code in enumerate(D8_CODES):
        pos = np.argwhere(fdr == code)[0]
        assert dy[tuple(pos)] == D8_DY[k] and dx[tuple(pos)] == D8_DX[k]
        assert valid[tuple(pos)]
    assert not valid[2].any()  # 0, 3, 255, 7 are invalid
    assert (step[2] == 0).all()


def test_successor_border_and_self():
    fdr = np.full((3, 3), 64, np.uint8)  # north everywhere
    succ, step, in_bounds, valid = d8.successor(fdr, 3, 3)
    succ = np.asarray(succ)
    # top row cells exit the grid -> succ = self
    assert (succ[0] == np.array([0, 1, 2])).all()
    assert not np.asarray(in_bounds)[0].any()
    # row 1 points to row 0
    assert (succ[1] == np.array([0, 1, 2])).all()


def test_d8_flow_direction_matches_numpy():
    dem = synthetic_dem(40, 56, seed=5)
    got = np.asarray(d8.d8_flow_direction(dem))
    want = d8_from_dem(dem)
    np.testing.assert_array_equal(got.astype(np.uint8), want)
    assert (got[dem == NODATA] == 0).all()
