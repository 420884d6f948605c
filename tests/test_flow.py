"""Flow distance / indices / HAND pointer jumping vs oracle, including the
termination branches: river absorption, dead ends, border exits, cycles."""

import numpy as np
import pytest

from descriptools_jax import oracle
from descriptools_jax.constants import NODATA
from descriptools_jax.ops import flow_distance_index, flow_hand_index, hand_calculator
from descriptools_jax.utils.synthetic import synthetic_basin

PX = 12.5


@pytest.fixture(scope="module")
def basin():
    return synthetic_basin(80, 112, seed=7)


def test_flow_distance_index_matches_oracle(basin):
    dem, fdr, river, _ = basin
    got_d, got_i = flow_distance_index(fdr, river, PX)
    want_d, want_i = oracle.flow_distance_index_oracle(fdr, river, PX)
    np.testing.assert_array_equal(np.asarray(got_i), want_i)
    np.testing.assert_allclose(np.asarray(got_d), want_d, rtol=1e-4, atol=1e-2)


def test_hand_matches_oracle_and_is_integer_exact(basin):
    dem, fdr, river, _ = basin
    dem_i = dem.astype(np.int32)
    _, _, hand = flow_hand_index(dem_i, fdr, river, PX)
    _, indices = oracle.flow_distance_index_oracle(fdr, river, PX)
    want = oracle.hand_oracle(dem_i, indices)
    np.testing.assert_array_equal(np.asarray(hand), want)


def test_cycle_goes_nodata():
    # Two cells pointing at each other: E then W.
    fdr = np.zeros((3, 4), np.uint8)
    fdr[1, 1] = 1  # E -> (1,2)
    fdr[1, 2] = 16  # W -> (1,1)
    river = np.zeros((3, 4), np.int8)
    river[0, 0] = 1
    d, i = flow_distance_index(fdr, river, PX)
    assert np.asarray(d)[1, 1] == NODATA and np.asarray(i)[1, 2] == NODATA


def test_termination_branches():
    # Row of cells flowing east into a river cell; plus a border exit; plus a
    # dead end (fdr==0 target).
    fdr = np.zeros((3, 6), np.uint8)
    river = np.zeros((3, 6), np.int8)
    fdr[0, :5] = 1  # east
    fdr[0, 5] = 1  # east off-grid -> border exit
    river[0, 3] = 1
    d, i = flow_distance_index(fdr, river, PX)
    d, i = np.asarray(d), np.asarray(i)
    # cell (0,0): 3 steps east to the river at flat index 3
    assert i[0, 0] == 3 and abs(d[0, 0] - 3 * PX) < 1e-4
    # river cell itself: distance 0, own index (fdr != 0 there)
    assert d[0, 3] == 0 and i[0, 3] == 3
    # cell (0,4): flows into (0,5) whose fdr exits the grid -> nan... but
    # (0,4) -> (0,5): fdr[0,5]=1 points off-grid; walk from (0,4) arrives at
    # (0,5) (fdr!=0, not river), then border exit -> -100.
    assert d[0, 4] == NODATA and i[0, 4] == NODATA
    # fdr==0 start cells -> -100
    assert d[1, 0] == NODATA and i[1, 0] == NODATA
    # matches oracle everywhere
    wd, wi = oracle.flow_distance_index_oracle(fdr, river, PX)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(d, wd, rtol=1e-5, atol=1e-6)


def test_arrived_river_with_zero_fdr_is_nan():
    # Reference quirk: arriving at a river cell whose fdr==0 yields -100
    # (flowhand.py:826-828 fires before the river re-check).
    fdr = np.zeros((1, 3), np.uint8)
    fdr[0, 0] = 1
    river = np.zeros((1, 3), np.int8)
    river[0, 1] = 1  # river cell with fdr == 0
    d, i = flow_distance_index(fdr, river, PX)
    assert np.asarray(d)[0, 0] == NODATA
    wd, wi = oracle.flow_distance_index_oracle(fdr, river, PX)
    np.testing.assert_array_equal(np.asarray(i), wi)


def test_hand_clamps_negative_to_zero():
    dem = np.array([[10, 5, 3], [2, 8, 9]], np.int32)
    idx = np.array([[2, 2, 2], [NODATA, 2, 2]], np.int32)
    hand = np.asarray(hand_calculator(dem, idx))
    want = oracle.hand_oracle(dem, idx)
    np.testing.assert_array_equal(hand, want)
    assert hand[1, 0] == NODATA  # idx nodata
    assert (hand[hand != NODATA] >= 0).all()


def test_flow_indices_exact_above_2_24():
    """Flat river indices past the f32-exact range (2^24) must stay exact.

    17.8M-cell grid, all-south D8, rivers every 8th row except a 128-column
    corridor that drains 4000+ rows to the bottom river row — the corridor
    forces the compacted-doubling phase (its packed gathers carry indices as
    int32 bit patterns), and expected outputs are analytic.
    """
    rows, cols = 4104, 4352  # 17.86M cells > 2^24 = 16.78M
    fdr = np.full((rows, cols), 4, np.uint8)  # all south
    river = np.zeros((rows, cols), np.int8)
    river[7::8, :] = 1
    river[:, :128] = 0
    river[rows - 1, :] = 1

    d, i = flow_distance_index(fdr, river, PX)
    d, i = np.asarray(d), np.asarray(i)

    ii = np.arange(rows, dtype=np.int64)[:, None]
    jj = np.arange(cols, dtype=np.int64)[None, :]
    r = ii + (7 - ii % 8)  # nearest river row at/below (cols >= 128)
    r = np.where(jj < 128, rows - 1, r)  # corridor drains to the bottom row
    np.testing.assert_array_equal(i.astype(np.int64), r * cols + jj)
    np.testing.assert_allclose(d, (r - ii) * PX, rtol=1e-6, atol=1e-3)


def test_hybrid_equals_doubling(basin):
    dem, fdr, river, _ = basin
    d1, i1 = flow_distance_index(fdr, river, PX, method="hybrid")
    d2, i2 = flow_distance_index(fdr, river, PX, method="doubling")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-4, atol=1e-2)


# ---------------------------------------------------------------------------
# Long-path terrains, each engine against the float64 oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["hybrid", "doubling"])
def test_tall_lateral_channel(method):
    """~500-step paths: east along each row, then north up the last column
    to the river — walks far past the compaction budget."""
    rows, cols = 384, 128
    fdr = np.full((rows, cols), 1, np.uint8)  # east
    fdr[:, -1] = 64  # last column: north
    river = np.zeros((rows, cols), np.int8)
    river[0, -1] = 1
    d, i = flow_distance_index(fdr, river, PX, max_steps=1000, method=method)
    want_d, want_i, trunc = oracle.flow_distance_index_oracle_trunc(
        fdr, river, PX, max_steps=1000
    )
    assert not trunc.any()
    np.testing.assert_array_equal(np.asarray(i), want_i)
    np.testing.assert_allclose(np.asarray(d), want_d, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("method", ["hybrid", "doubling"])
def test_chain_longer_than_2pow15_steps(method):
    """One boustrophedon path of 40000 > 2^15 cardinal steps: every cell
    drains to the river at its end, at exactly (steps to go) * px."""
    rows = cols = 200
    fdr = np.zeros((rows, cols), np.uint8)
    fdr[0::2, :] = 1  # east on even rows
    fdr[1::2, :] = 16  # west on odd rows
    fdr[0::2, -1] = 4  # south at the east end of even rows
    fdr[1::2, 0] = 4  # south at the west end of odd rows
    river = np.zeros((rows, cols), np.int8)
    river[-1, 0] = 1
    d, i = flow_distance_index(fdr, river, PX, max_steps=60000, method=method)

    rr = np.arange(rows)[:, None]
    cc = np.arange(cols)[None, :]
    pos = rr * cols + np.where(rr % 2 == 0, cc, cols - 1 - cc)
    steps = rows * cols - 1 - pos
    assert steps.max() > (1 << 15)
    np.testing.assert_array_equal(np.asarray(i), (rows - 1) * cols)
    np.testing.assert_array_equal(np.asarray(d), (steps * PX).astype(np.float32))


def test_flow_oracle_twin_matches_loop_oracle(basin):
    _, fdr, river, _ = basin
    want_d, want_i = oracle.flow_distance_index_oracle(fdr, river, PX)
    got_d, got_i, trunc = oracle.flow_distance_index_oracle_trunc(
        fdr, river, PX
    )
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert trunc.dtype == bool


def test_flow_oracle_twin_flags_window_edge_walks(basin):
    """On a window of a larger grid, non-trunc cells match the full-grid
    oracle (indices translated to global coordinates)."""
    _, fdr, river, _ = basin
    want_d, want_i = oracle.flow_distance_index_oracle(fdr, river, PX)
    ys, ye, xs, xe = 20, 70, 30, 90
    got_d, got_i, trunc = oracle.flow_distance_index_oracle_trunc(
        fdr[ys:ye, xs:xe], river[ys:ye, xs:xe], PX
    )
    cols, wcols = fdr.shape[1], xe - xs
    glob = np.where(got_i == NODATA, NODATA,
                    (ys + got_i // wcols) * cols + xs + got_i % wcols)
    ok = ~trunc
    assert trunc.any() and ok.any()
    np.testing.assert_array_equal(glob[ok], want_i[ys:ye, xs:xe][ok])
    np.testing.assert_array_equal(got_d[ok], want_d[ys:ye, xs:xe][ok])
