"""Downslope binary-descent vs oracle, incl. threshold/terminal/cap stops."""

import numpy as np
import pytest

from descriptools_jax import oracle
from descriptools_jax.constants import NODATA
from descriptools_jax.ops import downslope
from descriptools_jax.utils.synthetic import synthetic_basin

PX = 12.5


@pytest.fixture(scope="module")
def basin():
    return synthetic_basin(72, 96, seed=11)


@pytest.mark.parametrize("ed", [5.0, 1.0, 50.0])
def test_downslope_matches_oracle(basin, ed):
    dem, fdr, _, _ = basin
    got = np.asarray(downslope(dem, fdr, PX, ed))
    want = oracle.downslope_oracle(dem, fdr, PX, ed)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_downslope_cap_semantics():
    # A long flat-ish eastward channel that never drops 5 m within the cap:
    # the result must be the partial gradient after exactly max_steps steps.
    cols = 40
    dem = np.tile(np.linspace(100.0, 99.0, cols), (3, 1))
    dem = np.round(dem * 100) / 100
    fdr = np.full((3, cols), 1, np.uint8)  # east everywhere (border exit at end)
    got = np.asarray(downslope(dem, fdr, PX, 5.0, max_steps=8))
    want = oracle.downslope_oracle(dem, fdr, PX, 5.0, max_steps=8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_downslope_terminal_and_nodata():
    dem = np.array(
        [
            [50.0, 40.0, NODATA],
            [60.0, 45.0, 30.0],
        ]
    )
    fdr = np.array([[1, 1, 0], [1, 2, 64]], np.uint8)
    got = np.asarray(downslope(dem, fdr, PX, 5.0))
    want = oracle.downslope_oracle(dem, fdr, PX, 5.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[0, 2] == NODATA  # nodata cell masked
    # (0,0): drop to (0,1) is 10 >= 5 -> stops after 1 step
    np.testing.assert_allclose(got[0, 0], 10.0 / PX, rtol=1e-5)
    # (0,1): next target is NoData -> terminal at itself? No: walk stops at
    # (0,1)=start... threshold not reached, step target (0,2) is NoData ->
    # stop at start with dist 0 -> result 0.
    assert got[0, 1] == 0.0


@pytest.mark.parametrize("ed", [5.0, 1.0])
def test_jacobi_equals_descent(basin, ed):
    dem, fdr, _, _ = basin
    a = np.asarray(downslope(dem, fdr, PX, ed, method="jacobi"))
    b = np.asarray(downslope(dem, fdr, PX, ed, method="descent"))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Long-walk terrains, each engine against the float64 oracle
# ---------------------------------------------------------------------------


def _tall_north_basin(rows, cols, bump_every=None):
    """Northward walks ~100 cells long; optional ascending bumps make the
    descent non-monotone along every path."""
    dem = np.broadcast_to(
        np.round(np.arange(rows, dtype=np.float64) * 0.5 + 100.0)[:, None]
        .astype(np.float32),
        (rows, cols),
    ).copy()
    if bump_every:
        dem[::bump_every, :] += 3.0  # step from the row below ASCENDS
    fdr = np.full((rows, cols), 64, np.uint8)  # all north
    return dem, fdr


@pytest.mark.parametrize("method", ["jacobi", "descent"])
@pytest.mark.parametrize("bump_every", [None, 37])
def test_tall_multiband(bump_every, method):
    dem, fdr = _tall_north_basin(320, 128, bump_every)
    got = np.asarray(downslope(dem, fdr, PX, 50.0, max_steps=600,
                               method=method))
    want, _ = oracle.downslope_oracle_trunc(dem, fdr, PX, 50.0, max_steps=600)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["jacobi", "descent"])
def test_uphill_walks(method):
    """fdr points uphill (z rises eastward): every walk runs to the cap or
    the border without reaching the threshold."""
    rows, cols = 32, 128
    dem = np.broadcast_to(
        (100.0 + 0.5 * np.arange(cols)).astype(np.float32), (rows, cols)
    ).copy()
    fdr = np.full((rows, cols), 1, np.uint8)  # east, uphill
    got = np.asarray(downslope(dem, fdr, PX, 5.0, max_steps=200,
                               method=method))
    want, _ = oracle.downslope_oracle_trunc(dem, fdr, PX, 5.0, max_steps=200)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bump", [None, 40])
def test_trunc_tracking_matches_oracle(bump):
    """The jacobi engine's truncation flags (the sharded/tiled retry signal)
    equal the oracle's on a block cut from a wider grid whose east edge
    truncates the walks that need more than the block to drop 5 m."""
    import jax.numpy as jnp

    from descriptools_jax.ops.downslope import _downslope_jacobi, trunc_cells

    rows, cols = 64, 128
    dem = np.broadcast_to(
        (1000 - np.arange(cols) // 20).astype(np.float32), (rows, cols)
    ).copy()  # 1 m drop every 20 cells: 5 m takes ~100 steps
    if bump:
        dem[:, bump] += 3.0
    fdr = np.full((rows, cols), 1, np.uint8)  # gentle eastward flat walk
    d, f = jnp.asarray(dem), jnp.asarray(fdr)
    tr0 = trunc_cells(d, f, 0, 0, rows, 4 * cols)
    assert int(tr0.sum()) == rows
    got, gtr = _downslope_jacobi(d, f, PX, 5.0, 5000, trunc0=tr0)
    want, wtr = oracle.downslope_oracle_trunc(dem, fdr, PX, 5.0)
    np.testing.assert_array_equal(np.asarray(gtr), wtr)
    assert wtr.any() and not wtr.all()
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)


def test_trunc_tracking_on_basin_window():
    """Real-terrain window of a larger grid: result and truncation flags
    against the oracle on the same window."""
    import jax.numpy as jnp

    from descriptools_jax.ops.downslope import _downslope_jacobi, trunc_cells

    dem, fdr, _, _ = synthetic_basin(90, 120, seed=3)
    d, f = dem[10:74, 20:116], fdr[10:74, 20:116]
    tr0 = trunc_cells(jnp.asarray(d, jnp.float32), jnp.asarray(f),
                      10, 20, 90, 120)
    got, gtr = _downslope_jacobi(jnp.asarray(d, jnp.float32), jnp.asarray(f),
                                 PX, 5.0, 200, trunc0=tr0)
    want, wtr = oracle.downslope_oracle_trunc(d, f, PX, 5.0, max_steps=200)
    gtr = np.asarray(gtr)
    # Every walk the oracle sees leave the block is flagged.  The engine
    # also flags walks whose threshold stop falls ON a block-edge cell (its
    # terminal offset wins the compare), which only costs a retry.
    assert wtr.any() and not (wtr & ~gtr).any()
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_bench_terrain_is_monotone_descent():
    """The synthetic generator's D8 is strictly downhill, so walks descend
    monotonically on the benchmark terrain."""
    import jax.numpy as jnp

    from descriptools_jax.d8 import pull8
    from descriptools_jax.ops.downslope import _terminal_and_step

    dem, fdr, _, _ = synthetic_basin(128, 160, seed=0)
    z, terminal, _ = _terminal_and_step(dem.astype(np.float32), fdr, PX, -100)
    fdr_eff = jnp.where(terminal, 0, jnp.asarray(fdr)).astype(jnp.int32)
    (z_succ,) = pull8(fdr_eff, [z], [0.0])
    assert not bool(np.asarray(z_succ > z).any())
