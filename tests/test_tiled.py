"""Out-of-core tiled execution vs the in-core ops."""

import numpy as np

from descriptools_jax import oracle
from descriptools_jax.ops import slope
from descriptools_jax.ops.slope import slope_from_padded
from descriptools_jax.constants import NODATA
from descriptools_jax.tiled import tile_map, tiled_flow_hand
from descriptools_jax.utils.synthetic import synthetic_basin

PX = 12.5


def test_tile_map_slope_matches_incore():
    dem, _, _, _ = synthetic_basin(70, 90, seed=51)

    def fn(tile):
        import jax.numpy as jnp

        # tile arrives with a 1-cell halo; treat it as the padded block
        return slope_from_padded(jnp.asarray(tile, jnp.float32), PX)

    got = tile_map(fn, [dem.astype(np.float32)], [NODATA], 32, 48, halo=1)
    want = np.asarray(slope(dem, PX))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_tiled_flow_hand_bitwise_vs_oracle():
    dem, fdr, river, fac = synthetic_basin(75, 83, seed=52)
    dem = dem.astype(np.int32)
    fac = fac.astype(np.int32)
    fdist, indices, hand, river_fac = tiled_flow_hand(
        dem, fdr, river, fac, PX, tile_rows=32, tile_cols=28
    )
    want_d, want_i = oracle.flow_distance_index_oracle(fdr, river, PX)
    np.testing.assert_array_equal(indices, want_i)
    np.testing.assert_array_equal(hand, oracle.hand_oracle(dem, want_i))
    np.testing.assert_allclose(fdist, want_d, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(
        river_fac, oracle.river_accumulation_oracle(fac, want_i), rtol=1e-6
    )
