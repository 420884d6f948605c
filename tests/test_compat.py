"""The drop-in compatibility layer: a reference user's script runs unchanged.

Mirrors the flow of Example/example.py:18-147 against the compat API and
checks every stage against the oracles.
"""

import numpy as np

from descriptools_jax import compat, oracle
from descriptools_jax.constants import NODATA
from descriptools_jax.utils.synthetic import synthetic_basin

PX = 12.5


def test_reference_example_script_flow():
    dem, fdr, river, fac = synthetic_basin(60, 72, seed=41)
    dem = dem.astype(np.int16)
    fac = fac.astype(np.int64)

    # -- the reference example, line for line (Example/example.py:59-91) --
    sl = compat.sloper(dem, PX).astype("float32")
    sl = np.arctan(sl / 100).astype("float32")
    sl = np.where(dem == -100, -100, sl)
    TopoI, ModTi = compat.topographic_index(fac, sl, PX, 0.1)
    down = compat.downsloper(dem, fdr, PX, 5)
    flow, indices, hand = compat.flow_hand_index(dem, fdr, river, PX)
    geofi = compat.gfi_calculator(hand, fac, indices, 0.4, 0.1, PX)
    lnhlh = compat.ln_hl_H_calculator(hand, fac, 0.4, 0.1, PX)

    # -- calibration/validation (Example/example.py:106-147) --
    rng = np.random.default_rng(0)
    flood = (rng.uniform(size=dem.shape) < 0.25).astype("int8")
    elements, _ = np.unique(hand, return_counts=True)
    mx, mn = elements[-1], elements[1]
    desc = compat.minMaxScale(hand, mn, mx, -100)
    th = compat.calibration(desc, flood, "under")
    binary = compat.binary_map(desc, th, "under")
    c, f, class_map = compat.avaliacao(binary, flood)

    # -- oracles agree --
    want_d, want_i = oracle.flow_distance_index_oracle(fdr, river, PX)
    np.testing.assert_array_equal(indices, want_i)
    np.testing.assert_array_equal(hand, oracle.hand_oracle(dem, want_i))
    np.testing.assert_allclose(
        down, oracle.downslope_oracle(dem, fdr, PX, 5), rtol=1e-4, atol=1e-4
    )
    assert 0.0 <= th <= 1.0 and 0.0 <= f <= 1.0
    assert set(np.unique(class_map)) <= {0, 1, 2, 3}


def test_divisor_matches_reference_formula():
    br, bc = compat.divisor(2178, 1534, 2, 3)
    np.testing.assert_array_equal(br, [726, 1452])
    np.testing.assert_array_equal(bc, [383, 767, 1150])


def test_index_calculator():
    sub = np.array([[0, 3], [NODATA, 5]])
    out = compat.index_calculator(sub, 10, 20, 100)
    # local idx 0 -> (0+10)*100 + 0 + 20; idx 3 = (1,1) -> 11*100+21
    assert out[0, 0] == 1020 and out[0, 1] == 1121 and out[1, 0] == NODATA
