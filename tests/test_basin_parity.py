"""Basin-scale float parity: the production engines must match the
committed float64-oracle snapshot of the bundled 2178x1534 basin
(tests/data/basin_float_snapshot.npz, generated by
scripts/make_basin_snapshot.py from descriptools_jax.oracle — the spec
transcribed from the reference's *_sequential_jit twins).

This turns README's "~1e-5 relative" claim into a test: every float
descriptor is checked at [::4, ::4] (~209k real-basin samples each), and
indices/HAND stay integer-exact.  fdist gets 2e-4: it is a serial f32 sum
of up to 20000 step lengths, where f64-vs-f32 drift is genuinely larger.
"""

import os

import numpy as np
import pytest

from descriptools_jax.io import load_example_inputs
from descriptools_jax.pipeline import PipelineConfig, descriptor_suite

EXAMPLE = "/root/reference/Example"
SNAP_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "basin_float_snapshot.npz"
)

# (rtol, atol) per descriptor.  atol absorbs relative blowup where the
# descriptor crosses zero (log outputs, flat downslope ratios).
TOLS = {
    "slope": (1e-5, 1e-4),
    "twi": (1e-5, 1e-4),
    "mod_twi": (1e-5, 1e-4),
    "gfi": (1e-5, 1e-4),
    "ln_hl_h": (1e-5, 1e-4),
    "downslope": (1e-5, 1e-5),
    "fdist": (2e-4, 1e-1),
}


@pytest.fixture(scope="module")
def snap():
    return np.load(SNAP_PATH)


@pytest.fixture(scope="module")
def suite():
    import jax.numpy as jnp

    if not os.path.isdir(EXAMPLE):
        pytest.skip("bundled basin missing")
    data = load_example_inputs(EXAMPLE)
    out = descriptor_suite(
        jnp.asarray(data["dem"], jnp.int32),
        jnp.asarray(data["fdr"]),
        jnp.asarray(data["fac"], jnp.int32),
        jnp.asarray(data["river"]),
        PipelineConfig(),
    )
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("key", sorted(TOLS))
def test_basin_float_parity(suite, snap, key):
    stride = int(snap["stride"])
    got = suite[key][::stride, ::stride].astype(np.float64)
    want = snap[key].astype(np.float64)
    nodata = want == -100.0
    np.testing.assert_array_equal(got[nodata], -100.0, err_msg=f"{key} NoData")
    valid = ~nodata
    np.testing.assert_array_equal(
        np.isnan(got[valid]), np.isnan(want[valid]), err_msg=f"{key} NaN set"
    )
    ok = valid & ~np.isnan(want)
    rtol, atol = TOLS[key]
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=key)


def test_basin_integer_parity(suite, snap):
    stride = int(snap["stride"])
    np.testing.assert_array_equal(
        suite["indices"][::stride, ::stride], snap["indices"]
    )
    np.testing.assert_array_equal(suite["hand"][::stride, ::stride], snap["hand"])
