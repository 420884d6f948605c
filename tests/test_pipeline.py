"""End-to-end pipeline tests: synthetic basin + golden bundled basin.

The golden test reads the reference's committed hand_class.tif and requires
a *bitwise* match — the BASELINE.json config-1 target.  It runs on CPU and
takes ~1-2 minutes; mark slow-ish but keep it in the default run since it is
the single most important regression guard.
"""

import os

import numpy as np
import pytest

from descriptools_jax import oracle
from descriptools_jax.pipeline import (
    PipelineConfig,
    classify_flood,
    descriptor_suite,
    run_example,
)
from descriptools_jax.utils.synthetic import synthetic_basin

EXAMPLE = "/root/reference/Example"


def test_suite_on_synthetic_basin():
    dem, fdr, river, fac = synthetic_basin(64, 80, seed=31)
    import jax.numpy as jnp

    cfg = PipelineConfig()
    out = descriptor_suite(
        jnp.asarray(dem, jnp.int32), jnp.asarray(fdr),
        jnp.asarray(fac, jnp.int32), jnp.asarray(river), cfg,
    )
    want_d, want_i = oracle.flow_distance_index_oracle(fdr, river, cfg.px)
    np.testing.assert_array_equal(np.asarray(out["indices"]), want_i)
    np.testing.assert_array_equal(
        np.asarray(out["hand"]), oracle.hand_oracle(dem.astype(np.int32), want_i)
    )
    sl = oracle.slope_oracle(dem, cfg.px)
    np.testing.assert_allclose(np.asarray(out["slope"]), sl, rtol=2e-5, atol=1e-3)


def test_classify_flood_matches_oracle():
    rng = np.random.default_rng(0)
    hand = rng.integers(0, 60, size=(80, 100)).astype(np.int32)
    hand[:10, :10] = -100
    flood = (rng.uniform(size=hand.shape) < 0.3).astype(np.int8)
    th, c, f, cm = classify_flood(hand, flood)
    elements = np.unique(hand)
    desc = oracle.min_max_scale_oracle(hand, elements[1], elements[-1])
    want_th = oracle.calibration_oracle(desc, flood, "under")
    assert th == want_th


@pytest.mark.skipif(not os.path.isdir(EXAMPLE), reason="bundled basin missing")
def test_golden_bundled_basin_bitwise():
    from descriptools_jax.io import read_raster

    out = run_example(EXAMPLE)
    golden = read_raster(f"{EXAMPLE}/output/hand_class.tif")
    assert (out["class_map"] == golden).all(), "golden hand_class.tif mismatch"
    assert out["threshold"] == 0.012
