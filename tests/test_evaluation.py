"""Evaluation suite (scale, binary map, confusion, calibration) vs oracle."""

import numpy as np
import pytest

from descriptools_jax import evaluation, oracle
from descriptools_jax.constants import NODATA


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    desc = rng.uniform(0, 300, size=(60, 90))
    desc[0:10, 0:10] = NODATA
    desc[0, 0] = NODATA
    flood = (rng.uniform(size=(60, 90)) < (1 - desc / 400)).astype(np.int8)
    flood[0:10, 0:10] = 0
    return desc, flood


def test_min_max_scale(data):
    desc, _ = data
    mn, mx = desc[desc != NODATA].min(), desc.max()
    got = np.asarray(evaluation.min_max_scale(desc, mn, mx))
    want = oracle.min_max_scale_oracle(desc, mn, mx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


def test_binary_and_confusion(data):
    desc, flood = data
    mn, mx = desc[desc != NODATA].min(), desc.max()
    scaled = oracle.min_max_scale_oracle(desc, mn, mx)
    for th in (0.2, 0.5, 0.77):
        got_map = np.asarray(evaluation.binary_map(scaled, th, "under"))
        want_map = oracle.binary_map_oracle(scaled, th, "under")
        np.testing.assert_array_equal(got_map, want_map)
        c, f, res = evaluation.confusion(got_map, flood)
        wc, wf, wres = oracle.confusion_oracle(want_map, flood)
        np.testing.assert_allclose(float(c), wc, rtol=1e-6)
        np.testing.assert_allclose(float(f), wf, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(res), wres)


def test_batch_fit_agrees_with_serial(data):
    desc, flood = data
    mn, mx = desc[desc != NODATA].min(), desc.max()
    scaled = oracle.min_max_scale_oracle(desc, mn, mx)
    ths = [0.1, 0.35, 0.5, 0.9]
    got = np.asarray(evaluation.batch_fit(scaled, flood, np.float32(ths)))
    for th, g in zip(ths, got):
        _, wf, _ = oracle.confusion_oracle(
            oracle.binary_map_oracle(scaled, th, "under"), flood
        )
        np.testing.assert_allclose(g, wf, rtol=1e-6)


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_calibration_matches_oracle(data, backend):
    desc, flood = data
    mn, mx = desc[desc != NODATA].min(), desc.max()
    scaled = oracle.min_max_scale_oracle(desc, mn, mx)
    want = oracle.calibration_oracle(scaled, flood, "under")
    got = evaluation.calibration(scaled, flood, "under", backend=backend)
    assert abs(got - want) < 1e-12


def test_benchmark_not_mutated(data):
    _, flood = data
    before = flood.copy()
    evaluation.confusion(np.zeros_like(flood, dtype=np.int32), flood)
    oracle.confusion_oracle(np.zeros_like(flood), flood)
    np.testing.assert_array_equal(flood, before)
