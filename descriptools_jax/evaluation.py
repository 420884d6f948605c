"""Flood-map linear binary classifier: scaling, thresholding, Fit/Correctness,
and coarse-to-fine threshold calibration.

Recast of reference evaluation.py.  The reference's calibration is a serial
host loop of ~30 full-raster ``np.where`` + ``np.unique`` passes
(evaluation.py:12-87); here each search stage evaluates its whole threshold
batch in one fused, vmapped confusion pass (a histogram per threshold), and
only the tiny selection logic stays sequential.

Two backends:
  - ``jax``: fused on-device batch confusion (float32) — the fast path.
  - ``numpy``: float64, bit-identical to the reference arithmetic — used for
    golden-parity tests and exact threshold selection on integer descriptors.

The search-stage structure and comparison strictness (>= in the first
refinement, > afterwards) replicate evaluation.py:32-87 exactly; with equal
Fit values the two backends select identical thresholds, and the numpy
backend is exact by construction.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from descriptools_jax import oracle
from descriptools_jax.constants import NODATA


def min_max_scale(mat, mn, mx, nodata=NODATA):
    """Normalise to [0,1]; nodata -> NaN.  Spec: evaluation.py:5-9."""
    mat = jnp.asarray(mat, jnp.float32)
    scaled = jnp.where(mat == nodata, jnp.nan, mat)
    return (scaled - mn) / (mx - mn)


def binary_map(desc, threshold, under="under"):
    """Threshold a (scaled) descriptor into {0,1}.  Spec: evaluation.py:90-123.

    Cells equal to desc[0,0] (the reference's implicit NoData probe) and NaN
    cells classify as 0.
    """
    desc = jnp.asarray(desc)
    masked = jnp.where(desc == desc[0, 0], jnp.nan, desc)
    if under == "under":
        hit = masked <= threshold
    else:
        hit = masked >= threshold
    return jnp.where(jnp.isnan(masked), 0, jnp.where(hit, 1, 0)).astype(jnp.int32)


def _normalise_benchmark(bench):
    bench = jnp.asarray(bench, jnp.int32)
    out = jnp.where(bench == 1, 2, bench)
    return jnp.where(out == NODATA, 0, out)


def confusion(pred_binary, bench):
    """(correctness, fit, result map).  Spec: evaluation.py:126-171."""
    result = jnp.asarray(pred_binary, jnp.int32) + _normalise_benchmark(bench)
    count = jnp.bincount(result.reshape(-1), length=4)
    return correctness(count), fit(count), result


def correctness(count):
    """TP/(FN+TP).  Spec: evaluation.py:174-191."""
    return count[3] / (count[2] + count[3])


def fit(count):
    """TP/(TP+FN+FP).  Spec: evaluation.py:194-211."""
    return count[3] / (count[3] + count[2] + count[1])


@partial(jax.jit, static_argnames=("under",))
def batch_fit(desc, bench, thresholds, under="under"):
    """Fit index for a whole batch of thresholds in one fused device pass.

    This is the reference's calibration hot loop (~30 serial full-raster
    scans, evaluation.py:32-85) collapsed into one vmapped histogram kernel.
    """
    desc = jnp.asarray(desc)
    masked = jnp.where(desc == desc[0, 0], jnp.nan, desc).reshape(-1)
    bench01 = (_normalise_benchmark(bench) == 2).reshape(-1)
    valid = ~jnp.isnan(masked)

    def one(th):
        if under == "under":
            pred = valid & (masked <= th)
        else:
            pred = valid & (masked >= th)
        tp = jnp.sum(pred & bench01)
        fp = jnp.sum(pred & ~bench01)
        fn = jnp.sum((~pred) & bench01)
        return tp / (tp + fn + fp)

    return jax.vmap(one)(jnp.asarray(thresholds))


def coarse_to_fine_search(fits_at):
    """Threshold-search driver shared by every calibration backend.

    ``fits_at(values, scale)`` evaluates Fit at the batch of thresholds
    ``v/scale`` and returns a float64 array.  Stage structure, iteration
    order and comparison strictness (>= in the first refinement, > after)
    replicate the reference exactly (evaluation.py:12-87 /
    oracle.calibration_oracle) — with equal Fit inputs every backend selects
    the identical threshold.
    """
    f1, f2, f3 = fits_at([25, 50, 75], 100)
    if f3 > f2:
        fit_index, iteration_value = (f3, 75) if f3 > f1 else (f1, 25)
    else:
        fit_index, iteration_value = (f2, 50) if f2 > f1 else (f1, 25)

    threshold = None
    grid = list(range(iteration_value - 20, iteration_value + 30, 10))
    for i, f in zip(grid, fits_at(grid, 100)):
        if f >= fit_index:
            fit_index, threshold = f, i

    grid = list(range(threshold - 5, threshold + 6, 1))
    for i, f in zip(grid, fits_at(grid, 100)):
        if f > fit_index:
            fit_index, threshold = f, i

    threshold *= 10
    grid = list(range(threshold - 10, threshold + 11, 1))
    for i, f in zip(grid, fits_at(grid, 1000)):
        if f > fit_index:
            fit_index, threshold = f, i

    threshold *= 10
    grid = list(range(threshold - 10, threshold + 11, 1))
    for i, f in zip(grid, fits_at(grid, 10000)):
        if f > fit_index:
            fit_index, threshold = f, i

    return threshold / 10000


def calibration(desc, bench, under="under", backend="numpy"):
    """Coarse-to-fine threshold search maximising Fit.

    Stage structure replicates evaluation.py:12-87 (see oracle docstring).
    ``backend='numpy'`` is float64-exact; ``backend='jax'`` evaluates each
    stage's threshold batch on-device.
    """
    if backend == "numpy":
        return oracle.calibration_oracle(np.asarray(desc), np.asarray(bench), under)

    desc = jnp.asarray(desc)
    bench = jnp.asarray(bench)

    def fits_at(values, scale):
        ths = jnp.asarray([v / scale for v in values], jnp.float32)
        return np.asarray(batch_fit(desc, bench, ths, under=under), dtype=np.float64)

    return coarse_to_fine_search(fits_at)
