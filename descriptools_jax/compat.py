"""Drop-in API compatibility with the reference toolbox.

Every public entry point of JVBSouza/descriptools, with the reference
signatures, NumPy-in / NumPy-out, mapped onto this package's engines:

    reference                      here
    ---------                      ----
    helpers.divisor                divisor                (helpers.py:5)
    slope.sloper                   sloper                 (slope.py:96)
    topoindexes.topographic_index  topographic_index      (topoindexes.py:109)
    downslope.downsloper           downsloper             (downslope.py:317)
    flowhand.flow_hand_index       flow_hand_index        (flowhand.py:242)
    flowhand.hand_calculator       hand_calculator        (flowhand.py:414)
    flowhand.index_calculator      index_calculator       (flowhand.py:445)
    gfi.gfi_calculator             gfi_calculator         (gfi.py:150)
    gfi.ln_hl_H_calculator         ln_hl_H_calculator     (gfi.py:297)
    gfi.river_accumulation         river_accumulation     (gfi.py:118)
    evaluation.minMaxScale         minMaxScale            (evaluation.py:5)
    evaluation.calibration         calibration            (evaluation.py:12)
    evaluation.binary_map          binary_map             (evaluation.py:90)
    evaluation.avaliacao           avaliacao              (evaluation.py:126)
    evaluation.correctness         correctness            (evaluation.py:174)
    evaluation.fit                 fit                    (evaluation.py:194)

The ``division_column`` / ``division_row`` arguments exist in the reference
only to fit tiles in GPU memory (tiles ran serially; SURVEY §1).  Here the
whole grid is device-resident, so they are accepted and ignored — outputs
are identical to the reference's tiled path by construction (its tiling is
result-invariant).
"""

import numpy as np

from descriptools_jax import evaluation as _ev
from descriptools_jax import oracle as _oracle
from descriptools_jax import ops as _ops
from descriptools_jax.constants import NODATA


def divisor(row_length, column_length, row_division, column_division):
    """Interior tile-boundary rows/cols: floor((i+1)*len/(div+1))."""
    boundary_row = np.array(
        [(i + 1) * row_length // (row_division + 1) for i in range(row_division)],
        dtype=int,
    )
    boundary_column = np.array(
        [(i + 1) * column_length // (column_division + 1) for i in range(column_division)],
        dtype=int,
    )
    return boundary_row, boundary_column


def sloper(dem, px, division_column=0, division_row=0):
    return np.asarray(_ops.slope(np.asarray(dem, np.float32), px))


def topographic_index(flow_accumulation, slope, px, n_top, div_col=0, div_row=0):
    twi = _ops.topographic_index(flow_accumulation, slope, px)
    mtwi = _ops.modified_topographic_index(flow_accumulation, slope, px, n_top)
    return np.asarray(twi), np.asarray(mtwi)


def downsloper(dem, flow_direction, px, elevation_difference,
               column_division=0, row_division=0):
    return np.asarray(
        _ops.downslope(np.asarray(dem, np.float32), flow_direction, px,
                       elevation_difference)
    )


def flow_hand_index(dem_raster, flow_direction_matrix, river_matrix, px,
                    division_column=0, division_row=0):
    fdist, indices, hand = _ops.flow_hand_index(
        np.asarray(dem_raster), flow_direction_matrix, river_matrix, px
    )
    return np.asarray(fdist), np.asarray(indices), np.asarray(hand)


def hand_calculator(dem, indices):
    return np.asarray(_ops.hand_calculator(np.asarray(dem), indices))


def index_calculator(river_indices, row_start, column_start, column_size):
    """Sub-matrix -> whole-matrix river-index transform (flowhand.py:445-473;
    bypassed in the reference's own pipeline, kept for API parity)."""
    river_indices = np.asarray(river_indices)
    row, col = river_indices.shape
    return np.where(
        river_indices == NODATA,
        NODATA,
        (river_indices // col + row_start) * column_size
        + river_indices % col
        + column_start,
    )


def river_accumulation(flow_accumulation, indices):
    return np.asarray(_ops.river_accumulation(flow_accumulation, indices))


def gfi_calculator(hand, flow_accumulation, indices, n_gfi, scale_factor, size,
                   division_column=0, division_row=0):
    return np.asarray(
        _ops.gfi_calculator(hand, flow_accumulation, indices, n_gfi,
                            scale_factor, size)
    )


def ln_hl_H_calculator(hand, flow_accumulation, n_gfi, scale_factor, size,
                       division_column=0, division_row=0):
    return np.asarray(_ops.ln_hl_h(hand, flow_accumulation, n_gfi, scale_factor, size))


def minMaxScale(mat, mn, mx, nodata):
    return _oracle.min_max_scale_oracle(mat, mn, mx, nodata)


def calibration(descriptor_matrix, comparison_matrix, under):
    return _ev.calibration(descriptor_matrix, comparison_matrix, under,
                           backend="numpy")


def binary_map(descriptor_matrix, threshold, under):
    return _oracle.binary_map_oracle(descriptor_matrix, threshold, under)


def avaliacao(descriptor_flood_map, comparison_flood_map):
    return _oracle.confusion_oracle(descriptor_flood_map, comparison_flood_map)


def correctness(count):
    return _oracle.correctness_oracle(count)


def fit(count):
    return _oracle.fit_oracle(count)
