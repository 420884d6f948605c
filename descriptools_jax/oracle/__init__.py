"""NumPy oracle implementations of every descriptor.

These are the *executable specification* used by the test-suite: slow, simple,
trusted implementations whose semantics were derived from the reference's
Numba ``*_sequential_jit`` twins and ``@cuda.jit`` kernels (the ``_jit`` twins
are the trustworthy oracles per the reference; the non-jit twins contain stale
debug ranges).  Reference citations (file:line into /root/reference):

- slope:      descriptools/slope.py:8-49 (jit twin), slope.py:209-259 (GPU)
- TWI:        descriptools/topoindexes.py:233-261 (GPU variant — epsilon
              *inside* tan(), which is what produced the goldens; the jit twin
              at topoindexes.py:36-53 puts it outside — a known discrepancy we
              resolve in favour of the GPU)
- downslope:  descriptools/downslope.py:160-314 (jit twin; the public
              ``downsloper`` runs this over the global matrix as the repair
              pass, so it defines the end-to-end semantics)
- flow dist / indices: descriptools/flowhand.py:565-846 (GPU kernel with zero
              divisions: out == [0,0,0,0], 20000-step cap, cycle detection)
- HAND:       descriptools/flowhand.py:414-442
- GFI, ln(hl/H), river accumulation: descriptools/gfi.py
- evaluation: descriptools/evaluation.py (all of it)

None of this is a copy: everything is re-derived behaviour, vectorised where
exactness permits, and written against plain NumPy.
"""

from descriptools_jax.oracle.core import (
    slope_oracle,
    topographic_index_oracle,
    modified_topographic_index_oracle,
    downslope_oracle,
    downslope_oracle_trunc,
    flow_distance_index_oracle,
    flow_distance_index_oracle_trunc,
    hand_oracle,
    river_accumulation_oracle,
    gfi_oracle,
    ln_hl_h_oracle,
)
from descriptools_jax.oracle.evaluation import (
    min_max_scale_oracle,
    binary_map_oracle,
    confusion_oracle,
    correctness_oracle,
    fit_oracle,
    calibration_oracle,
)

__all__ = [
    "slope_oracle",
    "topographic_index_oracle",
    "modified_topographic_index_oracle",
    "downslope_oracle",
    "downslope_oracle_trunc",
    "flow_distance_index_oracle",
    "flow_distance_index_oracle_trunc",
    "hand_oracle",
    "river_accumulation_oracle",
    "gfi_oracle",
    "ln_hl_h_oracle",
    "min_max_scale_oracle",
    "binary_map_oracle",
    "confusion_oracle",
    "correctness_oracle",
    "fit_oracle",
    "calibration_oracle",
]
