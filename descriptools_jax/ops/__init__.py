"""Single-device descriptor ops (plain JAX, compiled by XLA)."""

from descriptools_jax.ops.slope import slope, slope_from_padded
from descriptools_jax.ops.topo import topographic_index, modified_topographic_index
from descriptools_jax.ops.downslope import downslope, build_downslope_tables
from descriptools_jax.ops.flow import (
    flow_distance_index,
    flow_hand_index,
    hand_calculator,
)
from descriptools_jax.ops.gfi import (
    gfi,
    gfi_calculator,
    ln_hl_h,
    river_accumulation,
)

__all__ = [
    "slope",
    "slope_from_padded",
    "topographic_index",
    "modified_topographic_index",
    "downslope",
    "build_downslope_tables",
    "flow_distance_index",
    "flow_hand_index",
    "hand_calculator",
    "gfi",
    "gfi_calculator",
    "ln_hl_h",
    "river_accumulation",
]
