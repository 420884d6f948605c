"""Topographic indexes (TWI and modified TWI) — pointwise maps.

Recast of reference topoindexes.py: the reference launches two
CUDA kernels over flattened tiles (topoindexes.py:233-295); here both are
pure jnp expressions that XLA fuses (with the slope stencil, when jitted
together) into a single HBM pass.

Semantics follow the GPU variants — epsilon *inside* tan() — because those
produced the reference goldens (topoindexes.py:257 vs the jit twin's
topoindexes.py:47; SURVEY §2.3 flags the discrepancy and resolves it this
way).  NoData: fac <= -100 -> -100.
"""

import jax.numpy as jnp

from descriptools_jax.constants import EPS, NODATA


def topographic_index(fac, slope_rad, px, nodata=NODATA):
    """TWI = ln(max(fac,1) * px^2 / tan(slope_rad + 0.01))."""
    fac = jnp.asarray(fac, jnp.float32)
    slope_rad = jnp.asarray(slope_rad, jnp.float32)
    area = jnp.where(fac == 0, 1.0, fac) * jnp.float32(px * px)
    twi = jnp.log(area / jnp.tan(slope_rad + jnp.float32(EPS)))
    return jnp.where(fac <= nodata, jnp.float32(nodata), twi)


def modified_topographic_index(fac, slope_rad, px, exponent, nodata=NODATA):
    """Modified TWI = ln((max(fac,1) * px^2)^n / tan(slope_rad + 0.01))."""
    fac = jnp.asarray(fac, jnp.float32)
    slope_rad = jnp.asarray(slope_rad, jnp.float32)
    area = jnp.where(fac == 0, 1.0, fac) * jnp.float32(px * px)
    mtwi = jnp.log(
        jnp.power(area, jnp.float32(exponent)) / jnp.tan(slope_rad + jnp.float32(EPS))
    )
    return jnp.where(fac <= nodata, jnp.float32(nodata), mtwi)
