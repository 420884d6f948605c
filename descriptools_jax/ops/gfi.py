"""Geomorphic flood index (GFI), ln(hl/H), and the river-accumulation gather.

Recast of reference gfi.py: pointwise maps plus one gather of
fac at each cell's drainage point (gfi.py:118-147).  The reference's quirk of
falling back to ``fac.flat[0]`` for unresolved cells is preserved for parity
(gfi.py:141-143); those cells are masked to -100 downstream anyway because
idx == -100 implies hand == -100.
"""

import jax.numpy as jnp

from descriptools_jax.constants import EPS, NODATA


def river_accumulation(fac, indices, nodata=NODATA):
    """fac gathered at each cell's river index (float32)."""
    fac = jnp.asarray(fac)
    flat = fac.reshape(-1).astype(jnp.float32)
    idx = jnp.asarray(indices).reshape(-1)
    safe = jnp.where(idx == nodata, 0, idx)
    out = jnp.where(idx != nodata, flat[safe], flat[0])
    return out.reshape(fac.shape)


def gfi(hand, river_fac, exponent, scale_factor, px, nodata=NODATA):
    """GFI = ln(b * (fac_river * px^2)^n / (hand + 0.01)).

    Spec: gfi.py:267-294.  ``river_fac`` comes from river_accumulation.
    """
    hand = jnp.asarray(hand, jnp.float32)
    river_fac = jnp.asarray(river_fac, jnp.float32)
    val = jnp.log(
        jnp.float32(scale_factor)
        * jnp.power(river_fac * jnp.float32(px * px), jnp.float32(exponent))
        / (hand + jnp.float32(EPS))
    )
    return jnp.where(hand <= nodata, jnp.float32(nodata), val)


def gfi_calculator(hand, fac, indices, exponent, scale_factor, px, nodata=NODATA):
    """Public GFI entry mirroring gfi.py:150-207 (gather + pointwise map)."""
    return gfi(hand, river_accumulation(fac, indices, nodata), exponent, scale_factor, px, nodata)


def ln_hl_h(hand, fac, exponent, scale_factor, px, nodata=NODATA):
    """ln(hl/H) = ln(b * (max(fac,1) * px^2)^n / (hand + 0.01)).

    Spec: gfi.py:403-440 — same shape as GFI but with the *local* fac and the
    fac==0 -> 1 guard.
    """
    hand = jnp.asarray(hand, jnp.float32)
    fac = jnp.asarray(fac, jnp.float32)
    area = jnp.where(fac == 0, 1.0, fac) * jnp.float32(px * px)
    val = jnp.log(
        jnp.float32(scale_factor)
        * jnp.power(area, jnp.float32(exponent))
        / (hand + jnp.float32(EPS))
    )
    return jnp.where(hand <= nodata, jnp.float32(nodata), val)
