"""Slope descriptor — 8-neighbour max-downhill-gradient stencil (XLA).

Recast of reference slope.py: the reference runs one CUDA thread
per cell over a flattened array with an 8-way neighbour loop
(slope.py:209-259) plus a -100 halo ring added host-side (slope.py:175-182).
Here the whole stencil is eight shifted-array subtractions fused by XLA into
a couple of elementwise passes over the raster; the NoData ring is a single
jnp.pad.  Semantics match ``slope_sequential_jit`` (slope.py:8-49): per cell
``max(0, max over valid neighbours of (z_c - z_n)/dist) * 100``, NoData ->
-100.
"""

import jax.numpy as jnp
import numpy as np

from descriptools_jax.constants import D8_DX, D8_DY, D8_STEP, NODATA


def slope_from_padded(padded, px, nodata=NODATA):
    """Slope for the interior of a 1-ring-padded DEM block.

    The pad ring supplies neighbour values (NoData on global borders, real
    halo data on shard boundaries), so the same kernel serves both the
    single-device and the shard_map path.
    """
    rows = padded.shape[0] - 2
    cols = padded.shape[1] - 2
    dem = padded[1:-1, 1:-1]
    nd = jnp.float32(nodata)
    best = jnp.zeros((rows, cols), jnp.float32)
    for dy, dx, step in zip(D8_DY, D8_DX, D8_STEP):
        nbr = padded[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]
        grad = (dem - nbr) / jnp.float32(px * float(step))
        best = jnp.where((nbr != nd) & (grad > best), grad, best)
    return jnp.where(dem == nd, nd, best * 100.0)


def slope(dem, px, nodata=NODATA):
    """Slope (%) of a whole DEM on one device."""
    dem = jnp.asarray(dem, jnp.float32)
    padded = jnp.pad(dem, 1, constant_values=np.float32(nodata))
    return slope_from_padded(padded, px, nodata)
