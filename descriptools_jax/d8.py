"""Vectorised D8 flow-direction machinery (JAX).

The reference decodes D8 with a per-cell 8-way if/elif chain inside each
kernel (downslope.py:76-127 is the canonical decoder).  Recast here as
whole-raster elementwise select chains — no gathers, no divergence.

Conventions: (row, col) arrays; ESRI codes 1=E 2=SE 4=S 8=SW 16=W 32=NW 64=N
128=NE; diagonal steps cost px*sqrt(2) (slope.py:255).
"""

import jax.numpy as jnp
import numpy as np

from descriptools_jax.constants import D8_CODES, D8_DX, D8_DY, D8_STEP


def decode(fdr):
    """Decode a D8 raster into (dy, dx, step_pixels, valid).

    Invalid codes (0 or anything not in the D8 set) give dy=dx=0, step=0,
    valid=False.  Everything is a flat select-chain: 8 equality masks fused
    by XLA into a few elementwise passes.
    """
    fdr = jnp.asarray(fdr)
    dy = jnp.zeros(fdr.shape, jnp.int32)
    dx = jnp.zeros(fdr.shape, jnp.int32)
    step = jnp.zeros(fdr.shape, jnp.float32)
    valid = jnp.zeros(fdr.shape, jnp.bool_)
    for code, cdy, cdx, cs in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
        hit = fdr == code
        dy = jnp.where(hit, jnp.int32(cdy), dy)
        dx = jnp.where(hit, jnp.int32(cdx), dx)
        step = jnp.where(hit, jnp.float32(cs), step)
        valid = valid | hit
    return dy, dx, step, valid


def successor(fdr, rows, cols, row0=0, col0=0, grid_rows=None, grid_cols=None):
    """Per-cell D8 successor as flat local indices, plus step length & flags.

    Returns (succ, step_pixels, in_bounds, valid):
      - ``succ``: int32 flat index into the local (rows, cols) block of the
        D8 target; cells whose step is invalid or leaves the *global* grid
        keep ``succ = self``.
      - ``step_pixels``: step length in pixels (0 where no step is taken).
      - ``in_bounds``: True where the D8 target stays inside the local block
        AND the global grid.
      - ``valid``: True where the D8 code itself decodes.

    ``row0``/``col0`` and ``grid_rows``/``grid_cols`` let a shard detect
    *global* border exits distinctly from shard-boundary exits: a step may
    leave the local block (handled by the caller's boundary machinery) while
    still being inside the global grid.
    """
    if grid_rows is None:
        grid_rows = rows
    if grid_cols is None:
        grid_cols = cols
    dy, dx, step, valid = decode(fdr)
    i = jnp.arange(rows, dtype=jnp.int32)[:, None]
    j = jnp.arange(cols, dtype=jnp.int32)[None, :]
    ty = i + dy
    tx = j + dx
    gy = ty + row0
    gx = tx + col0
    in_global = (gy >= 0) & (gy < grid_rows) & (gx >= 0) & (gx < grid_cols)
    in_local = (ty >= 0) & (ty < rows) & (tx >= 0) & (tx < cols)
    ok = valid & in_global & in_local
    self_idx = i * cols + j
    succ = jnp.where(ok, ty * cols + tx, self_idx).astype(jnp.int32)
    step = jnp.where(valid & in_global, step, 0.0)
    return succ, step, valid & in_global, valid


def d8_flow_direction(dem, nodata=-100):
    """Compute an ESRI D8 flow-direction raster from a DEM.

    Steepest-descent over the 8-neighbourhood with the same distance
    weighting as the slope stencil; ties resolve to the first direction in
    ESRI code order (E, SE, S, SW, W, NW, N, NE).  Cells with no downhill
    neighbour (pits/flats) and NoData cells get code 0.  This is a
    framework extra — the reference takes fdr as a precomputed input.
    """
    dem = jnp.asarray(dem, jnp.float32)
    rows, cols = dem.shape
    pad = jnp.pad(dem, 1, constant_values=np.float32(nodata))
    best = jnp.zeros(dem.shape, jnp.float32)
    code_out = jnp.zeros(dem.shape, jnp.int32)
    for code, cdy, cdx, cs in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
        nbr = jax_slice(pad, int(cdy), int(cdx), rows, cols)
        grad = (dem - nbr) / jnp.float32(cs)
        ok = (nbr != nodata) & (grad > best)
        best = jnp.where(ok, grad, best)
        code_out = jnp.where(ok, jnp.int32(int(code)), code_out)
    return jnp.where(dem == nodata, 0, code_out)


def jax_slice(padded, dy, dx, rows, cols):
    """Shifted view of a 1-ring-padded raster."""
    return padded[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]


def pull8(fdr, arrays, fills):
    """Per-cell pull of values from each cell's D8 successor — gather-free.

    ``pulled[c] = X[c + delta(fdr[c])]`` computed as eight shifted-array
    selects (streaming elementwise work, no random access).  Cells with
    invalid/no direction keep their own value.  ``fills`` pads the 1-ring
    (value seen when the successor is off the local grid).

    This is the workhorse of the frontier-propagation ("Jacobi") form of the
    flow walks: one pull advances every cell's knowledge one step along its
    flow path.
    """
    rows, cols = fdr.shape
    outs = []
    for arr, fill in zip(arrays, fills):
        padded = jnp.pad(arr, 1, constant_values=arr.dtype.type(fill))
        acc = arr
        for code, dy, dx in zip(D8_CODES, D8_DY, D8_DX):
            nbr = padded[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]
            acc = jnp.where(fdr == code, nbr, acc)
        outs.append(acc)
    return outs
