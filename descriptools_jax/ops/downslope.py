"""Downslope index — gather-free lookahead iteration (XLA).

Recast of reference downslope.py.  The reference walks each cell's
D8 path until the cumulative drop reaches ``elevation_difference`` (default
5 m), serially per CUDA thread with a 5000-step cap (downslope.py:434-532),
then repairs unresolved cells with a sequential CPU pass (downslope.py:373).

Key observation (derived from downslope_sequential_jit, downslope.py:160-314,
which defines the end-to-end semantics): the result is
``(z0 - z_stop) / dist_stop`` in *every* branch — threshold reached, terminal
step (border exit / NoData target / dead end), or cap.  Only the stop
position matters:

    stop(c0) = first p_k with  z(p_k) <= z(c0) - ed   (threshold)
                            or terminal(p_k)           (no valid next step)
                            or k == max_steps          (cap, 5000)

Because the threshold depends on the start cell, absorbing-state pointer
jumping does not apply directly, and gather-based successor doubling trades
streaming sweeps for whole-grid random access.
Instead we iterate a *shared t-step lookahead table*: per grid cell c,

    P_t(c) = P_{t-1}(succ(c)) ,  D_t(c) = d(c) + D_{t-1}(succ(c)) ,
    Z_t(c) = Z_{t-1}(succ(c)) ,  T_t(c) = T_{t-1}(succ(c))

— every update is a pull from the immediate D8 successor
(descriptools_jax.d8.pull8: eight shifted selects, no gathers).
Terminal cells self-saturate, so Z_t/D_t freeze at the stop automatically.
Each cell freezes its own result the first t where its stop condition fires;
the loop exits when every cell has stopped or at the cap (whose partial
result is exactly the reference's).  Depth = max stop time over cells —
tens of iterations on real terrain.

``method='descent'`` keeps the binary-descent-over-doubling-tables engine
(log-depth but gather-bound) for cross-checking and pathological flats.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from descriptools_jax.constants import DOWNSLOPE_MAX_STEPS, NODATA
from descriptools_jax.d8 import decode, pull8, successor

_NEG_INF = jnp.float32(-3e38)

# Packed step counts: the lookahead accumulates the walk's cardinal and
# diagonal step COUNTS in one int32 (cardinal bits 0-15, diagonal 16-31)
# instead of a serially-summed f32 distance raster — one raster fewer
# through the memory-bound sweeps, and the counts are exact integers.  No
# overflow is possible: the lookahead advances at most one step per sweep
# and sweeps are gated at max_steps (<= 5000 << 2^15, constants.py
# DOWNSLOPE_MAX_STEPS), so both fields stay < 2^13.  The f32 distance is
# reconstructed ONCE at the stop via :func:`unpack_dist`, landing ~1 ulp
# from the float64 distance (serial sums carried O(sqrt(L)) ulps).
_INC_DIAG = 1 << 16


def unpack_dist(pk, px):
    """f32 path distance from packed counts — the one shared reconstruction.

    Uses exactly the reference per-step f32 lengths (f32(step) * f32(px),
    the same operands d8.decode feeds the serial engines; slope.py:255 /
    downslope.py:495 diagonal convention)."""
    from descriptools_jax.constants import D8_STEP

    a = jnp.bitwise_and(pk, (1 << 16) - 1).astype(jnp.float32)
    b = jnp.right_shift(pk, 16).astype(jnp.float32)  # pk >= 0 always
    c_card = jnp.float32(np.float32(D8_STEP[0]) * np.float32(px))
    c_diag = jnp.float32(np.float32(D8_STEP[1]) * np.float32(px))
    return a * c_card + b * c_diag


def trunc_cells(dem, fdr, row0, col0, grid_rows, grid_cols, nodata=NODATA):
    """Cells whose D8 step leaves the local block while staying INSIDE the
    global grid.  A walk stopping at such a cell is *truncated* (the local
    block ran out of data), unlike a genuine terminal stop (global border
    exit / NoData target / dead end).  ``row0``/``col0`` — global coords of
    the block origin — may be traced (per-shard under shard_map).
    """
    rows, cols = dem.shape
    z = jnp.asarray(dem, jnp.float32)
    dy, dx, _step, valid = decode(fdr)
    i = jnp.arange(rows, dtype=jnp.int32)[:, None]
    j = jnp.arange(cols, dtype=jnp.int32)[None, :]
    ty = i + dy
    tx = j + dx
    gy = ty + row0
    gx = tx + col0
    in_local = (ty >= 0) & (ty < rows) & (tx >= 0) & (tx < cols)
    in_global = (gy >= 0) & (gy < grid_rows) & (gx >= 0) & (gx < grid_cols)
    return valid & in_global & ~in_local & (z != jnp.float32(nodata))


def _num_levels(max_steps):
    j = 0
    while (1 << (j + 1)) <= max_steps:
        j += 1
    return j + 1  # levels 0..j cover jumps up to 2^j <= max_steps


def _terminal_and_step(dem, fdr, px, nodata):
    """Per-cell terminal flag and step length (2-D)."""
    rows, cols = dem.shape
    z = jnp.asarray(dem, jnp.float32)
    succ, step, in_bounds, valid = successor(fdr, rows, cols)
    target_nodata = z.reshape(-1)[succ.reshape(-1)].reshape(rows, cols) == jnp.float32(
        nodata
    )
    terminal = (~valid) | (~in_bounds) | target_nodata | (z == jnp.float32(nodata))
    stepd = jnp.where(terminal, 0.0, step * jnp.float32(px))
    return z, terminal, stepd


@partial(jax.jit, static_argnames=("max_steps", "px", "elevation_difference"))
def _downslope_jacobi(dem, fdr, px, elevation_difference, max_steps, trunc0=None):
    """Gather-free lookahead engine.  With ``trunc0`` (per-cell bool marking
    truncation-terminal cells, see :func:`trunc_cells`) also returns a bool
    raster flagging cells whose stop landed on a truncated terminal — the
    sharded path retries those with a wider halo until none remain.
    """
    rows, cols = dem.shape
    z, terminal, stepd = _terminal_and_step(dem, fdr, px, NODATA)
    thresh = z - jnp.float32(elevation_difference)
    fdr_eff = jnp.where(terminal, 0, jnp.asarray(fdr))
    # Packed per-cell step increment (cardinal 1 / diagonal 1<<16; 0 at
    # terminals) — see the packed-counts note above unpack_dist.
    inc = jnp.where(
        terminal, 0, jnp.where(stepd > jnp.float32(px), _INC_DIAG, 1)
    ).astype(jnp.int32)
    track = trunc0 is not None

    # Lookahead state, two arrays per sweep: pk_t (packed step counts of t
    # steps) and Zt_t = z at P_t with the terminal flag folded in as a -2^20
    # offset (exact for integer-valued elevations: f32 ulp at 2^20 is 1/16).
    # t=0: self.
    _OFF = jnp.float32(1 << 20)
    _HALF = jnp.float32(1 << 19)
    Zt0 = jnp.where(terminal, z - _OFF, z)
    pk0 = inc * 0  # varying-typed zero (shard_map carries track mesh axes)
    stopped0 = terminal  # stop at k=0 when the start itself is terminal
    res_pk0 = pk0
    res_z0 = z
    if track:
        Tt0 = jnp.asarray(trunc0, jnp.bool_)
        res_t0 = terminal & Tt0  # stopped-at-start cells carry their own flag
    else:
        Tt0 = res_t0 = None

    def cond(carry):
        stopped, *_rest, t = carry
        return jnp.any(~stopped) & (t < max_steps)

    # Unrolled sweeps: XLA fuses the chained shifted-select pulls, so eight
    # walk steps cost little more HBM traffic than one.
    UNROLL = 8

    def body(carry):
        if track:
            stopped, pk, Zt, Tt, res_pk, res_z, res_t, t = carry
        else:
            stopped, pk, Zt, res_pk, res_z, t = carry
            Tt = res_t = None
        for k in range(UNROLL):
            live = t + k < max_steps
            if track:
                p_pk, pZt, pT = pull8(fdr_eff, [pk, Zt, Tt], [0, 0.0, False])
                Tt = jnp.where(live, pT, Tt)
            else:
                p_pk, pZt = pull8(fdr_eff, [pk, Zt], [0, 0.0])
            pk = jnp.where(live, inc + p_pk, pk)
            Zt = jnp.where(live, pZt, Zt)
            # Offset-encoded key: terminal positions sit ~2^20 below any
            # real elevation, so one compare catches both stop conditions.
            hit = live & (~stopped) & (Zt <= thresh)
            z_at = jnp.where(Zt < -_HALF, Zt + _OFF, Zt)
            res_pk = jnp.where(hit, pk, res_pk)
            res_z = jnp.where(hit, z_at, res_z)
            if track:
                # Truncated iff the stop was a terminal (offset-encoded)
                # that is truncation-flagged; threshold stops are exact.
                res_t = jnp.where(hit, Tt & (Zt < -_HALF), res_t)
            stopped = stopped | hit
        if track:
            return (stopped, pk, Zt, Tt, res_pk, res_z, res_t, t + UNROLL)
        return (stopped, pk, Zt, res_pk, res_z, t + UNROLL)

    if track:
        carry = (stopped0, pk0, Zt0, Tt0, res_pk0, res_z0, res_t0,
                 jnp.array(0, jnp.int32))
        stopped, pk, Zt, _Tt, res_pk, res_z, res_t, _t = jax.lax.while_loop(
            cond, body, carry
        )
    else:
        carry = (stopped0, pk0, Zt0, res_pk0, res_z0, jnp.array(0, jnp.int32))
        stopped, pk, Zt, res_pk, res_z, _t = jax.lax.while_loop(cond, body, carry)

    # Cap: unstopped cells take the partial result at the lookahead horizon
    # (identical formula, downslope.py:303-312).  A cap stop is exact: had
    # the path reached any terminal (incl. a block edge) it would have hit.
    res_pk = jnp.where(stopped, res_pk, pk)
    res_z = jnp.where(stopped, res_z, jnp.where(Zt < -_HALF, Zt + _OFF, Zt))

    res_d = unpack_dist(res_pk, px)
    out = jnp.where(res_pk == 0, 0.0, (z - res_z) / res_d)
    out = jnp.where(z == jnp.float32(NODATA), jnp.float32(NODATA), out)
    if track:
        return out, res_t & stopped
    return out


def build_downslope_tables(dem, fdr, px, nodata=NODATA, max_steps=DOWNSLOPE_MAX_STEPS):
    """Doubling tables (succs, dists, minkeys) for the binary descent."""
    rows, cols = dem.shape
    z = jnp.asarray(dem, jnp.float32).reshape(-1)
    succ, step, in_bounds, valid = successor(fdr, rows, cols)
    succ = succ.reshape(-1)
    step = step.reshape(-1)
    in_bounds = in_bounds.reshape(-1)
    valid = valid.reshape(-1)

    target_nodata = z[succ] == jnp.float32(nodata)
    terminal = (~valid) | (~in_bounds) | target_nodata | (z == jnp.float32(nodata))

    n = rows * cols
    self_idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(terminal, _NEG_INF, z)

    succ0 = jnp.where(terminal, self_idx, succ)
    dist0 = jnp.where(terminal, 0.0, step * jnp.float32(px))
    minkey0 = key[succ0]

    succs, dists, minkeys = [succ0], [dist0], [minkey0]
    for _ in range(_num_levels(max_steps) - 1):
        s, d, m = succs[-1], dists[-1], minkeys[-1]
        succs.append(s[s])
        dists.append(d + d[s])
        minkeys.append(jnp.minimum(m, m[s]))
    return jnp.stack(succs), jnp.stack(dists), jnp.stack(minkeys)


@partial(jax.jit, static_argnames=("max_steps", "px", "elevation_difference"))
def _downslope_descent(dem, fdr, px, elevation_difference, max_steps):
    rows, cols = dem.shape
    z = jnp.asarray(dem, jnp.float32).reshape(-1)
    succs, dists, minkeys = build_downslope_tables(dem, fdr, px, max_steps=max_steps)
    levels = succs.shape[0]

    n = rows * cols
    cur = jnp.arange(n, dtype=jnp.int32)
    dist = jnp.zeros(n, jnp.float32)
    steps = jnp.zeros(n, jnp.int32)
    thresh = z - jnp.float32(elevation_difference)

    for j in range(levels - 1, -1, -1):
        can = (minkeys[j][cur] > thresh) & (steps + (1 << j) <= max_steps)
        dist = jnp.where(can, dist + dists[j][cur], dist)
        steps = jnp.where(can, steps + (1 << j), steps)
        cur = jnp.where(can, succs[j][cur], cur)

    take = (steps < max_steps) & (minkeys[0][cur] <= thresh)
    dist = jnp.where(take, dist + dists[0][cur], dist)
    cur = jnp.where(take, succs[0][cur], cur)

    out = jnp.where(dist == 0.0, 0.0, (z - z[cur]) / dist)
    out = jnp.where(z == jnp.float32(NODATA), jnp.float32(NODATA), out)
    return out.reshape(rows, cols)


def downslope(
    dem, fdr, px, elevation_difference,
    max_steps=DOWNSLOPE_MAX_STEPS, method="jacobi",
):
    """Downslope index of a whole grid on one device (float32).

    ``elevation_difference`` must be > 0 (the reference's semantics are
    degenerate otherwise).  method='jacobi' (default) is the gather-free
    lookahead engine; 'descent' is the binary descent over doubling tables.
    """
    if method == "descent":
        return _downslope_descent(dem, fdr, px, elevation_difference, max_steps)
    return _downslope_jacobi(dem, fdr, px, elevation_difference, max_steps)
