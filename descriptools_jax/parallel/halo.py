"""Device-to-device halo exchange for sharded stencils and walks.

Replacement for the reference's host-side 1-cell tile overlap
(sloper, slope.py:145-147): inside shard_map, each block swaps edge strips
with its mesh neighbours via ``lax.ppermute`` (nearest-neighbour hops),
row phase then column phase — the column phase moves the already-extended
rows, so corner halos arrive without dedicated diagonal sends.  Global
borders are filled with the NoData sentinel, mirroring the reference's -100
ring (slope.py:175-182).
"""

import jax
import jax.numpy as jnp
from jax import lax


def _exchange_axis(block, width, axis, axis_name, fill):
    """Halo exchange along one array axis inside shard_map.

    ``width`` may exceed the block extent: deeper neighbours are reached by
    chained ppermute hops (k full-block sends fetch the block k devices
    away), so an iterating caller can widen its halo past one block — the
    exact-downslope retry loop needs this on pathological flats.  Positions
    beyond the global grid are filled with ``fill``.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    h = block.shape[axis]
    fill_v = jnp.asarray(fill, block.dtype)

    def take(arr, lo, hi):
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(lo, hi)
        return arr[tuple(sl)]

    fwd = [(i, i + 1) for i in range(n - 1)]  # data flows to higher idx
    bwd = [(i, i - 1) for i in range(1, n)]

    if width <= h:
        # Single hop: send only the strips.
        lead = take(block, 0, width)
        trail = take(block, h - width, h)
        if n > 1:
            before = lax.ppermute(trail, axis_name, fwd)
            after = lax.ppermute(lead, axis_name, bwd)
        else:
            before = jnp.zeros_like(lead)
            after = jnp.zeros_like(trail)
        before = jnp.where(idx == 0, fill_v, before)
        after = jnp.where(idx == n - 1, fill_v, after)
        return jnp.concatenate([before, block, after], axis=axis)

    # Multi-hop: roll whole blocks; hop k holds the block k devices away.
    hops = -(-width // h)
    before_parts, after_parts = [], []
    cur_f = block
    cur_b = block
    for k in range(1, hops + 1):
        w_k = min(h, width - (k - 1) * h)
        if n > 1:
            cur_f = lax.ppermute(cur_f, axis_name, fwd)  # block of idx-k
            cur_b = lax.ppermute(cur_b, axis_name, bwd)  # block of idx+k
        part_f = jnp.where(idx >= k, take(cur_f, h - w_k, h), fill_v)
        part_b = jnp.where(idx <= n - 1 - k, take(cur_b, 0, w_k), fill_v)
        before_parts.insert(0, part_f)  # farthest rows first
        after_parts.append(part_b)
    return jnp.concatenate(before_parts + [block] + after_parts, axis=axis)


def halo_exchange(block, width, fill, axis_names=("y", "x")):
    """Extend a local block by ``width`` cells of neighbour data on all four
    sides (corners included).  Must run inside shard_map over ``axis_names``.
    """
    ext = _exchange_axis(block, width, 0, axis_names[0], fill)
    ext = _exchange_axis(ext, width, 1, axis_names[1], fill)
    return ext
