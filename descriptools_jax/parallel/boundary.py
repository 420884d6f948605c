"""Boundary-graph reduction for cross-shard D8 flow tracing.

This generalises the reference's cross-tile stitching algorithm — host-side
presolve of the 1-cell tile-boundary skeleton (flowhand.py:282-286) plus
chain-on-exit inside the tile kernel (flowhand.py:622-795) — into a fully
device-resident, deterministic three-phase scheme:

  1. *Local phase* (per shard, concurrent): pointer jumping with absorbing
     states {RIVER, NAN, EXIT}; every cell resolves to an absorbed result or
     to an exit record (target global cell one step outside the block).
  2. *Ring phase* (tiny, replicated): the perimeter cells of all shards form
     a functional graph (each ring cell's local resolution either absorbs or
     chains to a perimeter cell of a neighbour shard).  The ring records are
     all-gathered over the mesh (2(h+w) entries per shard) and the graph is
     solved by pointer jumping on every device identically.
  3. *Combine* (per shard): exit cells look up their entry cell's solved ring
     record and add it on.

Distances/steps compose additively; the river payload (global flat index,
elevation, flow accumulation) rides along so HAND/GFI need no global gather.
Integer outputs (indices, HAND) are bitwise-identical to the single-device
path for any mesh shape; float distances differ only by f32 summation order.

Status codes: 0=STEP (unresolved), 1=RIVER, 2=NAN, 3=EXIT.
"""

import jax.numpy as jnp
import numpy as np

from descriptools_jax.d8 import decode

STEP, RIVER, NAN, EXIT = 0, 1, 2, 3


def _ceil_log2(n):
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def local_flow_summary(dem, fdr, river, fac, iy, ix, h, w, R, C, px,
                       max_steps=20000):
    """Phase 1: resolve every cell of a (h, w) block locally with
    ops.flow.resolve_absorbing_walk (gather-free frontier sweeps +
    compacted doubling), then one packed payload gather at the absorber
    finishes the records.

    Returns flat per-cell arrays: status, dist, steps, tgy, tgx (exit target,
    global coords), ridx (river global flat index), rz, rfac (payloads).
    """
    from descriptools_jax.ops.flow import resolve_absorbing_walk

    z = jnp.asarray(dem, jnp.float32)
    dy, dx, step, valid = decode(fdr)
    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    gy = iy * h + yy + dy
    gx = ix * w + xx + dx
    ty = yy + dy
    tx = xx + dx
    in_global = (gy >= 0) & (gy < R) & (gx >= 0) & (gx < C)
    in_local = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)

    fdr = jnp.asarray(fdr)
    is_zero = fdr == 0
    is_river = (~is_zero) & (jnp.asarray(river) == 1)
    role = jnp.where(
        is_river,
        RIVER,
        jnp.where(
            is_zero | (~valid) | (valid & ~in_global),
            NAN,
            jnp.where(~in_local, EXIT, STEP),
        ),
    ).astype(jnp.int32)

    n = h * w
    role_f = role.reshape(-1)
    self_idx = jnp.arange(n, dtype=jnp.int32)
    succ = jnp.where(role_f == STEP, (ty * w + tx).reshape(-1), self_idx)
    stepd_all = (step * jnp.float32(px)).reshape(-1)
    stepd = jnp.where(role_f == STEP, stepd_all, 0.0)
    absorbing = role_f != STEP

    cap = min(n, max(1024, n // 8))
    resolved, dist, steps, final, _tag = resolve_absorbing_walk(
        fdr, absorbing, stepd, succ, max_steps, cap
    )

    # One packed payload gather at the absorbing cell: its out-step length
    # (exit cells), its D8 offsets (for the exit target), river payloads,
    # and the absorber's role (the walk's status).
    exit_d_all = jnp.where(role_f == EXIT, stepd_all, 0.0)
    payload = jnp.stack(
        [
            exit_d_all,
            dy.reshape(-1).astype(jnp.float32),
            dx.reshape(-1).astype(jnp.float32),
            z.reshape(-1),
            jnp.asarray(fac).reshape(-1).astype(jnp.float32),
            role_f.astype(jnp.float32),
        ],
        axis=-1,
    )[final]
    status = jnp.where(resolved, payload[:, 5].astype(jnp.int32), NAN)

    dist = dist + payload[:, 0]
    steps = (steps + (status == EXIT)).astype(jnp.int32)
    fy = final // w
    fx = final % w
    tgy = iy * h + fy + payload[:, 1].astype(jnp.int32)
    tgx = ix * w + fx + payload[:, 2].astype(jnp.int32)
    # Global flat river index in int32: exact for grids < 2^31 cells, which
    # covers the 1e9-cell north-star config.  Callers assert R*C < 2^31.
    ridx = ((iy * h + fy) * C + (ix * w + fx)).astype(jnp.int32)

    return dict(
        status=status, dist=dist, steps=steps, tgy=tgy, tgx=tgx,
        ridx=ridx, rz=payload[:, 3], rfac=payload[:, 4],
    )


def ring_indices(h, w):
    """Flat local indices of the block perimeter in canonical ring order:
    [top row | bottom row | left col | right col] (corners duplicated,
    records identical)."""
    top = np.arange(w)
    bottom = (h - 1) * w + np.arange(w)
    left = np.arange(h) * w
    right = np.arange(h) * w + (w - 1)
    return np.concatenate([top, bottom, left, right]).astype(np.int32)


def slot_of(gy, gx, h, w, nx, ring_len):
    """Global ring-table slot of a perimeter cell given its global coords.

    Must mirror ring_indices' canonical order, with row slots taking
    priority over column slots for corner cells.
    """
    sy = gy // h
    sx = gx // w
    ly = gy - sy * h
    lx = gx - sx * w
    slot_in = jnp.where(
        ly == 0,
        lx,
        jnp.where(ly == h - 1, w + lx, jnp.where(lx == 0, 2 * w + ly, 2 * w + h + ly)),
    )
    return (sy * nx + sx) * ring_len + slot_in


def solve_ring(ring, h, w, nx, max_steps):
    """Phase 2: pointer-jump the gathered ring graph (replicated).

    ``ring`` holds flat arrays of length G = num_shards * ring_len.  Returns
    solved per-entry fields (status, dist, steps, ridx, rz, rfac) giving the
    full downstream resolution of a walk *entering* at each ring cell.
    """
    ring_len = 2 * (h + w)
    G = ring["status"].shape[0]
    is_exit = ring["status"] == EXIT
    self_idx = jnp.arange(G, dtype=jnp.int32)
    tgt_slot = slot_of(ring["tgy"], ring["tgx"], h, w, nx, ring_len)
    tgt_slot = jnp.clip(tgt_slot, 0, G - 1)
    succ = jnp.where(is_exit, tgt_slot, self_idx)
    accd = jnp.where(is_exit, ring["dist"], 0.0)
    accs = jnp.where(is_exit, ring["steps"], 0).astype(jnp.int32)

    cap = jnp.int32(max_steps + 1)
    for _ in range(_ceil_log2(max(G, 2)) + 1):
        accd = accd + accd[succ]
        accs = jnp.minimum(accs + accs[succ], cap)
        succ = succ[succ]

    fb = succ
    stat = ring["status"][fb]
    solved_status = jnp.where(stat == EXIT, NAN, stat)
    solved_dist = accd + jnp.where(stat == RIVER, ring["dist"][fb], 0.0)
    solved_steps = jnp.minimum(accs + ring["steps"][fb], cap)
    return dict(
        status=solved_status,
        dist=solved_dist,
        steps=solved_steps,
        ridx=ring["ridx"][fb],
        rz=ring["rz"][fb],
        rfac=ring["rfac"][fb],
    )


def combine(local, solved, h, w, nx, max_steps):
    """Phase 3: splice ring resolutions into each cell's local result.

    Returns flat arrays (landed, dist, ridx, rz, rfac) for the block.
    """
    ring_len = 2 * (h + w)
    G = solved["status"].shape[0]
    is_exit = local["status"] == EXIT
    slot = slot_of(local["tgy"], local["tgx"], h, w, nx, ring_len)
    slot = jnp.clip(slot, 0, G - 1)

    status = jnp.where(is_exit, solved["status"][slot], local["status"])
    dist = jnp.where(is_exit, local["dist"] + solved["dist"][slot], local["dist"])
    steps = local["steps"] + jnp.where(is_exit, solved["steps"][slot], 0)
    ridx = jnp.where(is_exit, solved["ridx"][slot], local["ridx"])
    rz = jnp.where(is_exit, solved["rz"][slot], local["rz"])
    rfac = jnp.where(is_exit, solved["rfac"][slot], local["rfac"])

    landed = (status == RIVER) & (steps <= max_steps)
    return landed, dist, ridx, rz, rfac
