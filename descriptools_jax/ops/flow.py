"""Flow tracing to the drainage network — a gather-minimal design.

Recast of reference flowhand.py.  The reference walks each cell's D8 path
serially, one GPU thread per cell — up to 20000 data-dependent steps per
thread (flowhand.py:565-846).  A naive pointer-jumping port is log-depth but
every doubling round is three whole-grid random-access gathers.

The production engine is therefore a two-phase hybrid that keeps whole-grid
work to streaming shifted selects and confines gathers to a small subset:

  Phase 1 — frontier propagation ("Jacobi"): every cell pulls its
  successor's resolution via descriptools_jax.d8.pull8 (an elementwise
  select chain, no gathers).  Each sweep extends every resolved drainage frontier
  one cell upstream, so k sweeps resolve all cells within k steps of a river
  or dead end.  The loop exits when the unresolved count fits the compaction
  budget, when a sweep resolves nothing (only cycle/over-cap cells remain —
  exactly the reference's -100 outcomes), or at the 20000-step cap.

  Phase 2 — compacted doubling: surviving long-path cells (a small minority)
  are compacted by a sort, and classic successor doubling runs on the small
  set with *packed* (K,4)-row gathers — one gather per round moves all four
  state fields of a row together.
  A walk that leaves the compacted set necessarily enters a resolved cell
  (resolution distance decreases along flow), absorbing immediately.

Integer results are bit-identical to the reference truth table (see
oracle/core.py flow_distance_index_oracle); float distances differ only in
f32 summation order.  method='doubling' keeps the plain pointer-jumping
engine for cross-checking.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from descriptools_jax.constants import FLOW_MAX_STEPS, NODATA
from descriptools_jax.d8 import pull8, successor

_I32_IDX_LIMIT = 1 << 31  # flat int32 indices (covers the 1e9-cell target)


def _f2i(x):
    """Reinterpret f32 bits as i32 (exact; lets f32 payloads ride i32 packs)."""
    return lax.bitcast_convert_type(x, jnp.int32)


def _i2f(x):
    """Reinterpret i32 bits as f32 (inverse of _f2i)."""
    return lax.bitcast_convert_type(x, jnp.float32)


def _doubling_rounds(max_steps):
    k = 0
    while (1 << k) < max_steps:
        k += 1
    return k


def flow_states(fdr, river, rows, cols):
    """Per-cell absorbing classification (flat arrays) — truth table derived
    from flowhand.py:599-846; identical for start and arrived-at cells."""
    fdr_f = jnp.asarray(fdr).reshape(-1)
    river_f = jnp.asarray(river).reshape(-1)
    succ, step, in_bounds, valid = successor(fdr, rows, cols)
    succ = succ.reshape(-1)
    step = step.reshape(-1)
    in_bounds = in_bounds.reshape(-1)
    valid = valid.reshape(-1)

    is_zero = fdr_f == 0
    is_river = (~is_zero) & (river_f == 1)
    absorb_nan = is_zero | ((~is_river) & (valid & ~in_bounds)) | ((~is_river) & ~valid)
    absorbing = absorb_nan | is_river
    return succ, step, absorbing, absorb_nan, is_river


@partial(jax.jit, static_argnames=("max_steps", "px"))
def _flow_doubling(fdr, river, px, max_steps):
    """Plain whole-grid successor doubling (reference engine for tests)."""
    rows, cols = fdr.shape
    succ, step, absorbing, absorb_nan, is_river = flow_states(fdr, river, rows, cols)
    n = rows * cols
    self_idx = jnp.arange(n, dtype=jnp.int32)
    succ = jnp.where(absorbing, self_idx, succ)
    dist = jnp.where(absorbing, 0.0, step * jnp.float32(px))
    steps = jnp.where(absorbing, 0, 1).astype(jnp.int32)

    def body(carry, _):
        s, d, st = carry
        return (s[s], d + d[s], st + st[s]), None

    (succ_f, dist_f, steps_f), _ = jax.lax.scan(
        body, (succ, dist, steps), None, length=_doubling_rounds(max_steps)
    )
    landed = is_river[succ_f] & (steps_f <= max_steps)
    fdist = jnp.where(landed, dist_f, jnp.float32(NODATA))
    indices = jnp.where(landed, succ_f, jnp.int32(NODATA))
    return fdist.reshape(rows, cols), indices.reshape(rows, cols)


def resolve_absorbing_walk(fdr, absorbing, stepd, succ, max_steps, cap, tag0=None):
    """Generic hybrid resolver: every cell walks its D8 path to the nearest
    absorbing cell, returning (resolved, dist, steps, absorber, tag).

    - ``absorbing``: flat bool — walk endpoints (self-classified).
    - ``stepd``: flat f32 step cost per cell (0 at absorbing cells).
    - ``succ``: flat int32 D8 successor (self where invalid).
    - ``tag0``: optional flat f32 payload defined at absorbing cells,
      carried to every cell that resolves there (e.g. a status code).

    Phase 1 is gather-free frontier propagation (pull8 sweeps); phase 2 is
    compacted successor doubling over the residue (see module docstring).
    Used by the single-device flow engine AND the per-shard local phase of
    the boundary-graph reduction.  Indices are exact int32 (f32 payloads
    ride the packed gathers as raw bits), so any n < 2^31 cells works.
    """
    rows, cols = fdr.shape
    n = rows * cols
    self_idx = jnp.arange(n, dtype=jnp.int32)
    absorbing2d = absorbing.reshape(rows, cols)
    stepd2d = stepd.reshape(rows, cols)
    if tag0 is None:
        # Derived from an input so shard_map's varying-axis tracking stays
        # consistent across the while_loop carry.
        tag0 = jnp.asarray(stepd, jnp.float32).reshape(-1) * 0.0

    # Pulls must not cross absorbing cells: zero their direction so pull8
    # keeps their own (final) values.
    fdr_eff = jnp.where(absorbing2d, 0, jnp.asarray(fdr))

    resolved0 = absorbing2d
    tag2d0 = tag0.reshape(rows, cols).astype(jnp.float32)
    # Derive zero-carries from inputs so shard_map's varying-axis tracking
    # sees consistent types between init and body outputs.
    dist0 = stepd2d * 0.0
    steps0 = stepd2d * 0.0
    absorber0 = jnp.where(resolved0, self_idx.reshape(rows, cols), 0)

    n_i32 = jnp.array(n, jnp.int32)
    stepd = stepd2d

    def cond(carry):
        *_rest, count, newly, t = carry
        return ((n_i32 - count) > cap) & (newly > 0) & (t < max_steps)

    # Unrolled sweeps: XLA fuses chained shifted-select pulls, amortizing
    # HBM traffic over several frontier steps.  One count reduction per body.
    UNROLL = 4

    def body(carry):
        resolved, tag, dist, steps, absorber, count, _newly, t = carry
        for _ in range(UNROLL):
            p_res, p_tag, p_d, p_s, p_a = pull8(
                fdr_eff,
                [resolved, tag, dist, steps, absorber],
                [False, 0.0, 0.0, 0.0, 0],
            )
            hit = (~resolved) & p_res
            dist = jnp.where(hit, stepd + p_d, dist)
            steps = jnp.where(hit, 1.0 + p_s, steps)
            absorber = jnp.where(hit, p_a, absorber)
            tag = jnp.where(hit, p_tag, tag)
            resolved = resolved | hit
        count_new = jnp.sum(resolved).astype(jnp.int32)
        return (
            resolved, tag, dist, steps, absorber,
            count_new, count_new - count, t + UNROLL,
        )

    count0 = jnp.sum(resolved0).astype(jnp.int32)
    carry = (
        resolved0, tag2d0, dist0, steps0, absorber0,
        count0, count0 * 0 + 1, count0 * 0,
    )
    resolved, tag, dist, steps, absorber, _c, _newly, _t = jax.lax.while_loop(
        cond, body, carry
    )

    # ---- Phase 2: compacted doubling over the unresolved residue ----
    unresolved = (~resolved).reshape(-1)

    def phase2(args):
        resolved_f, tag_f, dist_f, steps_f, absorber_f = (
            a.reshape(-1) for a in args
        )
        # Compact: unresolved first, in cell order — ``rank`` below assumes
        # it, so the sort must be stable (the GPU's sort is not by default).
        keys = jnp.where(unresolved, 0, 1).astype(jnp.int32)
        _, order = jax.lax.sort((keys, self_idx), num_keys=1, is_stable=True)
        sub = order[:cap]
        rank = jnp.cumsum(unresolved.astype(jnp.int32)) - 1  # global -> sub slot

        g_succ = succ[sub]
        g_un = unresolved[sub]
        # Full-grid resolution state, packed into i32 rows (f32 payloads ride
        # as raw bits — selects/gathers move bits, so this is exact at any
        # grid size, unlike f32-encoded indices which round above 2^24).
        full_pack = jnp.stack(
            [
                resolved_f.astype(jnp.int32),
                _f2i(dist_f),
                _f2i(steps_f),
                absorber_f,
                _f2i(tag_f),
            ],
            axis=-1,
        )
        # Two packed subset gathers: state at each sub cell and at its succ.
        at_sub = full_pack[sub]
        at_succ = full_pack[g_succ]
        succ_resolved = at_succ[:, 0] > 0

        sub_step = jnp.where(g_un, stepd.reshape(-1)[sub], 0.0)
        k = jnp.arange(cap, dtype=jnp.int32)
        # Absorbed at init: junk (already-resolved) slot, or a walker whose
        # successor is resolved.  Absorbed slots SELF-LOOP WITH ZERO EDGE
        # WEIGHT; their actual resolution lives in the static r_* arrays so
        # repeated composition cannot double-count it.
        absorbed0 = (~g_un) | succ_resolved
        r_dist = jnp.where(g_un, sub_step + _i2f(at_succ[:, 1]), _i2f(at_sub[:, 1]))
        r_steps = jnp.where(g_un, 1.0 + _i2f(at_succ[:, 2]), _i2f(at_sub[:, 2]))
        r_abs = jnp.where(g_un, at_succ[:, 3], at_sub[:, 3])
        r_tag = jnp.where(g_un, _i2f(at_succ[:, 4]), _i2f(at_sub[:, 4]))

        s_succ = jnp.where(absorbed0, k, jnp.clip(rank[g_succ], 0, cap - 1))
        e_dist = jnp.where(absorbed0, 0.0, sub_step)
        e_steps = jnp.where(absorbed0, 0.0, 1.0)

        pack = jnp.stack([s_succ, _f2i(e_dist), _f2i(e_steps)], axis=-1)

        rounds = _doubling_rounds(max_steps)

        def dbl_cond(state):
            p, r, done = state
            return (~done) & (r < rounds)

        def dbl_body(state):
            p, r, _ = state
            cur = p[:, 0]
            nxt = p[cur]  # one packed (cap, 3) gather per round
            p = jnp.stack(
                [
                    nxt[:, 0],
                    _f2i(_i2f(p[:, 1]) + _i2f(nxt[:, 1])),
                    _f2i(_i2f(p[:, 2]) + _i2f(nxt[:, 2])),
                ],
                axis=-1,
            )
            # Early exit once every live chain has reached an absorbed slot
            # (cycle-only residues cannot converge; the round cap bounds them).
            done = jnp.all(absorbed0[p[:, 0]] | ~g_un)
            return (p, r + 1, done)

        zero = jnp.sum(g_un).astype(jnp.int32) * 0  # varying-typed zero
        pack, _r, _d = jax.lax.while_loop(
            dbl_cond, dbl_body, (pack, zero, zero > 0)
        )

        # Converged iff the chain reached an init-absorbed slot (paths that
        # should land within max_steps always converge: 2^rounds >= max_steps
        # and longer paths are NaN by the cap anyway).
        final_slot = pack[:, 0]
        chain_done = absorbed0[final_slot]
        write = g_un & chain_done
        r_at_final = jnp.stack(
            [_f2i(r_dist), _f2i(r_steps), r_abs, _f2i(r_tag)], axis=-1
        )[final_slot]
        dist_f = dist_f.at[sub].set(
            jnp.where(write, _i2f(pack[:, 1]) + _i2f(r_at_final[:, 0]),
                      _i2f(at_sub[:, 1]))
        )
        steps_f = steps_f.at[sub].set(
            jnp.where(write, _i2f(pack[:, 2]) + _i2f(r_at_final[:, 1]),
                      _i2f(at_sub[:, 2]))
        )
        new_abs = jnp.where(write, r_at_final[:, 2], at_sub[:, 3])
        absorber_f = absorber_f.at[sub].set(new_abs)
        res_f = resolved_f.at[sub].set(resolved_f[sub] | write)
        tg_f = tag_f.at[sub].set(
            jnp.where(write, _i2f(r_at_final[:, 3]), _i2f(at_sub[:, 4]))
        )
        return res_f, tg_f, dist_f, steps_f, absorber_f

    def no_phase2(args):
        return tuple(a.reshape(-1) for a in args)

    resolved_f, tag_f, dist_f, steps_f, absorber_f = jax.lax.cond(
        jnp.any(unresolved),
        phase2,
        no_phase2,
        (resolved, tag, dist, steps, absorber),
    )
    return (resolved_f, dist_f, steps_f, absorber_f, tag_f)


@partial(jax.jit, static_argnames=("max_steps", "px", "cap"))
def _flow_hybrid(fdr, river, px, max_steps, cap):
    rows, cols = fdr.shape
    succ, step, absorbing, absorb_nan, is_river = flow_states(fdr, river, rows, cols)
    stepd = jnp.where(absorbing, 0.0, step * jnp.float32(px))
    resolved, dist, steps, absorber, tag = resolve_absorbing_walk(
        fdr, absorbing, stepd, succ, max_steps, cap,
        tag0=is_river.astype(jnp.float32),
    )
    landed = resolved & (tag > 0) & (steps <= max_steps)
    fdist = jnp.where(landed, dist, jnp.float32(NODATA))
    indices = jnp.where(landed, absorber, jnp.int32(NODATA))
    return fdist.reshape(rows, cols), indices.reshape(rows, cols)


def flow_distance_index(fdr, river, px, max_steps=FLOW_MAX_STEPS, method="hybrid"):
    """Flow distance + river-cell flat index for a whole grid on one device.

    Returns (fdist float32, indices int32).  method='hybrid' (default) is the
    frontier+compacted-doubling engine; 'doubling' is plain pointer jumping.
    """
    rows, cols = fdr.shape
    n = rows * cols
    if n >= _I32_IDX_LIMIT:
        raise ValueError(
            f"{n} cells overflow flat int32 indices; use the sharded or "
            "tiled path (descriptools_jax.parallel / tiled) above 2^31 cells"
        )
    if method == "doubling":
        return _flow_doubling(fdr, river, px, max_steps)
    cap = min(n, max(1024, n // 8))
    return _flow_hybrid(fdr, river, px, max_steps, cap)


def hand_calculator(dem, indices, nodata=NODATA):
    """HAND = clip(dem - dem.flat[indices], 0); NoData masked.

    Spec: flowhand.py:414-442.  Integer-exact when dem is integer (the golden
    pipeline feeds int16 dem), so pass dem as an int dtype for bitwise parity.
    """
    dem = jnp.asarray(dem)
    flat = dem.reshape(-1)
    idx = jnp.asarray(indices).reshape(-1)
    safe = jnp.where(idx == nodata, 0, idx)
    hand = flat - flat[safe]
    hand = jnp.where((flat != nodata) & (idx != nodata), hand, nodata)
    hand = jnp.where((hand < 0) & (hand != nodata), 0, hand)
    return hand.reshape(dem.shape)


def hand_and_river_fac(dem, fac, indices, nodata=NODATA):
    """HAND and river-gathered fac in ONE packed payload gather.

    Fetching (dem, fac) rows at the river indices takes one random-access
    pass instead of two (ROADMAP A5 measures it against two plain gathers).
    Semantics match
    hand_calculator (flowhand.py:414-442) and river_accumulation
    (gfi.py:118-147) exactly, including the fac.flat[0] fallback quirk.
    """
    dem = jnp.asarray(dem)
    fac = jnp.asarray(fac)
    flat_d = dem.reshape(-1)
    flat_f = fac.reshape(-1)
    idx = jnp.asarray(indices).reshape(-1)
    safe = jnp.where(idx == nodata, 0, idx)
    packed = jnp.stack(
        [flat_d.astype(jnp.float32), flat_f.astype(jnp.float32)], axis=-1
    )[safe]
    dem_at = packed[:, 0].astype(dem.dtype)
    fac_at = packed[:, 1]
    hand = flat_d - dem_at
    hand = jnp.where((flat_d != nodata) & (idx != nodata), hand, nodata)
    hand = jnp.where((hand < 0) & (hand != nodata), 0, hand)
    river_fac = jnp.where(idx != nodata, fac_at, flat_f[0].astype(jnp.float32))
    return hand.reshape(dem.shape), river_fac.reshape(dem.shape)


@partial(jax.jit, static_argnames=("max_steps", "px"))
def flow_hand_index(dem, fdr, river, px, max_steps=FLOW_MAX_STEPS):
    """Flow distance, river indices, and HAND in one fused pass.

    Mirrors the reference public API ``flow_hand_index`` (flowhand.py:242-411)
    minus the host-side tiling — the whole grid stays device-resident and
    the sharded variant lives in descriptools_jax.parallel.
    """
    fdist, indices = flow_distance_index(fdr, river, px, max_steps=max_steps)
    hand = hand_calculator(dem, indices)
    return fdist, indices, hand
