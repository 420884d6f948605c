"""Synthetic terrain generators for tests and benchmarks (NumPy, host-side).

Produces DEM / D8 / river rasters with the reference's conventions (-100
NoData, ESRI D8 codes, code 0 at pits & NoData) so every walk-termination
branch — river absorption, dead ends, border exits, NoData targets — is
exercised.  Steepest-descent D8 over a smooth field is strictly downhill, so
generated flow graphs are acyclic by construction; cycle handling is tested
separately with hand-crafted rasters.
"""

import numpy as np

from descriptools_jax.constants import D8_CODES, D8_DX, D8_DY, D8_STEP, NODATA


def synthetic_dem(rows, cols, seed=0, nodata_border=True, smooth=7, amp=80.0):
    """Smooth random DEM (float32-valued integers-ish) with a NoData region.

    A blurred noise field plus a broad ramp (so paths have somewhere to go).
    If ``nodata_border``, an irregular NoData region covers one corner, like
    the bundled basin's masked surroundings.
    """
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(rows, cols))
    # Separable box blur (avoid the scipy dependency in the hot test path).
    k = smooth
    kernel = np.ones(k) / k
    for axis in (0, 1):
        noise = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), axis, noise
        )
    ramp = np.linspace(1.0, 0.0, rows)[:, None] + np.linspace(0.5, 0.0, cols)[None, :]
    dem = 400.0 + amp * (noise + ramp)
    dem = np.round(dem).astype(np.float64)
    if nodata_border:
        yy, xx = np.mgrid[0:rows, 0:cols]
        blob = (yy + 1.3 * xx) < 0.25 * (rows + cols)
        dem[blob] = NODATA
    return dem


def d8_from_dem(dem, nodata=NODATA):
    """ESRI D8 by steepest descent; ties -> first code in ESRI order;
    pits/flats and NoData -> 0.  Mirrors descriptools_jax.d8.d8_flow_direction."""
    dem = np.asarray(dem, dtype=np.float64)
    rows, cols = dem.shape
    pad = np.full((rows + 2, cols + 2), nodata, dtype=np.float64)
    pad[1:-1, 1:-1] = dem
    best = np.zeros((rows, cols))
    code = np.zeros((rows, cols), dtype=np.int32)
    for c, dy, dx, s in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
        nbr = pad[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]
        grad = (dem - nbr) / float(s)
        ok = (nbr != nodata) & (grad > best)
        best = np.where(ok, grad, best)
        code = np.where(ok, int(c), code)
    return np.where(dem == nodata, 0, code).astype(np.uint8)


def _hash01(gy, gx, cols, salt):
    """Deterministic per-cell uniform in [0, 1): splitmix64 finalizer of the
    global flat index.  Pure elementwise — any window of any shape yields
    bitwise the same value for the same (gy, gx), which is what makes the
    windowed generator below self-consistent across out-of-core tiles."""
    u64 = np.uint64
    i = gy.astype(np.uint64)[:, None] * u64(cols) + gx.astype(np.uint64)[None, :]
    with np.errstate(over="ignore"):
        z = i * u64(0x9E3779B97F4A7C15) + u64(salt) * u64(0xD1B54A32D192ED03)
        z = (z ^ (z >> u64(30))) * u64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> u64(27))) * u64(0x94D049BB133111EB)
        z = z ^ (z >> u64(31))
    return (z >> u64(11)).astype(np.float64) * (1.0 / (1 << 53))


def windowed_basin(rows, cols, seed=0, smooth=7, amp=80.0, river_level=0.40):
    """Window-consistent synthetic basin for out-of-core runs: returns
    loaders {'dem','fdr','river','fac'}, each ``f(ys, ye, xs, xe) -> array``.

    Every window is bitwise-identical to the corresponding slice of the
    virtual global raster regardless of how it is windowed (the 1e9-cell
    north-star inputs can't be materialised per process; SURVEY §7 step 6).
    Construction mirrors ``synthetic_basin`` — smooth blurred noise + ramp,
    NoData corner blob, steepest-descent D8, low-elevation river set — but
    every primitive is local: hash noise per cell, ``smooth``-wide window
    mean via a fixed-order shifted-slice sum (cumsum would round differently
    per window origin), analytic ramp, and a fixed absolute river elevation
    (a quantile would be a global reduction).
    """
    half = smooth // 2
    scale = amp * 3.464 / (smooth * smooth)  # blurred-uniform std ~ 0.14*amp
    rthresh = np.float64(400.0 + amp * river_level)

    def _noise_padded(ys, ye, xs, xe, pad):
        """Raw noise on the padded window, zero outside the global grid
        (np.convolve 'same' zero-pad semantics at grid borders)."""
        ys0, ye0, xs0, xe0 = ys - pad, ye + pad, xs - pad, xe + pad
        out = np.zeros((ye0 - ys0, xe0 - xs0), np.float64)
        cy0, cy1 = max(ys0, 0), min(ye0, rows)
        cx0, cx1 = max(xs0, 0), min(xe0, cols)
        if cy1 > cy0 and cx1 > cx0:
            out[cy0 - ys0 : cy1 - ys0, cx0 - xs0 : cx1 - xs0] = (
                _hash01(np.arange(cy0, cy1), np.arange(cx0, cx1), cols, seed)
                - 0.5
            )
        return out

    def _win_sum(a, axis):
        """Width-``smooth`` sliding sum, fixed accumulation order."""
        n = a.shape[axis] - 2 * half
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, n)
        acc = a[tuple(sl)].copy()
        for k in range(1, smooth):
            sl[axis] = slice(k, k + n)
            acc += a[tuple(sl)]
        return acc

    def dem(ys, ye, xs, xe):
        nb = _win_sum(_win_sum(_noise_padded(ys, ye, xs, xe, half), 0), 1)
        gy = np.arange(ys, ye, dtype=np.int64)
        gx = np.arange(xs, xe, dtype=np.int64)
        ramp = (1.0 - gy / (rows - 1))[:, None] + (
            0.5 * (1.0 - gx / (cols - 1))
        )[None, :]
        d = np.round(400.0 + scale * nb + amp * ramp)
        blob = (gy[:, None] + 1.3 * gx[None, :]) < 0.25 * (rows + cols)
        d[blob] = NODATA
        return d.astype(np.int32)

    def _dem_halo1(ys, ye, xs, xe):
        """dem on the window plus a 1-cell rim, NODATA beyond the grid."""
        out = np.full((ye - ys + 2, xe - xs + 2), NODATA, np.int32)
        cy0, cy1 = max(ys - 1, 0), min(ye + 1, rows)
        cx0, cx1 = max(xs - 1, 0), min(xe + 1, cols)
        out[cy0 - ys + 1 : cy1 - ys + 1, cx0 - xs + 1 : cx1 - xs + 1] = dem(
            cy0, cy1, cx0, cx1
        )
        return out

    def fdr(ys, ye, xs, xe):
        pad = _dem_halo1(ys, ye, xs, xe).astype(np.float64)
        d = pad[1:-1, 1:-1]
        best = np.zeros(d.shape)
        code = np.zeros(d.shape, np.int32)
        h, w = d.shape
        for c, dy, dx, s in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
            nbr = pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            grad = (d - nbr) / float(s)
            ok = (nbr != NODATA) & (grad > best)
            best = np.where(ok, grad, best)
            code = np.where(ok, int(c), code)
        return np.where(d == NODATA, 0, code).astype(np.uint8)

    def river(ys, ye, xs, xe):
        d = dem(ys, ye, xs, xe)
        return ((d <= rthresh) & (d != NODATA)).astype(np.int8)

    def fac(ys, ye, xs, xe):
        d = dem(ys, ye, xs, xe)
        u = _hash01(
            np.arange(ys, ye), np.arange(xs, xe), cols, seed + 0x5EED
        )
        return np.where(
            d != NODATA, (u * 200000).astype(np.int32), np.int32(NODATA)
        )

    def flood(ys, ye, xs, xe):
        """Synthetic benchmark flood map: the low-elevation belt just above
        the river level (so calibration has a real optimum), NoData where
        the DEM is NoData — the reference benchmark's value set {NODATA,0,1}
        (Example/example.py:106, evaluation.py:149-150)."""
        d = dem(ys, ye, xs, xe)
        wet = (d <= rthresh + 0.125 * amp).astype(np.int32)
        return np.where(d == NODATA, np.int32(NODATA), wet)

    return dict(dem=dem, fdr=fdr, river=river, fac=fac, flood=flood)


def synthetic_basin(rows, cols, seed=0, river_quantile=0.15):
    """(dem, fdr, river, fac) for a synthetic basin.

    River cells = valid cells below the given elevation quantile (flow paths
    descend, so most cells drain into the river set).  fac is a crude proxy
    (elevation rank) — sufficient for the pointwise descriptors' formulas.
    """
    dem = synthetic_dem(rows, cols, seed=seed)
    fdr = d8_from_dem(dem)
    valid = dem != NODATA
    thresh = np.quantile(dem[valid], river_quantile)
    river = ((dem <= thresh) & valid).astype(np.int8)
    rng = np.random.default_rng(seed + 1)
    fac = np.where(valid, rng.integers(0, 200000, size=dem.shape), NODATA)
    return dem, fdr, river, fac


def synthetic_flood(dem, river, amp=80.0):
    """Benchmark flood map for a ``synthetic_basin``: the belt up to
    0.125 * amp above the highest river cell, NoData where the DEM is —
    the rule of ``windowed_basin``'s flood loader, with the basin's river
    level in place of its fixed one."""
    level = dem[river == 1].max()
    wet = (dem <= level + 0.125 * amp).astype(np.int32)
    return np.where(dem == NODATA, np.int32(NODATA), wet)
