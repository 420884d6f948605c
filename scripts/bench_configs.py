"""Benchmark the BASELINE.json analogue configs beyond bench.py's one
grid and print them as one JSON object.

  config 2 — synthetic 4096^2: full suite + stencil-only (slope+TWI).
  config 3 — synthetic 10000^2 (1e8 cells, past the old 2^24 index
             ceiling): full suite, single device.
  config 4 — calibration (jax backend, fused batch-fit) on the basin HAND;
             runs only with ``--example DIR`` (the reference's example
             basin).

Run on a GPU: python scripts/bench_configs.py [--example DIR].  Timings are
medians of calls ended by jax.block_until_ready.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--example")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from descriptools_jax import evaluation
    from descriptools_jax.io import load_example_inputs
    from descriptools_jax.ops import slope, topographic_index
    from descriptools_jax.pipeline import PipelineConfig, descriptor_suite
    from descriptools_jax.utils.synthetic import synthetic_basin
    from descriptools_jax.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )
    from descriptools_jax.utils.timing import timeit

    dev = require_gpu()
    cfg = PipelineConfig()
    results = {"device_kind": dev.device_kind,
               "card": card_name_and_power_limit()}

    def suite_time(size, iters):
        t0 = time.time()
        dem, fdr, river, fac = synthetic_basin(size, size, seed=0)
        gen_s = time.time() - t0
        args = (
            jnp.asarray(dem.astype(np.int32)), jnp.asarray(fdr),
            jnp.asarray(fac.astype(np.int32)), jnp.asarray(river),
        )
        t = timeit(lambda: descriptor_suite(*args, cfg), warmup=1, iters=iters)
        return dict(
            cells=size * size, seconds=round(t, 4),
            grid_points_per_s=round(size * size / t, 1),
            host_gen_s=round(gen_s, 1),
        )

    # config 2: 4096^2 full suite + stencil-only roofline
    results["config2_full_suite_4096"] = suite_time(4096, iters=3)
    dem4k = synthetic_basin(4096, 4096, seed=0)[0]
    dem_j = jnp.asarray(dem4k.astype(np.float32))
    fac_j = jnp.asarray(np.abs(dem4k).astype(np.int32))

    @jax.jit
    def stencil_only(d, f):
        sl = slope(d, cfg.px)
        sl_rad = jnp.arctan(sl / 100.0)
        return topographic_index(f, sl_rad, cfg.px)

    t = timeit(lambda: stencil_only(dem_j, fac_j), warmup=1, iters=5)
    results["config2_stencil_slope_twi_4096"] = dict(
        cells=4096 * 4096, seconds=round(t, 5),
        grid_points_per_s=round(4096 * 4096 / t, 1),
    )

    # config 3: 10k x 10k (1e8 cells) full suite, single device
    results["config3_full_suite_10000"] = suite_time(10000, iters=2)

    # config 3 derivation leg (BASELINE config 3 is "D8 flow direction +
    # HAND"; round-4 verdict, Missing #4): derive fdr+fac from the DEM
    # alone — steepest-descent D8 + O(log D) scatter-add accumulation —
    # timed at the same 1e8-cell scale.
    from descriptools_jax.ops.terrain import derive_terrain

    dem10k = synthetic_basin(10000, 10000, seed=0)[0]
    dem10k_j = jnp.asarray(dem10k.astype(np.int32))

    def derive():
        fdr_d, fac_d = derive_terrain(dem10k_j)
        return fac_d

    t = timeit(derive, warmup=1, iters=2)
    results["config3_derive_terrain_10000"] = dict(
        cells=10000 * 10000, seconds=round(t, 3),
        grid_points_per_s=round(10000 * 10000 / t, 1),
        note="d8_flow_direction + flow_accumulation(auto max_path) from DEM",
    )

    # config 4: calibration on the basin HAND (fused batch-fit, jax backend)
    if args.example is None:
        print(json.dumps(results))
        return
    data = load_example_inputs(args.example)
    out = descriptor_suite(
        jnp.asarray(data["dem"], jnp.int32), jnp.asarray(data["fdr"]),
        jnp.asarray(data["fac"], jnp.int32), jnp.asarray(data["river"]), cfg,
    )
    hand = np.asarray(out["hand"])
    elements = np.unique(hand)
    from descriptools_jax import oracle

    desc = oracle.min_max_scale_oracle(hand, elements[1], elements[-1])
    desc_j = jnp.asarray(desc, jnp.float32)
    flood_j = jnp.asarray(data["flood"])

    def calib():
        return evaluation.calibration(desc_j, flood_j, "under", backend="jax")

    th = calib()  # warm + value check
    t = timeit(calib, warmup=1, iters=3)
    results["config4_calibration_basin"] = dict(
        cells=int(hand.size), seconds=round(t, 4), threshold=float(th),
        grid_points_per_s=round(hand.size / t, 1),
        note="full coarse-to-fine search, ~100 thresholds over 3.3M cells",
    )

    print(json.dumps(results))


if __name__ == "__main__":
    main()
