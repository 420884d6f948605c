"""Per-stage wall-clock breakdown of the descriptor suite on the default
device.  Run on a GPU to see where the suite time goes.

Usage: python scripts/profile_stages.py [--synthetic N | --example DIR]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from descriptools_jax.constants import NODATA
from descriptools_jax.ops import (
    downslope,
    ln_hl_h,
    modified_topographic_index,
    slope,
    topographic_index,
)
from descriptools_jax.ops.flow import hand_and_river_fac
from descriptools_jax.ops.gfi import gfi
from descriptools_jax.ops.flow import flow_distance_index
from descriptools_jax.pipeline import PipelineConfig, descriptor_suite
from descriptools_jax.utils.timing import timeit


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--synthetic":
        from descriptools_jax.utils.synthetic import synthetic_basin

        size = int(sys.argv[2])
        dem, fdr, river, fac = synthetic_basin(size, size, seed=0)
        dem = dem.astype(np.int32)
        fac = fac.astype(np.int32)
    elif len(sys.argv) >= 3 and sys.argv[1] == "--example":
        from descriptools_jax.io import load_example_inputs

        data = load_example_inputs(sys.argv[2])
        dem = data["dem"].astype(np.int32)
        fdr, fac, river = data["fdr"], data["fac"].astype(np.int32), data["river"]
    else:
        sys.exit(__doc__)

    from descriptools_jax.utils.device import require_gpu

    cfg = PipelineConfig()
    dev = require_gpu()
    dem_d, fdr_d, fac_d, river_d = (
        jax.device_put(jnp.asarray(a), dev) for a in (dem, fdr, fac, river)
    )
    dem_f = jnp.asarray(dem_d, jnp.float32)

    stages = {}

    sl = slope(dem_f, cfg.px)
    sl_rad = jnp.where(dem_f == NODATA, jnp.float32(NODATA), jnp.arctan(sl / 100.0))
    fdist, indices = flow_distance_index(
        fdr_d, river_d, cfg.px, max_steps=cfg.flow_max_steps
    )
    hand, river_fac = hand_and_river_fac(dem_d, fac_d, indices)

    stages["slope"] = timeit(lambda: slope(dem_f, cfg.px))
    stages["twi"] = timeit(lambda: topographic_index(fac_d, sl_rad, cfg.px))
    stages["mod_twi"] = timeit(
        lambda: modified_topographic_index(fac_d, sl_rad, cfg.px, cfg.n_topo)
    )
    stages["downslope"] = timeit(lambda: downslope(
        dem_f, fdr_d, cfg.px, cfg.elevation_difference,
        max_steps=cfg.downslope_max_steps,
    ))
    stages["flow_distance_index"] = timeit(lambda: flow_distance_index(
        fdr_d, river_d, cfg.px, max_steps=cfg.flow_max_steps
    ))
    stages["hand_and_river_fac"] = timeit(
        lambda: hand_and_river_fac(dem_d, fac_d, indices)
    )
    stages["gfi"] = timeit(lambda: gfi(hand, river_fac, cfg.n_gfi, cfg.b_gfi, cfg.px))
    stages["ln_hl_h"] = timeit(lambda: ln_hl_h(hand, fac_d, cfg.n_gfi, cfg.b_gfi, cfg.px))
    stages["FULL_SUITE"] = timeit(
        lambda: descriptor_suite(dem_d, fdr_d, fac_d, river_d, cfg)
    )

    total = sum(v for k, v in stages.items() if k != "FULL_SUITE")
    for k, v in stages.items():
        print(f"{k:24s} {v * 1e3:10.2f} ms")
    print(f"{'sum-of-stages':24s} {total * 1e3:10.2f} ms")


if __name__ == "__main__":
    main()
