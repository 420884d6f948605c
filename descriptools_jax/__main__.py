"""CLI driver: full descriptor pipeline on a basin directory.

Mirrors the reference Example/example.py end to end — read rasters, compute
every descriptor, calibrate a flood threshold on HAND, write the classified
map — as ``python -m descriptools_jax <basin_dir> [-o out.tif]``.

The basin directory must follow the reference layout:
  input/12_dem.tif  input/12_fdr.tif  input/12_fac.tif  input/WB_12_100y.tif
"""

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="descriptools_jax")
    ap.add_argument("basin", help="basin directory (reference Example layout)")
    ap.add_argument("-o", "--output", default=None, help="classified map TIFF path")
    ap.add_argument("--px", type=float, default=12.5)
    ap.add_argument("--elevation-difference", type=float, default=5.0)
    ap.add_argument("--n-topo", type=float, default=0.1)
    ap.add_argument("--n-gfi", type=float, default=0.4)
    ap.add_argument("--b-gfi", type=float, default=0.1)
    args = ap.parse_args(argv)

    from descriptools_jax.io import write_raster
    from descriptools_jax.pipeline import PipelineConfig, run_example

    cfg = PipelineConfig(
        px=args.px,
        elevation_difference=args.elevation_difference,
        n_topo=args.n_topo,
        n_gfi=args.n_gfi,
        b_gfi=args.b_gfi,
    )
    t0 = time.time()
    out = run_example(args.basin, cfg)
    wall = time.time() - t0
    print(
        json.dumps(
            {
                "threshold": out["threshold"],
                "correctness": round(float(out["correctness"]), 4),
                "fit": round(float(out["fit"]), 4),
                "cells": int(out["hand"].size),
                "wall_s": round(wall, 1),
            }
        )
    )
    if args.output:
        write_raster(args.output, out["class_map"])
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
