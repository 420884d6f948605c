"""Benchmark: full descriptor suite throughput on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "grid-points/s", ...}

value = grid points per second of the full descriptor suite (slope, TWI,
        mod-TWI, downslope, fdist/indices/HAND, GFI, ln(hl/H)) on JAX's
        first device: cells / median steady-state seconds of ITERS calls,
        each ended by ``jax.block_until_ready``.  The first call (compile +
        run) is reported apart as ``first_call_s``.

Inputs: ``python bench.py --synthetic N`` (default N = 4096) benches a
seeded synthetic N x N basin; ``python bench.py --example DIR`` benches the
reference's bundled example basin read from DIR.  Any device other than a
GPU is refused; the output names the card and its power limit.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ITERS = 7


def _inputs(args):
    if args.example:
        from descriptools_jax.io import load_example_inputs

        data = load_example_inputs(args.example)
        return (
            data["dem"].astype(np.int32), data["fdr"],
            data["fac"].astype(np.int32), data["river"],
            "full_descriptor_suite_bundled_basin",
        )
    from descriptools_jax.utils.synthetic import synthetic_basin

    n = args.synthetic
    dem, fdr, river, fac = synthetic_basin(n, n, seed=0)
    return (
        dem.astype(np.int32), fdr, fac.astype(np.int32), river,
        f"full_descriptor_suite_synthetic_{n}",
    )


def main():
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--synthetic", type=int, default=4096)
    src.add_argument("--example")
    args = ap.parse_args()

    import jax

    from descriptools_jax.pipeline import PipelineConfig, descriptor_suite
    from descriptools_jax.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    card = card_name_and_power_limit()
    cfg = PipelineConfig()
    dem, fdr, fac, river, metric = _inputs(args)
    dev_args = [jax.device_put(a, dev) for a in (dem, fdr, fac, river)]

    def run():
        return jax.block_until_ready(descriptor_suite(*dev_args, cfg))

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    steady = float(np.median(times))

    print(json.dumps({
        "metric": metric,
        "value": dem.size / steady,
        "unit": "grid-points/s",
        "steady_state_ms": steady * 1e3,
        "first_call_s": first,
        "timed_calls": ITERS,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "card": card,
    }))


if __name__ == "__main__":
    main()
