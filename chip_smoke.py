"""Smoke run of the descriptor suite on a GPU, checked against the float64
oracles.

    python chip_smoke.py              # one GPU: phases 1-3
    python chip_smoke.py --chips 4    # four GPUs: phase 1 and phase 4 only

Phases:
  1. device — JAX's first device must be a GPU; prints the card's name and
     power limit (nvidia-smi), device kind, JAX version, XLA_FLAGS and the
     compile-cache directory.
  2. suite — ``descriptor_suite`` on a seeded 4096^2 synthetic basin (16.8 M
     cells, about one 1-degree GLO-30 tile), then ``classify_flood`` on its
     HAND with a seeded flood map.  Checks: every output on the GPU; 16
     interior 256^2 windows against the oracles (verify.sample_checks:
     indices and HAND exact, floats within verify.TOLS); the flow
     invariants over every cell; the threshold and class map of
     ``sharded_classify_flood`` on a one-device mesh equal to the host
     float64 classifier's.
  3. out of core — ``tiled_suite`` over the same inputs in 2048^2 tiles:
     indices and HAND bitwise equal to phase 2, floats within verify.TOLS.
  4. four devices — ``sharded_suite_staged`` over a 2x2 mesh on a seeded
     8192^2 basin (a 4096^2 block per device) against ``descriptor_suite``
     on one device: indices and HAND bitwise, floats within verify.TOLS.

Each phase prints its wall times (first call = compile + run, then a
steady-state call) beside the card's name and power limit.  Any failed
check raises, so the script exits non-zero and prints no result; on
success the last line is
    {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N = 4096
TILE = 2048
N4 = 8192
SEED = 0
INT_KEYS = ("indices", "hand")


class CheckFailed(RuntimeError):
    pass


def _log(msg):
    print(msg, flush=True)


def _timed(fn):
    """(result, seconds) of ``fn()``, blocked until its arrays are ready."""
    import jax

    t0 = time.perf_counter()
    res = jax.block_until_ready(fn())
    return res, time.perf_counter() - t0


def make_inputs(n, seed):
    """Seeded synthetic basin + flood map, as the suite's dtypes."""
    from descriptools_jax.utils.synthetic import synthetic_basin, synthetic_flood

    dem, fdr, river, fac = synthetic_basin(n, n, seed=seed)
    return dict(
        dem=dem.astype(np.int32), fdr=fdr, river=river,
        fac=fac.astype(np.int32), flood=synthetic_flood(dem, river),
    )


def _loaders(inp):
    return {k: (lambda ys, ye, xs, xe, a=a: a[ys:ye, xs:xe])
            for k, a in inp.items()}


def compare_outputs(got, want, what):
    """indices/HAND bitwise, floats within verify.TOLS of ``want``."""
    from descriptools_jax.verify import TOLS, float_mismatches

    bad = {k: int((np.asarray(got[k]) != np.asarray(want[k])).sum())
           for k in INT_KEYS}
    for k, (rtol, atol) in TOLS.items():
        bad[k] = int(float_mismatches(got[k], want[k], rtol, atol).sum())
    _log(f"[{what}] cells differing: {bad}")
    if any(bad.values()):
        raise CheckFailed(f"{what}: {bad}")


def phase_device():
    import jax

    from descriptools_jax.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    card = card_name_and_power_limit()
    for line in card:
        _log(line)
    _log(f"[device] kind={dev.device_kind} count={len(jax.devices())} "
         f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
         f" compile_cache={jax.config.jax_compilation_cache_dir}")
    return dev, card[0]


def phase_suite(inp, cfg, dev, card="", n_windows=16, win=256, halo=192):
    """Phase 2 on ``dev``; returns the suite's outputs as host arrays."""
    import jax

    from descriptools_jax.parallel import make_mesh
    from descriptools_jax.parallel.classify import sharded_classify_flood
    from descriptools_jax.pipeline import classify_flood, descriptor_suite
    from descriptools_jax.verify import sample_checks, streaming_flow_invariants

    shape = inp["dem"].shape
    args = [jax.device_put(inp[k], dev) for k in ("dem", "fdr", "fac", "river")]
    out, t_first = _timed(lambda: descriptor_suite(*args, cfg))
    _, t_steady = _timed(lambda: descriptor_suite(*args, cfg))
    _log(f"[suite] {shape[0]}x{shape[1]} first_call_s={t_first:.3f} "
         f"steady_s={t_steady:.4f} card={card}")
    off = sorted(k for k, v in out.items() if v.devices() != {dev})
    if off:
        raise CheckFailed(f"suite outputs not on {dev}: {off}")
    out = {k: np.asarray(v) for k, v in out.items()}

    loaders = _loaders(inp)
    t0 = time.perf_counter()
    checks = sample_checks(loaders, shape, out, cfg,
                           np.random.default_rng(SEED), n_windows, win, halo)
    _log(f"[suite] oracle windows: {len(checks['windows'])} ok={checks['ok']}"
         f" flow_cells={sum(w['flow_cells'] for w in checks['windows'])}"
         f" downslope_cells="
         f"{sum(w['downslope_cells'] for w in checks['windows'])}"
         f" host_s={time.perf_counter() - t0:.1f}")
    if not checks["ok"]:
        raise CheckFailed(f"oracle windows: {checks['failures'][:10]}")

    t0 = time.perf_counter()
    inv = streaming_flow_invariants(loaders, out, shape, cfg.px,
                                    cfg.flow_max_steps)
    _log(f"[suite] flow invariants: {inv['invariant_violations']} violations"
         f" over {inv['cells_checked']} cells"
         f" host_s={time.perf_counter() - t0:.1f}")
    if not inv["ok"]:
        raise CheckFailed(f"flow invariants: {inv['per_check']}")

    t0 = time.perf_counter()
    th, corr, fit, cm = classify_flood(out["hand"], inp["flood"])
    t_host = time.perf_counter() - t0
    mesh = make_mesh((1, 1), devices=[dev])
    (th_d, _, _, cm_d), t_dev = _timed(
        lambda: sharded_classify_flood(out["hand"], inp["flood"], mesh)
    )
    cm_bad = int((np.asarray(cm_d) != cm).sum())
    _log(f"[classify] threshold host={th} device={th_d} correctness={corr}"
         f" fit={fit} class_map_cells_differing={cm_bad}"
         f" host_s={t_host:.2f} device_first_call_s={t_dev:.3f} card={card}")
    if th_d != th or cm_bad:
        raise CheckFailed(f"classify: threshold {th_d} vs {th}, "
                          f"{cm_bad} class-map cells differ")
    return out


def phase_tiled(inp, cfg, want, tile, card=""):
    """Phase 3: tiled_suite against phase 2's outputs ``want``."""
    from descriptools_jax.tiled import tiled_suite

    shape = inp["dem"].shape
    loaders = _loaders({k: inp[k] for k in ("dem", "fdr", "river", "fac")})
    stats = {}
    got, t_first = _timed(lambda: tiled_suite(
        loaders, shape, cfg, tile_rows=tile, tile_cols=tile, stats=stats))
    _, t_steady = _timed(lambda: tiled_suite(
        loaders, shape, cfg, tile_rows=tile, tile_cols=tile))
    _log(f"[tiled] {shape[0]}x{shape[1]} tiles={stats['tiles']} "
         f"downslope_retries={stats['downslope_retries']} "
         f"first_call_s={t_first:.3f} steady_s={t_steady:.3f} card={card}")
    compare_outputs(got, want, "tiled vs suite")


def phase_four(inp, cfg, devices, card=""):
    """Phase 4: the staged suite over a 2x2 mesh of ``devices`` against
    descriptor_suite on ``devices[0]``."""
    import jax

    from descriptools_jax.parallel import make_mesh, sharded_suite_staged
    from descriptools_jax.pipeline import descriptor_suite

    shape = inp["dem"].shape
    mesh = make_mesh((2, 2), devices=devices)
    loaders = _loaders({k: inp[k] for k in ("dem", "fdr", "river", "fac")})

    def sharded():
        return sharded_suite_staged(mesh, shape, loaders, cfg)

    got, t_first = _timed(sharded)
    _, t_steady = _timed(sharded)
    _log(f"[four] {shape[0]}x{shape[1]} mesh=2x2 first_call_s={t_first:.3f}"
         f" steady_s={t_steady:.3f} card={card}")
    args = [jax.device_put(inp[k], devices[0])
            for k in ("dem", "fdr", "fac", "river")]
    want, t_one = _timed(lambda: descriptor_suite(*args, cfg))
    _log(f"[four] one-device suite first_call_s={t_one:.3f} card={card}")
    compare_outputs({k: np.asarray(v) for k, v in got.items()},
                    {k: np.asarray(v) for k, v in want.items()},
                    "2x2 mesh vs one device")


def result_line(devices):
    dev = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    import jax

    from descriptools_jax.pipeline import PipelineConfig

    dev, card = phase_device()
    cfg = PipelineConfig()
    devices = jax.devices()
    if args.chips == 4:
        if len(devices) < 4:
            raise CheckFailed(f"--chips 4 needs four GPUs, found {len(devices)}")
        t0 = time.perf_counter()
        inp = make_inputs(N4, SEED)
        _log(f"[four] inputs {N4}x{N4} host_s={time.perf_counter() - t0:.1f}")
        phase_four(inp, cfg, devices[:4], card)
    else:
        t0 = time.perf_counter()
        inp = make_inputs(N, SEED)
        _log(f"[suite] inputs {N}x{N} host_s={time.perf_counter() - t0:.1f}")
        out = phase_suite(inp, cfg, dev, card)
        phase_tiled(inp, cfg, out, TILE, card)
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
