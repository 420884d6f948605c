"""The staged multi-device path (sharded_suite_staged) at non-toy scale.

The staged N-host design had only ever run on toy grids (32x64 dryrun,
small multi-process tests) while the 1e9-cell run exercised the *tiled*
single-device path.  This harness runs the
ACTUAL staged suite — per-device shard staging via loaders, shard_map
boundary-ring flow, trunc-retry downslope, fused stencil+pointwise, psum
histogram classification, per-shard stage checkpoints — on the
8-virtual-device CPU mesh at 2048^2 (0.5M cells per shard), then verifies
EVERY integer output bitwise against the in-core single-device engines and
the classification against the host float64 classifier.

On real devices the same entry point runs unchanged over a device mesh;
the virtual run validates at-scale *behaviour* (collective layout, ring
volume, checkpoint size), not device speed — wall-clock here is bounded by
host serialization of the virtual devices.

Prints one JSON object.  Run: python scripts/staged_scale.py
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--mesh", type=int, nargs=2, default=[2, 4])
    args = ap.parse_args()

    import shutil
    import tempfile

    from descriptools_jax.constants import NODATA
    from descriptools_jax.parallel import make_mesh, sharded_suite_staged
    from descriptools_jax.pipeline import PipelineConfig, classify_flood
    from descriptools_jax.utils import provenance
    from descriptools_jax.utils.synthetic import windowed_basin

    n = args.n
    ny, nx = args.mesh
    shape = (n, n)
    cfg = PipelineConfig()
    mesh = make_mesh((ny, nx))
    loaders = windowed_basin(n, n, seed=21)

    ckpt_dir = tempfile.mkdtemp(prefix="staged_scale_")
    phases = {}

    def hook(name, compute):
        t0 = time.perf_counter()
        out = compute()
        for v in out.values():
            v.block_until_ready()
        phases[name] = round(time.perf_counter() - t0, 3)
        return out

    t0 = time.time()
    out = sharded_suite_staged(
        mesh, shape, loaders, cfg, downslope_halo=64, crop=False,
        ckpt_dir=ckpt_dir, stage_hook=hook,
    )
    wall = time.time() - t0
    ckpt_files = sorted(os.listdir(ckpt_dir))
    ckpt_bytes = sum(
        os.path.getsize(os.path.join(ckpt_dir, f)) for f in ckpt_files
    )

    # ---- bitwise verification vs the in-core single-device engines ------
    from descriptools_jax.ops import downslope as downslope_op
    from descriptools_jax.ops.flow import flow_distance_index, hand_and_river_fac
    from descriptools_jax.parallel.mesh import pad_to_mesh

    full = {k: loaders[k](0, n, 0, n) for k in loaders}
    demp = pad_to_mesh(full["dem"].astype(np.int32), mesh, NODATA)
    fdrp = pad_to_mesh(full["fdr"], mesh, 0)
    riverp = pad_to_mesh(full["river"], mesh, 0)
    facp = pad_to_mesh(full["fac"].astype(np.int32), mesh, NODATA)

    checks = dict(ok=True)

    def check(name, cond, detail=""):
        checks[name] = bool(cond)
        if not cond:
            checks["ok"] = False
            checks.setdefault("failures", []).append(f"{name} {detail}")

    fd0, ix0 = flow_distance_index(fdrp, riverp, cfg.px,
                                   max_steps=cfg.flow_max_steps)
    hd0, rf0 = hand_and_river_fac(demp, facp, ix0)
    dn0 = np.asarray(downslope_op(
        demp.astype(np.float32), fdrp, cfg.px, cfg.elevation_difference,
        max_steps=cfg.downslope_max_steps,
    ))
    want = {
        "indices": np.asarray(ix0), "hand": np.asarray(hd0),
        "downslope": dn0, "river_fac": np.asarray(rf0),
    }
    for key, w in want.items():
        same = all(
            np.array_equal(np.asarray(s.data), w[s.index])
            for s in out[key].addressable_shards
        )
        check(f"bitwise_{key}", same)
    fd_ok = all(
        np.allclose(np.asarray(s.data), np.asarray(fd0)[s.index],
                    rtol=1e-6, atol=1e-3, equal_nan=True)
        for s in out["fdist"].addressable_shards
    )
    check("fdist_allclose", fd_ok)

    floodp = pad_to_mesh(full["flood"].astype(np.int32), mesh, NODATA)
    th, corr, fitv, cmap = classify_flood(np.asarray(hd0), floodp)
    check("threshold_identical", out["threshold"] == th,
          f"{out['threshold']} vs {th}")
    check("fit_identical", out["fit"] == fitv)
    cm_ok = all(
        np.array_equal(np.asarray(s.data), cmap[s.index])
        for s in out["class_map"].addressable_shards
    )
    check("bitwise_class_map", cm_ok)

    # ---- resume path: a fresh call must load every stage, recompute none -
    import descriptools_jax.parallel.ckpt as _ck

    saves = []
    orig = _ck.save_stage_sharded
    _ck.save_stage_sharded = lambda p, a: saves.append(p) or orig(p, a)
    try:
        t0 = time.time()
        out2 = sharded_suite_staged(
            mesh, shape, loaders, cfg, downslope_halo=64, crop=False,
            ckpt_dir=ckpt_dir,
        )
        t_resume = time.time() - t0
    finally:
        _ck.save_stage_sharded = orig
    check("resume_recomputed_nothing", len(saves) == 0, str(saves))
    check("resume_threshold_identical", out2["threshold"] == th)

    cells = n * n
    result = {
        **provenance.stamp(REPO),
        "backend": jax.default_backend(),
        "mesh": f"{ny}x{nx}",
        "devices": ny * nx,
        "grid": [n, n],
        "cells": cells,
        "per_shard_cells": cells // (ny * nx),
        "wall_s": round(wall, 1),
        "resume_wall_s": round(t_resume, 1),
        "grid_points_per_s": round(cells / wall, 1),
        "phase_seconds": phases,
        "ckpt_files": len(ckpt_files),
        "ckpt_bytes": int(ckpt_bytes),
        "note": (
            "virtual CPU devices: validates the staged multi-device path's "
            "at-scale behaviour (shard staging, ring collective, trunc "
            "retry, psum classification, per-shard ckpt/resume) bitwise vs "
            "the in-core engines; wall-clock is host-bound"
        ),
        "checks": checks,
        "ok": checks["ok"],
    }
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(json.dumps(result))
    print("STAGED", "OK" if checks["ok"] else "FAIL")
    return 0 if checks["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
