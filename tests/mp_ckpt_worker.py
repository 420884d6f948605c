"""Worker for the multi-process shard-aware checkpoint/resume test.

argv: port pid nprocs ckpt_dir kill_stage
  kill_stage != "-" : run sharded_suite_staged with ckpt_dir and os._exit(17)
                      right after that stage's checkpoint completes (the
                      whole-job preemption a cluster restart recovers from).
  kill_stage == "-" : run to completion, verify every integer output bitwise
                      against the single-device engines and the staged
                      classification against the host float64 classifier.

No mocking beyond wrapping the save function to pull the plug — the kill is
a real os._exit, the resume a fresh process (SURVEY §5 failure/restart).
"""

import os
import sys

N_GLOBAL_DEVICES = 8


def main():
    port, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    ckpt_dir, kill_stage = sys.argv[4], sys.argv[5]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={N_GLOBAL_DEVICES // nprocs}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(
            f"localhost:{port}", num_processes=nprocs, process_id=pid
        )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np

    from descriptools_jax import oracle
    from descriptools_jax.constants import NODATA
    from descriptools_jax.parallel import make_mesh, sharded_suite_staged
    from descriptools_jax.parallel import ckpt as shckpt
    from descriptools_jax.pipeline import PipelineConfig
    from descriptools_jax.utils.synthetic import synthetic_basin

    if kill_stage != "-":
        orig = shckpt.save_stage_sharded

        def save_then_die(path, arrays):
            orig(path, arrays)
            if os.path.basename(path) == kill_stage:
                os._exit(17)

        shckpt.save_stage_sharded = save_then_die

    dem, fdr, river, fac = synthetic_basin(45, 53, seed=5)
    shape = dem.shape
    cfg = PipelineConfig()
    _, idx0 = oracle.flow_distance_index_oracle(fdr, river, cfg.px)
    hand0 = oracle.hand_oracle(dem.astype(np.int32), idx0)
    flood = ((hand0 != NODATA) & (hand0 <= 5)).astype(np.uint8)
    rasters = dict(
        dem=dem.astype(np.int32), fdr=fdr, river=river,
        fac=fac.astype(np.int32), flood=flood,
    )
    loaders = {
        k: (lambda ys, ye, xs, xe, a=v: a[ys:ye, xs:xe])
        for k, v in rasters.items()
    }

    mesh = make_mesh((2, 4))
    out = sharded_suite_staged(
        mesh, shape, loaders, cfg, downslope_halo=8, crop=False,
        ckpt_dir=ckpt_dir,
    )

    # Completion path: verify like mp_worker (integers bitwise).
    from descriptools_jax.ops import downslope, flow_distance_index
    from descriptools_jax.ops.flow import hand_and_river_fac
    from descriptools_jax.parallel.mesh import pad_to_mesh
    from descriptools_jax.pipeline import classify_flood

    demp = pad_to_mesh(rasters["dem"], mesh, NODATA)
    fdrp = pad_to_mesh(rasters["fdr"], mesh, 0)
    riverp = pad_to_mesh(rasters["river"], mesh, 0)
    facp = pad_to_mesh(rasters["fac"], mesh, NODATA)
    _, ix = flow_distance_index(fdrp, riverp, cfg.px)
    hd, _ = hand_and_river_fac(demp, facp, ix)
    dn = np.asarray(
        downslope(demp.astype(np.float32), fdrp, cfg.px, cfg.elevation_difference)
    )
    for key, want in [("indices", np.asarray(ix)), ("hand", np.asarray(hd)),
                      ("downslope", dn)]:
        for shard in out[key].addressable_shards:
            np.testing.assert_array_equal(
                np.asarray(shard.data), want[shard.index], err_msg=key
            )
    floodp = pad_to_mesh(flood.astype(np.int32), mesh, NODATA)
    th, corr, fitv, cmap = classify_flood(np.asarray(hd), floodp)
    assert out["threshold"] == th and out["fit"] == fitv
    for shard in out["class_map"].addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard.data), cmap[shard.index], err_msg="class_map"
        )
    print(f"CKPT WORKER {pid} OK ({nprocs} processes)")


if __name__ == "__main__":
    main()
