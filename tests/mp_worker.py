"""Worker process for the multi-process jax.distributed CPU test.

Launched by tests/test_multiprocess.py as one of N processes, each owning
8//N virtual CPU devices.  Initialises the distributed runtime (the same
handshake a multi-host cluster uses), stages a synthetic basin per-host via
sharded_suite_staged — no process materialises a global raster — and checks
every ADDRESSABLE shard of every output against a locally computed
single-device expectation (the grid is tiny, so each worker can afford the
full local recompute; at scale only the staged path exists).

Bitwise contract: indices / HAND / river_fac integer-exact vs single-device;
floats allclose (f32 summation order).  SURVEY §4's multi-process pledge.
"""

import os
import sys

N_GLOBAL_DEVICES = 8


def main():
    port, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
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

    from descriptools_jax.constants import NODATA
    from descriptools_jax.ops import downslope, flow_distance_index, slope
    from descriptools_jax.ops.flow import hand_and_river_fac
    from descriptools_jax.parallel import make_mesh, sharded_suite_staged
    from descriptools_jax.parallel.mesh import pad_to_mesh
    from descriptools_jax.pipeline import PipelineConfig
    from descriptools_jax.utils.synthetic import synthetic_basin

    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == N_GLOBAL_DEVICES, len(jax.devices())

    # Deterministic inputs, regenerated identically in every process (45x53
    # does not divide the mesh -> the padded staging path is exercised too).
    dem, fdr, river, fac = synthetic_basin(45, 53, seed=5)
    shape = dem.shape
    cfg = PipelineConfig()
    # Synthetic flood benchmark derived from the (deterministic) HAND so the
    # staged classification has a meaningful threshold to find.
    from descriptools_jax import oracle

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

    mesh = make_mesh()  # (2, 4) over the 8 global devices
    out = sharded_suite_staged(
        mesh, shape, loaders, cfg, downslope_halo=8, crop=False
    )

    # Local single-device expectation on the identically padded grid.
    demp = pad_to_mesh(rasters["dem"], mesh, NODATA)
    fdrp = pad_to_mesh(rasters["fdr"], mesh, 0)
    riverp = pad_to_mesh(rasters["river"], mesh, 0)
    facp = pad_to_mesh(rasters["fac"], mesh, NODATA)
    exp = {}
    exp["slope"] = np.asarray(slope(demp.astype(np.float32), cfg.px))
    fd, ix = flow_distance_index(fdrp, riverp, cfg.px)
    hd, rf = hand_and_river_fac(demp, facp, ix)
    exp["fdist"], exp["indices"] = np.asarray(fd), np.asarray(ix)
    exp["hand"], exp["river_fac"] = np.asarray(hd), np.asarray(rf)
    exp["downslope"] = np.asarray(
        downslope(demp.astype(np.float32), fdrp, cfg.px, cfg.elevation_difference)
    )

    exact = {"indices", "hand"}
    for key, want in exp.items():
        got = out[key]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        for shard in got.addressable_shards:
            data = np.asarray(shard.data)
            ref = want[shard.index]
            if key in exact:
                np.testing.assert_array_equal(data, ref, err_msg=key)
            else:
                np.testing.assert_allclose(
                    data, ref, rtol=1e-5, atol=1e-4, err_msg=key
                )

    # Staged classification (psum confusion histograms, parallel/classify.py)
    # must reproduce the host float64 classifier exactly — threshold, scores,
    # and the class map bitwise per shard (reference evaluation.py:5-211).
    from descriptools_jax.pipeline import classify_flood

    floodp = pad_to_mesh(flood.astype(np.int32), mesh, NODATA)
    th, corr, fitv, cmap = classify_flood(exp["hand"], floodp)
    assert out["threshold"] == th, (out["threshold"], th)
    assert out["correctness"] == corr and out["fit"] == fitv
    for shard in out["class_map"].addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard.data), cmap[shard.index], err_msg="class_map"
        )
    print(f"WORKER {pid} OK ({nprocs} processes)")


if __name__ == "__main__":
    main()
