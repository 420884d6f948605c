"""Shard-aware checkpoint/resume for the staged sharded suite
(parallel/ckpt.py): a REAL multi-process kill after a stage checkpoint,
then resume — with the same process count and with a different one (the
cluster-repartition case) — completing bitwise without recomputing the
checkpointed stages.  Round-2 verdict, Missing #4 / SURVEY §5.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mp_ckpt_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(nprocs, ckpt_dir, kill_stage):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(i), str(nprocs),
             str(ckpt_dir), kill_stage],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _mtimes(ckpt_dir, stage):
    files = [f for f in os.listdir(ckpt_dir) if f.startswith(stage + ".")]
    assert files, f"no checkpoint files for stage {stage}"
    return {f: os.path.getmtime(os.path.join(ckpt_dir, f)) for f in files}


@pytest.mark.parametrize("resume_procs", [2, 1])
def test_kill_after_flow_then_resume(tmp_path, resume_procs):
    ckpt_dir = str(tmp_path / "ckpt")

    # Phase 1: 2 processes, both really killed right after the 'flow'
    # stage checkpoint lands.
    res = _launch(2, ckpt_dir, "flow")
    if not all(rc == 17 for rc, _ in res):
        # One retry: on the 2-core host under full-suite load, the
        # 2-process distributed init can time out before the kill point
        # (observed once); a genuine failure reproduces.
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)
        res = _launch(2, ckpt_dir, "flow")
    assert all(rc == 17 for rc, _ in res), res
    assert os.path.exists(os.path.join(ckpt_dir, "flow.DONE"))
    assert not os.path.exists(os.path.join(ckpt_dir, "downslope.DONE"))
    assert not os.path.exists(os.path.join(ckpt_dir, "pointwise.DONE"))
    before = {s: _mtimes(ckpt_dir, s) for s in ("flow",)}

    # Phase 2: resume — same process count, or ONE process re-reading the
    # two dead processes' shard blocks (block keys are global coordinates,
    # so host re-partitions resume cleanly).
    res = _launch(resume_procs, ckpt_dir, "-")
    for i, (rc, out) in enumerate(res):
        assert rc == 0 and f"CKPT WORKER {i} OK" in out, (
            f"worker {i} rc={rc}\n{out[-4000:]}"
        )
    # Checkpointed stages were loaded, not recomputed.
    for s in ("flow",):
        assert _mtimes(ckpt_dir, s) == before[s], f"stage {s} was recomputed"


def test_manifest_guards_mismatched_resume(tmp_path):
    """Resuming with a different mesh decomposition must fail loudly."""
    import numpy as np

    from descriptools_jax import oracle
    from descriptools_jax.constants import NODATA
    from descriptools_jax.parallel import make_mesh, sharded_suite_staged
    from descriptools_jax.pipeline import PipelineConfig
    from descriptools_jax.utils.synthetic import synthetic_basin

    dem, fdr, river, fac = synthetic_basin(45, 53, seed=5)
    rasters = dict(
        dem=dem.astype(np.int32), fdr=fdr, river=river, fac=fac.astype(np.int32)
    )
    loaders = {
        k: (lambda ys, ye, xs, xe, a=v: a[ys:ye, xs:xe])
        for k, v in rasters.items()
    }
    cfg = PipelineConfig()
    ckpt_dir = str(tmp_path / "ckpt")
    sharded_suite_staged(
        make_mesh((2, 4)), dem.shape, loaders, cfg, downslope_halo=8,
        crop=False, ckpt_dir=ckpt_dir,
    )
    with pytest.raises(ValueError, match="different run"):
        sharded_suite_staged(
            make_mesh((4, 2)), dem.shape, loaders, cfg, downslope_halo=8,
            crop=False, ckpt_dir=ckpt_dir,
        )
