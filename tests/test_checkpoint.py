"""Checkpoint/resume: stage-boundary checkpoints make kill-and-resume
reproduce the uninterrupted run bitwise (SURVEY §5 — the reference keeps
every intermediate in RAM and restarts from zero)."""

from dataclasses import replace

import numpy as np
import pytest

import descriptools_jax.pipeline as pl
from descriptools_jax.pipeline import (
    PipelineConfig,
    descriptor_suite,
    run_suite_checkpointed,
)
from descriptools_jax.utils.synthetic import synthetic_basin

KEYS = (
    "slope", "twi", "mod_twi", "downslope",
    "fdist", "indices", "hand", "gfi", "ln_hl_h",
)


@pytest.fixture(scope="module")
def basin():
    dem, fdr, river, fac = synthetic_basin(64, 96, seed=11)
    return dem.astype(np.int32), fdr, fac.astype(np.int32), river


def test_checkpointed_matches_fused(tmp_path, basin):
    dem, fdr, fac, river = basin
    cfg = PipelineConfig()
    out = run_suite_checkpointed(dem, fdr, fac, river, cfg, str(tmp_path / "ck"))
    fused = descriptor_suite(dem, fdr, fac, river, cfg)
    for k in KEYS:
        got, want = np.asarray(out[k]), np.asarray(fused[k])
        if k in ("indices", "hand"):
            # Integer outputs are exact regardless of program partitioning.
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            # Floats: XLA fuses differently across the one-program and
            # per-stage partitionings (e.g. FMA formation) — allclose only.
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=k)


def test_kill_and_resume_bitwise(tmp_path, basin, monkeypatch):
    dem, fdr, fac, river = basin
    cfg = PipelineConfig()
    ckdir = str(tmp_path / "ck")
    ref = run_suite_checkpointed(dem, fdr, fac, river, cfg, str(tmp_path / "ref"))

    # First attempt dies inside the flow stage — stencil+walks are already
    # committed (atomic save), flow is not.
    def dying_flow(*a, **k):
        raise RuntimeError("simulated preemption")

    monkeypatch.setattr(pl, "flow_distance_index", dying_flow)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        run_suite_checkpointed(dem, fdr, fac, river, cfg, ckdir)
    monkeypatch.undo()

    # The resume must NOT recompute completed stages: poison the stencil op.
    def poisoned_slope(*a, **k):
        raise AssertionError("resume recomputed a completed stage")

    monkeypatch.setattr(pl, "slope", poisoned_slope)
    out = run_suite_checkpointed(dem, fdr, fac, river, cfg, ckdir)
    for k in KEYS:
        np.testing.assert_array_equal(
            np.asarray(out[k]), np.asarray(ref[k]), err_msg=k
        )


_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import descriptools_jax.pipeline as pl
from descriptools_jax.utils.synthetic import synthetic_basin
dem, fdr, river, fac = synthetic_basin(64, 96, seed=11)
if os.environ.get("CKPT_DIE") == "1":
    pl.flow_distance_index = lambda *a, **k: os._exit(3)
out = pl.run_suite_checkpointed(
    dem.astype(np.int32), fdr, fac.astype(np.int32), river,
    pl.PipelineConfig(), sys.argv[1],
)
np.savez(sys.argv[2], **{{k: np.asarray(v) for k, v in out.items()}})
"""


def test_real_process_kill_and_resume(tmp_path, basin):
    """A hard process death (os._exit, no cleanup) mid-pipeline must leave a
    resumable checkpoint dir; the rerun reproduces an uninterrupted run
    bitwise — the restart story a preempted cluster job needs."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _WORKER.format(repo=repo)
    ckdir = str(tmp_path / "ck")
    out_npz = str(tmp_path / "out.npz")
    env = dict(os.environ, CKPT_DIE="1")
    p = subprocess.run([sys.executable, "-c", code, ckdir, out_npz],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 3, p.stderr[-2000:]
    assert not os.path.exists(out_npz)
    env["CKPT_DIE"] = "0"
    p = subprocess.run([sys.executable, "-c", code, ckdir, out_npz],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]

    dem, fdr, fac, river = basin
    ref = run_suite_checkpointed(
        dem, fdr, fac, river, PipelineConfig(), str(tmp_path / "ref")
    )
    resumed = np.load(out_npz)
    for k in KEYS:
        np.testing.assert_array_equal(resumed[k], np.asarray(ref[k]), err_msg=k)


def test_manifest_guards_mismatched_resume(tmp_path, basin):
    dem, fdr, fac, river = basin
    cfg = PipelineConfig()
    ckdir = str(tmp_path / "ck")
    run_suite_checkpointed(dem, fdr, fac, river, cfg, ckdir)
    with pytest.raises(ValueError, match="different run"):
        run_suite_checkpointed(
            dem, fdr, fac, river,
            replace(cfg, elevation_difference=7.0), ckdir,
        )
