"""Stage checkpointing for long pipelines (SURVEY §5: the reference keeps
every intermediate in RAM; at 1e9 cells the descriptor stages need durable,
shard-aware checkpoints).

Uses orbax-checkpoint when available (async, sharding-preserving, the
standard JAX multi-host restart path); falls back to .npz written atomically
(tmp + rename), so a kill mid-write never leaves a stage that looks
complete.  The pipeline driver (pipeline.run_suite_checkpointed) saves at
every stage boundary and resumes after the last complete stage.
"""

import json
import os

import numpy as np

try:  # pragma: no cover - environment probe
    import orbax.checkpoint as ocp

    _HAS_ORBAX = True
except Exception:  # pragma: no cover
    _HAS_ORBAX = False


def save_stage(path, arrays):
    """Save a dict of rasters for one pipeline stage (atomic)."""
    if _HAS_ORBAX:
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(path), arrays, force=True)
        ckptr.wait_until_finished()
    else:
        tmp = path + ".npz.tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp, path + ".npz")


def stage_exists(path):
    """True when a COMPLETE stage checkpoint exists at ``path``."""
    if _HAS_ORBAX and os.path.isdir(path):
        return True
    return os.path.exists(path + ".npz")


def load_stage(path, like=None):
    """Load a stage checkpoint.  ``like`` (a matching pytree of arrays or
    ShapeDtypeStructs) restores shardings under orbax."""
    if _HAS_ORBAX and os.path.isdir(path):
        ckptr = ocp.StandardCheckpointer()
        if like is not None:
            return ckptr.restore(os.path.abspath(path), like)
        return ckptr.restore(os.path.abspath(path))
    data = np.load(path + ".npz")
    return {k: data[k] for k in data.files}


def check_manifest(ckpt_dir, manifest):
    """Write (or validate against) the run manifest so a resume cannot mix
    checkpoints from a different grid or config."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "manifest.json")
    if os.path.exists(path):
        with open(path) as fh:
            have = json.load(fh)
        if have != manifest:
            raise ValueError(
                f"checkpoint dir {ckpt_dir} belongs to a different run:\n"
                f"  stored:  {have}\n  current: {manifest}"
            )
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, path)
