"""Shard-aware stage checkpoints for the staged sharded suite (SURVEY §5).

``pipeline.run_suite_checkpointed`` materialises global rasters per stage on
the host — fine single-host, impossible at the 1e9-cell staged target
(round-2 verdict, Missing #4).  Here every process writes only its own
ADDRESSABLE shard blocks:

  <ckpt_dir>/<stage>.p<process>.npz     one atomic file per process, members
                                        keyed "<name>@<ys>:<ye>:<xs>:<xe>"
                                        (GLOBAL padded-grid block coords)
  <ckpt_dir>/<stage>.DONE               completion marker written by process
                                        0 AFTER a global barrier confirms
                                        every process's file landed; carries
                                        array dtypes/shapes + file count

Because members are keyed by global block coordinates — not by process — a
resume may use a DIFFERENT process count over the same device-mesh shape:
each process scans every stage file and reads only the members its own
addressable shards need (npz reads are lazy per member).  Restart therefore
works across host re-partitions, the cluster-restart case SURVEY §5 names.

A kill at ANY point is safe: block files appear atomically (tmp + rename)
and a stage without its DONE marker is recomputed — deterministic engines
make overwrites idempotent.  The resume decision is taken by process 0 and
broadcast (multihost_utils), so no process can branch differently on a
half-written directory.

Why not orbax here: orbax-checkpoint is present and is the standard
multi-host path, but its async coordinator adds nothing for synchronous stage saves
and its restore path needs abstract-array/sharding plumbing per call site;
the explicit block format keeps resume-across-process-counts testable and
transparent.  The single-host driver (utils/checkpoint.py) still prefers
orbax when importable.
"""

import glob
import json
import os

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import NamedSharding, PartitionSpec as P


def _barrier(tag):
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(tag)


def _agree(flag):
    """Process-0's bool, everywhere (consistent resume decisions)."""
    if jax.process_count() == 1:
        return bool(flag)
    return bool(
        multihost_utils.broadcast_one_to_all(np.asarray(flag, np.int32))
    )


def _key(name, index, gshape):
    ys = index[0].start or 0
    xs = index[1].start or 0
    ye = gshape[0] if index[0].stop is None else index[0].stop
    xe = gshape[1] if index[1].stop is None else index[1].stop
    return f"{name}@{ys}:{ye}:{xs}:{xe}"


def stage_done(path):
    return os.path.exists(path + ".DONE")


def save_stage_sharded(path, arrays):
    """Save a dict of P('y','x')-sharded global jax.Arrays, one file per
    process.  Collective: every process must call it."""
    pid = jax.process_index()
    _barrier(f"ckpt-clean:{path}")
    if pid == 0:
        # Stale files from a killed run with a different process count would
        # otherwise survive next to the fresh ones (harmless — deterministic
        # recompute writes identical blocks — but confusing); clear them.
        for f in glob.glob(f"{path}.p*.npz"):
            os.remove(f)
        if os.path.exists(path + ".DONE"):
            os.remove(path + ".DONE")
    _barrier(f"ckpt-cleaned:{path}")

    blocks, meta = {}, {}
    for name, arr in arrays.items():
        meta[name] = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
        for sh in arr.addressable_shards:
            blocks[_key(name, sh.index, arr.shape)] = np.asarray(sh.data)
    tmp = f"{path}.p{pid}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **blocks)
    os.replace(tmp, f"{path}.p{pid}.npz")

    _barrier(f"ckpt-wrote:{path}")
    if pid == 0:
        tmp = path + ".DONE.tmp"
        with open(tmp, "w") as fh:
            json.dump({"arrays": meta, "files": jax.process_count()}, fh)
        os.replace(tmp, path + ".DONE")
    _barrier(f"ckpt-done:{path}")


def load_stage_sharded(path, mesh):
    """Rebuild the stage's global sharded arrays; each process reads only
    the npz members its addressable shards cover (lazy per-member reads),
    regardless of which process wrote them."""
    with open(path + ".DONE") as fh:
        meta = json.load(fh)["arrays"]
    catalog = {}
    for f in sorted(glob.glob(f"{path}.p*.npz")):
        z = np.load(f)
        for k in z.files:
            catalog[k] = z
    sharding = NamedSharding(mesh, P("y", "x"))

    out = {}
    for name, m in meta.items():
        gshape = tuple(m["shape"])

        def cb(index, name=name, gshape=gshape):
            k = _key(name, index, gshape)
            if k not in catalog:
                raise ValueError(
                    f"checkpoint block {k} missing — the mesh decomposition "
                    f"changed; resume with the same mesh shape"
                )
            return catalog[k][k]

        out[name] = jax.make_array_from_callback(gshape, sharding, cb)
    return out


def stage_hook(ckpt_dir, mesh, manifest):
    """Stage hook for ``sharded_suite(..., stage_hook=...)``: load complete
    stages, compute + save incomplete ones.  ``manifest`` guards against
    resuming with a different grid/config/mesh decomposition
    (utils.checkpoint.check_manifest; identical-content writes race safely)."""
    from descriptools_jax.utils.checkpoint import check_manifest

    os.makedirs(ckpt_dir, exist_ok=True)
    check_manifest(ckpt_dir, manifest)
    resumed = []

    def hook(name, compute):
        path = os.path.join(ckpt_dir, name)
        if _agree(stage_done(path)):
            resumed.append(name)
            return load_stage_sharded(path, mesh)
        out = compute()
        save_stage_sharded(path, out)
        return out

    hook.resumed = resumed
    return hook
