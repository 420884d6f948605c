"""Multi-host execution support.

The reference is strictly single-process / single-GPU (SURVEY §2.10); this
module is the from-scratch distributed runtime layer: process-group
initialisation, a global 2-D mesh spanning all hosts' devices, and
host-local raster staging so each process only ever materialises its own
shards (mandatory at the 1e9-cell target).

Usage on a multi-host cluster (one process per host):

    from descriptools_jax.parallel import multihost
    multihost.initialize()                    # jax.distributed handshake
    mesh = multihost.global_mesh()            # Mesh over ALL devices
    dem = multihost.stage_global(mesh, loader)  # per-host shard loading
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed.initialize with env-based defaults (idempotent)."""
    if jax.process_count() > 1:
        return  # already initialised
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # Single-process run (tests, one host): nothing to do.
        pass


def global_mesh(shape=None, axis_names=("y", "x")):
    """2-D mesh over every device of every process.

    Defaults to (num_hosts * local_y, local_x)-style near-square layout via
    parallel.mesh.make_mesh on the global device list.
    """
    from descriptools_jax.parallel.mesh import make_mesh

    return make_mesh(shape=shape, devices=jax.devices(), axis_names=axis_names)


def stage_padded(mesh, shape, fill, block_loader, dtype):
    """Stage a global raster PADDED to a mesh-divisible shape.

    ``block_loader(ys, ye, xs, xe)`` reads a window in ORIGINAL raster
    coordinates; positions beyond ``shape`` (the bottom/right padding the
    equal-block decomposition needs) are filled with ``fill`` — the same
    NoData conventions as parallel.mesh.pad_to_mesh, but applied per-block
    so no process ever holds the global raster.
    """
    ny, nx = mesh.devices.shape
    R = -(-shape[0] // ny) * ny
    C = -(-shape[1] // nx) * nx
    sharding = NamedSharding(mesh, P("y", "x"))

    def cb(index):
        ys = index[0].start or 0
        xs = index[1].start or 0
        ye = index[0].stop if index[0].stop is not None else R
        xe = index[1].stop if index[1].stop is not None else C
        blk = np.full((ye - ys, xe - xs), fill, dtype)
        rye, rxe = min(ye, shape[0]), min(xe, shape[1])
        if ys < shape[0] and xs < shape[1]:
            blk[: rye - ys, : rxe - xs] = np.asarray(
                block_loader(ys, rye, xs, rxe), dtype=dtype
            )
        return blk

    return jax.make_array_from_callback((R, C), sharding, cb)


def stage_global(mesh, shape, dtype, block_loader):
    """Assemble a global sharded array without any host holding it whole.

    ``block_loader(ys, ye, xs, xe) -> np.ndarray`` reads one block from
    disk (e.g. a windowed GeoTIFF/Zarr read).  Each process loads only the
    blocks its local devices own (jax.make_array_from_callback), so peak
    host memory is grid_size / num_hosts.
    """
    sharding = NamedSharding(mesh, P("y", "x"))

    def cb(index):
        ys, xs = index[0].start or 0, index[1].start or 0
        ye = index[0].stop if index[0].stop is not None else shape[0]
        xe = index[1].stop if index[1].stop is not None else shape[1]
        return np.asarray(block_loader(ys, ye, xs, xe), dtype=dtype)

    return jax.make_array_from_callback(tuple(shape), sharding, cb)
