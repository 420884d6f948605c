"""Multi-device execution: 2-D mesh domain decomposition.

The reference's "parallelism" is a serial host-side tile loop for out-of-core
fitting (SURVEY §2.10).  Here tiles become *shards running concurrently* on a
``Mesh(('y','x'))``:

- stencils: shard_map + 1-cell halo exchange (lax.ppermute)
- flow tracing: per-shard pointer jumping to shard edges, then a tiny
  replicated *boundary-graph ring reduction* — the device-resident generalisation
  of the reference's host-side boundary presolve (flowhand.py:282-286) and
  chain-on-exit protocol (flowhand.py:622-795)
- pointwise maps & metrics: plain jit over sharded arrays (XLA partitions
  elementwise ops and psum-reduces histograms automatically)
"""

from descriptools_jax.parallel.mesh import make_mesh, pad_to_mesh, crop_from_mesh
from descriptools_jax.parallel.halo import halo_exchange
from descriptools_jax.parallel.sharded import (
    sharded_slope,
    sharded_flow_hand,
    sharded_downslope,
    sharded_suite,
    sharded_suite_staged,
)

__all__ = [
    "make_mesh",
    "pad_to_mesh",
    "crop_from_mesh",
    "halo_exchange",
    "sharded_slope",
    "sharded_flow_hand",
    "sharded_downslope",
    "sharded_suite",
    "sharded_suite_staged",
]
