"""descriptools_jax — a terrain-descriptor engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
JVBSouza/descriptools (the Numba-CUDA flood-descriptor toolbox): slope, TWI,
modified TWI, downslope index, flow distance / river indices / HAND, GFI,
ln(hl/H), and the linear-binary flood classifier with coarse-to-fine
calibration.  Serial per-cell D8 walks are recast as frontier sweeps and
log-depth pointer jumping; stencils are fused elementwise passes; multi-device
execution decomposes the grid over a 2-D device mesh with halo exchange and a
boundary-graph reduction for cross-shard flow paths
(descriptools_jax.parallel).
"""

__version__ = "0.1.0"

import os

import jax

from descriptools_jax import constants, d8, evaluation, io, ops
from descriptools_jax.constants import NODATA

__all__ = ["constants", "d8", "evaluation", "io", "ops", "NODATA", "__version__"]

# Persistent XLA compilation cache, so a later process reuses the walk
# programs' compiled code.  ``JAX_COMPILATION_CACHE_DIR``, when set, is left
# to JAX; otherwise the cache lives in ``<checkout>/.jax_cache`` (JAX creates
# the directory on its first write).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
