"""End-to-end descriptor pipeline — the framework's driver.

Replaces the reference's Example/example.py (its only "API"): computes the
full descriptor suite in dependency order, then calibrates/validates a flood
map.  Device-resident: one jitted program computes every descriptor; only
raster I/O and the exact float64 calibration run on host.

Dependency DAG (Example/example.py:59-91):
    slope -> TWI/mod-TWI;  fdr -> downslope;  fdr+river -> fdist,indices ->
    HAND -> GFI;  indices+fac -> river-fac -> GFI;  hand+fac -> ln(hl/H);
    HAND -> calibration -> classified map.
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from descriptools_jax import evaluation
from descriptools_jax.constants import DOWNSLOPE_MAX_STEPS, FLOW_MAX_STEPS, NODATA
from descriptools_jax.ops import (
    downslope,
    ln_hl_h,
    slope,
    topographic_index,
    modified_topographic_index,
)
from descriptools_jax.ops.flow import flow_distance_index, hand_and_river_fac
from descriptools_jax.ops.gfi import gfi as _gfi


@dataclass(frozen=True)
class PipelineConfig:
    """Physics constants of the suite (reference call-site values,
    Example/example.py:45-91)."""

    px: float = 12.5
    elevation_difference: float = 5.0  # downslope potential-energy drop [m]
    n_topo: float = 0.1  # modified-TWI exponent
    n_gfi: float = 0.4  # GFI / ln(hl/H) exponent
    b_gfi: float = 0.1  # GFI / ln(hl/H) scale factor
    river_threshold: int = 128000  # fac cells above this are river
    downslope_max_steps: int = DOWNSLOPE_MAX_STEPS
    flow_max_steps: int = FLOW_MAX_STEPS


@partial(jax.jit, static_argnames=("cfg",))
def descriptor_suite(dem, fdr, fac, river, cfg: PipelineConfig):
    """All descriptors in one compiled program.

    dem should be an integer dtype for bitwise HAND parity with the
    reference golden (the example feeds int16).
    """
    dem_f = jnp.asarray(dem, jnp.float32)
    sl = slope(dem_f, cfg.px)
    sl_rad = jnp.where(dem_f == NODATA, jnp.float32(NODATA), jnp.arctan(sl / 100.0))
    twi = topographic_index(fac, sl_rad, cfg.px)
    mtwi = modified_topographic_index(fac, sl_rad, cfg.px, cfg.n_topo)
    down = downslope(
        dem_f, fdr, cfg.px, cfg.elevation_difference,
        max_steps=cfg.downslope_max_steps,
    )
    fdist, indices = flow_distance_index(
        fdr, river, cfg.px, max_steps=cfg.flow_max_steps
    )
    hand, river_fac = hand_and_river_fac(dem, fac, indices)
    geofi = _gfi(hand, river_fac, cfg.n_gfi, cfg.b_gfi, cfg.px)
    lnhlh = ln_hl_h(hand, fac, cfg.n_gfi, cfg.b_gfi, cfg.px)
    return dict(
        slope=sl,
        slope_rad=sl_rad,
        twi=twi,
        mod_twi=mtwi,
        downslope=down,
        fdist=fdist,
        indices=indices,
        hand=hand,
        gfi=geofi,
        ln_hl_h=lnhlh,
    )


def run_suite_checkpointed(dem, fdr, fac, river, cfg: PipelineConfig, ckpt_dir):
    """Descriptor suite with durable stage-boundary checkpoints.

    Each stage saves its rasters to ``ckpt_dir`` (orbax when present, atomic
    .npz otherwise); a rerun after a kill resumes after the last COMPLETE
    stage and reproduces the uninterrupted outputs bitwise (stages recompute
    from exact saved inputs; see tests/test_checkpoint.py).  A manifest
    guards against resuming with a different grid or physics config.

    The fused ``descriptor_suite`` stays the fast path — use this driver
    when wall-clock per stage is long enough that restart-from-zero hurts
    (the 1e9-cell configs; SURVEY §5's checkpoint/resume obligation).
    """
    import os

    from dataclasses import asdict

    from descriptools_jax.utils import checkpoint as ckpt

    dem = jnp.asarray(dem)
    fdr = jnp.asarray(fdr)
    fac = jnp.asarray(fac)
    river = jnp.asarray(river)
    manifest = dict(
        shape=list(np.asarray(dem.shape)), dem_dtype=str(dem.dtype),
        **{k: (v if isinstance(v, (int, float, str)) else str(v))
           for k, v in asdict(cfg).items()},
    )
    manifest["shape"] = [int(s) for s in manifest["shape"]]
    ckpt.check_manifest(ckpt_dir, manifest)

    state = {}

    def stage(name, fn):
        path = os.path.join(ckpt_dir, name)
        if ckpt.stage_exists(path):
            state.update(ckpt.load_stage(path))
            return
        out = {k: np.asarray(v) for k, v in fn().items()}
        ckpt.save_stage(path, out)
        state.update(out)

    dem_f = jnp.asarray(dem, jnp.float32)

    def _stencil():
        sl = slope(dem_f, cfg.px)
        sl_rad = jnp.where(
            dem_f == NODATA, jnp.float32(NODATA), jnp.arctan(sl / 100.0)
        )
        return dict(
            slope=sl,
            slope_rad=sl_rad,
            twi=topographic_index(fac, sl_rad, cfg.px),
            mod_twi=modified_topographic_index(fac, sl_rad, cfg.px, cfg.n_topo),
        )

    def _walks():
        return dict(downslope=downslope(
            dem_f, fdr, cfg.px, cfg.elevation_difference,
            max_steps=cfg.downslope_max_steps,
        ))

    def _flow():
        fdist, indices = flow_distance_index(
            fdr, river, cfg.px, max_steps=cfg.flow_max_steps
        )
        hand, river_fac = hand_and_river_fac(dem, fac, indices)
        return dict(fdist=fdist, indices=indices, hand=hand, river_fac=river_fac)

    def _pointwise():
        return dict(
            gfi=_gfi(state["hand"], state["river_fac"], cfg.n_gfi, cfg.b_gfi, cfg.px),
            ln_hl_h=ln_hl_h(state["hand"], fac, cfg.n_gfi, cfg.b_gfi, cfg.px),
        )

    stage("stencil", _stencil)
    stage("walks", _walks)
    stage("flow", _flow)
    stage("pointwise", _pointwise)
    return state


def classify_flood(hand, flood, under="under"):
    """Calibrate a threshold on HAND and classify, exactly like
    Example/example.py:106-147.  Returns (threshold, correctness, fit,
    class_map uint8) — class_map is the golden ``hand_class.tif`` artifact.
    """
    hand = np.asarray(hand)
    elements = np.unique(hand)
    mx = elements[-1]
    mn = elements[1]  # elements[0] is the -100 NoData sentinel
    # Float64 scaling on host, matching the reference arithmetic exactly.
    from descriptools_jax import oracle

    desc = oracle.min_max_scale_oracle(hand, mn, mx)
    th = evaluation.calibration(desc, flood, under, backend="numpy")
    binary = oracle.binary_map_oracle(desc, th, under)
    c, f, class_map = oracle.confusion_oracle(binary, flood)
    return th, c, f, class_map.astype(np.uint8)


def run_example(example_dir, cfg: PipelineConfig = PipelineConfig()):
    """Full pipeline on the bundled basin; returns descriptors + classification."""
    from descriptools_jax.io import load_example_inputs

    data = load_example_inputs(example_dir)
    out = descriptor_suite(
        jnp.asarray(data["dem"], jnp.int32),
        jnp.asarray(data["fdr"]),
        jnp.asarray(data["fac"], jnp.int32),
        jnp.asarray(data["river"]),
        cfg,
    )
    out = {k: np.asarray(v) for k, v in out.items()}
    th, c, f, class_map = classify_flood(out["hand"], data["flood"])
    out.update(threshold=th, correctness=c, fit=f, class_map=class_map)
    return out
