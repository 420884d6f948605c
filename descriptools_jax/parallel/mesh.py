"""Device-mesh construction and raster padding for equal-block sharding."""

import math

import jax
import numpy as np

from descriptools_jax.constants import NODATA


def make_mesh(shape=None, devices=None, axis_names=("y", "x")):
    """Build a 2-D ``Mesh`` over the available devices.

    With no shape given, factorises the device count as close to square as
    possible (halo traffic scales with the perimeter of each block).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        py = int(math.sqrt(n))
        while n % py:
            py -= 1
        shape = (py, n // py)
    assert shape[0] * shape[1] == n, f"mesh {shape} != {n} devices"
    return jax.sharding.Mesh(np.asarray(devices).reshape(shape), axis_names)


def pad_to_mesh(arr, mesh, fill):
    """Pad a raster (bottom/right) so both dims divide the mesh shape.

    Padding with the NoData conventions (dem -> -100, fdr -> 0, river -> 0)
    is semantics-preserving for every descriptor: walks entering padding hit
    fdr==0 dead ends exactly like the reference's border exits, and stencils
    see -100 neighbours exactly like the reference's -100 halo ring
    (slope.py:175-182).
    """
    ny, nx = mesh.devices.shape
    r, c = arr.shape
    rp = (-r) % ny
    cp = (-c) % nx
    if rp == 0 and cp == 0:
        return arr
    return np.pad(np.asarray(arr), ((0, rp), (0, cp)), constant_values=fill)


def crop_from_mesh(arr, shape):
    """Undo pad_to_mesh."""
    return arr[: shape[0], : shape[1]]
