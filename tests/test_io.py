"""Raster I/O: read/write round trips and reference nodata normalisation."""

import os

import numpy as np
import pytest

from descriptools_jax.io import load_example_inputs, normalise_nodata, read_raster, write_raster

EXAMPLE = "/root/reference/Example"


def test_write_read_roundtrip(tmp_path):
    arr = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = str(tmp_path / "x.tif")
    write_raster(p, arr)
    got = read_raster(p)
    np.testing.assert_array_equal(got, arr)


@pytest.mark.skipif(not os.path.isdir(EXAMPLE), reason="bundled basin missing")
def test_write_with_geotiff_template(tmp_path):
    from PIL import Image

    arr = np.zeros((2178, 1534), np.uint8)
    p = str(tmp_path / "geo.tif")
    write_raster(p, arr, template=f"{EXAMPLE}/input/12_dem.tif", nodata=0)
    out = Image.open(p)
    src = Image.open(f"{EXAMPLE}/input/12_dem.tif")
    # pixel scale + tiepoint tags survive
    for tag in (33550, 33922):
        if tag in src.tag_v2:
            assert tuple(out.tag_v2[tag]) == tuple(src.tag_v2[tag])
    assert out.tag_v2[42113] == "0"


def test_normalise_nodata_cast_semantics():
    # float32 -3.4e38 -> int16 cast -> 0 -> corner-probe -> -100
    a = np.full((4, 4), -3.4e38, np.float32)
    a[1:, 1:] = 345.0
    with np.errstate(invalid="ignore"):
        out = normalise_nodata(a, cast="int16")
    assert out[0, 0] == -100 and out[2, 2] == 345


@pytest.mark.skipif(not os.path.isdir(EXAMPLE), reason="bundled basin missing")
def test_load_example_inputs_contract():
    data = load_example_inputs(EXAMPLE)
    assert data["dem"].dtype == np.int16
    assert (data["dem"] == -100).sum() == 1771049
    assert data["river"].sum() == 3265
    assert data["px"] == 12.5
