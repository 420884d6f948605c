"""Provenance stamps embedded in measurement records."""

import os

from descriptools_jax.utils import provenance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stamp_fields():
    s = provenance.stamp(REPO)
    assert s["rev"] and isinstance(s["rev"], str)
    assert "engine_sources_dirty" in s
    assert s["jax_version"]
