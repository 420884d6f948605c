"""Test configuration: run on CPU with 8 virtual devices so the
multi-device sharding paths execute without accelerators (SURVEY §4).
``jax.config.update`` pins the platform even where the environment
preselects another one.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
