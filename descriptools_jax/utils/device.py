"""The accelerator a measurement runs on.

Every speed figure this repository reports comes from a GPU, so measuring
code refuses any other device instead of falling back to the CPU, and names
the card (its power limit sets how fast it can run under load).
"""

import subprocess

import jax


def require_gpu():
    """JAX's first device, or SystemExit when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})"
        )
    return dev


def card_name_and_power_limit():
    """``nvidia-smi``'s ``name, power.limit`` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()
