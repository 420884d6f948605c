"""Provenance stamps for measurement and verification records.

Every record a script writes embeds ``stamp()``: the git rev, whether the
compute-path sources differ from it, the JAX version and the time.
"""

import subprocess
import time

# Files whose change invalidates a recorded measurement: everything on the
# compute path (engines, pipeline wiring, constants).
ENGINE_PATHS = (
    "descriptools_jax/ops",
    "descriptools_jax/parallel",
    "descriptools_jax/pipeline.py",
    "descriptools_jax/d8.py",
    "descriptools_jax/constants.py",
    "descriptools_jax/evaluation.py",
    "descriptools_jax/oracle",
)


def _git(repo_root, *args):
    out = subprocess.run(
        ["git", *args], capture_output=True, text=True, cwd=repo_root
    )
    return out.returncode, out.stdout.strip()


def git_rev(repo_root):
    rc, rev = _git(repo_root, "rev-parse", "HEAD")
    return rev if rc == 0 else None


def stamp(repo_root):
    """Provenance dict to merge into every evidence artifact."""
    import jax

    rev = git_rev(repo_root)
    rc, _ = _git(repo_root, "diff", "--quiet", "HEAD", "--", *ENGINE_PATHS)
    return {
        "rev": rev,
        "engine_sources_dirty": bool(rc != 0) if rev else None,
        "jax_version": jax.__version__,
        "time_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
