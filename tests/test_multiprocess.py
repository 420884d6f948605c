"""Multi-process execution tests: N jax.distributed CPU processes run the
staged sharded suite (tests/mp_worker.py) and verify their addressable
shards.  This is the multi-host story the reference never had (it is
single-GPU; SURVEY §2.10) exercised for real — process-group init, per-host
staging, cross-process collectives (Gloo on CPU, NCCL across GPUs).

Workers regenerate identical inputs per process and compare against the
single-device engines, so passing at nprocs=1 and nprocs=2 proves bitwise
indices/HAND across process counts.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("nprocs", [1, 2])
def test_staged_suite_across_process_counts(nprocs):
    port = _free_port()
    env = os.environ.copy()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(i), str(nprocs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER {i} OK" in out, (
            f"worker {i} rc={p.returncode}\n{out[-4000:]}"
        )
