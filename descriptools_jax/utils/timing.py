"""Timing / profiling helpers.

``timeit`` ends every timed call in ``jax.block_until_ready``, so it times
the device work and not just the enqueue.  ``trace()`` wraps jax.profiler
for TensorBoard / Perfetto traces (SURVEY §5: the reference has no
profiling at all; timings for its paper were measured externally).
"""

import contextlib
import time

import jax


def timeit(fn, *args, warmup=1, iters=3, **kwargs):
    """Median wall-clock seconds of ``fn(*args)``, each call blocked until
    its outputs are ready on the device."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def trace(logdir):
    """jax.profiler trace context (view with TensorBoard or Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
