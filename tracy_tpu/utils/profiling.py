"""Profiling helper: a jax.profiler trace around a block.

The reference self-meters with a stopwatch and ray counters
(SURVEY.md §5 tracing/profiling); the device-side equivalent is a profiler
trace (view in TensorBoard / Perfetto).
"""

from __future__ import annotations

import contextlib
import time

import jax

from tracy_tpu.utils.log import log


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block into `log_dir`.

    View with: tensorboard --logdir <log_dir>  (or open the
    .trace.json.gz in ui.perfetto.dev).
    """
    jax.profiler.start_trace(log_dir)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log(f"profiler trace ({time.perf_counter() - t0:.2f}s) -> {log_dir}")
