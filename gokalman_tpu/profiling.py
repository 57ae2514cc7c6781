"""Tracing, timing, device identity and the compile cache.

The reference has no profiling at all (SURVEY.md §5: only Go test
timing).  This provides jax.profiler traces viewable in
XProf/TensorBoard, a steady-state timing helper, the device record that
every benchmark result carries, and the one place that chooses the
persistent compile cache.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def setup_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX has already read it and
    this leaves the directory alone; otherwise the cache lives at the
    fixed path <repo>/.jax_cache (the path is part of the cache key, so
    a moving directory would never hit)."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return jax.config.jax_compilation_cache_dir


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info() -> dict:
    """The device record a benchmark result carries."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu_name_power_limit": gpu_name_and_power_limit(),
    }


def require_gpu() -> dict:
    """device_info(), or SystemExit when JAX found no GPU: a measurement
    never falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX platform is {info['platform']!r}; refusing to "
            "report device numbers")
    return info


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace: `with profiling.trace("/tmp/trace"): ...`"""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, warmup: int = 1, iters: int = 3):
    """Best-of-N steady-state wall time of a jitted function.

    Returns (best_seconds, last_output).  Compiles/warms up first so
    the measurement excludes tracing and compilation.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
        jax.block_until_ready(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)
