"""Test harness config.

Tests run on the CPU with 8 virtual devices, so multi-device sharding
code paths are exercised without accelerators (SURVEY.md §4.8), and
with x64 enabled for 1e-9-level parity against the float64 gonum
reference semantics.  JAX_PLATFORMS defaults to cpu; tests marked
`gpu` skip there and run on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Quiet XLA:CPU's cpu_aot_loader LOG(ERROR) spam when persistent-cache
# entries are loaded (it flags the synthetic prefer-no-scatter/-gather
# "features" as a machine mismatch; the load succeeds — verified by the
# warm-run speedup — and real failures still surface as Python
# exceptions).
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402

from gokalman_tpu import profiling  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent on-disk compilation cache: warm reruns of the suite skip
# XLA:CPU codegen, roughly halving wall time, and cache hits bypass the
# LLVM codegen path that has crashed late in long single-process runs.
profiling.setup_compile_cache(min_compile_time_secs=0.0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip tests marked `gpu` unless JAX's first device is a GPU."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")
