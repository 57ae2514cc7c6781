"""The GPU harness pieces that run without a card: the compile-cache
helper, the device record, and chip_smoke.py refusing to run (and
printing no result) where JAX finds no GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from gokalman_tpu import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = (
    "import jax, jax.numpy as jnp\n"
    "from gokalman_tpu import profiling\n"
    "print(profiling.setup_compile_cache(min_compile_time_secs=0.0))\n"
    "jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) @ x)"
    "(jnp.ones((8, 8))))\n"
)


def _run(args, env_extra=None, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in drop and k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    if cwd == REPO:
        env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def test_compile_cache_defaults_to_repo_dir():
    out = _run(["-c", PROBE], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[0] == profiling.REPO_CACHE_DIR


def test_compile_cache_honours_env_dir(tmp_path):
    cache = tmp_path / "cache"
    out = _run(["-c", PROBE], {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[0] == str(cache)
    assert any(cache.iterdir()), "nothing cached in JAX_COMPILATION_CACHE_DIR"


def test_device_info_and_require_gpu_on_cpu():
    info = profiling.device_info()
    assert info["platform"] == jax.devices()[0].platform
    assert info["device_count"] == len(jax.devices())
    if info["platform"] == "gpu":
        pytest.skip("checks a host without a GPU")
    with pytest.raises(SystemExit, match="no GPU"):
        profiling.require_gpu()


def test_chip_smoke_refuses_cpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script fails too."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
