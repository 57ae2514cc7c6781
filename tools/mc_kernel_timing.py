"""Time the fused Monte-Carlo kernel against the XLA pipelines on the GPU.

Runs the 6-state CV tracker of bench.py at 98,304 runs x 1,000 steps:

- `ops.ensemble.mc_chi_square` (the lax.scan pipeline, covariance path
  included);
- `ops.pallas_mc.mc_chi_square_reference` (the kernel's own pipeline
  with identical counter noise, compiled by XLA);
- `ops.pallas_mc.mc_chi_square_pallas` end to end (covariance path
  included) and with the path precomputed, for each tile given.

Each time is the median of --reps warm runs, each ending in
block_until_ready.  Prints one JSON object per line.

    python tools/mc_kernel_timing.py [--reps 12] [--tiles 32,64,128]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gokalman_tpu import profiling
from gokalman_tpu.ops import ensemble, pallas_mc

import bench


def median_ms(fn, arg, reps):
    jax.block_until_ready(fn(arg))
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg + i + 1))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times)), 1e3 * min(times), 1e3 * max(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--tiles", default=str(pallas_mc.TILE))
    ap.add_argument("--samples", type=int, default=bench.SAMPLES)
    ap.add_argument("--steps", type=int, default=bench.STEPS)
    args = ap.parse_args()
    profiling.setup_compile_cache()
    print(json.dumps(profiling.device_info()), flush=True)
    model, st = bench.make_model()
    s, t = args.samples, args.steps

    def row(name, fn, arg):
        t0 = time.perf_counter()
        out = fn(arg)
        jax.block_until_ready(out)
        first = time.perf_counter() - t0
        med, lo, hi = median_ms(fn, arg, args.reps)
        print(json.dumps({"name": name, "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "first_call_s": first,
                          "reps": args.reps, "samples": s, "steps": t}),
              flush=True)
        return out

    xla = jax.jit(lambda k: ensemble.mc_chi_square(
        model, st, s, t, jax.random.PRNGKey(k), init_spread=True,
        lagged_measurements=False))
    ref = jax.jit(lambda k: pallas_mc.mc_chi_square_reference(
        model, st, s, t, k))
    row("xla_mc_chi_square", xla, jnp.int32(0))
    r_out = row("xla_counter_reference", ref, jnp.int32(0))
    path = pallas_mc.precompute_path(model, st, t)
    for tile in (int(v) for v in args.tiles.split(",")):
        e2e = jax.jit(lambda k, tile=tile: pallas_mc.mc_chi_square_pallas(
            model, st, s, t, k, tile=tile))
        pre = jax.jit(lambda k, tile=tile: pallas_mc.mc_chi_square_pallas(
            model, st, s, t, k, tile=tile, path=path))
        k_out = row(f"kernel_e2e_tile{tile}", e2e, jnp.int32(0))
        row(f"kernel_path_precomputed_tile{tile}", pre, jnp.int32(0))
        diff = {f: float(np.max(np.abs(np.asarray(getattr(k_out, f))
                                       - np.asarray(getattr(r_out, f)))))
                for f in k_out._fields}
        print(json.dumps({"name": f"kernel_vs_reference_tile{tile}",
                          "max_abs_diff": diff}), flush=True)


if __name__ == "__main__":
    main()
