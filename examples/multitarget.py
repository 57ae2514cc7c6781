"""Multi-target serving demo: thousands of independent trackers as one
fused device computation.

The reference runs side-by-side filters as separate mutable structs in
a Go loop (examples/jerkcar/main.go:133-161 runs 3).  Here S = 4096
independent 4-state constant-velocity targets share one (time-varying)
measurement schedule and are filtered by ops.ensemble.filter_bank — a
single lax.scan whose covariance path is computed once, with per-target
work reduced to broadcast matvecs.  This is the serving shape: one
compiled program, states resident on device, O(n·S) streaming I/O.

Run:  python examples/multitarget.py [outdir]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import gokalman_tpu as gk
from gokalman_tpu.ops.ensemble import filter_bank


def main(outdir="."):
    n, p, t, s = 4, 2, 500, 4096
    dt = 0.1
    f = jnp.array(
        [[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1.0]]
    )
    h = jnp.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])  # position fix
    q = 1e-3 * jnp.eye(n)
    r = 0.25 * jnp.eye(p)
    x0 = jnp.zeros(n)
    p0 = jnp.diag(jnp.array([25.0, 25.0, 4.0, 4.0]))

    # Simulate S targets with random initial states + process noise.
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((s, n)) * np.sqrt(np.diag(np.asarray(p0)))
    lq = np.linalg.cholesky(np.asarray(q))
    ys = np.empty((t, p, s))
    for k in range(t):
        xs = xs @ np.asarray(f).T + rng.standard_normal((s, n)) @ lq.T
        ys[k] = (xs[:, :p] + 0.5 * rng.standard_normal((s, p))).T
    truth_final = xs

    model, state0 = gk.vanilla.new(x0, p0, f, None, h, gk.noise.awgn(q, r))
    bank = jax.jit(lambda m, st, y: filter_bank(m, st, y))
    # Stage the measurement block on device first (serving systems feed
    # measurements on-device; a host->device copy would swamp the
    # compute timing).
    ys_dev = jax.device_put(jnp.asarray(ys))
    states, innovs, _ = bank(model, state0, ys_dev)
    jax.block_until_ready(states)

    t0 = time.perf_counter()
    states, innovs, _ = bank(model, state0, ys_dev)
    sync = float(states[-1, 0, 0])
    wall = time.perf_counter() - t0

    err = np.asarray(states[-1]).T - truth_final  # [S, n]
    pos_rmse = float(np.sqrt((err[:, :2] ** 2).sum(1).mean()))
    print(f"{s} targets x {t} steps in {wall*1e3:.1f} ms "
          f"({s * t / wall:.3g} tracker-steps/s)")
    print(f"final position RMSE over {s} targets: {pos_rmse:.3f} "
          f"(measurement sigma 0.5)")
    np.save(os.path.join(outdir, "multitarget_states.npy"),
            np.asarray(states))
    print(f"wrote {outdir}/multitarget_states.npy")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
