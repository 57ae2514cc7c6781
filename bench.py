"""Headline benchmark: 100k-ensemble 6-state CKF Monte-Carlo + chi-square.

Batched filter steps per second for a 98,304-run, 1,000-step, 6-state
CKF Monte-Carlo ensemble on one GPU.  One "filter step" = one (run,
time-step) pair; each step here performs strictly more work than the
reference's pure-predictor loop -- it fuses AWGN truth generation, a
full noiseless CKF replay update, and the NEES/NIS consistency
statistics (the SURVEY.md §3.2 pipeline), so the count is conservative.

Runs in one process and refuses to run without a GPU.  Prints exactly
one JSON line carrying the device it ran on:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}
"""

import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

import gokalman_tpu as gk

SAMPLES = 98_304  # 100k-class ensemble
STEPS = 1_000
DTYPE = jnp.float32


def make_model():
    """6-state 3D constant-velocity tracker, H = position, discretized
    with Van Loan (the 6x6 statOD-scale system of BASELINE.md)."""
    dt = 0.1
    i3 = jnp.eye(3, dtype=DTYPE)
    z3 = jnp.zeros((3, 3), dtype=DTYPE)
    a = jnp.block([[z3, i3], [z3, z3]])
    gamma = jnp.concatenate([z3, i3], axis=0)
    w = 0.02 * i3
    f, q, _ = gk.c2d.van_loan(a, gamma, w, dt, check_nyquist=False)
    f = f.astype(DTYPE)
    q = q.astype(DTYPE)
    h = jnp.concatenate([i3, z3], axis=1)
    r = 0.5 * i3
    x0 = jnp.zeros(6, dtype=DTYPE)
    p0 = jnp.eye(6, dtype=DTYPE)
    return gk.vanilla.new(x0, p0, f, None, h, gk.noise.awgn(q, r))


def smoother_streams(b_streams, t_steps, seed=42):
    """b_streams independent truth/measurement streams of the 6-state
    model: (model, state0, xs [B, T, 6], ys [B, T, 3])."""
    model, state0 = make_model()
    lq, lr = model.noise.sqrt_q, model.noise.sqrt_r

    def gen(k):
        k1, k2 = jax.random.split(k)
        wn = jax.random.normal(k1, (t_steps, 6), DTYPE) @ lq.T
        vn = jax.random.normal(k2, (t_steps, 3), DTYPE) @ lr.T

        def body(x, inp):
            w, v = inp
            xn = model.f @ x + w
            return xn, (xn, model.h @ xn + v)

        _, (xs, ys) = jax.lax.scan(body, state0.x, (wn, vn))
        return xs, ys

    xs, ys = jax.jit(jax.vmap(gen))(
        jax.random.split(jax.random.PRNGKey(seed), b_streams))
    jax.block_until_ready((xs, ys))
    return model, state0, xs, ys


def smoother_bench(b_streams=256, t_steps=1024, prefix="smoother",
                   r_hi=3):
    """Secondary metric: the O(log T) associative-scan filter+RTS
    smoother (ops/assoc_scan) on the same 6-state model, batched over
    streams (reference anchor: SmoothAll srif.go:165-192).

    Slope-timed like the headline (R=1 vs R=r_hi repeats inside one
    jit, single scalar-read sync): the marginal cost per repeat, with
    the fixed per-call dispatch cost subtracted.  Gated on the smoother
    actually smoothing: smoothed truth-RMSE < filtered truth-RMSE.

    Called at two shapes: the serving batch (256 x 1024) and the
    long-T single-sequence regime (16 x 65536, the parallel-in-time
    point the time-sharded distributed scan targets).
    """
    from gokalman_tpu.ops import assoc_scan

    def stage(msg):
        print(f"[{prefix}] {msg} @{time.perf_counter() - _t_start:.0f}s",
              file=sys.stderr, flush=True)

    _t_start = time.perf_counter()
    model, state0, xs, ys = smoother_streams(b_streams, t_steps)
    stage("truth generated")

    def run_once(y):
        means, covs = assoc_scan.filter_parallel(model, state0, y)
        sm, _ = assoc_scan.smooth_parallel(model, means, covs)
        return means, sm

    def make(repeats):
        @jax.jit
        def fn(shift):
            outs = [jax.vmap(run_once)(jnp.roll(ys, shift + i, axis=0))
                    for i in range(repeats)]
            means = sum(o[0] for o in outs)
            sms = sum(o[1] for o in outs)
            return means, sms

        return fn

    f1, fh = make(1), make(r_hi)
    means, sms = f1(jnp.int32(0))
    jax.block_until_ready((means, sms))
    stage("R=1 compiled+run")
    jax.block_until_ready(fh(jnp.int32(0)))
    stage(f"R={r_hi} compiled+run")
    # Gate (unrolled from the R=1 outputs at shift 0).
    rmse_f = float(jnp.sqrt(jnp.mean((means - xs) ** 2)))
    rmse_s = float(jnp.sqrt(jnp.mean((sms - xs) ** 2)))

    def timed(fn, s):
        t0 = time.perf_counter()
        out = fn(jnp.int32(s))
        _ = float(out[1][-1, -1, 0])  # single scalar read = sync
        return time.perf_counter() - t0

    t1 = min(timed(f1, s) for s in (1, 2, 3, 4))
    th = min(timed(fh, s) for s in (1, 2, 3, 4))
    stage("timing done")
    marginal = max((th - t1) / (r_hi - 1), 1e-9)
    steps = b_streams * t_steps
    return {
        f"{prefix}_steps_per_sec": steps / marginal,
        f"{prefix}_kernel_ms": 1e3 * marginal,
        f"{prefix}_shape": [b_streams, t_steps],
        f"{prefix}_rmse_filtered": rmse_f,
        f"{prefix}_rmse_smoothed": rmse_s,
        f"{prefix}_gate_pass": bool(rmse_s < rmse_f),
    }


def l96_scenario(n_members, t_cycles):
    """Lorenz-96 (n=40, F=8) twin experiment: every second site observed
    with unit noise, Gaspari-Cohn localization (radius 4), inflation
    1.04.  Returns (run_once(obs, key) -> analysis means [T, 40], truth
    [T, 40], observations [T, 20])."""
    from gokalman_tpu.filters import enkf

    n_state, forcing, dt = 40, 8.0, 0.05

    def l96_deriv(x):
        return (jnp.roll(x, -1) - jnp.roll(x, 2)) * jnp.roll(x, 1) \
            - x + forcing

    def l96_step(x):
        k1 = l96_deriv(x)
        k2 = l96_deriv(x + 0.5 * dt * k1)
        k3 = l96_deriv(x + 0.5 * dt * k2)
        k4 = l96_deriv(x + dt * k3)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    h_idx = jnp.arange(0, n_state, 2)  # observe 20 of 40
    hx = lambda x: x[h_idx]

    @jax.jit
    def gen(key):
        x = jnp.full((n_state,), forcing, DTYPE).at[0].add(0.01)
        x = jax.lax.fori_loop(0, 400, lambda _, s: l96_step(s), x)
        _, truth = jax.lax.scan(lambda s, _: (l96_step(s),) * 2, x,
                                None, length=t_cycles)
        obs = truth[:, h_idx] + jax.random.normal(
            key, (t_cycles, h_idx.shape[0]), DTYPE)
        return truth, obs

    truth, ys = gen(jax.random.PRNGKey(7))
    jax.block_until_ready((truth, ys))

    p = h_idx.shape[0]
    noise = gk.noise.awgn(jnp.zeros((n_state, n_state), DTYPE),
                          jnp.eye(p, dtype=DTYPE))

    def cyc_dist(a, b):
        d = jnp.abs(a[:, None] - b[None, :])
        return jnp.minimum(d, n_state - d)

    sites = jnp.arange(n_state, dtype=DTYPE)
    loc_xy = enkf.gaspari_cohn(cyc_dist(sites, sites[h_idx]), 4.0)
    loc_yy = enkf.gaspari_cohn(cyc_dist(sites[h_idx], sites[h_idx]), 4.0)
    x0 = truth[0] + 2.0 * jax.random.normal(jax.random.PRNGKey(8),
                                            (n_state,), DTYPE)
    s0 = enkf.new(x0, 4.0 * jnp.eye(n_state, dtype=DTYPE), n_members,
                  key=jax.random.PRNGKey(9))

    def run_once(obs, key):
        _, est = enkf.run(noise, s0, obs, l96_step, hx, key=key,
                          inflation=1.04, loc_xy=loc_xy, loc_yy=loc_yy)
        return est.state

    return run_once, truth, ys


def enkf_l96_bench(n_members=1024, t_cycles=300, prefix="enkf_l96"):
    """Secondary metric: EnKF on Lorenz-96 — the high-dimensional
    data-assimilation flagship and the one workload in the repo whose
    hot path is matrix-product shaped (anomaly matmuls [n, N] x [N, p]
    at serving ensemble sizes, see filters/enkf.py module docstring;
    scenario identical to tests/test_enkf_lorenz96.py but f32 at
    N=1024).

    Slope-timed (R=1 vs R=5 scans in one jit, one scalar-read sync)
    like the other rows.  Gated on the classic DA
    result: analysis RMSE below the observation noise (sigma = 1) with
    half the state observed — throughput with a diverged filter would
    be meaningless.
    """
    def stage(msg):
        print(f"[{prefix}] {msg} @{time.perf_counter() - _t_start:.0f}s",
              file=sys.stderr, flush=True)

    _t_start = time.perf_counter()
    run_once, truth, ys = l96_scenario(n_members, t_cycles)
    stage("truth generated")
    n_state = truth.shape[1]

    def make(repeats):
        @jax.jit
        def fn(shift):
            outs = [run_once(jnp.roll(ys, shift + i, axis=0),
                             jax.random.PRNGKey(20 + i))
                    for i in range(repeats)]
            return sum(outs)

        return fn

    # R=1 vs R=5, not R=3: four intervals double the signal against
    # per-call jitter; the retry loop + degenerate flag make a
    # noise-eaten slope impossible to mistake for a measurement.
    r_hi = 5
    f1, f5 = make(1), make(r_hi)
    mean1 = f1(jnp.int32(0))
    jax.block_until_ready(mean1)
    stage("R=1 compiled+run")
    jax.block_until_ready(f5(jnp.int32(0)))
    stage(f"R={r_hi} compiled+run")
    rmse = float(jnp.sqrt(jnp.mean((mean1 - truth)[t_cycles // 3:] ** 2)))

    def timed(fn, s):
        t0 = time.perf_counter()
        out = fn(jnp.int32(s))
        _ = float(out[-1, 0])
        return time.perf_counter() - t0

    slope = 0.0
    for attempt in range(3):
        t1 = min(timed(f1, s) for s in (1, 2, 3, 4, 5))
        t5 = min(timed(f5, s) for s in (1, 2, 3, 4, 5))
        slope = t5 - t1
        if slope > 1e-3:
            break
        stage(f"degenerate slope {slope * 1e3:.2f} ms, retrying")
    degenerate = slope <= 1e-3
    marginal = max(slope / (r_hi - 1), 1e-9)
    return {
        f"{prefix}_member_steps_per_sec": n_members * t_cycles / marginal,
        f"{prefix}_cycles_per_sec": t_cycles / marginal,
        f"{prefix}_kernel_ms": 1e3 * marginal,
        f"{prefix}_shape": [n_members, n_state, t_cycles],
        f"{prefix}_rmse": rmse,
        f"{prefix}_slope_degenerate": bool(degenerate),
        f"{prefix}_gate_pass": bool(rmse < 1.0 and not degenerate),
    }


def main():
    info = gk.profiling.require_gpu()
    gk.profiling.setup_compile_cache()
    model, state0 = make_model()

    # The fused kernel (ops/pallas_mc.py): the whole runs x steps
    # pipeline in one launch, member states in registers, counter-based
    # noise.  The covariance path (gains + NEES/NIS weights) depends
    # only on the model, never the seed: compute it once, like loading
    # model weights, so steady-state experiment throughput is the
    # kernel launch.
    from gokalman_tpu.ops.pallas_mc import mc_chi_square_pallas, precompute_path

    path = precompute_path(model, state0, STEPS)
    jax.block_until_ready(path)

    def make_pipeline(repeats):
        # `repeats` back-to-back experiments (distinct seeds) inside ONE
        # jitted call, stats averaged; timing two repeat counts and
        # taking the slope measures the marginal per-experiment cost.
        @jax.jit
        def pipeline(seed0):
            outs = [
                mc_chi_square_pallas(model, state0, SAMPLES, STEPS,
                                     seed0 + jnp.int32(1000 * i),
                                     init_spread=True, path=path)
                for i in range(repeats)
            ]
            return jax.tree.map(lambda *xs: sum(xs) / repeats, *outs)

        return pipeline

    pipeline = make_pipeline(1)
    res = pipeline(jnp.int32(0))
    jax.block_until_ready(res)

    # Sanity: consistency statistics must be in range or the speed is
    # meaningless.
    nees_tail = float(jnp.mean(res.nees_means[STEPS // 2 :]))
    nis_tail = float(jnp.mean(res.nis_means[STEPS // 2 :]))
    assert 5.0 < nees_tail < 7.0, f"NEES {nees_tail} out of range (expect ~6)"
    assert 2.5 < nis_tail < 3.5, f"NIS {nis_tail} out of range (expect ~3)"

    def timed(fn, arg):
        t0 = time.perf_counter()
        out = fn(arg)
        nees_last = float(out.nees_means[-1])
        assert 5.0 < nees_last < 7.0, nees_last
        return time.perf_counter() - t0

    # Two-point slope: sustained per-experiment cost with the fixed
    # per-call dispatch+read overhead subtracted.
    r_lo, r_hi = 1, 5
    keys = [1, 2, 3, 4, 5, 6]
    hi = make_pipeline(r_hi)
    jax.block_until_ready(hi(jnp.int32(0)))  # compile
    t_lo = min(timed(pipeline, jnp.int32(s)) for s in keys)
    t_hi = min(timed(hi, jnp.int32(s)) for s in keys)
    marginal = max((t_hi - t_lo) / (r_hi - r_lo), 1e-9)

    # Secondary rows after the headline, one after another in this
    # process.
    fields = {}
    fields.update(smoother_bench())
    fields.update(smoother_bench(16, 65536, prefix="smoother_longT", r_hi=2))
    fields.update(enkf_l96_bench())
    steps = SAMPLES * STEPS
    print(
        json.dumps(
            {
                "metric": "ckf_mc_chi_square_steps_per_sec",
                "value": steps / marginal,
                "unit": "filter_steps/s",
                "per_launch": steps / t_lo,
                "dispatch_overhead_ms": 1e3 * (t_lo - marginal),
                "kernel_ms": 1e3 * marginal,
                "nees_tail": nees_tail,
                "nis_tail": nis_tail,
                "n_timed": 2 * len(keys),
                "backend": "pallas_triton",
                "device": info,
                **fields,
            }
        )
    )
    gates = [k for k in fields if k.endswith("_gate_pass")]
    assert all(fields[k] for k in gates), "secondary accuracy gates failed"


if __name__ == "__main__":
    main()
