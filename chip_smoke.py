"""Smoke run of gokalman_tpu's main path on the GPU, at deployment sizes.

    python chip_smoke.py            # six phases on one GPU
    python chip_smoke.py --chips 4  # only the sharded pipelines, four GPUs

One GPU, six phases, each checked against the repo's plain reference:

1. Monte-Carlo consistency campaign through the XLA pipeline
   (ops.ensemble.mc_chi_square), 98,304 runs x 1,000 steps, f32:
   NEES/NIS tail gates.
2. The same campaign through the fused kernel (ops.pallas_mc): the
   same gates, per-step mean/stddev/NEES/NIS traces within 6 Monte-Carlo
   standard errors of phase 1, and agreement with its jnp replica
   (identical counter noise).
3. vanilla.run over a 1,000-step stream in f32 against the float64 numpy
   oracle of the tests.
4. Associative-scan filter + smoother, 256 streams x 1,024 steps,
   against the sequential vanilla.run + RTS smoother.
5. Lorenz-96 EnKF with 1,024 members: analysis RMSE < 1.
6. A 24 h LEO SRIF orbit-determination arc in float64: the reference's
   gates (position RMS < 1e-3 km, velocity RMS < 1e-6 km/s).

Every phase prints one line with its result, tolerance and matmul
precision; compile time is reported per phase and in total.  Any failed
gate raises, so the script exits non-zero.  Without a GPU it exits
non-zero before printing any result.  The last line of standard output
is one JSON object naming the device.
"""

import argparse
import json
import os
import sys
import time

import jax

HIGHP = "float32 (linalg.highp: full f32, no TF32)"
N_MC, T_MC = 98_304, 1_000


def _phase_runner(compile_times):
    """run(name, fn, *args): AOT-compile fn, run it once, and return its
    output with (compile_s, run_s) recorded."""
    def run(name, fn, *args):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).trace(*args).lower().compile()
        t1 = time.perf_counter()
        out = compiled(*args)
        jax.block_until_ready(out)
        t2 = time.perf_counter()
        compile_times[name] = t1 - t0
        return out, t1 - t0, t2 - t1

    return run


def _report(name, ok_text, precision, compile_s, run_s):
    print(f"phase {name}: PASS {ok_text}; precision {precision}; "
          f"compile {compile_s:.1f} s; run {run_s:.3f} s", flush=True)


def _tail_gates(res, label):
    nees = float(res.nees_means[T_MC // 2:].mean())
    nis = float(res.nis_means[T_MC // 2:].mean())
    assert 5.0 < nees < 7.0, f"{label}: NEES tail {nees} not in (5, 7)"
    assert 2.5 < nis < 3.5, f"{label}: NIS tail {nis} not in (2.5, 3.5)"
    return (f"NEES tail {nees:.4f} in (5, 7), NIS tail {nis:.4f} in "
            f"(2.5, 3.5)")


def single_gpu_phases():
    import jax.numpy as jnp
    import numpy as np

    import bench
    import gokalman_tpu as gk
    from gokalman_tpu.filters import smoothing
    from gokalman_tpu.ops import assoc_scan, pallas_mc

    compile_times = {}
    run = _phase_runner(compile_times)
    model, st = bench.make_model()

    # 1. XLA Monte-Carlo pipeline.
    res1, c, r = run("mc_chi_square_xla", lambda key: gk.ops.ensemble
                     .mc_chi_square(model, st, N_MC, T_MC, key,
                                    init_spread=True,
                                    lagged_measurements=False),
                     jax.random.PRNGKey(0))
    _report("1 mc_chi_square_xla", f"{N_MC}x{T_MC} f32; "
            + _tail_gates(res1, "xla"), HIGHP, c, r)

    # 2. Fused kernel, same campaign, another noise stream.
    res2, c, r = run("mc_chi_square_pallas", lambda seed: pallas_mc
                     .mc_chi_square_pallas(model, st, N_MC, T_MC, seed),
                     np.int32(3))
    gates = _tail_gates(res2, "kernel")
    sd = np.asarray(res1.stddev, np.float64)
    n, p = sd.shape[1], model.h.shape[0]
    # Independent campaigns: each difference has standard error
    # sqrt(2) x the per-campaign one.
    z = {
        "mean": np.abs(np.asarray(res2.mean) - np.asarray(res1.mean))
        / (np.sqrt(2.0 / N_MC) * sd),
        "stddev": np.abs(np.asarray(res2.stddev) - sd)
        / (sd / np.sqrt(N_MC - 1.0)),
        "nees": np.abs(np.asarray(res2.nees_means)
                       - np.asarray(res1.nees_means))
        / np.sqrt(4.0 * n / N_MC),
        "nis": np.abs(np.asarray(res2.nis_means)
                      - np.asarray(res1.nis_means)) / np.sqrt(4.0 * p / N_MC),
    }
    worst = {k: float(v.max()) for k, v in z.items()}
    assert max(worst.values()) < 6.0, f"kernel vs XLA traces: {worst}"
    rep = jax.jit(lambda seed: pallas_mc.mc_chi_square_reference(
        model, st, N_MC, T_MC, seed))(np.int32(3))
    scale = float(np.max(np.asarray(rep.stddev)))
    diff = max(float(np.max(np.abs(np.asarray(getattr(res2, f))
                                   - np.asarray(getattr(rep, f)))))
               for f in res2._fields)
    tol = 1e-4 * max(scale, 6.0)
    assert diff < tol, f"kernel vs jnp replica: {diff} >= {tol}"
    _report("2 mc_chi_square_pallas",
            f"{N_MC}x{T_MC} f32, Triton kernel; {gates}; traces vs phase "
            f"1 max |z| " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      worst.items())
            + f" (tol 6 MC standard errors); vs jnp replica with identical "
            f"noise max |diff| {diff:.2e} (tol {tol:.1e})",
            "f32 scalar FMAs (no matmuls); covariance path " + HIGHP, c, r)

    # 3. vanilla.run, f32 on the card, against the float64 numpy oracle.
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from fixtures import NumpyCKF

    _, _, xs, ys = bench.smoother_streams(1, T_MC)
    ests, c, r = run("vanilla_run", lambda y: gk.vanilla.run(
        model, st, measurements=y)[1], ys[0])
    oracle = NumpyCKF(st.x, st.p, model.f, None, model.h, model.noise.q,
                      model.noise.r)
    ref = [oracle.update(y) for y in np.asarray(ys[0], np.float64)]
    x_ref = np.stack([o["x"] for o in ref])
    p_ref = np.stack([o["p"] for o in ref])
    x_err = float(np.max(np.abs(np.asarray(ests.state) - x_ref))
                  / np.max(np.abs(x_ref)))
    p_err = float(np.max(np.abs(np.asarray(ests.covariance) - p_ref))
                  / np.max(np.abs(p_ref)))
    assert x_err < 1e-4 and p_err < 1e-4, (x_err, p_err)
    _report("3 vanilla_run", f"{T_MC} steps f32 vs float64 numpy oracle: "
            f"max state err {x_err:.2e}, max covariance err {p_err:.2e} "
            "relative to the largest entry (tol 1e-4)", HIGHP, c, r)

    # 4. Parallel-in-time filter + smoother vs sequential filter + RTS.
    b, t = 256, 1024
    model_s, st_s, xs, ys = bench.smoother_streams(b, t)

    def parallel(y):
        means, covs = assoc_scan.filter_parallel(model_s, st_s, y)
        return means, assoc_scan.smooth_parallel(model_s, means, covs)[0]

    def sequential(y):
        est = gk.vanilla.run(model_s, st_s, measurements=y)[1]
        phis = jnp.broadcast_to(model_s.f, (t,) + model_s.f.shape)
        sm = smoothing.rts_smoother(phis, model_s.noise.q, est.state,
                                    est.covariance)[0]
        return est.state, sm

    (pm, ps), c, r = run("assoc_scan", jax.vmap(parallel), ys)
    sm_m, sm_s = jax.jit(jax.vmap(sequential))(ys)
    scale = float(np.max(np.abs(np.asarray(sm_m))))
    f_err = float(np.max(np.abs(np.asarray(pm) - np.asarray(sm_m)))) / scale
    s_err = float(np.max(np.abs(np.asarray(ps) - np.asarray(sm_s)))) / scale
    rmse_f = float(np.sqrt(np.mean((np.asarray(pm) - np.asarray(xs)) ** 2)))
    rmse_s = float(np.sqrt(np.mean((np.asarray(ps) - np.asarray(xs)) ** 2)))
    assert f_err < 1e-4 and s_err < 1e-4, (f_err, s_err)
    assert rmse_s < rmse_f, (rmse_s, rmse_f)
    _report("4 assoc_scan", f"{b}x{t} f32 filter_parallel + "
            f"smooth_parallel vs sequential vanilla.run + RTS: max err "
            f"{f_err:.2e} (filter), {s_err:.2e} (smoother) relative to "
            f"max |x| (tol 1e-4); smoothed RMSE {rmse_s:.4f} < filtered "
            f"{rmse_f:.4f}", HIGHP, c, r)

    # 5. Lorenz-96 EnKF, 1,024 members.
    run_once, truth, ys = bench.l96_scenario(1024, 300)
    means, c, r = run("enkf_l96", run_once, ys, jax.random.PRNGKey(20))
    rmse = float(np.sqrt(np.mean((np.asarray(means)
                                  - np.asarray(truth))[100:] ** 2)))
    assert rmse < 1.0, f"L96 EnKF analysis RMSE {rmse} >= 1"
    _report("5 enkf_l96", f"1024 members x 300 cycles f32: analysis RMSE "
            f"{rmse:.4f} < 1 (observation sigma)", HIGHP, c, r)

    # 6. Float64 SRIF orbit determination (importing bench_od turns on
    # x64, so this phase runs last).
    import bench_od
    from gokalman_tpu import noise as gn
    from gokalman_tpu import od

    s = bench_od.scenario(8640)
    noise = gn.noiseless(jnp.zeros((3, 3)), s["r"])
    x0 = s["x0_ref"] + jnp.array([1e-3, -1e-3, 1e-3, 1e-6, -1e-6, 1e-6])
    res, c, r = run("srif_od_f64", lambda: od.run_srif_od(
        x0, s["p0"], noise, s["ms"], s["dt"], stations_list=s["sts"],
        degree=2, t0=s["t0"], truth0=s["x0_ref"]))
    assert res.est_states.dtype == jnp.float64
    pos, vel = bench_od.gate_rms(res, s["truth"], s["ms"].has_meas)
    assert pos < 1e-3 and vel < 1e-6, (pos, vel)
    _report("6 srif_od_f64", f"24 h LEO arc, {res.est_states.shape[0]} "
            f"steps float64: position RMS {pos:.3e} km < 1e-3, velocity "
            f"RMS {vel:.3e} km/s < 1e-6", "float64", c, r)
    return compile_times


def four_gpu_phase(devices):
    """The sharded pipelines on a 1-D ensemble mesh over four GPUs, each
    against its unsharded single-device run."""
    import __graft_entry__

    def report(res):
        ok = (res["max_abs_diff"] <= res["tol"]
              and res["devices"] == len(devices))
        print(f"phase sharded {res['name']}: {'PASS' if ok else 'FAIL'} "
              f"max |sharded - unsharded| {res['max_abs_diff']:.3e} (tol "
              f"{res['tol']:.1e}); outputs span {res['devices']} devices; "
              "precision f32 as in the single-device path", flush=True)

    t0 = time.perf_counter()
    __graft_entry__.multichip_legs(devices, mc_samples=N_MC, mc_steps=T_MC,
                                   report=report)
    return {"multichip_legs (compile + run)": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: need {args.chips} GPUs, have {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gokalman_tpu import profiling

    profiling.setup_compile_cache()
    print(f"gpu: {profiling.gpu_name_and_power_limit()}", flush=True)
    t0 = time.perf_counter()
    if args.chips == 4:
        used = devices[:4]
        compile_times = four_gpu_phase(used)
    else:
        used = devices[:1]
        compile_times = single_gpu_phases()
    print("compile: " + ", ".join(f"{k} {v:.1f} s"
                                  for k, v in compile_times.items())
          + f"; total {sum(compile_times.values()):.1f} s", flush=True)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": used[0].platform, "kind": used[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
