"""Navigation-tier benchmark: IEKF INS fleets on the GPU.

Two slope-timed, accuracy-gated rows (the bench_tracking.py idiom —
R=1 vs R=3 repeats of a vmapped fleet inside one jit, single
scalar-read sync, marginal per-fleet cost as the number):

1. `iekf_fleet` — B vehicles x T IMU steps with landmark fixes at
   every 5th step; gated on fleet-tail position RMS (f32, the serving
   path).
2. `iekf_smooth_pipeline` — filter + invariant RTS end-to-end per
   vehicle (the offline-reprocessing serving shape); gated on the
   smoother beating the filter's RMS (throughput with a smoother that
   doesn't smooth would be meaningless).  Landmark fixes arrive every
   5th step, so the smoother's between-fix interpolation is visible in
   the gate.

Runs in one process and refuses to run without a GPU.  Prints one JSON
line per row, each carrying the device it ran on.
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from gokalman_tpu import profiling
from gokalman_tpu.filters import iekf

DTYPE = jnp.float32
B_FLEET = int(os.environ.get("BENCH_NAV_FLEET", 512))
T_STEPS = int(os.environ.get("BENCH_NAV_STEPS", 200))
DT = 0.02
SIG_G, SIG_A, SIG_M = 2e-3, 2e-2, 0.05
G3 = jnp.asarray([0.0, 0.0, -9.81], DTYPE)
LMS = jnp.asarray([[15.0, 0.0, 2.0], [0.0, 15.0, 1.0],
                   [-12.0, -4.0, 3.0]], DTYPE)


def stage(name):
    print(f"[bench_nav] {name}", file=sys.stderr, flush=True)


def _gen_fleet(key):
    """Per-vehicle bounded arcs (the examples/navigation.py design:
    world velocity chosen sinusoid, accelerometer = specific force)
    with per-vehicle phase offsets; returns truth positions and the
    noisy IMU + landmark-fix streams, all [B, T, ...]."""
    t = np.arange(T_STEPS) * DT
    ks = np.random.default_rng(0).uniform(0.8, 1.2, (B_FLEET, 3))
    om = np.stack([0.25 * np.sin(0.22 * t[None] * ks[:, :1]),
                   0.2 * np.cos(0.14 * t[None] * ks[:, 1:2]),
                   0.15 * np.sin(0.10 * t[None] * ks[:, 2:3] + 1.0)],
                  axis=2)  # [B, T, 3]
    vw = np.stack([1.2 * np.cos(0.12 * t[None] * ks[:, :1]),
                   1.2 * np.sin(0.12 * t[None] * ks[:, 1:2]),
                   0.3 * np.cos(0.25 * t[None] * ks[:, 2:3])], axis=2)
    aw = np.gradient(vw, DT, axis=1)
    g_np = np.asarray(G3, np.float64)

    def rodrigues(phi):
        # pure numpy: an eager lg.so3_exp here would be one device
        # dispatch per call, B*T of them
        th = np.linalg.norm(phi)
        if th < 1e-12:
            return np.eye(3)
        k = phi / th
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx

    rs = np.zeros((B_FLEET, T_STEPS, 3, 3))
    ps = np.zeros((B_FLEET, T_STEPS, 3))
    a_b = np.zeros((B_FLEET, T_STEPS, 3))
    for b in range(B_FLEET):
        r = np.eye(3)
        v = vw[b, 0].copy()
        p = np.zeros(3)
        for k in range(T_STEPS):
            ab = r.T @ (aw[b, k] - g_np)
            a_b[b, k] = ab
            a_w = r @ ab + g_np
            p = p + v * DT + 0.5 * a_w * DT**2
            v = v + a_w * DT
            r = r @ rodrigues(om[b, k] * DT)
            rs[b, k] = r
            ps[b, k] = p

    rng = np.random.default_rng(1)
    gyro = om + SIG_G / np.sqrt(DT) * rng.standard_normal(om.shape)
    accel = a_b + SIG_A / np.sqrt(DT) * rng.standard_normal(a_b.shape)
    obs = (np.einsum("btji,lj->btli", rs, np.asarray(LMS))
           - np.einsum("btji,btj->bti", rs, ps)[:, :, None, :]
           + SIG_M * rng.standard_normal(
               (B_FLEET, T_STEPS, LMS.shape[0], 3)))
    masks = np.zeros((B_FLEET, T_STEPS, LMS.shape[0]), bool)
    masks[:, ::5, :] = True  # fixes at every 5th IMU step
    return (jnp.asarray(ps, DTYPE), jnp.asarray(gyro, DTYPE),
            jnp.asarray(accel, DTYPE), jnp.asarray(obs, DTYPE),
            jnp.asarray(masks))


def _slope_time(make_fn, sync_leaf):
    f1, f3 = make_fn(1), make_fn(3)
    out1 = f1(jnp.int32(0))
    jax.block_until_ready(out1)
    jax.block_until_ready(f3(jnp.int32(0)))

    def timed(fn, s):
        t0 = time.perf_counter()
        out = fn(jnp.int32(s))
        _ = float(sync_leaf(out))
        return time.perf_counter() - t0

    t1 = min(timed(f1, s) for s in (1, 2, 3))
    t3 = min(timed(f3, s) for s in (1, 2, 3))
    return max((t3 - t1) / 2.0, 1e-9), out1


def main():
    dev = profiling.require_gpu()
    profiling.setup_compile_cache()
    stage("gen fleet")
    ps, gyro, accel, obs, masks = _gen_fleet(jax.random.PRNGKey(3))
    cov0 = jnp.diag(jnp.asarray([1e-4] * 3 + [1e-2] * 3 + [1e-2] * 3,
                                DTYPE))
    model, state0 = iekf.new(jnp.eye(3, dtype=DTYPE),
                             jnp.zeros(3, DTYPE), jnp.zeros(3, DTYPE),
                             cov0, LMS, sigma_g=SIG_G, sigma_a=SIG_A,
                             sigma_meas=SIG_M, dt=DT, g=G3)

    def run_one(g_, a_, o_, m_):
        _, est = iekf.run(model, state0, g_, a_, o_, m_)
        return est

    fleet = jax.vmap(run_one)

    stage("row iekf_fleet")

    def make_filter(repeats):
        @jax.jit
        def fn(shift):
            outs = []
            for i in range(repeats):
                g_ = jnp.roll(gyro, shift + i, axis=0)
                a_ = jnp.roll(accel, shift + i, axis=0)
                o_ = jnp.roll(obs, shift + i, axis=0)
                m_ = jnp.roll(masks, shift + i, axis=0)
                outs.append(fleet(g_, a_, o_, m_).pos)
            return sum(outs)

        return fn

    marginal, pos0 = _slope_time(make_filter, lambda o: o[-1, -1, 0])
    tail = T_STEPS // 2
    rms = float(jnp.sqrt(jnp.mean(
        jnp.sum((pos0[:, tail:] - ps[:, tail:]) ** 2, axis=-1))))
    steps = B_FLEET * T_STEPS
    print(json.dumps({
        "metric": "iekf_fleet_ins_steps_per_sec",
        "value": steps / marginal, "unit": "ins_steps/s",
        "fleet_ms": 1e3 * marginal, "vehicles": B_FLEET,
        "steps": T_STEPS, "landmarks": int(LMS.shape[0]),
        "tail_pos_rms_m": rms, "dtype": "float32", "device": dev,
        "gates_pass": bool(rms < 0.15),
    }), flush=True)

    stage("row iekf_smooth_pipeline")
    est0 = fleet(gyro, accel, obs, masks)
    jax.block_until_ready(est0.pos)
    smooth = jax.vmap(
        lambda e, g_, a_: iekf.rts_smoother(model, e, g_, a_)[2])

    def make_smoother(repeats):
        @jax.jit
        def fn(shift):
            outs = []
            for i in range(repeats):
                g_ = jnp.roll(gyro, shift + i, axis=0)
                a_ = jnp.roll(accel, shift + i, axis=0)
                o_ = jnp.roll(obs, shift + i, axis=0)
                m_ = jnp.roll(masks, shift + i, axis=0)
                e = fleet(g_, a_, o_, m_)
                outs.append(smooth(e, g_, a_))
            return sum(outs)

        return fn

    marginal_s, psm = _slope_time(make_smoother, lambda o: o[-1, -1, 0])
    rms_s = float(jnp.sqrt(jnp.mean(
        jnp.sum((psm[:, tail:] - ps[:, tail:]) ** 2, axis=-1))))
    print(json.dumps({
        "metric": "iekf_smooth_pipeline_steps_per_sec",
        "value": steps / marginal_s, "unit": "smoothed_steps/s",
        "includes_filter_pass": True,
        "fleet_ms": 1e3 * marginal_s, "vehicles": B_FLEET,
        "steps": T_STEPS, "filter_tail_rms_m": rms,
        "smoother_tail_rms_m": rms_s, "dtype": "float32",
        "device": dev,
        "gates_pass": bool(rms_s < rms and rms_s < 0.15),
    }), flush=True)
    assert rms < 0.15 and rms_s < rms, "nav-tier accuracy gates failed"


if __name__ == "__main__":
    main()
