"""Strapdown inertial navigation: the invariant EKF on SE_2(3).

The third estimation domain beside orbit determination and spacecraft
attitude: a vehicle navigating from an IMU (gyro + accelerometer) with
intermittent landmark fixes — think lidar/vision registration against
a known map, with a GPS dropout thrown in.  The estimator is the
right-invariant EKF (filters/iekf.py): because the IMU dynamics are
group-affine on SE_2(3), the filter's error propagation is EXACTLY
log-linear whatever the trajectory, which is what lets act 3 converge
from a 120-degree attitude initialization where a linearized filter's
first update points the wrong way.

Every printed claim is asserted:

1. INS + landmark fixes at 1 Hz (IMU at 50 Hz): position RMS < 12 cm
   and attitude < 0.7 deg on the converged tail (the 1 s dead-reckoning
   gaps dominate both), with honest covariance (pose NEES ~ 9 over
   Monte-Carlo draws);
2. a 20 s total landmark outage: the dead-reckoned covariance stays
   honest — the pose NEES at the re-acquisition step over MC draws
   sits in the chi^2_9 band (the narrative draw itself lands at ~2.5
   sigma, printed for scale); recovery to the pre-outage error level
   takes < 3 s;
3. lost-in-space initialization (120 deg attitude error, 8 m position
   error): the IEKF converges to < 1 deg / < 10 cm;
4. the invariant RTS smoother run over the outage trace bridges the
   gap: mean position error inside the 20 s outage drops by > 3x vs
   the filter, and the smoothed track matches the filter at the final
   step exactly.

Run: JAX_PLATFORMS=cpu python examples/navigation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from gokalman_tpu.dynamics import liegroup as lg
from gokalman_tpu.filters import iekf

DT = 0.02  # IMU at 50 Hz
T = 3000  # 60 s
G = jnp.asarray([0.0, 0.0, -9.81])
SIG_G = 2e-3  # gyro white noise, rad/s/sqrt(Hz)
SIG_A = 2e-2  # accel white noise, m/s^2/sqrt(Hz)
SIG_M = 0.05  # landmark fix noise, m per axis
LANDMARKS = jnp.asarray([
    [15.0, 0.0, 2.0], [0.0, 15.0, 1.0], [-12.0, -4.0, 3.0],
    [5.0, -14.0, 0.5],
])
MEAS_EVERY = 50  # landmark fixes at 1 Hz


def truth_and_imu(rng):
    """A bounded maneuvering arc INSIDE the landmark field: world
    velocity is a chosen sinusoid (so the vehicle loops within ~±15 m
    of the origin instead of flying away), body rates are sinusoids,
    and the accelerometer reading is derived as the specific force
    a_b = R^T (v̇ − g) — the quantity an accelerometer actually
    measures, consistent with the filter model v' = R a_b + g.

    (Design note, measured: an unconstrained body-frame acceleration
    profile sends the vehicle kilometres from the origin, where the
    right-invariant parameterization's world-frame error coordinates
    pick up |p|-scaled attitude-position coupling — a known property
    of the right-IEKF, not a bug; navigation frames are chosen near
    the operating area for exactly this reason.)"""
    ks = np.arange(T)
    t = ks * DT
    omegas = np.stack([0.25 * np.sin(0.22 * t),
                       0.2 * np.cos(0.14 * t),
                       0.15 * np.sin(0.10 * t + 1.0)], axis=1)
    # world velocity: loops of ~10 m radius, plus a gentle climb wave
    vw = np.stack([1.2 * np.cos(0.12 * t), 1.2 * np.sin(0.12 * t),
                   0.3 * np.cos(0.25 * t)], axis=1)
    aw = np.stack([-1.2 * 0.12 * np.sin(0.12 * t),
                   1.2 * 0.12 * np.cos(0.12 * t),
                   -0.3 * 0.25 * np.sin(0.25 * t)], axis=1)
    r = np.eye(3)
    v = vw[0].copy()
    p = np.zeros(3)
    rs, vs, ps, a_bodies = [], [], [], []
    for k in range(T):
        a_b = r.T @ (aw[k] - np.asarray(G))  # specific force
        a_bodies.append(a_b)
        a_w = r @ a_b + np.asarray(G)  # == aw[k]
        p = p + v * DT + 0.5 * a_w * DT**2
        v = v + a_w * DT
        r = r @ np.asarray(lg.so3_exp(jnp.asarray(omegas[k] * DT)))
        rs.append(r)
        vs.append(v)
        ps.append(p)
    rs, vs, ps = np.stack(rs), np.stack(vs), np.stack(ps)
    a_bodies = np.stack(a_bodies)
    gyro = omegas + SIG_G / np.sqrt(DT) * rng.standard_normal((T, 3))
    accel = a_bodies + SIG_A / np.sqrt(DT) * rng.standard_normal((T, 3))
    obs = np.einsum("tji,lj->tli", rs, np.asarray(LANDMARKS)) \
        - np.einsum("tji,tj->ti", rs, ps)[:, None, :] \
        + SIG_M * rng.standard_normal((T, LANDMARKS.shape[0], 3))
    return (jnp.asarray(rs), jnp.asarray(vs), jnp.asarray(ps),
            jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(obs),
            omegas, a_bodies)


def run_filter(r0, v0, p0, cov0, gyro, accel, obs, masks):
    model, state = iekf.new(r0, v0, p0, cov0, LANDMARKS, sigma_g=SIG_G,
                            sigma_a=SIG_A, sigma_meas=SIG_M, dt=DT, g=G)
    return jax.jit(lambda g_, a_, o_, m_: iekf.run(
        model, state, g_, a_, o_, m_))(gyro, accel, obs, masks)


def ang_deg(r_est, r_true):
    return np.degrees(np.linalg.norm(np.asarray(
        lg.so3_log(r_est @ r_true.T))))


def main():
    rng = np.random.default_rng(7)
    rs, vs, ps, gyro, accel, obs, omegas, a_bodies = truth_and_imu(rng)
    meas_mask = np.zeros((T, LANDMARKS.shape[0]), bool)
    meas_mask[::MEAS_EVERY, :] = True

    # --- act 1: nominal INS + landmark fusion --------------------------
    cov0 = jnp.diag(jnp.asarray([1e-4] * 3 + [1e-2] * 3 + [1e-2] * 3))
    _, est = run_filter(jnp.eye(3), jnp.asarray([1.0, 0.0, 0.0]),
                        jnp.zeros(3), cov0, gyro, accel, obs,
                        jnp.asarray(meas_mask))
    tail = slice(T // 2, None)
    pos_rms = float(jnp.sqrt(jnp.mean(
        jnp.sum((est.pos[tail] - ps[tail]) ** 2, axis=1))))
    att_err = max(ang_deg(np.asarray(est.rot[k]), np.asarray(rs[k]))
                  for k in range(T // 2, T, 97))
    print(f"act 1: tail position RMS {100 * pos_rms:.1f} cm, "
          f"worst sampled attitude error {att_err:.3f} deg")
    assert pos_rms < 0.12 and att_err < 0.7

    # honest covariance: pose NEES over MC draws — fresh IMU/fix noise
    # around the same truth arc each draw
    n_mc = 24
    clean_obs = np.einsum("tji,lj->tli", np.asarray(rs),
                          np.asarray(LANDMARKS)) \
        - np.einsum("tji,tj->ti", np.asarray(rs),
                    np.asarray(ps))[:, None, :]

    def nees_run(key, mask):
        kg, ka, km = jax.random.split(key, 3)
        gy = jnp.asarray(omegas) + SIG_G / np.sqrt(DT) * \
            jax.random.normal(kg, (T, 3))
        ac = jnp.asarray(a_bodies) + SIG_A / np.sqrt(DT) * \
            jax.random.normal(ka, (T, 3))
        ob = jnp.asarray(clean_obs) + SIG_M * jax.random.normal(
            km, (T, LANDMARKS.shape[0], 3))
        model, state = iekf.new(jnp.eye(3), jnp.asarray([1.0, 0.0, 0.0]),
                                jnp.zeros(3), cov0, LANDMARKS,
                                sigma_g=SIG_G, sigma_a=SIG_A,
                                sigma_meas=SIG_M, dt=DT, g=G)
        _, e = iekf.run(model, state, gy, ac, ob, mask)

        def nees_k(rot, vel, pos, cov, rt, vt, pt):
            xi = iekf.error_twist(lg.se23_from_rvp(rot, vel, pos),
                                  rt, vt, pt)
            from gokalman_tpu import linalg
            return xi @ linalg.solve_psd(cov, xi)

        return jax.vmap(nees_k)(e.rot, e.vel, e.pos, e.covariance,
                                rs, vs, ps)

    keys = jax.random.split(jax.random.PRNGKey(5), n_mc)
    nees = jax.jit(jax.vmap(nees_run, in_axes=(0, None)))(
        keys, jnp.asarray(meas_mask))
    nees_tail = float(jnp.mean(nees[:, 100:]))
    print(f"act 1: pose NEES over {n_mc} draws = {nees_tail:.2f} "
          f"(dim 9 — honest covariance)")
    assert 7.8 < nees_tail < 10.2

    # --- act 2: landmark outage ---------------------------------------
    out_start, out_end = 1500, 2500  # 20 s dropout
    mask_out = meas_mask.copy()
    mask_out[out_start:out_end, :] = False
    _, e2 = run_filter(jnp.eye(3), jnp.asarray([1.0, 0.0, 0.0]),
                       jnp.zeros(3), cov0, gyro, accel, obs,
                       jnp.asarray(mask_out))
    k_re = out_end - 1  # last dead-reckoned step
    perr = np.asarray(e2.pos[k_re] - ps[k_re])
    psig = np.sqrt(np.asarray(e2.covariance[k_re]).diagonal()[6:9])
    # single-draw sanity only (this particular noise draw lands at
    # ~2.5 sigma — measured; the STATISTICAL claim is the MC NEES
    # below, which is what "honest covariance" actually means)
    inside = np.linalg.norm(perr) < 4.0 * np.linalg.norm(psig)
    print(f"act 2: after 20 s dead reckoning |pos err| = "
          f"{np.linalg.norm(perr):.2f} m vs predicted 1-sigma "
          f"{np.linalg.norm(psig):.2f} m (within 4x: {inside})")
    assert bool(inside)
    # the statistical version of the same claim: pose NEES AT the
    # re-acquisition step, over the MC draws, sits in the chi^2_9 band
    # — the dead-reckoned covariance is neither optimistic nor padded
    nees_out = jax.jit(jax.vmap(nees_run, in_axes=(0, None)))(
        keys, jnp.asarray(mask_out))
    nees_re = float(jnp.mean(nees_out[:, k_re]))
    print(f"act 2: NEES at re-acquisition over {n_mc} draws = "
          f"{nees_re:.2f} (dim 9)")
    assert 6.0 < nees_re < 12.0
    pre_rms = float(jnp.sqrt(jnp.mean(jnp.sum(
        (e2.pos[out_start - 300:out_start] -
         ps[out_start - 300:out_start]) ** 2, axis=1))))
    rec = out_end + 150  # 3 s after re-acquisition
    post_rms = float(jnp.sqrt(jnp.mean(jnp.sum(
        (e2.pos[rec:rec + 300] - ps[rec:rec + 300]) ** 2, axis=1))))
    print(f"act 2: pre-outage RMS {100 * pre_rms:.1f} cm, "
          f"3 s after re-acquisition {100 * post_rms:.1f} cm")
    assert post_rms < 2.0 * pre_rms + 0.02

    # --- act 3: lost-in-space initialization --------------------------
    axis = np.array([0.48, -0.6, 0.64])
    axis /= np.linalg.norm(axis)
    r0_bad = lg.so3_exp(jnp.asarray(axis * np.deg2rad(120.0)))
    cov0_big = jnp.diag(jnp.asarray([5.0] * 3 + [4.0] * 3 + [100.0] * 3))
    _, e3 = run_filter(r0_bad, jnp.asarray([2.0, -1.0, 0.0]),
                       jnp.asarray([8.0, 0.0, -3.0]), cov0_big,
                       gyro, accel, obs, jnp.asarray(meas_mask))
    final_att = ang_deg(np.asarray(e3.rot[-1]), np.asarray(rs[-1]))
    final_pos = float(jnp.linalg.norm(e3.pos[-1] - ps[-1]))
    print(f"act 3: from 120 deg / 8 m error -> final attitude "
          f"{final_att:.2f} deg, position {100 * final_pos:.1f} cm")
    assert final_att < 1.0 and final_pos < 0.1

    # --- act 4: invariant RTS smoothing over the outage trace ----------
    r_s, v_s, p_s, _, cov_s = iekf.rts_smoother(
        iekf.new(jnp.eye(3), jnp.asarray([1.0, 0.0, 0.0]), jnp.zeros(3),
                 cov0, LANDMARKS, sigma_g=SIG_G, sigma_a=SIG_A,
                 sigma_meas=SIG_M, dt=DT, g=G)[0],
        e2, gyro, accel)
    err_f = np.linalg.norm(np.asarray(e2.pos) - np.asarray(ps), axis=1)
    err_s = np.linalg.norm(np.asarray(p_s) - np.asarray(ps), axis=1)
    gap_f = err_f[out_start:out_end].mean()
    gap_s = err_s[out_start:out_end].mean()
    print(f"act 4: outage-interval mean position error: filter "
          f"{gap_f:.2f} m -> smoother {gap_s:.2f} m "
          f"({gap_f / gap_s:.1f}x)")
    assert gap_s < gap_f / 3.0
    assert float(jnp.linalg.norm(p_s[-1] - e2.pos[-1])) == 0.0

    print("navigation example: all claims hold")


if __name__ == "__main__":
    main()
