"""Maneuvering-target tracking with the non-Gaussian tier.

Three estimators on one synthetic scenario (reference-style example
driver, cf. examples/robot/main.go):

1. IMM (quiet-CV + agile-CV bank) vs the single-model CKF on a target
   that goes ballistic -> weaving: the mode probabilities flag the
   maneuver onset and the IMM halves the tracking RMS.
2. Bootstrap particle filter on a sign-ambiguous |x| sensor where every
   Gaussian filter's unimodal posterior picks a side and the PF keeps
   both hypotheses alive.
3. Rao-Blackwellized PF: 1-D nonlinear "terrain" position + marginal
   KF over [sensor bias, terrain gain error] — the PF samples only the
   1 nonlinear dim; the eta-dependent C(eta) makes both calibration
   states observable.
4. ETKF on the same linear tracker, covariance-free.

Run: JAX_PLATFORMS=cpu python examples/maneuvering_target.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import gokalman_tpu as gk
from gokalman_tpu.filters import enkf, imm, particle, rbpf, vanilla

DT = 0.5


def cv_model(q_scale):
    f = jnp.array([[1.0, DT], [0.0, 1.0]])
    h = jnp.array([[1.0, 0.0]])
    q = q_scale * jnp.array([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]])
    r = jnp.array([[0.09]])
    model, _ = vanilla.new(jnp.zeros(2), jnp.eye(2), f, None, h,
                           gk.noise.noiseless(q, r))
    return model


def main():
    rng = np.random.default_rng(7)

    # --- scenario: ballistic for 30 steps, then a hard weave ---------
    quiet, agile = cv_model(1e-4), cv_model(1.0)
    xs = [np.array([0.0, 0.4])]
    for k in range(80):
        x = np.asarray(quiet.f) @ xs[-1]
        if k >= 30:
            x[1] += 0.8 * np.sin(0.6 * k)
        xs.append(x)
    truth = np.stack(xs[1:])
    ys = jnp.asarray(truth[:, :1] + 0.3 * rng.standard_normal((80, 1)))

    # --- IMM vs single-model CKF -------------------------------------
    trans = jnp.array([[0.97, 0.03], [0.03, 0.97]])
    im, ist = imm.new(jnp.array([0.0, 0.4]), jnp.eye(2), [quiet, agile], trans)
    _, iest = imm.run(im, ist, ys)
    _, qst = vanilla.new(jnp.array([0.0, 0.4]), jnp.eye(2), quiet.f, None,
                         quiet.h, quiet.noise)
    _, kest = vanilla.run(quiet, qst, measurements=ys)

    def rms(a):
        return float(np.sqrt(np.mean((np.asarray(a)[35:, 0] - truth[35:, 0]) ** 2)))

    onset = int(np.argmax(np.asarray(iest.mode_probs)[:, 1] > 0.5))
    print(f"IMM: maneuver flagged at step {onset} (true onset 30); "
          f"post-maneuver RMS {rms(iest.state):.3f} vs single-model CKF "
          f"{rms(kest.state):.3f}")

    # --- particle filter on the sign-ambiguous sensor ----------------
    def fx(x):
        return jnp.array([x[0] + DT * 0.4, x[1]])

    def hx(x):
        return jnp.array([jnp.abs(x[0])])

    noise = gk.noise.awgn(jnp.diag(jnp.array([1e-4, 1e-4])),
                          jnp.array([[1e-3]]))
    truth_pf = [jnp.array([-2.0, 0.0])]
    for _ in range(30):
        truth_pf.append(fx(truth_pf[-1]))
    truth_pf = jnp.stack(truth_pf[1:])
    ys_pf = jax.vmap(hx)(truth_pf) + 0.03 * jnp.asarray(
        rng.standard_normal((30, 1)))

    s0 = particle.new(jnp.array([2.0, 0.0]), jnp.diag(jnp.array([9.0, 0.01])),
                      4096, jax.random.PRNGKey(0))
    prop = particle.additive_dynamics(fx, noise)
    loglik = particle.gaussian_log_likelihood(hx, noise)
    _, pest = particle.run(s0, ys_pf, prop, loglik, jax.random.PRNGKey(1))
    print(f"PF:  |x| sensor, prior on the wrong sign: final error "
          f"{abs(float(pest.state[-1, 0] - truth_pf[-1, 0])):.3f} "
          f"(ESS {float(pest.ess[-1]):.0f}/4096)")

    # --- RBPF: terrain-aided navigation style ------------------------
    # Position eta random-walks over a bumpy "terrain"; the sensor
    # reads y = (1 + gain_err) * terrain(eta) + bias + v, which is
    # nonlinear in eta but LINEAR in z = [bias, gain_err]: the PF
    # samples only eta while per-particle KFs estimate the sensor
    # calibration exactly (the eta-dependent C(eta) is what makes both
    # calibration states observable as the terrain varies).
    def terrain(e):
        return jnp.sin(0.8 * e[0]) + 0.3 * e[0]

    def f_eta(e):
        return e  # random walk via Q_eta

    def g_eta(e):
        return jnp.zeros(2)

    def h_eta(e):
        return jnp.array([terrain(e)])

    def c_eta(e):
        return jnp.array([[1.0, terrain(e)]])  # d y / d [bias, gain_err]

    f_z = jnp.eye(2)  # constant calibration states
    q_eta = jnp.array([[4e-3]])
    q_z = jnp.diag(jnp.array([1e-8, 1e-8]))
    r_t = jnp.array([[4e-4]])

    rngp = np.random.default_rng(11)
    eta_t = np.array([0.3])
    bias_t, gain_t = 0.15, 0.08  # true calibration errors
    ys_r = []
    for _ in range(120):
        eta_t = eta_t + rngp.normal(0, np.sqrt(4e-3), 1)
        terr = np.sin(0.8 * eta_t[0]) + 0.3 * eta_t[0]
        ys_r.append((1.0 + gain_t) * terr + bias_t + rngp.normal(0, 2e-2))
    ys_r = jnp.asarray(np.asarray(ys_r).reshape(-1, 1))

    model_r, s0_r = rbpf.new(jnp.array([0.0]), jnp.eye(1),
                             jnp.array([0.0, 0.0]), 0.04 * jnp.eye(2),
                             f_z, q_eta, q_z, r_t, 1024, jax.random.PRNGKey(20))
    _, rest = rbpf.run(model_r, s0_r, ys_r, f_eta, g_eta, h_eta, c_eta,
                       key=jax.random.PRNGKey(21))
    print(f"RBPF: terrain navigation, 1024 particles over 1 sampled dim; "
          f"calibration estimate bias={float(rest.z[-1, 0]):.3f} "
          f"(true 0.150), gain={float(rest.z[-1, 1]):.3f} (true 0.080), "
          f"ESS {float(rest.ess[-1]):.0f}")

    # --- ETKF: the covariance-free linear path -----------------------
    n0 = gk.noise.noiseless(jnp.zeros((2, 2)), jnp.array([[0.09]]))
    fx_l, hx_l = enkf.linear_fns(quiet.f, quiet.h)
    es0 = enkf.new(jnp.array([0.0, 0.4]), jnp.eye(2), 8)
    _, eest = enkf.run(n0, es0, ys, fx_l, hx_l, method="etkf")
    m2, v0 = vanilla.new(jnp.array([0.0, 0.4]), jnp.eye(2), quiet.f, None,
                         quiet.h, n0)
    _, vest = vanilla.run(m2, v0, measurements=ys)
    d = float(jnp.max(jnp.abs(eest.state - vest.state)))
    print(f"ETKF: 8-member ensemble == exact KF to {d:.1e} (linear, Q=0)")


if __name__ == "__main__":
    main()
