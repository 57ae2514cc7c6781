"""Robust estimation: picking the right defense for the right threat.

The reference library answers model uncertainty with one tool — eyeball
the chi-square plots (chisquare.go) and retune.  This example runs ONE
tracking scenario under three distinct threat models and shows that
each defense wins exactly where its assumptions hold (every claim below
is asserted, not just printed):

1. Heavy-tailed measurement glitches  -> `vanilla.robust_step` (Huber)
   beats both the plain CKF and H-inf: outliers are a statistical
   deviation, best handled statistically.
2. Deterministic (unmodeled, adversarial-style) disturbance ->
   `hinf` minimax filter beats the Kalman filter tuned to the wrong
   white-noise assumption; its gamma=inf limit IS the Kalman filter.
3. Exact physical side-knowledge (here: total momentum of a two-cart
   system is conserved) -> `constrained` projection beats everything
   that ignores the constraint, and satisfies it to roundoff.
4. Noise with BOUNDS but no distribution (quantization-style) ->
   `setmembership` ellipsoids: the truth is inside the set at EVERY
   step (a guarantee no stochastic filter offers — the tuned KF's
   2-sigma ellipsoid misses on a measurable fraction of steps), at
   the price of a larger set.

Run: JAX_PLATFORMS=cpu python examples/robust_estimation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from gokalman_tpu import noise as gn
from gokalman_tpu.filters import constrained, hinf, vanilla

DT = 0.1
T = 500


def rms(est_states, truth):
    return float(jnp.sqrt(jnp.mean((jnp.asarray(est_states) - truth) ** 2)))


# ---------------------------------------------------------------- threat 1
def outlier_scenario():
    """CV tracking, 5% of range measurements glitched by 8 sigma."""
    f = jnp.array([[1.0, DT], [0.0, 1.0]])
    h = jnp.array([[1.0, 0.0]])
    q = jnp.array([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]]) * 0.02
    r = jnp.array([[0.25]])
    key = jax.random.PRNGKey(0)
    kw, kv, ko, kp = jax.random.split(key, 4)
    ws = jax.random.multivariate_normal(kw, jnp.zeros(2), q, (T,))
    truth = [jnp.zeros(2)]
    for t in range(T - 1):
        truth.append(f @ truth[-1] + ws[t])
    truth = jnp.stack(truth)
    vs = 0.5 * jax.random.normal(kv, (T, 1))
    glitch = (jax.random.uniform(ko, (T, 1)) < 0.05).astype(truth.dtype)
    vs = vs + glitch * 8.0 * 0.5 * jnp.sign(jax.random.normal(kp, (T, 1)))
    meas = truth[:, :1] + vs

    nz = gn.noiseless(q, r)
    x0, p0 = jnp.zeros(2), jnp.eye(2)
    model, state0 = vanilla.new(x0, p0, f, None, h, nz)

    _, e_ckf = vanilla.run(model, state0, meas)

    def huber_body(carry, m):
        st, est, _w = vanilla.robust_step(model, carry, m, huber_k=1.345)
        return st, est

    _, e_hub = jax.lax.scan(huber_body, state0, meas)

    x0h, p0h = f @ x0, f @ p0 @ f.T + q
    _, e_hinf = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz, gamma=3.0), meas)

    r_ckf, r_hub, r_hinf = (rms(e_ckf.state, truth), rms(e_hub.state, truth),
                            rms(e_hinf.state, truth))
    print(f"[outliers]   CKF {r_ckf:.4f}  Huber {r_hub:.4f}  "
          f"H-inf(3) {r_hinf:.4f}")
    assert r_hub < r_ckf, "Huber must beat the plain CKF under glitches"
    assert r_hub < r_hinf, ("outliers are statistical, not worst-case: "
                            "Huber must beat minimax here")


# ---------------------------------------------------------------- threat 2
def disturbance_scenario():
    """Same cart, but the 'noise' is a deterministic slow sinusoid the
    Kalman filter's white-noise model cannot represent."""
    f = jnp.array([[1.0, DT], [0.0, 1.0]])
    h = jnp.array([[1.0, 0.0]])
    q = jnp.array([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]]) * 0.02
    r = jnp.array([[0.5]])
    ks = jnp.arange(T, dtype=jnp.float64)
    dist = 0.15 * jnp.sin(2 * jnp.pi * ks / 80.0)
    truth = [jnp.zeros(2)]
    for t in range(T - 1):
        truth.append(f @ truth[-1] + jnp.array([0.0, 1.0]) * dist[t])
    truth = jnp.stack(truth)
    meas = truth[:, :1] + jnp.sqrt(0.5) * jax.random.normal(
        jax.random.PRNGKey(3), (T, 1))

    nz = gn.noiseless(q, r)
    x0, p0 = jnp.zeros(2), jnp.eye(2)
    x0h, p0h = f @ x0, f @ p0 @ f.T + q
    _, e_kf = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz), meas)
    _, e_h3 = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz, gamma=3.0), meas)
    assert bool(np.asarray(e_h3.feasible).all())
    r_kf, r_h3 = rms(e_kf.state, truth), rms(e_h3.state, truth)
    print(f"[worst-case] KF {r_kf:.4f}  H-inf(3) {r_h3:.4f}")
    assert r_h3 < r_kf, "minimax must beat KF under deterministic disturbance"

    # an overly aggressive gamma is detected, not silently wrong
    _, e_bad = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz, gamma=0.5), meas)
    assert not bool(np.asarray(e_bad.feasible).all())
    print("[worst-case] gamma=0.5 correctly flagged infeasible")


# ---------------------------------------------------------------- threat 3
def constraint_scenario():
    """Two carts exchanging momentum (total conserved); both velocities
    measured noisily."""
    f = jnp.array([[0.97, 0.03], [0.03, 0.97]])  # doubly stochastic
    h = jnp.eye(2)
    q = 1e-8 * jnp.eye(2)
    r = 0.09 * jnp.eye(2)
    truth = [jnp.array([2.0, -1.0])]
    for _ in range(T - 1):
        truth.append(f @ truth[-1])
    truth = jnp.stack(truth)
    meas = truth + 0.3 * jax.random.normal(jax.random.PRNGKey(4), (T, 2))

    nz = gn.noiseless(q, r)
    x0, p0 = jnp.zeros(2), jnp.eye(2)
    model, state0 = vanilla.new(x0, p0, f, None, h, nz)
    d_mat, d_vec = jnp.array([[1.0, 1.0]]), jnp.array([1.0])  # p1+p2 = 1

    _, e_u = vanilla.run(model, state0, meas)
    _, e_c = constrained.run(model, state0, d_mat, d_vec, meas)
    viol = np.abs(np.asarray(e_c.state).sum(axis=1) - 1.0).max()
    r_u, r_c = rms(e_u.state, truth), rms(e_c.state, truth)
    print(f"[constraint] CKF {r_u:.4f}  projected {r_c:.4f}  "
          f"max violation {viol:.2e}")
    assert viol < 1e-10
    assert r_c < r_u, "projection must beat the unconstrained CKF"


# ---------------------------------------------------------------- threat 4
def bounded_noise_scenario():
    """Uniform (bounded, non-Gaussian) noise: the set-membership filter
    certifies containment at every step; a KF tuned to the matching
    variances cannot."""
    from gokalman_tpu.filters import setmembership as sm

    rng = np.random.default_rng(4)
    f = np.array([[1.0, DT], [0.0, 1.0]])
    h = np.array([[1.0, 0.0]])
    wb = np.array([0.02, 0.06])   # |w_i| <= wb_i
    vb = 0.3                      # |v| <= vb
    # ellipsoid bounds: box's circumscribed ellipsoid diag(n * b^2)
    q_ell = np.diag(2 * wb**2)
    r_ell = np.array([[vb**2]])
    steps = 300
    x = np.zeros(2)
    xs, ys = [], []
    for _ in range(steps):
        x = f @ x + rng.uniform(-wb, wb)
        xs.append(x.copy())
        ys.append(h @ x + rng.uniform(-vb, vb, 1))
    xs = np.stack(xs)
    ys = jnp.asarray(np.stack(ys))
    model, state0 = sm.new(jnp.zeros(2), 0.25 * jnp.eye(2), f, None, h,
                           gn.noiseless(jnp.asarray(q_ell),
                                        jnp.asarray(r_ell)))
    _, est = sm.run(model, state0, ys)
    d = xs - np.asarray(est.center)
    m = np.einsum("ti,tij,tj->t", d,
                  np.linalg.inv(np.asarray(est.shape)), d)
    # matched-variance KF (uniform[-b,b] variance = b^2/3)
    kq = np.diag(wb**2 / 3.0)
    kr = np.array([[vb**2 / 3.0]])
    km, ks = vanilla.new(jnp.zeros(2), 0.25 * jnp.eye(2),
                         jnp.asarray(f), None, jnp.asarray(h),
                         gn.noiseless(jnp.asarray(kq), jnp.asarray(kr)))
    _, ek = vanilla.run(km, ks, ys)
    dk = xs - np.asarray(ek.state)
    mk = np.einsum("ti,tij,tj->t", dk,
                   np.linalg.inv(np.asarray(ek.covariance)), dk)
    kf_miss = float((mk > 4.0).mean())  # outside 2-sigma
    print(f"[bounded]    set-membership containment "
          f"{float((m <= 1.0).mean()):.3f} (worst {m.max():.3f})  "
          f"vs KF outside-2sigma rate {kf_miss:.3f}")
    assert m.max() <= 1.0 + 1e-9  # the guarantee
    assert kf_miss > 0.01  # the KF certifies nothing


if __name__ == "__main__":
    outlier_scenario()
    disturbance_scenario()
    constraint_scenario()
    bounded_noise_scenario()
    print("all robust-estimation claims verified")
