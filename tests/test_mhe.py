"""MHE pins: exact KF equivalence on linear models (state AND
covariance, warmup included), masked measurements, and the nonlinear
window-relinearization win."""

import jax
import jax.numpy as jnp
import numpy as np

from gokalman_tpu import noise as gn
from gokalman_tpu.filters import mhe, ukf, vanilla

from fixtures import robot1d_matrices


def _linear_system():
    f, g, dt = robot1d_matrices()
    h = jnp.array([[1.0, 0.0]])
    q = jnp.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]) * 0.02
    r = jnp.array([[0.5]])
    x0 = jnp.array([0.5, -0.2])
    p0 = jnp.diag(jnp.array([4.0, 1.0]))
    return f, h, q, r, x0, p0


def test_linear_equals_kalman_exactly():
    """Window-end state and covariance == vanilla CKF at EVERY t —
    including the t < N warmup (full-information windows)."""
    f, h, q, r, x0, p0 = _linear_system()
    nz = gn.noiseless(q, r)
    T = 40
    meas = jax.random.normal(jax.random.PRNGKey(0), (T, 1))
    vm, vs = vanilla.new(x0, p0, f, None, h, nz)
    _, ev = vanilla.run(vm, vs, meas)
    ests = mhe.run(lambda x: f @ x, lambda x: h @ x, x0, p0, nz, meas,
                   horizon=8, iters=1)
    assert np.allclose(np.asarray(ests.state), np.asarray(ev.state),
                       atol=1e-9)
    assert np.allclose(np.asarray(ests.covariance),
                       np.asarray(ev.covariance), atol=1e-9)
    # window-start state at t is the SMOOTHED x_{t-N|t}: more accurate
    # than the filtered x_{t-N|t-N} was (sanity: costs are finite)
    assert np.isfinite(np.asarray(ests.cost)).all()


def test_masked_measurements_equal_masked_kf():
    """Missing measurements contribute only dynamics residuals — the
    masked-step OD idiom; equals the vanilla run with the same mask
    (via the padded-measurement path)."""
    f, h, q, r, x0, p0 = _linear_system()
    nz = gn.noiseless(q, r)
    T = 30
    meas = jax.random.normal(jax.random.PRNGKey(1), (T, 1))
    mask = jnp.arange(T) % 3 != 1
    vm, vs = vanilla.new(x0, p0, f, None, h, nz)
    _, ev = vanilla.run(vm, vs, meas, meas_masks=mask[:, None])
    ests = mhe.run(lambda x: f @ x, lambda x: h @ x, x0, p0, nz, meas,
                   meas_masks=mask, horizon=6, iters=1)
    assert np.allclose(np.asarray(ests.state), np.asarray(ev.state),
                       atol=1e-9)
    assert np.allclose(np.asarray(ests.covariance),
                       np.asarray(ev.covariance), atol=1e-9)


def test_nonlinear_window_relinearization_beats_ukf():
    """Range-only tracking from a bad prior: the MHE relinearizes the
    whole window each Gauss-Newton pass and recovers; the one-pass UKF
    carries its early linearization error much longer."""
    dt = 0.5
    f_mat = jnp.array([[1, 0, dt, 0], [0, 1, 0, dt],
                       [0, 0, 1, 0], [0, 0, 0, 1.0]])
    q = 1e-4 * jnp.eye(4)
    r = jnp.array([[0.01]])
    beacon = jnp.array([0.0, 0.0])

    def fx(x):
        return f_mat @ x

    def hx(x):
        return jnp.array([jnp.linalg.norm(x[:2] - beacon)])

    key = jax.random.PRNGKey(2)
    kw, kv = jax.random.split(key)
    T = 60
    lq = jnp.linalg.cholesky(q)
    ws = jax.random.normal(kw, (T, 4)) @ lq.T
    truth = [jnp.array([3.0, 4.0, -0.3, 0.1])]
    for t in range(T - 1):
        truth.append(fx(truth[-1]) + ws[t])
    truth = jnp.stack(truth)
    meas = (jax.vmap(hx)(truth)
            + 0.1 * jax.random.normal(kv, (T, 1)))

    x0_bad = jnp.array([6.0, 1.0, 0.0, 0.0])  # wrong direction, right-ish range
    p0 = jnp.diag(jnp.array([9.0, 9.0, 0.25, 0.25]))
    nz = gn.noiseless(q, r)

    ests = mhe.run(fx, hx, x0_bad, p0, nz, meas, horizon=10, iters=3)
    um, us = ukf.new(x0_bad, p0, nz)
    _, eu = ukf.run(um, us, meas, fx, hx)

    err_m = np.asarray(ests.state)[:, :2] - np.asarray(truth)[:, :2]
    err_u = np.asarray(eu.state)[:, :2] - np.asarray(truth)[:, :2]
    rms_m = float(np.sqrt((err_m[T // 2:] ** 2).mean()))
    rms_u = float(np.sqrt((err_u[T // 2:] ** 2).mean()))
    assert np.isfinite(rms_m) and rms_m < rms_u, (rms_m, rms_u)


def test_window_start_is_smoother_grade():
    """x_{t-N|t} (window start) should beat x_{t-N|t-N} (what the
    filter knew then) — the MHE quietly provides fixed-lag smoothing."""
    f, h, q, r, x0, p0 = _linear_system()
    nz = gn.noiseless(q, r)
    T, N = 60, 8
    key = jax.random.PRNGKey(3)
    kw, kv = jax.random.split(key)
    lq = jnp.linalg.cholesky(q)
    ws = jax.random.normal(kw, (T, 2)) @ lq.T
    truth = [jnp.array([0.0, 1.0])]
    for t in range(T - 1):
        truth.append(f @ truth[-1] + ws[t])
    truth = jnp.stack(truth)
    meas = truth @ h.T + jnp.sqrt(0.5) * jax.random.normal(kv, (T, 1))

    vm, vs = vanilla.new(x0, p0, f, None, h, nz)
    _, ev = vanilla.run(vm, vs, meas)
    ests = mhe.run(lambda x: f @ x, lambda x: h @ x, x0, p0, nz, meas,
                   horizon=N, iters=1)
    # window_start at time t estimates x_{t-N}
    lagged_est = np.asarray(ests.window_start)[N:]
    filt_then = np.asarray(ev.state)[: T - N]
    tru = np.asarray(truth)[: T - N]
    rms_smooth = float(np.sqrt(((lagged_est - tru) ** 2).mean()))
    rms_filt = float(np.sqrt(((filt_then - tru) ** 2).mean()))
    assert rms_smooth < rms_filt, (rms_smooth, rms_filt)


def test_constrained_mhe_reactor():
    """Haseltine & Rawlings (2005) Ex.1, gas-phase 2A -> B reactor with
    a badly wrong prior: unconstrained estimators chase negative
    partial pressures (UKF transient hits -1.1; unconstrained MHE
    diverges to -3.5); projected-GN MHE with a positive floor locks
    onto the truth at ~0.04 RMS — 5x better than the UKF tail.

    The floor must be strictly positive (0.1 here): the x1^2 dynamics
    Jacobian vanishes at x1 = 0, so clipping to exactly zero stalls
    projected Gauss-Newton at the degenerate boundary (measured: locks
    at x1=0; documented in the module docstring)."""
    k_rate, dt = 0.16, 0.1

    def ode(x):
        return jnp.array([-2 * k_rate * x[0] ** 2, k_rate * x[0] ** 2])

    def fx(x):
        k1 = ode(x)
        k2 = ode(x + 0.5 * dt * k1)
        k3 = ode(x + 0.5 * dt * k2)
        k4 = ode(x + dt * k3)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    def hx(x):
        return jnp.array([x[0] + x[1]])  # total pressure

    T = 60
    truth = [jnp.array([3.0, 1.0])]
    for _ in range(T - 1):
        truth.append(fx(truth[-1]))
    truth = jnp.stack(truth)
    meas = jax.vmap(hx)(truth) + 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (T, 1))
    x0_bad = jnp.array([0.1, 4.5])
    p0 = 36.0 * jnp.eye(2)
    nz = gn.noiseless(1e-6 * jnp.eye(2), jnp.array([[0.01]]))

    em = mhe.run(fx, hx, x0_bad, p0, nz, meas, horizon=10, iters=5,
                 project_fn=lambda x: jnp.maximum(x, 0.1))
    um, us = ukf.new(x0_bad, p0, nz)
    _, eu = ukf.run(um, us, meas, fx, hx)
    e_free = mhe.run(fx, hx, x0_bad, p0, nz, meas, horizon=10, iters=5)

    tr = np.asarray(truth)
    rms = lambda e: float(np.sqrt(((np.asarray(e)[T // 2:] - tr[T // 2:]) ** 2).mean()))
    r_con, r_ukf, r_free = rms(em.state), rms(eu.state), rms(e_free.state)
    assert float(np.asarray(em.state).min()) >= 0.1 - 1e-9
    assert r_con < 0.1, r_con
    assert float(np.asarray(eu.state).min()) < -0.5  # UKF goes negative
    assert r_con < 0.5 * r_ukf, (r_con, r_ukf)
    assert r_free > 5 * r_con  # unconstrained MHE diverges here too


def test_smoother_equals_dense_window():
    """The scan-form GN window solve (`solve_window`, TV affine
    KF + RTS per GN step — Bell 1994) == the dense jacfwd+QR form
    (`solve_window_dense`) it replaced: the two solve the SAME
    quadratic subproblem each iteration, so the iterates, the
    window-end covariance, and the cost agree to solver roundoff —
    nonlinear dynamics, warmup (j0 > 0), masked measurements, and
    projection all included.  The dense form's program grows with the
    horizon; this pin is what lets the scan form carry MHE instead."""
    horizon, n = 6, 2
    dt = 0.1

    def fx(x):
        return x + dt * jnp.array([x[1], -0.4 * jnp.sin(x[0])])

    def hx(x):
        return jnp.array([x[0] + 0.05 * x[0] ** 2])

    nz = gn.noiseless(jnp.diag(jnp.array([1e-4, 4e-3])),
                      jnp.array([[0.04]]))
    key = jax.random.PRNGKey(3)
    ys = jax.random.normal(key, (horizon + 1, 1)) * 0.5 + 1.0
    x_arr = jnp.array([0.9, -0.1])
    p_arr = jnp.diag(jnp.array([0.5, 0.8]))
    xs_init = jnp.broadcast_to(x_arr, (horizon + 1, n)) \
        + 0.01 * jnp.arange(horizon + 1)[:, None]
    meas_mask = jnp.asarray(
        [1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0])

    for j0 in (0, 3):
        slot_mask = (jnp.arange(horizon + 1) >= j0).astype(ys.dtype)
        for project_fn in (None, lambda x: jnp.maximum(x, -0.5)):
            a = mhe.solve_window(fx, hx, nz, x_arr, p_arr, ys,
                                 slot_mask, meas_mask, xs_init,
                                 jnp.int32(j0), iters=3,
                                 project_fn=project_fn)
            b = mhe.solve_window_dense(fx, hx, nz, x_arr, p_arr, ys,
                                       slot_mask, meas_mask, xs_init,
                                       jnp.int32(j0), iters=3,
                                       project_fn=project_fn)
            for got, want, name in zip(a, b, ("xs", "cov_end", "cost")):
                np.testing.assert_allclose(
                    np.asarray(got), np.asarray(want), atol=1e-8,
                    err_msg=f"j0={j0} proj={project_fn is not None} {name}")
