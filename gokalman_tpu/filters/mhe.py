"""Moving-horizon estimation (MHE): optimization-based filtering.

The estimation counterpart of MPC (Rao, Rawlings & Mayne 2003): at each
time t solve, over the last N+1 states jointly,

    min  ||x_s − x̄||²_{P̄⁻¹}                        (arrival cost)
       + Σ ||x_{i+1} − f(x_i)||²_{Q⁻¹}              (dynamics)
       + Σ m_i ||y_i − h(x_i)||²_{R⁻¹}              (measurements)

by Gauss-Newton, then slide the window; the arrival prior (x̄, P̄) is
carried by a companion EKF that consumes measurements as they leave
the window (the standard filtering approximation of the arrival cost).
Why bother vs a filter: the window relinearizes f and h at the SMOOTHED
trajectory on every iteration, so strong nonlinearity + poor priors
that wreck one-pass filters (even iterated ones touch only one step)
get N+1 steps of joint relinearization.

Exactness anchor (pinned in tests): for a linear model the Gauss-Newton
step is exact in one iteration and the companion is the Kalman filter,
so the MHE window-end state AND covariance equal the vanilla CKF's at
every t — including the warmup (t < N windows are full-information).

Static-shape design: fixed window length N+1 (static), warmup via slot
validity masks instead of growing windows, the stacked residual's
Jacobian by jax.jacfwd (block-sparse, but at (N+1)·n ≤ ~100 variables a
dense QR solve is cheap), `run` is one lax.scan carrying the
rolling (measurement buffer, warm-start trajectory, arrival prior).
The window-end covariance is the last diagonal block of (JᵀJ)⁻¹ read
off the QR factor — for linear models exactly the KF posterior.

The reference has no optimization-based estimation at all; its batch
filter (batch.go) is the epoch-only special case (window = everything,
one linearization, no arrival cost).

Program-size note: the original Gauss-Newton step materialized the
FULL window Jacobian with jacfwd — an [(N+1)(2n+p)+n, (N+1)n] dense
matrix — and QR-factored it, a program that grows with the horizon
and whose compile time blew up (horizon 6-10, iters 3-5).  The default GN step is now the structure-exploiting classic
(`solve_window`): the window NLS problem is block-tridiagonal, so each
GN step is EXACTLY one time-varying affine Kalman filter + RTS smoother
pass over the window — a lax.scan over slots whose program size is
horizon-INDEPENDENT, O(N·n³) instead of O(N³·n³) flops, no giant
Jacobian, no dense QR.  The dense path is kept as `solve_window_dense`
and pinned equal to digit level in tests
(tests/test_mhe.py::test_smoother_equals_dense_window).

Constrained-MHE gotcha (measured, tests/test_mhe.py reactor case): a
projection floor of exactly zero can STALL projected Gauss-Newton when
the dynamics Jacobian is degenerate at the boundary (e.g. x² kinetics:
∂(kx²)/∂x = 0 at x = 0 leaves no restoring gradient, and the clipped
arrival companion locks overconfidently at 0).  Clip to a small
strictly-positive floor instead — max(x, 0.1) recovers the
Haseltine-Rawlings reactor at 0.04 RMS where max(x, 0) locks at x=0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise


class Estimate(NamedTuple):
    state: jax.Array  # [n] window-end estimate x̂_{t|t}
    covariance: jax.Array  # [n, n] last block of (JᵀJ)⁻¹ (== KF posterior on linear)
    window_start: jax.Array  # [n] smoothed x̂_{t-N|t} (slot-0 state)
    cost: jax.Array  # [] Gauss-Newton objective at the solution

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _window_residual(xs_flat, fx, hx, lq, lr, lp, x_arr, ys, slot_mask,
                     meas_mask, anchor, j0, n, horizon):
    """Stacked whitened residual of the window NLS problem.

    `j0` is the slot index of the window start (N−t during warmup, 0
    after); the arrival residual attaches to slot j0 via a one-hot
    contraction so shapes stay static.  Pre-window slots (< j0) carry
    no physical residual — `anchor` pins them at the warm start with a
    unit-weight residual so the Gauss-Newton Jacobian keeps full column
    rank; those residuals are zero at the solution and block-decoupled
    from the valid slots (the dynamics residual INTO slot j0 is
    masked), so they change nothing else.
    """
    xs = xs_flat.reshape(horizon + 1, n)
    onehot = (jnp.arange(horizon + 1) == j0).astype(xs.dtype)
    x_start = onehot @ xs
    r_prior = jax.scipy.linalg.solve_triangular(
        lp, x_start - x_arr, lower=True)
    # dynamics: slot i -> i+1 active only when slot i is in-window
    preds = jax.vmap(fx)(xs[:-1])
    dyn = jax.vmap(lambda d: jax.scipy.linalg.solve_triangular(
        lq, d, lower=True))(xs[1:] - preds)
    dyn = dyn * slot_mask[:-1, None]
    meas = jax.vmap(lambda x, y: jax.scipy.linalg.solve_triangular(
        lr, y - hx(x), lower=True))(xs, ys)
    meas = meas * (slot_mask * meas_mask)[:, None]
    dummy = (xs - anchor) * (1.0 - slot_mask)[:, None]
    return jnp.concatenate([r_prior, dyn.reshape(-1), meas.reshape(-1),
                            dummy.reshape(-1)])


@linalg.highp
def solve_window(fx, hx, noise: Noise, x_arr, p_arr, ys, slot_mask,
                 meas_mask, xs_init, j0, iters: int = 2, project_fn=None):
    """Gauss-Newton solve of one window via the smoother form; returns
    (xs [N+1, n], cov_end [n, n], cost).  `project_fn` (state -> state,
    e.g. a nonnegativity clip) turns this into projected Gauss-Newton —
    the constrained-MHE workhorse (Haseltine & Rawlings 2005).

    Each GN step solves the linearized quadratic subproblem EXACTLY as
    a time-varying affine Kalman filter + RTS pass over the increment
    variables dx_i (the block-tridiagonal normal equations of the MHE
    window are the smoothing problem's — Bell 1994, "The iterated
    Kalman smoother as a Gauss-Newton method"):

        prior  at slot j0:  dx_{j0} ~ N(x_arr − x_{j0}, P̄)
        dynamics:           dx_{i+1} = F_i dx_i + (f(x_i) − x_{i+1}) + w
        measurements:       y_i − h(x_i) = H_i dx_i + v

    so the smoothed increments ARE the Gauss-Newton step.  Pre-window
    slots (< j0) take dx = 0, matching the dense path's anchor rows.
    The window-end covariance is the slot-N filtered covariance of the
    final linearization — the same last diagonal block of (JᵀJ)⁻¹ the
    dense path reads off its QR factor."""
    horizon = ys.shape[0] - 1
    n = x_arr.shape[0]
    dt = x_arr.dtype
    lq = jnp.linalg.cholesky(noise.q)
    lr = jnp.linalg.cholesky(noise.r)
    lp = jnp.linalg.cholesky(p_arr)
    f_jac = jax.jacfwd(fx)
    h_jac = jax.jacfwd(hx)
    slots = jnp.arange(horizon + 1)
    nI = jnp.eye(n, dtype=dt)

    def gn_step(xs_flat, _):
        xs = xs_flat.reshape(horizon + 1, n)
        f_mats = jax.vmap(f_jac)(xs)  # [N+1, n, n] (slot N's unused)
        h_mats = jax.vmap(h_jac)(xs)  # [N+1, p, n]
        defects = jax.vmap(fx)(xs) - jnp.concatenate(
            [xs[1:], xs[-1:]], axis=0)  # f(x_i) − x_{i+1} (slot N unused)
        y_res = ys - jax.vmap(hx)(xs)  # [N+1, p]
        upd_mask = (slot_mask * meas_mask).astype(dt)  # [N+1]

        def fwd(carry, inp):
            m, p = carry
            i, f_prev, defect_prev, h_i, y_i, u_i, x_i = inp
            # propagate from slot i−1 (slot 0's result is overwritten
            # by the arrival injection at i == j0)
            m_pred = f_prev @ m + defect_prev
            p_pred = linalg.sym(f_prev @ p @ f_prev.T + noise.q)
            inject = i == j0
            m_pred = jnp.where(inject, x_arr - x_i, m_pred)
            p_pred = jnp.where(inject, p_arr, p_pred)
            # masked measurement update (Joseph, gain-generic)
            s = h_i @ p_pred @ h_i.T + noise.r
            k_gain = linalg.solve_psd(s, h_i @ p_pred).T * u_i
            m_f = m_pred + k_gain @ (y_i - h_i @ m_pred)
            imkh = nI - k_gain @ h_i
            p_f = linalg.sym(imkh @ p_pred @ imkh.T
                             + k_gain @ noise.r @ k_gain.T)
            return (m_f, p_f), (m_f, p_f, m_pred, p_pred)

        f_prevs = jnp.concatenate([f_mats[-1:], f_mats[:-1]], axis=0)
        d_prevs = jnp.concatenate([defects[-1:], defects[:-1]], axis=0)
        (_, _), (m_fs, p_fs, m_preds, p_preds) = jax.lax.scan(
            fwd, (jnp.zeros(n, dt), nI),
            (slots, f_prevs, d_prevs, h_mats, y_res, upd_mask, xs))

        def bwd(dx_next, inp):
            i, m_f, p_f, f_i, m_pred_next, p_pred_next = inp
            # no smoothing across the arrival injection at slot j0+? —
            # the injection replaces the PREDICTION into j0, so slots
            # i >= j0 smooth normally; i < j0 pins dx = 0.
            g = linalg.solve_psd(p_pred_next, f_i @ p_f).T
            dx = m_f + g @ (dx_next - m_pred_next)
            across = i + 1 == j0  # slot j0's prior is not a propagation
            dx = jnp.where(across | (i < j0), jnp.zeros_like(dx), dx)
            return dx, dx

        _, dxs_rev = jax.lax.scan(
            bwd, m_fs[-1],
            (slots[:-1], m_fs[:-1], p_fs[:-1], f_mats[:-1],
             m_preds[1:], p_preds[1:]),
            reverse=True)
        dxs = jnp.concatenate([dxs_rev, m_fs[-1:]], axis=0)
        dxs = dxs * (slots >= j0).astype(dt)[:, None]
        out = xs + dxs
        if project_fn is not None:
            out = jax.vmap(project_fn)(out)
        return out.reshape(-1), None

    xs_flat, _ = jax.lax.scan(gn_step, xs_init.reshape(-1), None,
                              length=iters)
    res = _window_residual(xs_flat, fx, hx, lq, lr, lp, x_arr, ys,
                           slot_mask, meas_mask, xs_init, j0, n, horizon)

    # Window-end covariance at the FINAL linearization (the dense path
    # re-Jacobians at the solution before reading off (JᵀJ)⁻¹; the
    # covariance recursion is measurement-value-independent, so one
    # P-only forward pass reproduces it exactly).
    xs_fin = xs_flat.reshape(horizon + 1, n)
    f_fin = jax.vmap(f_jac)(xs_fin)
    h_fin = jax.vmap(h_jac)(xs_fin)
    upd_fin = (slot_mask * meas_mask).astype(dt)

    def cov_fwd(p, inp):
        i, f_prev, h_i, u_i = inp
        p_pred = linalg.sym(f_prev @ p @ f_prev.T + noise.q)
        p_pred = jnp.where(i == j0, p_arr, p_pred)
        s = h_i @ p_pred @ h_i.T + noise.r
        k_gain = linalg.solve_psd(s, h_i @ p_pred).T * u_i
        imkh = nI - k_gain @ h_i
        p_f = linalg.sym(imkh @ p_pred @ imkh.T
                         + k_gain @ noise.r @ k_gain.T)
        return p_f, None

    cov_end, _ = jax.lax.scan(
        cov_fwd, nI,
        (slots, jnp.concatenate([f_fin[-1:], f_fin[:-1]], axis=0),
         h_fin, upd_fin))
    return xs_fin, cov_end, 0.5 * jnp.sum(res**2)


@linalg.highp
def solve_window_dense(fx, hx, noise: Noise, x_arr, p_arr, ys, slot_mask,
                       meas_mask, xs_init, j0, iters: int = 2,
                       project_fn=None):
    """The original dense Gauss-Newton solve (full-window jacfwd + QR):
    kept as the parity reference for `solve_window` — it is the
    directly-assembled normal-equations solution, but its program
    compiles catastrophically slowly at larger horizons (see module
    docstring)."""
    horizon = ys.shape[0] - 1
    n = x_arr.shape[0]
    lq = jnp.linalg.cholesky(noise.q)
    lr = jnp.linalg.cholesky(noise.r)
    lp = jnp.linalg.cholesky(p_arr)

    def res_fn(xs_flat):
        return _window_residual(xs_flat, fx, hx, lq, lr, lp, x_arr, ys,
                                slot_mask, meas_mask, xs_init, j0, n,
                                horizon)

    def gn_step(xs_flat, _):
        res = res_fn(xs_flat)
        jac = jax.jacfwd(res_fn)(xs_flat)
        q_mat, r_mat = jnp.linalg.qr(jac)
        dx = jax.scipy.linalg.solve_triangular(
            r_mat, -(q_mat.T @ res), lower=False)
        out = xs_flat + dx
        if project_fn is not None:
            out = jax.vmap(project_fn)(out.reshape(horizon + 1, n)).reshape(-1)
        return out, None

    xs_flat, _ = jax.lax.scan(gn_step, xs_init.reshape(-1), None,
                              length=iters)
    res = res_fn(xs_flat)
    # window-end covariance: last n×n block of (JᵀJ)⁻¹ via the R factor
    jac = jax.jacfwd(res_fn)(xs_flat)
    r_mat = linalg.qr_r(jac)
    rinv_rows = jax.scipy.linalg.solve_triangular(
        r_mat, jnp.eye(r_mat.shape[0], dtype=r_mat.dtype), lower=False
    )[-n:, :]
    cov_end = linalg.sym(rinv_rows @ rinv_rows.T)
    return (xs_flat.reshape(horizon + 1, n), cov_end,
            0.5 * jnp.sum(res**2))


@linalg.highp
def run(fx: Callable, hx: Callable, x0, p0, noise: Noise, measurements,
        meas_masks=None, horizon: int = 8, iters: int = 2,
        project_fn: Callable = None):
    """Sliding-window MHE over [T, p] measurements.

    `fx`/`hx` follow the ukf convention (state -> state / state ->
    measurement); `noise.q`/`noise.r` must be positive definite (their
    Cholesky factors whiten the residuals).  `meas_masks` [T] marks
    steps that carry a measurement (missing steps contribute only
    dynamics residuals, the OD masked-step idiom).  `project_fn`
    (state -> state) enforces state constraints by projected
    Gauss-Newton (e.g. `lambda x: jnp.maximum(x, 0)` for
    concentrations/pressures — the Haseltine & Rawlings 2005 setting
    where the EKF estimates negative states and locks onto the wrong
    solution); it is also applied inside the arrival-cost companion.
    Returns the stacked per-step Estimate.
    """
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    measurements = jnp.asarray(measurements)
    steps, p_dim = measurements.shape
    n = x0.shape[0]
    dt = p0.dtype
    if meas_masks is None:
        meas_masks = jnp.ones(steps, bool)

    h_jac = jax.jacfwd(hx)
    f_jac = jax.jacfwd(fx)

    def companion_ekf(x, p, y, m):
        """One EKF step of the arrival-cost companion (measurement
        update at the leaving time, then time update)."""
        h_mat = h_jac(x)
        s = h_mat @ p @ h_mat.T + noise.r
        k_gain = linalg.solve_psd(s, h_mat @ p).T
        k_gain = k_gain * m
        x_up = x + k_gain @ (y - hx(x))
        if project_fn is not None:
            x_up = project_fn(x_up)
        nI = jnp.eye(n, dtype=dt)
        p_up = linalg.sym((nI - k_gain @ h_mat) @ p @ (nI - k_gain @ h_mat).T
                          + k_gain @ noise.r @ k_gain.T)
        f_mat = f_jac(x_up)
        return fx(x_up), linalg.sym(f_mat @ p_up @ f_mat.T + noise.q)

    def body(carry, inp):
        buf_y, buf_m, x_arr, p_arr, warm, t = carry
        y_t, m_t = inp
        # push the new measurement into the rolling buffers
        buf_y = jnp.concatenate([buf_y[1:], y_t[None]], axis=0)
        buf_m = jnp.concatenate([buf_m[1:], m_t[None]])
        warm_last = fx(warm[-1])
        warm = jnp.concatenate([warm[1:], warm_last[None]], axis=0)
        j0 = jnp.maximum(horizon - t, 0)
        slot_mask = (jnp.arange(horizon + 1) >= j0).astype(dt)
        xs, cov_end, cost = solve_window(
            fx, hx, noise, x_arr, p_arr, buf_y, slot_mask,
            buf_m.astype(dt), warm, j0, iters, project_fn)
        # slide the arrival prior once the window is full: the slot-0
        # measurement leaves the window, the companion consumes it
        full = t >= horizon
        x_a2, p_a2 = companion_ekf(x_arr, p_arr, buf_y[0],
                                   buf_m[0].astype(dt))
        x_arr = jnp.where(full, x_a2, x_arr)
        p_arr = jnp.where(full, p_a2, p_arr)
        est = Estimate(state=xs[-1], covariance=cov_end,
                       window_start=xs[0], cost=cost)
        return (buf_y, buf_m, x_arr, p_arr, xs, t + 1), est

    # Align with the library's predict-then-update timing (vanilla.step
    # predicts before its first measurement): the arrival prior for the
    # first window is x_{0|-1} = fx(x0), F P0 Fᵀ + Q.
    f0 = f_jac(x0)
    x_arr0 = fx(x0)
    p_arr0 = linalg.sym(f0 @ p0 @ f0.T + noise.q)
    carry0 = (
        jnp.zeros((horizon + 1, p_dim), dt),
        jnp.zeros(horizon + 1, bool),
        x_arr0,
        p_arr0,
        jnp.broadcast_to(x_arr0, (horizon + 1, n)),
        jnp.int32(0),
    )
    _, ests = jax.lax.scan(body, carry0, (measurements, meas_masks))
    return ests
