"""Unscented Kalman filter (UKF).

The reference *declares* a UKF in its filter taxonomy (reference:
kalman.go:28-29 UKFType) but never implements one; this completes the
enum with a standard additive-noise UKF (Wan & van der Merwe scaled
sigma points).  Nonlinear dynamics/measurement functions are plain
jittable callables — sigma-point propagation is one vmap, so the whole
step stays a single fused XLA computation, scannable over time and
vmappable over ensembles like every other filter here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise


class Params(NamedTuple):
    """Scaled unscented-transform parameters.

    Default alpha=1.0 (lambda=0, all-positive weights): numerically safe
    in float32.  The textbook alpha=1e-3 puts a ~-1e6 weight on the
    center point, which is fine in float64 but catastrophically cancels
    in float32 — pass it explicitly only on f64 paths.
    """

    alpha: float = 1.0
    beta: float = 2.0
    kappa: float = 0.0


class Model(NamedTuple):
    noise: Noise
    params: Params


class State(NamedTuple):
    x: jax.Array  # [n]
    p: jax.Array  # [n, n]
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array
    measurement: jax.Array  # predicted measurement \hat{y}
    innovation: jax.Array
    covariance: jax.Array
    pred_covariance: jax.Array
    gain: jax.Array
    # Unscented innovation covariance S = cov(hx sigma pts) + R: not
    # recoverable from (gain, pred_covariance) for nonlinear hx, and
    # needed by likelihood consumers (imm_ukf mode probabilities,
    # innovations_log_likelihood-style fitting).
    innovation_covariance: jax.Array = None

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, noise: Noise, alpha=1.0, beta=2.0, kappa=0.0):
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    return Model(noise, Params(alpha, beta, kappa)), State(x0, p0, jnp.int32(0))


def _weights(n: int, params: Params, dtype):
    lam = params.alpha**2 * (n + params.kappa) - n
    wm = jnp.full((2 * n + 1,), 1.0 / (2.0 * (n + lam)), dtype)
    wm = wm.at[0].set(lam / (n + lam))
    wc = wm.at[0].add(1.0 - params.alpha**2 + params.beta)
    return lam, wm, wc


def sigma_points(x, p, params: Params):
    """Scaled sigma points X_0 = x, X_±i = x ± sqrt((n+λ) P)_i."""
    n = x.shape[0]
    lam, _, _ = _weights(n, params, x.dtype)
    s = jnp.linalg.cholesky((n + lam) * p)
    pts = jnp.concatenate(
        [x[None, :], x[None, :] + s.T, x[None, :] - s.T], axis=0
    )  # [2n+1, n]
    return pts


def unscented_transform(points, wm, wc, noise_cov=None):
    mean = wm @ points
    dev = points - mean[None, :]
    cov = jnp.einsum("i,ij,ik->jk", wc, dev, dev)
    if noise_cov is not None:
        cov = cov + noise_cov
    return mean, linalg.sym(cov), dev


@linalg.highp
def predict(model: Model, state: State, fx: Callable, control=None):
    """Time update through the nonlinear dynamics fx(x[, u])."""
    n = state.x.shape[0]
    _, wm, wc = _weights(n, model.params, state.x.dtype)
    pts = sigma_points(state.x, state.p, model.params)
    prop = jax.vmap((lambda s: fx(s, control)) if control is not None else fx)(pts)
    x_pred, p_pred, _ = unscented_transform(prop, wm, wc, model.noise.q)
    return x_pred, p_pred, prop, (wm, wc)


@linalg.highp
def step(model: Model, state: State, measurement, fx: Callable, hx: Callable,
         control=None, has=None):
    """One UKF update: unscented time update through fx, unscented
    measurement update through hx, joint-statistics gain.

    `has` (traced bool) masks the measurement update: when False the
    gain and innovation are zeroed, so the step reduces *exactly* to
    the unscented time update (x_pred, p_pred) — the same masked-scan
    convention as srif.step / hybrid.step, with no second computation
    of the step (cf. the gated/IEKF double-compute pattern)."""
    x_pred, p_pred, prop, (wm, wc) = predict(model, state, fx, control)

    # Re-draw sigma points around the predicted density (standard
    # additive-noise form), push through the measurement function.
    pts = sigma_points(x_pred, p_pred, model.params)
    zpts = jax.vmap(hx)(pts)
    y_hat, s_cov, zdev = unscented_transform(zpts, wm, wc, model.noise.r)
    xdev = pts - x_pred[None, :]
    cross = jnp.einsum("i,ij,ik->jk", wc, xdev, zdev)  # [n, p]
    k_gain = linalg.solve_psd(s_cov, cross.T).T

    innovation = measurement - y_hat
    if has is not None:
        k_gain = jnp.where(has, k_gain, jnp.zeros_like(k_gain))
        innovation = jnp.where(has, innovation, jnp.zeros_like(innovation))
        y_hat = jnp.where(has, y_hat, jnp.zeros_like(y_hat))
    x = x_pred + k_gain @ innovation
    # Zero gain => p == p_pred exactly (the pure-prediction step).
    p = linalg.sym(p_pred - k_gain @ s_cov @ k_gain.T)
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=p,
        pred_covariance=p_pred,
        gain=k_gain,
        innovation_covariance=s_cov,
    )
    return State(x, p, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, fx: Callable, hx: Callable,
        controls=None, meas_masks=None):
    """lax.scan driver over the time axis.  `meas_masks` ([T] bool)
    marks which steps carry a measurement (masked steps are pure
    unscented predictions)."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, fx, hx, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))


@linalg.highp
def rts_smoother(model: Model, means, covs, fx: Callable, controls=None):
    """Unscented Rauch-Tung-Striebel smoother (Särkkä 2008): given the
    UKF's filtered moments (means [T, n], covs [T, n, n]) and the same
    dynamics fx, runs the backward pass with unscented-transform
    predicted/cross statistics instead of Jacobians:

      G_k = C_k P_pred^{-1},   C_k = Σ_i wc_i (X_i - m_k)(f(X_i) - m_pred)^T
      m_k^s = m_k + G_k (m^s_{k+1} - m_pred)
      P_k^s = P_k + G_k (P^s_{k+1} - P_pred) G_k^T

    Completes the smoothing tier across the nonlinear family (the
    reference has no smoother beyond the Φ-inverse backmap,
    hybrid.go:209-238); for linear fx this equals
    smoothing.rts_smoother exactly (pinned in tests/test_ukf.py).
    `controls` ([T, m]) aligns with the filter's inputs: controls[k+1]
    drives the k -> k+1 transition.
    """
    n = means.shape[1]
    _, wm, wc = _weights(n, model.params, means.dtype)

    def body(carry, xs):
        x_next, p_next = carry
        x_k, p_k, u_next, is_last = xs
        pts = sigma_points(x_k, p_k, model.params)
        prop = jax.vmap(
            (lambda s: fx(s, u_next)) if u_next is not None else fx
        )(pts)
        x_pred, p_pred, pdev = unscented_transform(prop, wm, wc, model.noise.q)
        xdev = pts - x_k[None, :]
        cross = jnp.einsum("i,ij,ik->jk", wc, xdev, pdev)  # [n, n]
        g = linalg.solve_psd(p_pred, cross.T).T
        x_sm = x_k + g @ (x_next - x_pred)
        p_sm = linalg.sym(p_k + g @ (p_next - p_pred) @ g.T)
        x_out = jnp.where(is_last, x_k, x_sm)
        p_out = jnp.where(is_last, p_k, p_sm)
        return (x_out, p_out), (x_out, p_out)

    t = means.shape[0]
    is_last = jnp.arange(t) == (t - 1)
    u_next = None
    if controls is not None:
        # xs[k] smooths k against k+1: the transition uses controls[k+1].
        u_next = jnp.concatenate([controls[1:], controls[-1:]], axis=0)
    (_, _), (xs_sm, ps_sm) = jax.lax.scan(
        body, (means[-1], covs[-1]), (means, covs, u_next, is_last),
        reverse=True,
    )
    return xs_sm, ps_sm


def cubature_params() -> Params:
    """Parameters that make the scaled unscented transform the
    third-degree spherical-radial cubature rule (Arasaratnam & Haykin
    2009 CKF): alpha=1, kappa=0 give lambda=0 so the center point's
    mean weight vanishes and the 2n symmetric points get weight 1/(2n)
    at radius sqrt(n); beta=0 zeroes the center covariance weight too.
    Use as `ukf.new(x0, p0, noise, **ukf.cubature_params()._asdict())`
    or pass to Params directly — every UKF entry point then *is* the
    cubature Kalman filter."""
    return Params(alpha=1.0, beta=0.0, kappa=0.0)


@linalg.highp
def step_augmented(model: Model, state: State, measurement, fx: Callable,
                   hx: Callable, control=None, has=None):
    """One AUGMENTED-state UKF step for NON-ADDITIVE noise (Wan & van
    der Merwe §7.3 / Särkkä alg. 5.14): sigma points are drawn over the
    joint [x; w; v] with block-diagonal covariance diag(P, Q, R), and
    the noises ride THROUGH the nonlinear maps —

        X_i' = fx(X_i, W_i[, u]),     Z_i = hx(X_i', V_i)

    — so multiplicative, state-scaled, or otherwise embedded noise is
    handled to sigma-point accuracy, where the standard additive-form
    `step` simply adds Q and R to the transformed covariances.  On
    linear additive models it equals the exact KF (pinned).

    Signatures: fx(x, w[, u]) and hx(x, v).  The noise dimensions are
    taken from model.noise.q/r.  2(n+nw+p)+1 sigma points.
    """
    n = state.x.shape[0]
    nw = model.noise.q.shape[0]
    p_dim = model.noise.r.shape[0]
    na = n + nw + p_dim
    dt = state.x.dtype
    _, wm, wc = _weights(na, model.params, dt)

    x_aug = jnp.concatenate([state.x, jnp.zeros(nw, dt), jnp.zeros(p_dim, dt)])
    p_aug = jax.scipy.linalg.block_diag(state.p, model.noise.q,
                                        model.noise.r)
    pts = sigma_points(x_aug, p_aug, model.params)  # [2na+1, na]
    xs_pts, ws_pts, vs_pts = (pts[:, :n], pts[:, n:n + nw],
                              pts[:, n + nw:])

    prop = jax.vmap(
        (lambda s, w: fx(s, w, control)) if control is not None
        else fx)(xs_pts, ws_pts)
    x_pred = wm @ prop
    xdev = prop - x_pred[None, :]
    p_pred = linalg.sym(jnp.einsum("i,ij,ik->jk", wc, xdev, xdev))

    zpts = jax.vmap(hx)(prop, vs_pts)
    y_hat = wm @ zpts
    zdev = zpts - y_hat[None, :]
    s_cov = linalg.sym(jnp.einsum("i,ij,ik->jk", wc, zdev, zdev))
    cross = jnp.einsum("i,ij,ik->jk", wc, xdev, zdev)
    k_gain = linalg.solve_psd(s_cov, cross.T).T

    innovation = measurement - y_hat
    if has is not None:
        k_gain = jnp.where(has, k_gain, jnp.zeros_like(k_gain))
        innovation = jnp.where(has, innovation, jnp.zeros_like(innovation))
        y_hat = jnp.where(has, y_hat, jnp.zeros_like(y_hat))
    x = x_pred + k_gain @ innovation
    p = linalg.sym(p_pred - k_gain @ s_cov @ k_gain.T)
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=p,
        pred_covariance=p_pred,
        gain=k_gain,
        innovation_covariance=s_cov,
    )
    return State(x, p, state.k + 1), est


@linalg.highp
def run_augmented(model: Model, state: State, measurements, fx: Callable,
                  hx: Callable, controls=None, meas_masks=None):
    """lax.scan driver for the augmented (non-additive noise) UKF."""

    def body(carry, xs):
        meas, u, has = xs
        return step_augmented(model, carry, meas, fx, hx, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))


@linalg.highp
def step_iplf(model: Model, state: State, measurement, fx: Callable,
              hx: Callable, control=None, has=None, iters: int = 3):
    """One ITERATED posterior-linearization filter step
    (García-Fernández, Svensson, Morelande & Särkkä 2015): the UKF's
    measurement update performs statistical linear regression (SLR) of
    hx around the PRIOR; when the posterior lands far from the prior
    (strong nonlinearity + informative measurement) that linearization
    is evaluated in the wrong place.  The IPLF re-linearizes around the
    CURRENT POSTERIOR and repeats:

        (H, b, Ω) = SLR of hx at (x_i, P_i):
            H = C_xzᵀ P_i⁻¹,  b = ȳ − H x_i,  Ω = S_z − H P_i Hᵀ
        (x_{i+1}, P_{i+1}) = exact KF update of the PRIOR with the
            affine model y = H x + b + e,  e ~ N(0, R + Ω)

    iters=1 IS the standard UKF update (pinned); each further sweep is
    a fixed-point iteration on the linearization point.  Unlike the
    IEKF (hybrid.iekf_update) this keeps the derivative-free SLR AND
    the Ω linearization-residual inflation, so it remains calibrated
    where the IEKF's Jacobian update goes overconfident.
    """
    x_pred, p_pred, prop, (wm, wc) = predict(model, state, fx, control)

    def slr_update(carry, _):
        x_i, p_i = carry
        pts = sigma_points(x_i, p_i, model.params)
        zpts = jax.vmap(hx)(pts)
        y_bar, s_z, zdev = unscented_transform(zpts, wm, wc)
        xdev = pts - x_i[None, :]
        c_xz = jnp.einsum("i,ij,ik->jk", wc, xdev, zdev)  # [n, p]
        h_lin = linalg.solve_psd(p_i, c_xz).T  # [p, n]
        omega = linalg.sym(s_z - h_lin @ p_i @ h_lin.T)
        r_eff = model.noise.r + omega
        # exact affine-model update of the PRIOR
        y_hat_prior = y_bar + h_lin @ (x_pred - x_i)
        s = linalg.sym(h_lin @ p_pred @ h_lin.T + r_eff)
        k_gain = linalg.solve_psd(s, (p_pred @ h_lin.T).T).T
        innovation = measurement - y_hat_prior
        x_new = x_pred + k_gain @ innovation
        p_new = linalg.sym(p_pred - k_gain @ s @ k_gain.T)
        return (x_new, p_new), (k_gain, innovation, s, y_hat_prior)

    (x, p), (k_gain, innovation, s, y_hat) = jax.lax.scan(
        slr_update, (x_pred, p_pred), None, length=iters)
    k_gain, innovation = k_gain[-1], innovation[-1]
    s_last, y_hat = s[-1], y_hat[-1]

    if has is not None:
        x = jnp.where(has, x, x_pred)
        p = jnp.where(has, p, p_pred)
        k_gain = jnp.where(has, k_gain, jnp.zeros_like(k_gain))
        innovation = jnp.where(has, innovation, jnp.zeros_like(innovation))
        y_hat = jnp.where(has, y_hat, jnp.zeros_like(y_hat))
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=p,
        pred_covariance=p_pred,
        gain=k_gain,
        innovation_covariance=s_last,
    )
    return State(x, p, state.k + 1), est


@linalg.highp
def run_iplf(model: Model, state: State, measurements, fx: Callable,
             hx: Callable, controls=None, meas_masks=None, iters: int = 3):
    """lax.scan driver for the IPLF."""

    def body(carry, xs):
        meas, u, has = xs
        return step_iplf(model, carry, meas, fx, hx, u, has, iters)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))
