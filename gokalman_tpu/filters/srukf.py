"""Square-root unscented Kalman filter (SR-UKF).

Beyond the reference: it declares a UKF type and never builds one
(kalman.go:23-32); filters/ukf.py supplies the plain form, and this is
its square-root variant (van der Merwe & Wan 2001, and the QR-based
square-root statistical-linear-regression filters of PAPERS.md).  The
carry is (x, S) with P = S Sᵀ:

- time update: sigma points come straight off S (no per-step Cholesky);
  S⁻ is the QR factor of the weighted propagated deviations stacked
  with sqrt(Q), rank-1-updated with the center point (whose weight can
  be negative — linalg.chol_update handles both signs);
- measurement update: S_yy by the same QR+update; K by two triangular
  solves against S_yy; S⁺ by p rank-1 *downdates* with the columns of
  U = K S_yy.

The payoff is float32 robustness: the plain UKF's covariance update
P⁺ = P⁻ − K S Kᵀ is subtractive and goes indefinite on tight-R
workloads in f32 (like the Joseph CKF in tests/test_f32_conditioning),
while the square-root form cannot produce an indefinite covariance.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from .ukf import Params, _weights


class Model(NamedTuple):
    noise: Noise  # sqrt_q / sqrt_r are the factors consumed here
    params: Params


class State(NamedTuple):
    x: jax.Array  # [n]
    s: jax.Array  # [n, n] lower factor, P = S Sᵀ
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array
    measurement: jax.Array  # predicted measurement
    innovation: jax.Array
    sqrt_covariance: jax.Array  # S⁺ (lower)
    sqrt_pred_covariance: jax.Array  # S⁻ (lower)
    gain: jax.Array

    @property
    def covariance(self) -> jax.Array:
        return linalg.factor_product(self.sqrt_covariance)

    @property
    def pred_covariance(self) -> jax.Array:
        return linalg.factor_product(self.sqrt_pred_covariance)

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, noise: Noise, alpha=1.0, beta=2.0, kappa=0.0):
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    s0 = jnp.linalg.cholesky(p0)
    return (Model(noise, Params(alpha, beta, kappa)),
            State(x0, s0, jnp.int32(0)))


def _sigma_points_from_factor(x, s, lam):
    """X₀ = x, X_±i = x ± sqrt(n+λ)·S_i — no Cholesky needed."""
    n = x.shape[0]
    scaled = jnp.sqrt(jnp.asarray(n + lam, x.dtype)) * s
    return jnp.concatenate(
        [x[None, :], x[None, :] + scaled.T, x[None, :] - scaled.T], axis=0
    )


def _sign_normalize(s):
    """Flip factor columns so the diagonal is positive (S Sᵀ invariant)."""
    flip = jnp.where(jnp.diagonal(s) < 0, -1.0, 1.0).astype(s.dtype)
    return s * flip[None, :]


def _wc0_nonneg(n: int, params: Params) -> bool:
    """Static sign of the center covariance weight (params are Python
    floats, so this is a trace-time constant)."""
    lam = params.alpha**2 * (n + params.kappa) - n
    return (lam / (n + lam) + 1.0 - params.alpha**2 + params.beta) >= 0.0


def _sqrt_transform(points, wm, wc, sqrt_noise, wc0_nonneg: bool):
    """(mean, S, dev) with S Sᵀ = Σ wc_i dev_i dev_iᵀ + noise.

    wc0_nonneg=True (the default scaled-UT parameters): every weighted
    deviation including the center joins one QR stack — additions only,
    no rank-1 arithmetic.  Negative-wc₀ parameterizations fall back to
    QR over the non-center rows plus a rank-1 downdate
    (linalg.chol_update), which is NOT f32-robust — exactly why Params'
    default keeps wc₀ ≥ 0."""
    mean = wm @ points
    dev = points - mean[None, :]
    if wc0_nonneg:
        a = jnp.concatenate(
            [jnp.sqrt(wc)[:, None] * dev, sqrt_noise.T], axis=0
        )
        return mean, _sign_normalize(linalg.qr_r(a).T), dev
    a = jnp.concatenate(
        [jnp.sqrt(wc[1]) * dev[1:], sqrt_noise.T], axis=0
    )
    s = _sign_normalize(linalg.qr_r(a).T)
    s = linalg.chol_update(s, dev[0], wc[0])
    return mean, s, dev


@linalg.highp
def predict(model: Model, state: State, fx: Callable, control=None):
    """Square-root unscented time update."""
    n = state.x.shape[0]
    lam, wm, wc = _weights(n, model.params, state.x.dtype)
    pts = _sigma_points_from_factor(state.x, state.s, lam)
    prop = jax.vmap((lambda s_: fx(s_, control)) if control is not None else fx)(pts)
    x_pred, s_pred, _ = _sqrt_transform(
        prop, wm, wc, model.noise.sqrt_q, _wc0_nonneg(n, model.params)
    )
    return x_pred, s_pred


@linalg.highp
def step(model: Model, state: State, measurement, fx: Callable, hx: Callable,
         control=None, has=None):
    """One SR-UKF update; `has` masks the measurement (zeroed gain ==
    exact time update), matching ukf.step's convention.

    With wc₀ ≥ 0 (default Params) the measurement update is ONE QR of
    the joint weighted-deviation pre-array
        [[√Rᵀ,  0 ],
         [Z_w, X_w]]
    whose R factor is [[Syyᵀ, Syy⁻¹P_zx],[0, S⁺ᵀ]] — gain by triangular
    solve and the posterior factor directly, with no subtraction
    anywhere (the van-der-Merwe K·Syy column *downdates* cancel
    catastrophically in f32 on tight-R workloads; this form cannot).
    """
    n = state.x.shape[0]
    p = model.noise.sqrt_r.shape[0]
    lam, wm, wc = _weights(n, model.params, state.x.dtype)
    wc0_ok = _wc0_nonneg(n, model.params)
    x_pred, s_pred = predict(model, state, fx, control)

    pts = _sigma_points_from_factor(x_pred, s_pred, lam)
    zpts = jax.vmap(hx)(pts)
    xdev = pts - x_pred[None, :]

    if wc0_ok:
        y_hat = wm @ zpts
        zdev = zpts - y_hat[None, :]
        sq = jnp.sqrt(wc)[:, None]
        dtype = s_pred.dtype
        pre = jnp.concatenate([
            jnp.concatenate(
                [model.noise.sqrt_r.T, jnp.zeros((p, n), dtype)], axis=1),
            jnp.concatenate([sq * zdev, sq * xdev], axis=1),
        ], axis=0)
        u = linalg.qr_r(pre)
        syy = u[:p, :p].T
        w_mat = u[:p, p:].T  # [n, p]
        s_post = _sign_normalize(u[p:, p:].T)
        k_gain = jax.scipy.linalg.solve_triangular(syy.T, w_mat.T,
                                                   lower=False).T
    else:
        y_hat, syy, zdev = _sqrt_transform(
            zpts, wm, wc, model.noise.sqrt_r, False)
        cross = jnp.einsum("i,ij,ik->jk", wc, xdev, zdev)  # [n, p]
        k_gain = jax.scipy.linalg.solve_triangular(
            syy.T,
            jax.scipy.linalg.solve_triangular(syy, cross.T, lower=True),
            lower=False,
        ).T
        u_cols = k_gain @ syy  # [n, p]
        s_post, _ = jax.lax.scan(
            lambda s, col: (linalg.chol_update(s, col, -1.0), None),
            s_pred, u_cols.T)

    innovation = measurement - y_hat
    if has is not None:
        k_gain = jnp.where(has, k_gain, jnp.zeros_like(k_gain))
        innovation = jnp.where(has, innovation, jnp.zeros_like(innovation))
        y_hat = jnp.where(has, y_hat, jnp.zeros_like(y_hat))
        s_plus = jnp.where(has, s_post, s_pred)
    else:
        s_plus = s_post
    x = x_pred + k_gain @ innovation

    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        sqrt_covariance=s_plus,
        sqrt_pred_covariance=s_pred,
        gain=k_gain,
    )
    return State(x, s_plus, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, fx: Callable, hx: Callable,
        controls=None, meas_masks=None):
    """lax.scan driver (meas_masks: [T] bool measurement availability)."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, fx, hx, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))
