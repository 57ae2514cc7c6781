"""Square-root Kalman filter (QR-factor propagation).

Rebuild of the reference square-root KF (reference:
squareroot.go:21-360).  The Cholesky factor S (P = S S^T) is propagated
instead of P:

- time update: QR of the stacked [ (F S)^T ; sqrtQ^T ] (2n x n) block
  (squareroot.go:155-185) — one batched QR instead of the
  reference's element-by-element C-matrix fill;
- measurement update: QR of the (p+n) pre-array
      [[ sqrtR^T,        0      ],
       [ (S^-)^T H^T, (S^-)^T  ]]
  whose R factor yields Syy, W and S^+ (squareroot.go:195-234); the
  gain is K = W Syy^{-1} via a triangular solve.  The reference's
  scalar-measurement special case (squareroot.go:247-252) disappears.

Note: the reference stores the *upper* QR factor as its predicted
stddev and computes P^- as U U^T (squareroot.go:185, 330-340), which is
not F P F^T + Q; here S^- = R^T (lower) so P^- = S^- S^-T is exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise, measurement_sample, process_sample


class Model(NamedTuple):
    f: jax.Array  # [n, n]
    g: Optional[jax.Array]  # [n, m] or None
    h: jax.Array  # [p, n]
    noise: Noise  # sqrt_q / sqrt_r are the cached factors (squareroot.go:100-114)


class State(NamedTuple):
    x: jax.Array  # [n]
    s: jax.Array  # [n, n] lower factor, P = S S^T
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    """Square-root estimate (reference: squareroot.go:278-360)."""

    state: jax.Array
    measurement: jax.Array
    innovation: jax.Array
    sqrt_covariance: jax.Array  # S^+ (lower)
    sqrt_pred_covariance: jax.Array  # S^- (lower)
    gain: jax.Array

    @property
    def covariance(self) -> jax.Array:
        return linalg.factor_product(self.sqrt_covariance)

    @property
    def pred_covariance(self) -> jax.Array:
        return linalg.factor_product(self.sqrt_pred_covariance)

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, f, g, h, noise: Noise):
    """Build (Model, State); S0 = chol(P0) (reference: squareroot.go:21-50)."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    g = None if g is None or linalg.is_nil(g) else jnp.asarray(g)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
    s0 = jnp.linalg.cholesky(p0)
    return Model(f, g, h, noise), State(x0, s0, jnp.int32(0))


@linalg.highp
def time_update_factor(model: Model, s: jax.Array, go_upper: bool = False) -> jax.Array:
    """S^- lower with S^- S^-T = F S S^T F^T + Q via QR (squareroot.go:155-185).

    go_upper=True mirrors a genuine reference quirk: the Go filter
    extracts the *upper* QR factor U and uses it directly as its
    predicted sqrt factor (squareroot.go:179-185, then Uᵀ in the
    Δ-array bottom blocks, squareroot.go:190-213, and P⁻ = U Uᵀ in
    PredCovariance, squareroot.go:330-340).  Since U Uᵀ ≠ UᵀU =
    F P Fᵀ + Q, the Go measurement update runs against a *rotated*
    predicted covariance.  The default returns the correct lower
    factor; the quirk mode exists for row-level parity with the
    committed Go outputs (tests/test_jerkcar_golden.py).
    """
    c = jnp.concatenate([(model.f @ s).T, model.noise.sqrt_q.T], axis=0)
    u = linalg.qr_r(c)
    return u if go_upper else u.T


@linalg.highp
def measurement_update_factors(model: Model, s_pred: jax.Array):
    """(S^+, Syy, W) from the (p+n) pre-array QR (squareroot.go:195-234)."""
    n = s_pred.shape[0]
    p = model.h.shape[0]
    dtype = s_pred.dtype
    top = jnp.concatenate(
        [model.noise.sqrt_r.T, jnp.zeros((p, n), dtype=dtype)], axis=1
    )
    bottom = jnp.concatenate([s_pred.T @ model.h.T, s_pred.T], axis=1)
    u = linalg.qr_r(jnp.concatenate([top, bottom], axis=0))
    syy = u[:p, :p].T  # lower, Syy Syy^T = H P^- H^T + R
    w = u[:p, p:].T  # [n, p]
    s_plus = u[p:, p:].T  # lower, S^+ S^+T = P^+
    return s_plus, syy, w


@linalg.highp
def step(model: Model, state: State, measurement, control=None, w2=None, v=None,
         h=None, r=None, meas_mask=None, go_upper_pred_factor: bool = False):
    """One square-root update (reference: squareroot.go:129-274).

    Matches the reference's noise convention: no process-noise draw in
    the prediction, one draw (`w2`) added after the measurement update
    (squareroot.go:268).  `h`/`r`/`meas_mask` override the measurement
    model per step (time-varying padded measurements, see
    vanilla.mask_measurement).  `go_upper_pred_factor` (static) mirrors
    the reference's upper-factor time update (see time_update_factor).
    """
    if h is not None or r is not None or meas_mask is not None:
        from .vanilla import mask_measurement

        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement, meas_mask)
        model = model._replace(
            h=h_k,
            noise=model.noise._replace(r=r_k, sqrt_r=jnp.linalg.cholesky(r_k)),
        )
    x_pred = model.f @ state.x
    if model.g is not None and control is not None:
        x_pred = x_pred + model.g @ control

    s_pred = time_update_factor(model, state.s, go_upper=go_upper_pred_factor)
    s_plus, syy, w_mat = measurement_update_factors(model, s_pred)
    # K = W Syy^{-1}: solve Syy^T K^T = W^T (triangular).
    k_gain = jax.scipy.linalg.solve_triangular(syy.T, w_mat.T, lower=False).T

    y_hat = model.h @ state.x
    if v is not None:
        y_hat = y_hat + v

    innovation = measurement - model.h @ x_pred
    x = x_pred + k_gain @ innovation
    if w2 is not None:
        x = x + w2

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
def run(model: Model, state: State, measurements, controls=None, key=None,
        hs=None, rs=None, meas_masks=None, go_upper_pred_factor: bool = False):
    """lax.scan driver over the time axis (hs/rs/meas_masks: per-step
    measurement-model overrides, see vanilla.run)."""
    steps = jnp.shape(measurements)[0]
    keys = None if key is None else jax.random.split(key, steps)

    def body(carry, xs):
        meas, ctrl, k, h_k, r_k, mask = xs
        w2 = v = None
        if k is not None:
            kw, kv = jax.random.split(k)
            w2 = process_sample(model.noise, kw)
            v = measurement_sample(model.noise, kv)
        return step(model, carry, meas, ctrl, w2, v, h_k, r_k, mask,
                    go_upper_pred_factor=go_upper_pred_factor)

    xs = (measurements, controls, keys, hs, rs, meas_masks)
    return jax.lax.scan(body, state, xs, length=steps)
