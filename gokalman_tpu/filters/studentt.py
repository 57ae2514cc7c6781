"""Student-t filter (heavy-tailed process AND measurement noise).

Completes the robust tier with the *model-based* robust filter: where
Huber IRLS (vanilla.robust_step) and H-infinity (hinf) bolt robustness
onto a Gaussian filter, this is the exact Bayesian recursion when state
and noises are jointly Student-t distributed (Roth, Özkan & Gustafsson,
"A Student's t filter for heavy tailed process and measurement noise",
ICASSP 2013).  The reference (vanilla.go:128-220) is the ν→∞ limit of
this filter — pinned in tests.

Representation: the posterior is St(x; m, P, ν) with *scale matrix* P
(moment covariance = ν/(ν−2)·P, requires ν>2).  With w ~ St(0, Q, ν)
and v ~ St(0, R, ν) sharing the state's dof (the common-dof
approximation that keeps the family closed):

  predict:  m⁻ = F m + G u,      P⁻ = F P Fᵀ + Q            (scales add)
  update:   S = H P⁻ Hᵀ + R,     K = P⁻ Hᵀ S⁻¹,  e = y − H m⁻
            δ² = eᵀ S⁻¹ e        (squared Mahalanobis innovation)
            m⁺ = m⁻ + K e
            P' = (ν + δ²)/(ν + p) · (P⁻ − K S Kᵀ),   ν' = ν + p
            moment-match ν' back to ν:
            P⁺ = (ν−2)/ν · ν'/(ν'−2) · P'

The (ν+δ²)/(ν+p) factor is the filter's whole character: an innovation
far outside S *inflates* the posterior scale (a 5σ surprise under a
t model means "my uncertainty was understated", where a Gaussian filter
keeps its precomputed covariance no matter what the data said).  The
mean update is the Kalman one — robustness here is honest covariance
under outliers/maneuvers, not residual down-weighting; combine with
vanilla.robust_step when the outliers are sensor faults rather than
model tails.

Design notes: NamedTuple pytrees, lax.scan driver, masked steps for sparse
measurements, all algebra under linalg.highp; Joseph-form posterior
scale (P⁻ − K S Kᵀ rewritten as (I−KH)P⁻(I−KH)ᵀ + KRKᵀ) so the scale
stays PSD in f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from . import vanilla


class Model(NamedTuple):
    f: jax.Array  # [n, n]
    g: Optional[jax.Array]  # [n, m] or None
    h: jax.Array  # [p, n]
    noise: Noise  # q/r are the t SCALE matrices (not moment covariances)
    dof: float  # static ν > 2


class State(NamedTuple):
    x: jax.Array  # [n]
    p_scale: jax.Array  # [n, n] posterior t scale matrix
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    """covariance/pred_covariance are MOMENT covariances (ν/(ν−2)·scale)
    so NEES/within_nsigma consumers calibrate exactly like the Gaussian
    filters; the raw scale matrix rides in `scale`."""

    state: jax.Array
    measurement: jax.Array
    innovation: jax.Array
    covariance: jax.Array
    pred_covariance: jax.Array
    gain: jax.Array
    scale: jax.Array  # [n, n] posterior scale matrix
    mahalanobis_sq: jax.Array  # [] δ² of this step's innovation

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0_scale, f, g, h, noise: Noise, dof: float = 4.0):
    """Build (Model, State).  `p0_scale` is the prior SCALE matrix; to
    match a Gaussian prior with covariance P0 use p0_scale=(ν−2)/ν·P0.
    `noise.q`/`noise.r` are likewise scale matrices."""
    if not dof > 2.0:
        raise ValueError(f"Student-t filter needs dof > 2 (got {dof}); "
                         "dof <= 2 has no finite covariance to match")
    x0 = jnp.asarray(x0)
    p0_scale = jnp.asarray(p0_scale)
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    g = None if g is None or linalg.is_nil(g) else jnp.asarray(g)
    linalg.check_dims((x0.shape[0], 1), p0_scale.shape, "x0", "P0", "rows2cols")
    linalg.check_dims(f.shape, p0_scale.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
    return Model(f, g, h, noise, float(dof)), State(x0, p0_scale, jnp.int32(0))


def moment_covariance(model: Model, scale: jax.Array) -> jax.Array:
    """Second-moment covariance of St(·; m, scale, ν) = ν/(ν−2)·scale."""
    nu = model.dof
    return (nu / (nu - 2.0)) * scale


@linalg.highp
def predict(model: Model, state: State, control=None):
    """Time update: scale matrices propagate exactly like covariances
    under the common-dof joint-t assumption (Roth 2013, eq. 8-9)."""
    x = model.f @ state.x
    if model.g is not None and control is not None:
        x = x + model.g @ control
    p = linalg.sym(model.f @ state.p_scale @ model.f.T + model.noise.q)
    return x, p


@linalg.highp
def step(model: Model, state: State, measurement, control=None, has=None):
    """One Student-t filter step.  `has` (traced bool) masks the
    measurement update: when False the posterior equals the prediction
    exactly (no dof bookkeeping — a skipped measurement carries no
    information, so the scale passes through unchanged)."""
    nu = model.dof
    p_dim = model.h.shape[0]
    x_pred, p_pred = predict(model, state, control)

    y_hat = model.h @ x_pred
    pht = p_pred @ model.h.T
    s = linalg.sym(model.h @ pht + model.noise.r)
    k_gain = linalg.solve_psd(s, pht.T).T
    innovation = measurement - y_hat
    delta_sq = innovation @ linalg.solve_psd(s, innovation)

    if has is not None:
        k_gain = jnp.where(has, k_gain, jnp.zeros_like(k_gain))
        innovation = jnp.where(has, innovation, jnp.zeros_like(innovation))
        delta_sq = jnp.where(has, delta_sq, jnp.zeros_like(delta_sq))
    x = x_pred + k_gain @ innovation

    # Joseph form of P⁻ − K S Kᵀ (exact for the optimal gain, PSD by
    # construction in f32), then the t rescale + dof moment match.
    p_post = vanilla.joseph_update(p_pred, k_gain, model.h, model.noise.r)
    nu_post = nu + p_dim
    factor = ((nu + delta_sq) / nu_post) \
        * ((nu - 2.0) / nu) * (nu_post / (nu_post - 2.0))
    if has is not None:
        # Masked step: posterior scale == predicted scale, untouched.
        factor = jnp.where(has, factor, jnp.ones_like(factor))
        p_post = jnp.where(has, p_post, p_pred)
    p_scale = factor * p_post

    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=moment_covariance(model, p_scale),
        pred_covariance=moment_covariance(model, p_pred),
        gain=k_gain,
        scale=p_scale,
        mahalanobis_sq=delta_sq,
    )
    return State(x, p_scale, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None,
        meas_masks=None):
    """lax.scan driver; meas_masks ([T] bool) marks measurement steps."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))
