"""Information filter (KF in information space).

Rebuild of the reference information filter (reference:
information.go:20-330): state carried as (i = I·x, I = P^{-1}); F, Q, R
are inverted once at construction (information.go:38-50); the estimate
exposes state/covariance by inversion on demand.  The reference's lazy
cached inverses (information.go:257-316) are just functions here — XLA
CSE/DCE gives the same "compute only if used" behavior under jit.
The scalar-R special case (information.go:198-203) disappears under
batched linalg.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise, measurement_sample


def _inv_or_zero(m: jax.Array) -> jax.Array:
    """Inverse, or zeros when singular (the reference prints a warning
    and substitutes a nil matrix, information.go:69-75, 286)."""
    inv = jnp.linalg.inv(m)
    finite = jnp.all(jnp.isfinite(inv))
    return jnp.where(finite, inv, jnp.zeros_like(inv))


def _norm1(m: jax.Array) -> jax.Array:
    return jnp.max(jnp.sum(jnp.abs(m), axis=-2), axis=-1)


def _inv_or_zero_cond(m: jax.Array) -> jax.Array:
    """gonum-faithful estimate-side inverse: zeros when ill-conditioned.

    The reference's InformationEstimate.Covariance() discards the
    computed inverse whenever mat64.Inverse reports a Condition error
    (information.go:278-293) — gonum flags cond_1(A) > 1e16.  The
    filter *constructor* keeps ill-conditioned inverses (the Go ctor
    only prints a warning and uses the receiver anyway,
    information.go:38-50), so this gate applies only on the
    estimate-export path, exactly like the reference.
    """
    inv = jnp.linalg.inv(m)
    cond = _norm1(m) * _norm1(inv)
    ok = jnp.all(jnp.isfinite(inv)) & (cond <= 1e16)
    return jnp.where(ok, inv, jnp.zeros_like(inv))


class Model(NamedTuple):
    f_inv: jax.Array  # [n, n] inverse state transition (information.go:38)
    g: Optional[jax.Array]  # [n, m] control or None
    h: jax.Array  # [p, n]
    q_inv: jax.Array  # [n, n]
    r_inv: jax.Array  # [p, p]
    noise: Noise


class State(NamedTuple):
    i: jax.Array  # [n] information state
    info: jax.Array  # [n, n] information matrix
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    """Information-space estimate (reference: information.go:231-330)."""

    info_state: jax.Array  # i^+
    measurement: jax.Array  # \hat{y}
    info_mat: jax.Array  # I^+
    pred_info_mat: jax.Array  # I^-

    @property
    def state(self) -> jax.Array:
        return linalg.highp(jnp.einsum)(
            "...ij,...j->...i", self.covariance, self.info_state)

    @property
    def innovation(self) -> jax.Array:
        # The reference returns the information state as "innovation"
        # (information.go:272-274).
        return self.info_state

    @property
    def covariance(self) -> jax.Array:
        if self.info_mat.ndim == 2:
            return _inv_or_zero_cond(self.info_mat)
        return jax.vmap(_inv_or_zero_cond)(self.info_mat)

    @property
    def pred_covariance(self) -> jax.Array:
        if self.pred_info_mat.ndim == 2:
            return _inv_or_zero_cond(self.pred_info_mat)
        return jax.vmap(_inv_or_zero_cond)(self.pred_info_mat)

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(i0, info0, f, g, h, noise: Noise):
    """Build from information-space initials (reference: information.go:20-53)."""
    i0 = jnp.asarray(i0)
    info0 = jnp.asarray(info0)
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    g = None if g is None or linalg.is_nil(g) else jnp.asarray(g)
    linalg.check_dims((i0.shape[0], 1), info0.shape, "i0", "I0", "rows2cols")
    linalg.check_dims(f.shape, info0.shape, "F", "I0", "rows2cols")
    linalg.check_dims(h.shape, (i0.shape[0], 1), "H", "i0", "cols2rows")
    model = Model(
        f_inv=_inv_or_zero(f),
        g=g,
        h=h,
        q_inv=_inv_or_zero(noise.q),
        r_inv=_inv_or_zero(noise.r),
        noise=noise,
    )
    return model, State(i0, info0, jnp.int32(0))


def new_from_state(x0, p0, f, g, h, noise: Noise):
    """Build from (x0, P0): I0 = P0^{-1} (zeros when singular), i0 = I0 x0.

    Reference: information.go:65-81.
    """
    p0 = jnp.asarray(p0)
    info0 = _inv_or_zero(p0)
    i0 = info0 @ jnp.asarray(x0)
    return new(i0, info0, f, g, h, noise)


@linalg.highp
def step(model: Model, state: State, measurement, control=None, v=None,
         h=None, r=None, meas_mask=None):
    """One information-filter update (reference: information.go:153-227).

    `h`/`r`/`meas_mask` override the measurement model per step
    (time-varying padded measurements, see vanilla.mask_measurement);
    R^{-1} is recomputed for the step when overridden.
    """
    if h is not None or r is not None or meas_mask is not None:
        from .vanilla import mask_measurement

        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else jnp.asarray(r)
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement, meas_mask)
        model = model._replace(h=h_k, r_inv=_inv_or_zero(r_k))
    # z = F^{-T} I F^{-1} (information.go:163-165).
    z = model.f_inv.T @ state.info @ model.f_inv
    # M = -z (z + Q^{-1})^{-1} (information.go:169-174).
    m = -jnp.linalg.solve((z + model.q_inv).T, z.T).T
    n = z.shape[0]

    i_pred = model.f_inv.T @ state.i
    if model.g is not None and control is not None:
        i_pred = i_pred + z @ (model.g @ control)
    i_pred = (jnp.eye(n, dtype=z.dtype) + m) @ i_pred
    info_pred = linalg.sym(z + m @ z.T)

    # Estimated measurement from the previous state (information.go:192-194):
    # x = I^{-1} i, zeros while the information matrix is singular or
    # ill-conditioned (the reference's prevEst.State() goes through the
    # condition-gated Covariance(), information.go:257-264).
    x_prev = _inv_or_zero_cond(state.info) @ state.i
    y_hat = model.h @ x_prev
    if v is not None:
        y_hat = y_hat + v

    htr = model.h.T @ model.r_inv
    i_plus = i_pred + htr @ measurement
    info_plus = linalg.sym(info_pred + htr @ model.h)

    est = Estimate(i_plus, y_hat, info_plus, info_pred)
    return State(i_plus, info_plus, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None, key=None,
        hs=None, rs=None, meas_masks=None):
    """lax.scan driver over the time axis (hs/rs/meas_masks: per-step
    measurement-model overrides, see vanilla.run)."""
    steps = jnp.shape(measurements)[0]
    keys = None if key is None else jax.random.split(key, steps)

    def body(carry, xs):
        meas, ctrl, k, h_k, r_k, mask = xs
        v = None if k is None else measurement_sample(model.noise, k)
        return step(model, carry, meas, ctrl, v, h_k, r_k, mask)

    xs = (measurements, controls, keys, hs, rs, meas_masks)
    return jax.lax.scan(body, state, xs, length=steps)
