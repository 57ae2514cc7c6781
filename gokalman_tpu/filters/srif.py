"""Square-root information filter (SRIF) for nonlinear systems.

Rebuild of the reference SRIF (reference: srif.go:14-340; algorithms
from Tapley, Schutz & Born "Statistical Orbit Determination"): the
state is carried as (R, b) with x = R^{-1} b and P = R^{-1} R^{-T}.

- the Prepare/locked handshake (srif.go:82-86, 102-104) disappears:
  Φ and H̃ are explicit arguments to the pure update functions;
- the measurement update stacks A = [[R̄, b̄], [H̃, y]] and runs the
  Householder triangularization (srif.go:298-340), which here is the
  vectorized masked-rank-1 kernel in linalg.householder_triangularize;
- `non_tri_r=True` skips the time-update re-triangularization of
  [R̄ | b̄] (srif.go:121-132) — a static flag, two compiled variants;
- process noise IS supported (the reference panics, srif.go:77-79):
  passing `gamma` to `new` enables the Dyer–McReynolds factored time
  update (Bierman "Factorization Methods" ch. VII; Tapley, Schutz &
  Born §5.7.2).  With dynamics x_{k+1} = Φ x_k + Γ u, u ~ N(0, Q),
  the prior data equations  R_w u = 0 + ν_w  (R_wᵀR_w = Q⁻¹) and
  R_k x_k = b_k + ν_k  combine, after substituting
  x_k = Φ⁻¹(x_{k+1} − Γ u), into the stacked system

      [ R_w      0  | 0   ]          [ R̂_w  R̂_wx | ẑ_w ]
      [ −R̄Γ     R̄ | b_k ]   --T-->  [ 0     R̄'  | b̄'  ]

  with R̄ = R_k Φ⁻¹; one Householder pass over the (q+n)×(q+n+1)
  stack yields the propagated pair (R̄', b̄') that absorbs √Q with no
  covariance ever formed — the f32-robust square-root property the
  Joseph-form CKF lacks on ill-conditioned workloads.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise


class Model(NamedTuple):
    sqrt_inv_noise: jax.Array  # [p, p] whitening matrix chol(R)^{-1} (srif.go:38-45)
    meas_size: int
    non_tri_r: bool  # static: skip Householder re-triangularization of R̄
    # Optional process noise (Dyer–McReynolds); None compiles to the
    # exact reference-mirroring Q-less time update.
    sqrt_inv_q: object = None  # [q, q] R_w with R_wᵀ R_w = Q⁻¹
    gamma: object = None  # [n, q] noise mapping Γ


class State(NamedTuple):
    r: jax.Array  # [n, n] square-root information matrix
    b: jax.Array  # [n] square-root information state
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    """SRIF estimate (reference: srif.go:196-295)."""

    phi: jax.Array  # STM used this step (kept for smoothing, srif.go:197)
    sqinfo_state: jax.Array  # b
    measurement: jax.Array  # real observation
    obs_dev: jax.Array  # whitened observation deviation (srif.go:247-249)
    r: jax.Array  # R_k
    pred_r: jax.Array  # R̄_k

    @property
    def state(self) -> jax.Array:
        """x = R^{-1} b (srif.go:223-234)."""
        return linalg.solve_qr(self.r, self.sqinfo_state)

    @property
    def innovation(self) -> jax.Array:
        # The reference returns b as "innovation" (srif.go:237-239).
        return self.sqinfo_state

    @property
    def covariance(self) -> jax.Array:
        """P = R^{-1} R^{-T} (srif.go:252-265)."""
        return linalg.factor_product(linalg.inv_qr(self.r))

    @property
    def pred_covariance(self) -> jax.Array:
        return linalg.factor_product(linalg.inv_qr(self.pred_r))

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, meas_size: int, non_tri_r: bool, noise: Noise, gamma=None):
    """Build (Model, State, Estimate0).

    I0 inverts the *diagonal* of P0 elementwise (the reference documents
    P0 as always diagonal, srif.go:22-26); R0 = chol(I0)^T (upper) and
    b0 = R0 x0 (srif.go:27-35).  The whitening matrix is chol(R)^{-1}
    (srif.go:38-45).

    `gamma` ([n, q] noise mapping, e.g. od.snc_gamma for SNC) enables
    the Dyer–McReynolds process-noise time update with Q = noise.q
    (which must then be [q, q] positive definite); the reference
    refuses process noise outright (srif.go:77-79).
    """
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    i0 = jnp.diag(1.0 / jnp.diag(p0))
    r0 = jnp.linalg.cholesky(i0).T  # upper; diagonal here, same as reference
    b0 = r0 @ x0
    sqrt_meas = jnp.linalg.cholesky(noise.r)
    sqrt_inv = linalg.solve_tri_lower(
        sqrt_meas, jnp.eye(sqrt_meas.shape[-1], dtype=sqrt_meas.dtype)
    )
    sqrt_inv_q = None
    if gamma is not None:
        gamma = jnp.asarray(gamma, dtype=x0.dtype)
        q = jnp.asarray(noise.q, dtype=x0.dtype)
        if q.shape != (gamma.shape[1], gamma.shape[1]):
            raise ValueError(
                f"process noise Q {q.shape} must be square matching "
                f"gamma columns ({gamma.shape[1]})"
            )
        lq = jnp.linalg.cholesky(q)
        # R_w = L⁻¹ (lower): R_wᵀ R_w = L⁻ᵀ L⁻¹ = Q⁻¹.
        sqrt_inv_q = linalg.solve_tri_lower(
            lq, jnp.eye(lq.shape[-1], dtype=lq.dtype)
        )
    model = Model(sqrt_inv, meas_size, non_tri_r, sqrt_inv_q, gamma)
    p = meas_size
    est0 = Estimate(
        phi=jnp.eye(x0.shape[0], dtype=x0.dtype),
        sqinfo_state=b0,
        measurement=jnp.zeros((p,), dtype=x0.dtype),
        obs_dev=jnp.zeros((p,), dtype=x0.dtype),
        r=r0,
        pred_r=r0,
    )
    return model, State(r0, b0, jnp.int32(0)), est0


@linalg.highp
def measurement_update(r, h, b, y):
    """Stack A = [[R, b], [H, y]] and Householder-triangularize.

    Returns (Rk, bk, ek) (reference: measurementSRIFUpdate srif.go:298-340).
    """
    r = jnp.asarray(r)
    h = jnp.asarray(h)
    b = jnp.asarray(b)
    y = jnp.asarray(y)
    n = b.shape[-1]
    m = y.shape[-1]
    linalg.check_dims(r.shape, h.shape, "R", "H", "cols2cols")
    a0 = jnp.concatenate([r, h], axis=0)  # [(n+m), n]
    rhs = jnp.concatenate([b, y], axis=0)[:, None]  # [(n+m), 1]
    a = jnp.concatenate([a0, rhs], axis=1)
    a = linalg.householder_triangularize(a, n, m)
    return a[:n, :n], a[:n, n], a[n:, n]


def _time_update(model: Model, state: State, phi):
    """R̄ = R Φ^{-1}, b̄ = R̄ Φ x̂ (srif.go:111-119), with optional
    re-triangularization of [R̄ | b̄] (srif.go:121-132).

    With process noise (model.gamma set), the Dyer–McReynolds stack

        [ R_w     0  | 0 ]      (q rows: prior on u ~ N(0, Q))
        [ -R̄Γ    R̄ | b ]      (n rows: dynamics-mapped data equation)

    is Householder-triangularized over all q+n columns and the bottom
    block is the propagated (R̄', b̄') — see module docstring.  Note
    b̄ = R̄ Φ x̂ = R x̂ = b exactly, so the stacked RHS is just b.
    """
    phi_inv = linalg.inv_qr(phi)  # QR: backward-stable for general Φ
    r_bar = state.r @ phi_inv
    if model.gamma is not None:
        n = state.b.shape[0]
        q = model.gamma.shape[1]
        dtype = r_bar.dtype
        top = jnp.concatenate(
            [model.sqrt_inv_q, jnp.zeros((q, n + 1), dtype)], axis=1
        )
        bot = jnp.concatenate(
            [-(r_bar @ model.gamma), r_bar, state.b[:, None]], axis=1
        )
        a = jnp.concatenate([top, bot], axis=0)  # [(q+n), (q+n+1)]
        a = linalg.householder_triangularize(a, q + n, 0)
        return a[q:, q : q + n], a[q:, q + n]
    x_hat = linalg.solve_qr(state.r, state.b)
    b_bar = r_bar @ (phi @ x_hat)
    if not model.non_tri_r:
        n = b_bar.shape[0]
        a = jnp.concatenate([r_bar, b_bar[:, None]], axis=1)
        a = linalg.householder_triangularize(a, n, 0)
        r_bar = a[:, :n]
        b_bar = a[:, n]
    return r_bar, b_bar


@linalg.highp
def predict(model: Model, state: State, phi):
    """Pure time update (reference: srif.go:96-98, 134-141)."""
    r_bar, b_bar = _time_update(model, state, phi)
    p = model.meas_size
    est = Estimate(
        phi=jnp.asarray(phi),
        sqinfo_state=b_bar,
        measurement=jnp.zeros((p,), dtype=b_bar.dtype),
        obs_dev=jnp.zeros((p,), dtype=b_bar.dtype),
        r=r_bar,
        pred_r=r_bar,
    )
    return State(r_bar, b_bar, state.k + 1), est


@linalg.highp
def update(model: Model, state: State, phi, htilde, real_obs, computed_obs):
    """Full time + measurement update (reference: srif.go:101-160)."""
    r_bar, b_bar = _time_update(model, state, phi)
    y = jnp.asarray(real_obs) - jnp.asarray(computed_obs)
    h_w = model.sqrt_inv_noise @ jnp.asarray(htilde)
    y_w = model.sqrt_inv_noise @ y
    rk, bk, _ek = measurement_update(r_bar, h_w, b_bar, y_w)
    est = Estimate(
        phi=jnp.asarray(phi),
        sqinfo_state=bk,
        measurement=jnp.asarray(real_obs),
        obs_dev=y_w,
        r=rk,
        pred_r=r_bar,
    )
    return State(rk, bk, state.k + 1), est


@linalg.highp
def step(model: Model, state: State, phi, htilde, real_obs, computed_obs, has_meas):
    """Masked update: one compiled step that predicts when has_meas is
    False and updates when True — the scan-with-cond form of the
    reference's Predict/Update pair for measurement-gap handling."""
    st_u, est_u = update(model, state, phi, htilde, real_obs, computed_obs)
    st_p, est_p = predict(model, state, phi)
    pick = lambda a, b: jnp.where(has_meas, a, b)
    return jax.tree.map(pick, st_u, st_p), jax.tree.map(pick, est_u, est_p)


@linalg.highp
def run(model: Model, state: State, phis, htildes, real_obs, computed_obs, has_meas):
    """Scan the masked step over a trajectory of prepared (Φ, H̃) inputs."""

    def body(carry, xs):
        return step(model, carry, *xs)

    return jax.lax.scan(body, state, (phis, htildes, real_obs, computed_obs, has_meas))


@linalg.highp
def smooth_all(estimates: Estimate) -> Estimate:
    """Backward smoother (reference: SmoothAll srif.go:165-192):
    x̂_k = Φ_{k+1}^{-1} x̂_{k+1}, P_k = Φ^{-1} P_{k+1} Φ^{-T}, as a
    reverse lax.scan over the stacked estimate pytree.  Returns
    estimates with smoothed state folded back in via (R, b) such that
    state/covariance reproduce the smoothed values.

    Assumes Q = 0 (deterministic dynamics between estimates), exactly
    like the reference; for a filter built with process noise
    (new(..., gamma=...)) use `smooth_all_q`, which accounts for the
    noise term in the backward pass.
    """
    from .smoothing import phi_inverse_smoother

    xs_sm, ps_sm = phi_inverse_smoother(
        estimates.phi, estimates.state, estimates.covariance
    )
    return _encode_smoothed(estimates, xs_sm, ps_sm)


@linalg.highp
def smooth_all_q(model: Model, estimates: Estimate) -> Estimate:
    """Fixed-interval smoother for a process-noise SRIF (moment-form
    RTS): the backward pass uses P̄_{k+1} = Φ P_k Φᵀ + Γ Q Γᵀ, so the
    smoothed trajectory correctly discounts the noise the filter
    absorbed — `smooth_all`'s deterministic Φ-inverse backmap is wrong
    whenever Q ≠ 0 (it treats every propagated deviation as exact).
    Beyond the reference (whose SRIF refuses process noise,
    srif.go:77-79).  Requires a model built with `gamma`.
    """
    if model.gamma is None:
        raise ValueError("smooth_all_q needs a process-noise model "
                         "(srif.new(..., gamma=...)); use smooth_all")
    from .smoothing import rts_smoother

    # Recover Q = L Lᵀ from the stored R_w = L⁻¹.
    lq = linalg.solve_tri_lower(
        model.sqrt_inv_q,
        jnp.eye(model.sqrt_inv_q.shape[-1], dtype=model.sqrt_inv_q.dtype),
    )
    q_eff = model.gamma @ (lq @ lq.T) @ model.gamma.T
    xs_sm, ps_sm = rts_smoother(
        estimates.phi, q_eff, estimates.state, estimates.covariance
    )
    return _encode_smoothed(estimates, xs_sm, ps_sm)


def _encode_smoothed(estimates: Estimate, xs_sm, ps_sm) -> Estimate:
    # Re-encode smoothed (x, P) as (R, b): R = chol(P^{-1})^T, b = R x.
    def encode(x, p):
        info = linalg.inv_psd(p)
        r = jnp.linalg.cholesky(linalg.sym(info)).T
        return r, r @ x

    rs, bs = jax.vmap(encode)(xs_sm, ps_sm)
    return estimates._replace(r=rs, pred_r=rs, sqinfo_state=bs)
