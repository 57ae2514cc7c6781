"""Bierman-Thornton U-D factorized Kalman filter.

The third classical factorized form alongside the QR square-root filter
(reference: squareroot.go:21-50, which motivates factor propagation for
exactly the conditioning reasons mirrored here) and the SRIF
(srif.go:14-49): the covariance is carried as P = U diag(d) Uᵀ with U
unit upper-triangular.  Unlike the QR form there are NO square roots in
the recursion at all — only multiplies and scalar divides — which keeps
it exact on the factored representation at f32:

- time update: Thornton's modified weighted Gram-Schmidt (MWGS) over
  the stacked [F·U | Gq] block with weights [d | dq] (Bierman 1977
  §VI.4; Thornton 1976), the U-D analogue of the reference's stacked-QR
  time update (squareroot.go:155-185);
- measurement update: Bierman's rank-one scalar update (Bierman 1977
  §V.3), applied sequentially to Cholesky-whitened measurement rows —
  whitening makes the components independent, so sequential scalar
  processing equals the batch update exactly and the reference's
  scalar-measurement special case (squareroot.go:247-252) becomes the
  general path.

Design: n is small and static, so the inherently sequential j-loops
(MWGS elimination, Bierman's alpha recursion) are unrolled at trace
time into [n]-vector ops — no dynamic control flow, XLA fuses the whole
step; under vmap the unrolled ops batch over the ensemble axis like
every other filter here.  All algebra runs under linalg.highp.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise, measurement_sample, process_sample


class Model(NamedTuple):
    f: jax.Array  # [n, n]
    g: Optional[jax.Array]  # [n, m] control map or None
    h: jax.Array  # [p, n]
    noise: Noise
    gq: jax.Array  # [n, nq] process-noise map with Q = Gq diag(dq) Gqᵀ
    dq: jax.Array  # [nq]


class State(NamedTuple):
    x: jax.Array  # [n]
    u: jax.Array  # [n, n] unit upper-triangular
    d: jax.Array  # [n] diagonal of D (P = U D Uᵀ)
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    """U-D estimate; covariance reconstructed lazily like the
    reference's SquareRootEstimate (squareroot.go:278-355)."""

    state: jax.Array
    measurement: jax.Array
    innovation: jax.Array
    u: jax.Array  # posterior factor
    d: jax.Array
    u_pred: jax.Array  # predicted factor
    d_pred: jax.Array
    gain: jax.Array  # effective K = P⁺ Hᵀ R⁻¹

    @property
    def covariance(self) -> jax.Array:
        return _reconstruct(self.u, self.d)

    @property
    def pred_covariance(self) -> jax.Array:
        return _reconstruct(self.u_pred, self.d_pred)

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


@linalg.highp
def _reconstruct(u, d):
    """P = U diag(d) Uᵀ at f32 matmul precision (see linalg.factor_product)."""
    return (u * d[..., None, :]) @ jnp.swapaxes(u, -1, -2)


@linalg.highp
def udu_factor(p):
    """(U, d) with P = U diag(d) Uᵀ, U unit upper-triangular.

    Backward rank-one elimination (Bierman 1977 §III.4).  Handles
    singular PSD inputs: a zero pivot yields a zero column (and zero d),
    so rank-deficient process noise factors cleanly.
    """
    p = jnp.asarray(p)
    p = 0.5 * (p + p.T)
    n = p.shape[0]
    dt = p.dtype
    idx = jnp.arange(n)
    u = jnp.zeros((n, n), dtype=dt)
    d = jnp.zeros(n, dtype=dt)
    w = p
    for j in range(n - 1, -1, -1):
        dj = w[j, j]
        ok = dj > 0
        d = d.at[j].set(jnp.where(ok, dj, 0.0))
        col = jnp.where(ok & (idx < j), w[:, j] / jnp.where(ok, dj, 1.0), 0.0)
        cfull = col + (idx == j).astype(dt)
        u = u.at[:, j].set(cfull)
        w = w - jnp.where(ok, dj, 0.0) * jnp.outer(cfull, cfull)
    return u, d


@linalg.highp
def thornton_time_update(u, d, f, gq, dq):
    """(U⁻, d⁻) with U⁻D⁻U⁻ᵀ = F U D Uᵀ Fᵀ + Gq diag(dq) Gqᵀ.

    Thornton's MWGS orthogonalization of the rows of W = [F·U | Gq]
    under the weighted inner product diag([d | dq]) — the U-D analogue
    of the reference's stacked-QR time update (squareroot.go:155-185),
    but square-root-free.
    """
    n = u.shape[0]
    dt = u.dtype
    idx = jnp.arange(n)
    w = jnp.concatenate([f @ u, gq], axis=1)  # [n, n+nq]
    dw = jnp.concatenate([d, dq])  # [n+nq]
    u_new = jnp.eye(n, dtype=dt)
    d_new = jnp.zeros(n, dtype=dt)
    for j in range(n - 1, -1, -1):
        v = w[j] * dw
        dj = w[j] @ v
        ok = dj > 0
        d_new = d_new.at[j].set(jnp.where(ok, dj, 0.0))
        c = jnp.where(ok & (idx < j), (w @ v) / jnp.where(ok, dj, 1.0), 0.0)
        u_new = u_new.at[:, j].set(c + (idx == j).astype(dt))
        w = w - jnp.outer(c, w[j])
    return u_new, d_new


@linalg.highp
def bierman_update(u, d, h_row, r_scalar):
    """(U⁺, d⁺, k) for one scalar measurement row: rank-one U-D
    downdate (Bierman 1977 §V.3).  Returns the gain VECTOR k [n]; the
    alpha recursion is unrolled over the (static, small) state dim.
    """
    n = u.shape[0]
    dt = u.dtype
    f = u.T @ h_row  # [n]
    g = d * f  # [n]
    alpha = jnp.asarray(r_scalar, dt)
    kvec = jnp.zeros(n, dt)
    u_cols = []
    d_new = jnp.zeros(n, dt)
    for j in range(n):
        alpha_next = alpha + f[j] * g[j]
        safe = jnp.where(alpha_next > 0, alpha_next, 1.0)
        d_new = d_new.at[j].set(d[j] * alpha / safe)
        lam = -f[j] / jnp.where(alpha > 0, alpha, 1.0)
        u_cols.append(u[:, j] + lam * kvec)
        kvec = kvec + g[j] * u[:, j]
        alpha = alpha_next
    u_new = jnp.stack(u_cols, axis=1)
    return u_new, d_new, kvec / jnp.where(alpha > 0, alpha, 1.0)


def new(x0, p0, f, g, h, noise: Noise, gamma=None):
    """Build (Model, State): U0 d0 from P0, process noise factored once
    at config time (Q = Gq diag(dq) Gqᵀ; with `gamma` [n, m] given, the
    model noise q is m×m and Gq = gamma·Uq).  Dim checks mirror
    vanilla.new (vanilla.go:21-40)."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    g = None if g is None or linalg.is_nil(g) else jnp.asarray(g)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
    uq, dq = udu_factor(noise.q)
    if gamma is not None:
        gamma = jnp.asarray(gamma)
        linalg.check_dims((f.shape[0], 1), (gamma.shape[0], 1), "F", "Gamma",
                          "rows2rows")
        uq = gamma @ uq
    u0, d0 = udu_factor(p0)
    return (Model(f, g, h, noise, uq, dq),
            State(x0, u0, d0, jnp.int32(0)))


@linalg.highp
def step(model: Model, state: State, measurement, control=None, w=None,
         v=None, h=None, r=None, meas_mask=None):
    """One U-D filter step.

    Conventions match vanilla.step (vanilla.go:128-220): `w` is a
    process-noise draw added in the prediction, `v` a measurement-noise
    draw added to the estimated measurement; `h`/`r`/`meas_mask`
    override the measurement model per step (padded time-varying
    shapes, see vanilla.mask_measurement — a masked row whitens to a
    zero H row against unit variance, so its Bierman update is exactly
    a no-op).
    """
    if h is not None or r is not None or meas_mask is not None:
        from .vanilla import mask_measurement

        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement,
                                                     meas_mask)
        model = model._replace(h=h_k, noise=model.noise._replace(r=r_k))

    x_pred = model.f @ state.x
    if model.g is not None and control is not None:
        x_pred = x_pred + model.g @ control
    if w is not None:
        x_pred = x_pred + w

    u_pred, d_pred = thornton_time_update(state.u, state.d, model.f,
                                          model.gq, model.dq)

    y_hat = model.h @ state.x  # from the previous state (vanilla.go:155-157)
    if v is not None:
        y_hat = y_hat + v
    innovation = measurement - model.h @ x_pred

    # Whiten the measurement rows so sequential scalar processing is
    # exact for correlated R.
    l = jnp.linalg.cholesky(model.noise.r)
    hw = jax.scipy.linalg.solve_triangular(l, model.h, lower=True)
    zw = jax.scipy.linalg.solve_triangular(l, innovation, lower=True)

    x = x_pred
    u, d = u_pred, d_pred
    for i in range(hw.shape[0]):
        z_i = zw[i] - hw[i] @ (x - x_pred)
        u, d, kvec = bierman_update(u, d, hw[i], jnp.asarray(1.0, u.dtype))
        x = x + kvec * z_i

    p_plus = (u * d[None, :]) @ u.T
    k_eff = jax.scipy.linalg.cho_solve((l, True), model.h @ p_plus).T

    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        u=u,
        d=d,
        u_pred=u_pred,
        d_pred=d_pred,
        gain=k_eff,
    )
    return State(x, u, d, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None, key=None,
        hs=None, rs=None, meas_masks=None):
    """lax.scan driver (hs/rs/meas_masks: per-step measurement-model
    overrides, see vanilla.run)."""
    steps = jnp.shape(measurements)[0]
    keys = None if key is None else jax.random.split(key, steps)

    def body(carry, xs):
        meas, ctrl, k, h_k, r_k, mask = xs
        w = v = None
        if k is not None:
            kw, kv = jax.random.split(k)
            w = process_sample(model.noise, kw)
            v = measurement_sample(model.noise, kv)
        return step(model, carry, meas, ctrl, w, v, h_k, r_k, mask)

    xs = (measurements, controls, keys, hs, rs, meas_masks)
    return jax.lax.scan(body, state, xs, length=steps)
