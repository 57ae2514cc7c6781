"""Rao-Blackwellized (marginalized) particle filter.

For conditionally linear-Gaussian models (Schön, Gustafsson & Nordlund
2005) the linear substate can be marginalized analytically: particles
sample only the nonlinear substate η, and each particle carries a
Kalman filter over the linear substate z.  The Rao-Blackwell theorem
guarantees the estimator variance is never worse than a plain particle
filter with the same N — in practice far better, since the sampled
dimension shrinks.

Model class handled here:

    η_{k+1} = f(η_k) + w_η,            w_η ~ N(0, Q_η)   (sampled)
    z_{k+1} = F z_k + g(η_k) + w_z,    w_z ~ N(0, Q_z)   (marginalized)
    y_k     = h(η_k) + C(η_k) z_k + v, v   ~ N(0, R)

Weights use the exact marginal likelihood
p(y | η_{1:k}) = N(y; h(η) + C z⁻, C P⁻ Cᵀ + R) — no likelihood
approximation — and the per-particle KF measurement update conditions
z on the same observation.

Static-shape design: the particle axis is one `vmap` over everything —
the N mini-KFs are batched [N, nz, nz] linalg, the resampling is
the same branch-free systematic gather as filters.particle.  The whole
filter is a single fused scan.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from .particle import effective_sample_size, systematic_resample_indices


class Model(NamedTuple):
    f_mat: jax.Array  # [nz, nz] linear-substate transition F
    q_eta: jax.Array  # [ne, ne] nonlinear-substate process noise
    q_z: jax.Array  # [nz, nz] linear-substate process noise
    r: jax.Array  # [p, p] measurement noise
    sqrt_q_eta: jax.Array  # [ne, ne] lower factor for sampling


class State(NamedTuple):
    etas: jax.Array  # [N, ne] sampled nonlinear substates
    zs: jax.Array  # [N, nz] per-particle KF means
    ps: jax.Array  # [N, nz, nz] per-particle KF covariances
    log_weights: jax.Array  # [N], normalized
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    eta: jax.Array  # [ne] weighted nonlinear-substate mean
    z: jax.Array  # [nz] weighted linear-substate mean
    eta_covariance: jax.Array  # [ne, ne] weighted sample covariance
    z_covariance: jax.Array  # [nz, nz] E_w[P] + spread-of-means
    ess: jax.Array
    log_likelihood: jax.Array  # [] incremental log p(y_k | y_{1:k-1})
    resampled: jax.Array


def new(eta0, p_eta0, z0, p_z0, f_mat, q_eta, q_z, r, n_particles: int,
        key: jax.Array):
    """Initial cloud: η_i ~ N(eta0, P_eta0); every particle starts the
    marginal KF at (z0, P_z0)."""
    eta0 = jnp.asarray(eta0)
    p_eta0 = jnp.asarray(p_eta0)
    z0 = jnp.asarray(z0)
    p_z0 = jnp.asarray(p_z0)
    f_mat = jnp.asarray(f_mat)
    q_eta = jnp.asarray(q_eta)
    q_z = jnp.asarray(q_z)
    r = jnp.asarray(r)
    linalg.check_dims((eta0.shape[0], 1), p_eta0.shape, "eta0", "P_eta0",
                      "rows2cols")
    linalg.check_dims((z0.shape[0], 1), p_z0.shape, "z0", "P_z0", "rows2cols")
    linalg.check_dims(f_mat.shape, q_z.shape, "F", "Q_z", "rows2cols")
    ze = jax.random.normal(key, (n_particles, eta0.shape[0]), eta0.dtype)
    etas = eta0[None, :] + ze @ jnp.linalg.cholesky(p_eta0).T
    model = Model(f_mat, q_eta, q_z, r, jnp.linalg.cholesky(q_eta))
    lw = jnp.full((n_particles,), -jnp.log(float(n_particles)), eta0.dtype)
    return model, State(
        etas,
        jnp.broadcast_to(z0, (n_particles,) + z0.shape),
        jnp.broadcast_to(p_z0, (n_particles,) + p_z0.shape),
        lw,
        jnp.int32(0),
    )


@linalg.highp
def step(model: Model, state: State, measurement, f_eta: Callable,
         g_eta: Callable, h_eta: Callable, c_eta: Callable, key: jax.Array,
         resample_threshold: float = 0.5, has=None):
    """One RBPF step.

    f_eta(η) -> [ne] nonlinear drift; g_eta(η) -> [nz] linear-substate
    input; h_eta(η) -> [p] measurement offset; c_eta(η) -> [p, nz]
    measurement matrix.  All are per-particle jittable callables,
    vmapped here.  `has` masks the measurement (pure propagation step),
    as everywhere in this framework.
    """
    n = state.etas.shape[0]
    k_prop, k_res = jax.random.split(key)

    # 1. Sample the nonlinear substate forward.
    ze = jax.random.normal(k_prop, state.etas.shape, state.etas.dtype)
    etas = jax.vmap(f_eta)(state.etas) + ze @ model.sqrt_q_eta.T

    # 2. Per-particle KF time update for z.  The documented model is
    # z_{k+1} = F z_k + g(eta_k): g is evaluated at the PRE-propagation
    # nonlinear substate, matching f_eta's input.
    zs_pred = state.zs @ model.f_mat.T + jax.vmap(g_eta)(state.etas)
    ps_pred = jnp.einsum("ij,njk,lk->nil", model.f_mat, state.ps,
                         model.f_mat) + model.q_z[None]

    # 3. Marginal likelihood + KF measurement update, per particle.
    hs = jax.vmap(h_eta)(etas)  # [N, p]
    cs = jax.vmap(c_eta)(etas)  # [N, p, nz]

    def meas_update(z_pred, p_pred, h_off, c):
        y_pred = h_off + c @ z_pred
        s = c @ p_pred @ c.T + model.r
        ls = jnp.linalg.cholesky(s)
        innov = measurement - y_pred
        e = linalg.solve_tri_lower(ls, innov)
        p_dim = model.r.shape[0]
        ll = (
            -0.5 * jnp.dot(e, e)
            - jnp.sum(jnp.log(jnp.diagonal(ls)))
            - 0.5 * p_dim * jnp.log(2.0 * jnp.pi)
        )
        k_gain = jax.scipy.linalg.cho_solve((ls, True), c @ p_pred).T
        z_new = z_pred + k_gain @ innov
        nz = z_pred.shape[0]
        ikh = jnp.eye(nz, dtype=p_pred.dtype) - k_gain @ c
        p_new = linalg.sym(ikh @ p_pred @ ikh.T + k_gain @ model.r @ k_gain.T)
        return z_new, p_new, ll

    zs_new, ps_new, lls = jax.vmap(meas_update)(zs_pred, ps_pred, hs, cs)
    if has is not None:
        lls = jnp.where(has, lls, jnp.zeros_like(lls))
        zs_new = jnp.where(has, zs_new, zs_pred)
        ps_new = jnp.where(has, ps_new, ps_pred)

    lw = state.log_weights + lls
    log_inc = jax.scipy.special.logsumexp(lw)
    lw = lw - log_inc
    if has is not None:
        log_inc = jnp.where(has, log_inc, jnp.zeros_like(log_inc))

    # 4. Rao-Blackwellized moments.
    w = jnp.exp(lw)
    eta_mean = w @ etas
    eta_dev = etas - eta_mean[None, :]
    eta_cov = (eta_dev * w[:, None]).T @ eta_dev / jnp.maximum(
        1.0 - jnp.sum(w**2), 1e-12
    )
    z_mean = w @ zs_new
    z_dev = zs_new - z_mean[None, :]
    # Same unbiased normalization as eta_cov so the two covariance
    # blocks of one Estimate are mutually consistent.
    z_cov = jnp.einsum("n,nij->ij", w, ps_new) + (
        (z_dev * w[:, None]).T @ z_dev
    ) / jnp.maximum(1.0 - jnp.sum(w**2), 1e-12)
    ess = effective_sample_size(lw)

    # 5. Branch-free systematic resampling of the JOINT particle.
    idx = systematic_resample_indices(lw, k_res)
    do_res = ess < resample_threshold * n
    if has is not None:
        do_res = jnp.logical_and(do_res, has)
    take = jnp.where(do_res, idx, jnp.arange(n, dtype=jnp.int32))
    etas = jnp.take(etas, take, axis=0)
    zs_new = jnp.take(zs_new, take, axis=0)
    ps_new = jnp.take(ps_new, take, axis=0)
    lw = jnp.where(
        do_res, jnp.full_like(lw, -jnp.log(float(n))), jnp.take(lw, take)
    )

    est = Estimate(
        eta=eta_mean,
        z=z_mean,
        eta_covariance=linalg.sym(eta_cov),
        z_covariance=linalg.sym(z_cov),
        ess=ess,
        log_likelihood=log_inc,
        resampled=do_res,
    )
    return State(etas, zs_new, ps_new, lw, state.k + 1), est


def run(model: Model, state: State, measurements, f_eta: Callable,
        g_eta: Callable, h_eta: Callable, c_eta: Callable, key: jax.Array,
        meas_masks=None, resample_threshold: float = 0.5):
    """lax.scan driver; total evidence = estimates.log_likelihood.sum()."""
    t = measurements.shape[0]
    keys = jax.random.split(key, t)

    def body(carry, xs):
        meas, has, k = xs
        return step(model, carry, meas, f_eta, g_eta, h_eta, c_eta, k,
                    resample_threshold, has)

    return jax.lax.scan(body, state, (measurements, meas_masks, keys))
