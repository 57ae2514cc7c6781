"""Gauss-Hermite quadrature Kalman filter (GHKF) — and a generic
deterministic-rule Gaussian filter it instantiates.

Completes the sigma-point hierarchy: the UKF/CKF (filters/ukf.py) are
3rd-degree rules — exact for polynomials of degree 3 under a Gaussian;
the Gauss-Hermite filter (Ito & Xiong 2000; Arasaratnam, Haykin & Elliott
2007) uses a tensor product of 1-D Gauss-Hermite nodes, exact to degree
2·order−1, so strongly nonlinear measurement/dynamics maps (cubics,
quartics, exponentials) get materially better posterior moments at the
cost of order^n points.  Practical for n ≤ ~6 — exactly the filter
sizes this framework targets (the reference never exceeds n=6,
SURVEY.md §3.1).

The module is a generic *quadrature filter*: any unit rule (points
ξ_i ~ N(0, I) abscissae + weights summing to 1) drives the same
predict/update; `gauss_hermite_rule(n, order)` supplies the GH rule and
`spherical_radial_rule(n)` reproduces the cubature points (pinned
==ukf.cubature_params in tests).  Points transform as x + chol(P) ξ — a
[K, n] batch matmul per step, vmappable over ensembles like
every filter here.

Design notes: rules are built HOST-SIDE in numpy at trace time (static
shapes; order^n is a compile-time constant), the step is pure jnp.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import linalg
from ..noise import Noise


class Rule(NamedTuple):
    """Unit quadrature rule for N(0, I_n) expectations."""

    points: jax.Array  # [K, n] unit abscissae
    weights: jax.Array  # [K] weights, sum to 1


class Model(NamedTuple):
    noise: Noise
    rule: Rule


class State(NamedTuple):
    x: jax.Array  # [n]
    p: jax.Array  # [n, n]
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array
    measurement: jax.Array
    innovation: jax.Array
    covariance: jax.Array
    pred_covariance: jax.Array
    gain: jax.Array
    innovation_covariance: jax.Array = None

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def gauss_hermite_rule(n: int, order: int = 3, dtype=None) -> Rule:
    """Tensor-product Gauss-Hermite rule: order^n points, exact for
    polynomial integrands up to total degree 2·order−1 per axis under
    N(0, I).  Probabilists' (Hermite-e) nodes, so the abscissae are in
    unit-variance coordinates directly."""
    if order < 1:
        raise ValueError(f"order must be >= 1 (got {order})")
    x1, w1 = np.polynomial.hermite_e.hermegauss(order)
    w1 = w1 / w1.sum()
    grids = np.stack(np.meshgrid(*([x1] * n), indexing="ij"), axis=0)
    pts = grids.reshape(n, -1).T  # [order^n, n]
    wgrids = np.stack(np.meshgrid(*([w1] * n), indexing="ij"), axis=0)
    ws = wgrids.reshape(n, -1).prod(axis=0)
    dtype = dtype or jnp.zeros(0).dtype
    return Rule(jnp.asarray(pts, dtype), jnp.asarray(ws, dtype))


def spherical_radial_rule(n: int, dtype=None) -> Rule:
    """The 3rd-degree spherical-radial cubature rule (Arasaratnam &
    Haykin 2009): 2n points at ±sqrt(n) e_i, equal weights — the same
    rule ukf.cubature_params() induces (pinned in tests)."""
    eye = np.sqrt(n) * np.eye(n)
    pts = np.concatenate([eye, -eye], axis=0)
    ws = np.full((2 * n,), 1.0 / (2 * n))
    dtype = dtype or jnp.zeros(0).dtype
    return Rule(jnp.asarray(pts, dtype), jnp.asarray(ws, dtype))


def new(x0, p0, noise: Noise, order: int = 3, rule: Rule = None):
    """Build (Model, State).  Default rule: Gauss-Hermite of `order`
    (order=3 → 3^n points, degree-5 exactness)."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    if rule is None:
        rule = gauss_hermite_rule(x0.shape[0], order, x0.dtype)
    return Model(noise, rule), State(x0, p0, jnp.int32(0))


def transform_points(x, p, rule: Rule):
    """X_i = x + chol(P) ξ_i."""
    s = linalg.chol_or_eigh_sqrt(p)
    return x[None, :] + rule.points @ s.T


def expectation(points_fx, rule: Rule, noise_cov=None):
    """Weighted mean/cov/deviations of transformed points."""
    mean = rule.weights @ points_fx
    dev = points_fx - mean[None, :]
    cov = jnp.einsum("i,ij,ik->jk", rule.weights, dev, dev)
    if noise_cov is not None:
        cov = cov + noise_cov
    return mean, linalg.sym(cov), dev


@linalg.highp
def predict(model: Model, state: State, fx: Callable, control=None):
    pts = transform_points(state.x, state.p, model.rule)
    prop = jax.vmap((lambda s: fx(s, control)) if control is not None else fx)(pts)
    x_pred, p_pred, _ = expectation(prop, model.rule, model.noise.q)
    return x_pred, p_pred


@linalg.highp
def step(model: Model, state: State, measurement, fx: Callable, hx: Callable,
         control=None, has=None):
    """One quadrature-filter step (same masked-scan convention as
    ukf.step: has=False reduces exactly to the time update)."""
    x_pred, p_pred = predict(model, state, fx, control)

    pts = transform_points(x_pred, p_pred, model.rule)
    zpts = jax.vmap(hx)(pts)
    y_hat, s_cov, zdev = expectation(zpts, model.rule, model.noise.r)
    xdev = pts - x_pred[None, :]
    cross = jnp.einsum("i,ij,ik->jk", model.rule.weights, xdev, zdev)
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
def run(model: Model, state: State, measurements, fx: Callable, hx: Callable,
        controls=None, meas_masks=None):
    """lax.scan driver over the time axis."""

    def body(carry, xs):
        meas, u, m = xs
        return step(model, carry, meas, fx, hx, u, m)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))


@linalg.highp
def rts_smoother(model: Model, means, covs, fx: Callable, controls=None):
    """Quadrature-rule Rauch-Tung-Striebel smoother: ukf.rts_smoother's
    backward pass (Särkkä 2008) with the model's deterministic rule
    supplying the predicted/cross statistics — degree-(2·order−1)
    moment accuracy in the smoother too.  `controls[k+1]` drives the
    k -> k+1 transition, matching the filter's inputs."""

    def body(carry, xs):
        x_next, p_next = carry
        x_k, p_k, u_next, is_last = xs
        pts = transform_points(x_k, p_k, model.rule)
        prop = jax.vmap(
            (lambda s: fx(s, u_next)) if u_next is not None else fx
        )(pts)
        x_pred, p_pred, pdev = expectation(prop, model.rule, model.noise.q)
        xdev = pts - x_k[None, :]
        cross = jnp.einsum("i,ij,ik->jk", model.rule.weights, xdev, pdev)
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
        u_next = jnp.concatenate([controls[1:], controls[-1:]], axis=0)
    (_, _), (xs_sm, ps_sm) = jax.lax.scan(
        body, (means[-1], covs[-1]), (means, covs, u_next, is_last),
        reverse=True,
    )
    return xs_sm, ps_sm
