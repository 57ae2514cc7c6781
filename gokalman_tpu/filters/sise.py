"""Simultaneous input and state estimation (SISE): filtering when an
UNKNOWN, arbitrary input drives the dynamics.

Every filter in this library assumes known inputs; a fault, an
unmodeled thrust, a cyber-attack on an actuator, or an unmeasured
disturbance makes the vanilla KF biased (pinned: a step disturbance
biases the CKF by many sigma while SISE stays unbiased).  The
Gillijns-De Moor (2007) recursive three-step filter estimates BOTH
without any model of the input — no dynamics, no prior, no bound:

    x_k = F x_{k-1} + G u_k + E d_{k-1} + w_k     (d unknown)
    y_k = H x_k + v_k

    1. predict ignoring d
    2. d-hat = weighted LS of the innovation on (H E): the unbiased
       minimum-variance input estimate, Pd = (E'H' Rt^-1 H E)^-1
    3. compensate the prediction with E d-hat, then a measurement
       update whose gain accounts for the d-hat <-> v correlation
       (the innovation components along H E are spent — the update
       covariance is singular there, hence the pseudo-inverse gain)

    Requires rank(H E) = n_d (the input must be observable in ONE
    step); checked at construction.

The decisive correctness pin: SISE is EXACTLY the limit of an
augmented-state KF that models d as white noise with unbounded
variance (unknown-input = infinite-variance noise) — tests verify
state AND input estimates against an augmented vanilla KF with
Q_d = 1e8 to 4 digits, plus MC unbiasedness/NEES under adversarial
deterministic inputs.

Design notes: the pseudo-inverse gain is jnp.linalg.pinv (SVD-based:
the update covariance is structurally singular, so neither LU nor
Cholesky solves apply); everything else is the library's standard
pure-step shape under linalg.highp.

No reference counterpart (the reference assumes known inputs
throughout, vanilla.go:128).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise


class Model(NamedTuple):
    f: jax.Array  # [n, n]
    g: Optional[jax.Array]  # [n, m] known-input map (or None)
    h: jax.Array  # [p, n]
    e: jax.Array  # [n, nd] unknown-input map
    noise: Noise


class State(NamedTuple):
    x: jax.Array  # [n]
    p: jax.Array  # [n, n]
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array  # [n]
    covariance: jax.Array  # [n, n]
    input: jax.Array  # [nd] estimated unknown input d_{k-1}
    input_covariance: jax.Array  # [nd, nd]
    innovation: jax.Array  # [p] pre-compensation innovation
    pred_covariance: jax.Array  # [n, n]


def new(x0, p0, f, g, h, e, noise: Noise):
    """Build (Model, State).  `e` [n, nd] maps the unknown input into
    the dynamics; rank(H E) must equal nd (one-step observability of
    the input) or the weighted LS in step 2 is singular."""
    x0, p0 = jnp.asarray(x0), jnp.asarray(p0)
    f, h, e = jnp.asarray(f), jnp.asarray(h), jnp.asarray(e)
    if e.ndim != 2 or e.shape[0] != f.shape[0]:
        raise ValueError(f"e must be [n, nd] (got {e.shape})")
    if x0.shape != (f.shape[0],) or p0.shape != f.shape:
        raise ValueError(
            f"dimensions must agree: x0{x0.shape} P0{p0.shape} "
            f"F{f.shape} [sise.new]")
    import numpy as np

    he = np.asarray(h @ e)
    if np.linalg.matrix_rank(he) < e.shape[1]:
        raise ValueError(
            f"rank(H E) = {np.linalg.matrix_rank(he)} < n_d = "
            f"{e.shape[1]}: the unknown input is not one-step "
            "observable (reduce E's columns or add sensors)")
    g = None if g is None else jnp.asarray(g)
    return (Model(f, g, h, e, noise),
            State(x0, p0, jnp.int32(0)))


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One SISE step (Gillijns & De Moor 2007, Automatica 43:111)."""
    f, h, e, r = model.f, model.h, model.e, model.noise.r
    n = state.x.shape[0]

    # 1. prediction without the unknown input
    x_pred = f @ state.x
    if model.g is not None and control is not None:
        x_pred = x_pred + model.g @ control
    p_pred = linalg.sym(f @ state.p @ f.T + model.noise.q)

    # 2. unbiased minimum-variance input estimate
    innov = measurement - h @ x_pred  # [p]
    rt = linalg.sym(h @ p_pred @ h.T + r)
    fe = h @ e  # [p, nd]
    rt_fe = linalg.solve_psd(rt, fe)  # Rt^-1 (H E)
    pd = linalg.inv_psd(linalg.sym(fe.T @ rt_fe))  # [nd, nd]
    m_gain = pd @ rt_fe.T  # [nd, p]
    d_hat = m_gain @ innov

    # 3. compensate, then update with the d-hat <-> v correlation
    x_star = x_pred + e @ d_hat
    iemh = jnp.eye(n, dtype=x_pred.dtype) - e @ m_gain @ h
    em = e @ m_gain
    p_star = linalg.sym(iemh @ p_pred @ iemh.T + em @ r @ em.T)
    c_xv = -em @ r  # Cov(x*-error, v)
    s_t = linalg.sym(h @ p_star @ h.T + r + h @ c_xv + c_xv.T @ h.T)
    # the compensation zeroes the innovation along range(H E): s_t is
    # structurally singular there — Moore-Penrose gain (GDM07 eq. 22)
    k_gain = (p_star @ h.T + c_xv) @ jnp.linalg.pinv(s_t)
    x = x_star + k_gain @ (measurement - h @ x_star)
    ikh = jnp.eye(n, dtype=x.dtype) - k_gain @ h
    # e_post = (I - K H) e* - K v with Cov(e*, v) = c_xv: the cross
    # terms enter NEGATIVE (a sign error here diverges the recursion
    # against the infinite-variance augmented-KF oracle within steps)
    p = linalg.sym(ikh @ p_star @ ikh.T + k_gain @ r @ k_gain.T
                   - ikh @ c_xv @ k_gain.T - k_gain @ c_xv.T @ ikh.T)

    est = Estimate(x, p, d_hat, pd, innov, p_pred)
    return State(x, p, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None):
    """lax.scan over [T, p] measurements (controls [T, m] optional)."""
    measurements = jnp.asarray(measurements)
    if controls is None:
        def body(carry, y):
            return step(model, carry, y)

        return jax.lax.scan(body, state, measurements)

    def body_u(carry, ys):
        y, u = ys
        return step(model, carry, y, u)

    return jax.lax.scan(body_u, state, (measurements,
                                        jnp.asarray(controls)))
