"""Discrete-time H-infinity (minimax) filter.

The robust counterpart to the CKF tier (vanilla.go:128-220): instead of
minimizing expected squared error under known Gaussian Q/R, the H∞
filter guarantees a worst-case energy gain below γ² from disturbances
(w, v, x0 error) to the estimation error of z = L x — no distributional
assumptions at all.  This is the standard suboptimal a-priori H∞
recursion (Simon, *Optimal State Estimation*, eqs. 11.86-11.88), with
θ = 1/γ²:

    K_k     = P_k M_k⁻¹ Hᵀ R⁻¹,      M_k = I − θ S̄ P_k + Hᵀ R⁻¹ H P_k
    x_{k+1} = F x_k + F K_k (y_k − H x_k) (+ G u_k)
    P_{k+1} = F P_k M_k⁻¹ Fᵀ + Q

with S̄ = Lᵀ S L.  θ = 0 recovers the a-priori Kalman filter EXACTLY
(pinned in tests) — γ is a knob between optimal-on-average (γ→∞) and
robust-to-worst-case.  The solution exists only while

    P_k⁻¹ − θ S̄ + Hᵀ R⁻¹ H ≻ 0

(Simon eq. 11.89); each step emits a `feasible` flag (smallest
eigenvalue > 0) rather than raising — under jit the caller gates on it
(θ chosen too large simply reports infeasibility, the reference-style
panic is not jittable).

Design notes: pure NamedTuple pytrees, lax.scan driver, all algebra
under linalg.highp; the n×n solve uses linalg.solve_qr (M is
nonsymmetric and can approach singularity near the γ bound).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise


class Model(NamedTuple):
    f: jax.Array  # [n, n]
    g: Optional[jax.Array]  # [n, m] or None
    h: jax.Array  # [p, n]
    noise: Noise
    theta: jax.Array  # [] = 1/gamma^2; 0 = Kalman
    s_bar: jax.Array  # [n, n] = Lᵀ S L cost weighting


class State(NamedTuple):
    x: jax.Array  # [n] a-priori estimate x_{k|k-1}
    p: jax.Array  # [n, n]
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array  # the a-priori estimate the recursion carries
    innovation: jax.Array
    covariance: jax.Array  # P_k (worst-case energy bound matrix, not an error covariance)
    gain: jax.Array
    feasible: jax.Array  # [] bool — γ-condition (Simon eq. 11.89) held this step

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, f, g, h, noise: Noise, gamma: float = math.inf, l=None, s=None):
    """Build (Model, State).  `gamma` is the H∞ performance bound
    (gamma=inf ⇒ Kalman); `l`/`s` define the performance output
    z = L x with weight S (defaults: L = I, S = I).

    NOTE the a-priori timing: `x0`/`p0` here are x_{0|-1}/P_{0|-1} —
    the estimate entering the FIRST measurement update.  The vanilla
    CKF predicts before its first update, so to reproduce it exactly at
    gamma=inf pass `F @ x0_v, F @ P0_v @ F.T + Q` (pinned in
    tests/test_hinf_constrained.py)."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    g = None if g is None or linalg.is_nil(g) else jnp.asarray(g)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
    n = x0.shape[0]
    dt = p0.dtype
    # Config-time scalar (math, not jnp: constructors must not force
    # device computation — see the imm._bank_init advisor finding).
    gamma_f = float(gamma)
    theta = jnp.asarray(0.0 if math.isinf(gamma_f) else 1.0 / gamma_f**2, dt)
    if l is None:
        s_bar = jnp.eye(n, dtype=dt) if s is None else jnp.asarray(s, dt)
    else:
        l = jnp.asarray(l, dt)
        sm = jnp.eye(l.shape[0], dtype=dt) if s is None else jnp.asarray(s, dt)
        s_bar = l.T @ sm @ l
    return (Model(f, g, h, noise, theta, s_bar),
            State(x0, p0, jnp.int32(0)))


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One a-priori H∞ step (Simon eqs. 11.86-11.88)."""
    n = state.x.shape[0]
    dt = state.p.dtype
    eye = jnp.eye(n, dtype=dt)
    hrh = model.h.T @ linalg.solve_psd(model.noise.r, model.h)  # Hᵀ R⁻¹ H
    a = hrh - model.theta * model.s_bar
    m = eye + a @ state.p  # M = I − θS̄P + HᵀR⁻¹HP
    # P M⁻¹ = (I + P A)⁻¹ P = (Mᵀ)⁻¹ P for symmetric P, A — one QR
    # solve instead of forming M⁻¹.
    pm = linalg.solve_qr(m.T, state.p)
    k_gain = pm @ model.h.T @ linalg.inv_qr(model.noise.r)
    innovation = measurement - model.h @ state.x
    x_next = model.f @ (state.x + k_gain @ innovation)
    if model.g is not None and control is not None:
        x_next = x_next + model.g @ control
    p_next = linalg.sym(model.f @ pm @ model.f.T + model.noise.q)

    # Existence: P⁻¹ − θS̄ + HᵀR⁻¹H ≻ 0 ⇔ eig_min > 0 (Simon 11.89).
    cond_mat = linalg.sym(linalg.inv_qr(state.p) - model.theta * model.s_bar
                          + hrh)
    feasible = jnp.linalg.eigvalsh(cond_mat)[0] > 0

    est = Estimate(
        state=state.x,
        innovation=innovation,
        covariance=state.p,
        gain=model.f @ k_gain,
        feasible=feasible,
    )
    return State(x_next, p_next, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None):
    """lax.scan driver; estimates are a-priori (x_{k|k-1})."""
    def body(carry, xs):
        meas, ctrl = xs
        return step(model, carry, meas, ctrl)

    return jax.lax.scan(body, state, (measurements, controls))
