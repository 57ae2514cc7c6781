"""Equality-constrained Kalman filtering (projection method).

State constraints the reference cannot express (gokalman estimates
unconstrained states only; the closest idiom is the statOD closed-loop
Fcl = F − G·T example, examples/statOD5044/main.go:46-57): when the
truth is known to satisfy D x = d exactly (mass balance, unit-norm
direction cosines, kinematic couplings, zero net force), projecting the
unconstrained estimate onto the constraint surface is both optimal and
free — no model augmentation, no tuning.

This is Simon's estimate-projection method (*Optimal State Estimation*
§7.2; Simon & Chia 2002): with W = P⁻¹ (the maximum-probability
weighting),

    x_c = x − P Dᵀ (D P Dᵀ)⁻¹ (D x − d)
    P_c = (I − P Dᵀ (D P Dᵀ)⁻¹ D) P

Properties (all pinned in tests): D x_c = d exactly; the projection is
idempotent; P_c ⪯ P (the constrained estimator is never worse); and
the projected filter equals running a KF with the constraint appended
as a perfect (R=0-limit) measurement.

`step`/`run` wrap the vanilla CKF and project every posterior, keeping
the constrained pair (x_c, P_c) as the carried state so the time update
propagates the constrained estimate (the "system-projection" variant;
for constraint subspaces invariant under F the constraint then holds
for the prior too).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import linalg
from . import vanilla


@linalg.highp
def project(x, p, d_mat, d_vec):
    """(x_c, P_c): maximum-probability projection of (x, P) onto
    {x : D x = d} (Simon §7.2, W = P⁻¹)."""
    d_mat = jnp.asarray(d_mat, p.dtype)
    d_vec = jnp.asarray(d_vec, p.dtype)
    pdt = p @ d_mat.T  # [n, c]
    s = d_mat @ pdt  # [c, c] = D P Dᵀ
    gain = linalg.solve_psd(s, pdt.T).T  # [n, c] = P Dᵀ (D P Dᵀ)⁻¹
    x_c = x - gain @ (d_mat @ x - d_vec)
    p_c = linalg.sym(p - gain @ pdt.T)
    return x_c, p_c


@linalg.highp
def step(model: vanilla.Model, state: vanilla.State, d_mat, d_vec,
         measurement=None, control=None, h=None, r=None, meas_mask=None):
    """One vanilla CKF step followed by constraint projection; the
    projected (x_c, P_c) is the carried posterior."""
    new_state, est = vanilla.step(model, state, measurement, control,
                                  h=h, r=r, meas_mask=meas_mask)
    x_c, p_c = project(new_state.x, new_state.p, d_mat, d_vec)
    est = est._replace(state=x_c, covariance=p_c)
    return vanilla.State(x_c, p_c, new_state.k), est


@linalg.highp
def run(model: vanilla.Model, state: vanilla.State, d_mat, d_vec,
        measurements, controls=None, hs=None, rs=None, meas_masks=None):
    """lax.scan driver: constrained filtering over the time axis
    (hs/rs/meas_masks: per-step measurement overrides, see
    vanilla.run)."""
    d_mat = jnp.asarray(d_mat)
    d_vec = jnp.asarray(d_vec)

    def body(carry, xs):
        meas, ctrl, h_k, r_k, mask = xs
        return step(model, carry, d_mat, d_vec, meas, ctrl, h_k, r_k, mask)

    xs = (measurements, controls, hs, rs, meas_masks)
    return jax.lax.scan(body, state, xs)
