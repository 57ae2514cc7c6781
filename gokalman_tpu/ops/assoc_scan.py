"""Parallel-in-time Kalman filtering via associative scan.

The reference's per-step Update loop is inherently serial
(vanilla.go:128-220 — SURVEY.md §5 notes the recurrence x_{k+1}=f(x_k)
as the un-parallelizable axis).  On a parallel device that's not the end of the
story: the Kalman filter's conditional-density recursion is an
*associative* operation on (A, b, C, eta, J) elements [Särkkä &
García-Fernández, "Temporal Parallelization of Bayesian Smoothers",
IEEE TAC 2021], so all T filtered means/covariances can be computed in
O(log T) parallel depth with `lax.associative_scan` — the SURVEY §5
"parallel-in-time covariance propagation" stretch goal, generalized to
the full filter.

Elements for step k (model x_k = F x_{k-1} + G u_k + q, y_k = H x_k + r):
  A_k = (I - K H) F,  b_k = K y_k + (I - K H) G u_k,  C_k = (I - K H) Q
  eta_k = F^T H^T S^{-1} (y_k - H G u_k),  J_k = F^T H^T S^{-1} H F
with S = H Q H^T + R, K = Q H^T S^{-1}.  The first element conditions
on the prior instead.  After the scan, the prefix (b_k, C_k) are the
filtered mean/covariance at every step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..filters import vanilla


class _Elem(NamedTuple):
    a: jax.Array  # [T, n, n]
    b: jax.Array  # [T, n]
    c: jax.Array  # [T, n, n]
    eta: jax.Array  # [T, n]
    j: jax.Array  # [T, n, n]


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """Associative combination of filtering elements (Särkkä &
    García-Fernández 2021, Lemma 8).  Batched over leading dims."""
    n = ei.a.shape[-1]
    eye = jnp.eye(n, dtype=ei.a.dtype)
    # (I + C_i J_j)^{-1} applied from the right/left via solves.
    icj = eye + ei.c @ ej.j
    # X = (I + C_i J_j)^{-1} [A_i | b_i + C_i eta_j]:
    rhs_b = ei.b + jnp.einsum("...ij,...j->...i", ei.c, ej.eta)
    sol_a = jnp.linalg.solve(icj, ei.a)
    sol_b = jnp.linalg.solve(icj, rhs_b[..., None])[..., 0]
    a = ej.a @ sol_a
    b = jnp.einsum("...ij,...j->...i", ej.a, sol_b) + ej.b
    c = linalg.sym(ej.a @ jnp.linalg.solve(icj, ei.c) @ jnp.swapaxes(ej.a, -1, -2) + ej.c)
    # Dual: (I + J_j C_i)^{-1}
    ijc = eye + ej.j @ ei.c
    rhs_eta = ej.eta - jnp.einsum("...ij,...j->...i", ej.j, ei.b)
    sol_eta = jnp.linalg.solve(ijc, rhs_eta[..., None])[..., 0]
    sol_j = jnp.linalg.solve(ijc, ej.j)
    ait = jnp.swapaxes(ei.a, -1, -2)
    eta = jnp.einsum("...ij,...j->...i", ait, sol_eta) + ei.eta
    j = linalg.sym(ait @ sol_j @ ei.a + ei.j)
    return _Elem(a, b, c, eta, j)


def identity_elem(n: int, dtype) -> _Elem:
    """The combine's identity: (I, 0, 0, 0, 0).  Used as the block
    prefix on device 0 of the time-sharded distributed scan
    (parallel/time_scan.py)."""
    eye = jnp.eye(n, dtype=dtype)
    z = jnp.zeros((n,), dtype)
    zm = jnp.zeros((n, n), dtype)
    return _Elem(eye, z, zm, z, zm)


@linalg.highp
def filter_elements(
    model: vanilla.Model,
    state0: vanilla.State,
    measurements: jax.Array,
    controls: Optional[jax.Array] = None,
) -> _Elem:
    """Per-step scan elements for the parallel-in-time filter — the
    vectorized element construction of `filter_parallel`, exposed so
    the time-sharded distributed scan can build elements once and scan
    them across devices."""
    f, h = model.f, model.h
    q, r = model.noise.q, model.noise.r
    t = measurements.shape[0]
    n = f.shape[0]
    dtype = f.dtype
    eye = jnp.eye(n, dtype=dtype)

    gu = (
        jnp.zeros((t, n), dtype)
        if (controls is None or model.g is None)
        else jnp.einsum("ij,tj->ti", model.g, controls)
    )

    # Generic elements (k >= 1).
    s = h @ q @ h.T + r
    k_gain = linalg.solve_psd(s, h @ q.T).T  # Q H^T S^{-1}
    ikh = eye - k_gain @ h
    a_g = ikh @ f
    c_g = linalg.sym(ikh @ q)
    fthsi = f.T @ h.T @ linalg.inv_psd(s)  # F^T H^T S^{-1}
    j_g = linalg.sym(fthsi @ h @ f)

    y_eff = measurements - jnp.einsum("ij,tj->ti", h, gu)
    a = jnp.broadcast_to(a_g, (t, n, n))
    b = jnp.einsum("ij,tj->ti", k_gain, measurements) + jnp.einsum(
        "ij,tj->ti", ikh, gu
    )
    c = jnp.broadcast_to(c_g, (t, n, n))
    eta = jnp.einsum("ij,tj->ti", fthsi, y_eff)
    j = jnp.broadcast_to(j_g, (t, n, n))

    # First element conditions on the prior (m0, P0).
    m_pred = f @ state0.x + gu[0]
    p_pred = linalg.sym(f @ state0.p @ f.T + q)
    s1 = h @ p_pred @ h.T + r
    k1 = linalg.solve_psd(s1, h @ p_pred.T).T
    b0 = m_pred + k1 @ (measurements[0] - h @ m_pred)
    c0 = linalg.sym((eye - k1 @ h) @ p_pred)
    a = a.at[0].set(jnp.zeros((n, n), dtype))
    b = b.at[0].set(b0)
    c = c.at[0].set(c0)
    eta = eta.at[0].set(jnp.zeros((n,), dtype))
    j = j.at[0].set(jnp.zeros((n, n), dtype))
    return _Elem(a, b, c, eta, j)


@linalg.highp
def filter_parallel(
    model: vanilla.Model,
    state0: vanilla.State,
    measurements: jax.Array,
    controls: Optional[jax.Array] = None,
):
    """All filtered (means [T, n], covariances [T, n, n]) in O(log T)
    parallel depth.  Produces the same posteriors as scanning
    vanilla.step over the measurements (noiseless-replay semantics)."""
    out = jax.lax.associative_scan(
        _combine, filter_elements(model, state0, measurements, controls)
    )
    return out.b, out.c


class _SElem(NamedTuple):
    e: jax.Array
    g: jax.Array
    l: jax.Array


def _scomb(ej: _SElem, ei: _SElem) -> _SElem:
    """Reverse-order smoother combine: (E, g, L)_i after (E, g, L)_j
    (ej covers LATER time steps).  Batched over leading dims."""
    ee = ei.e @ ej.e
    gg = jnp.einsum("...ij,...j->...i", ei.e, ej.g) + ei.g
    ll = linalg.sym(ei.e @ ej.l @ jnp.swapaxes(ei.e, -1, -2) + ei.l)
    return _SElem(ee, gg, ll)


def sidentity_elem(n: int, dtype) -> _SElem:
    """Identity for `_scomb`: (I, 0, 0) — the block suffix on the last
    device of the time-sharded distributed smoother."""
    return _SElem(jnp.eye(n, dtype=dtype), jnp.zeros((n,), dtype),
                  jnp.zeros((n, n), dtype))


@linalg.highp
def smoother_elements(model: vanilla.Model, means, covs) -> _SElem:
    """Per-step reverse-scan elements for the parallel-in-time RTS
    smoother (Särkkä & García-Fernández 2021, §IV):
      E_k = P_k F^T (F P_k F^T + Q)^{-1},  g_k = m_k - E_k F m_k,
      L_k = P_k - E_k F P_k;  last element: (0, m_T, P_T)."""
    f = model.f
    q = model.noise.q
    t, n = means.shape
    dtype = means.dtype

    p_pred = f @ covs @ jnp.swapaxes(f, -1, -2) + q  # [T, n, n] via broadcast
    e = jnp.swapaxes(
        jnp.linalg.solve(p_pred, f @ jnp.swapaxes(covs, -1, -2)), -1, -2
    )  # P F^T (F P F^T + Q)^{-1}
    g = means - jnp.einsum("tij,tj->ti", e @ f, means)
    l = covs - e @ (f @ covs)
    l = linalg.sym(l)
    e = e.at[-1].set(jnp.zeros((n, n), dtype))
    g = g.at[-1].set(means[-1])
    l = l.at[-1].set(covs[-1])
    return _SElem(e, g, l)


@linalg.highp
def smooth_parallel(model: vanilla.Model, means, covs):
    """Parallel-in-time RTS smoother over filtered (means, covs):
    all smoothed means/covariances in O(log T) depth.  Combined in
    reverse; prefix (g, L) are the smoothed moments."""
    out = jax.lax.associative_scan(
        _scomb, smoother_elements(model, means, covs), reverse=True
    )
    return out.g, out.l
