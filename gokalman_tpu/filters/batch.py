"""Batch least-squares estimator (normal equations).

Rebuild of the reference batch filter (reference: batch.go:34-79).
The reference's stateful accumulate-then-solve protocol
(SetNextMeasurement / Solve) becomes one fused einsum over the stacked
measurement set: Λ = Σ H^T W H, N = Σ H^T W y, x̂0 = Λ^{-1} N,
P0 = Λ^{-1}.

NOTE on the weight: the reference multiplies by the matrix returned
from noise.MeasurementMatrix() directly — i.e. by R, *not* R^{-1}
(batch.go:50).  The caller must therefore pass the inverse measurement
covariance as the weight to get properly weighted least squares; this
API keeps that contract explicit via the `weight` argument.  The STM Φ
is stored per-measurement but unused in Solve (batch.go:57, 64-79) —
mirrored here by simply not requiring it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg


class Solution(NamedTuple):
    x0: jax.Array  # [n] estimated initial state deviation
    p0: jax.Array  # [n, n] covariance = Λ^{-1}
    lam: jax.Array  # [n, n] information matrix Λ
    n_vec: jax.Array  # [n]


@linalg.highp
def accumulate(hs, weight, real_obs, computed_obs):
    """Λ and N from stacked measurements.

    hs: [T, p, n] mapping matrices; weight: [p, p]; observations [T, p].
    Reference: SetNextMeasurement batch.go:41-61, one einsum instead of
    a Go loop.
    """
    hs = jnp.asarray(hs)
    weight = jnp.asarray(weight)
    y = jnp.asarray(real_obs) - jnp.asarray(computed_obs)  # [T, p]
    lam = jnp.einsum("tpi,pq,tqj->ij", hs, weight, hs)
    n_vec = jnp.einsum("tpi,pq,tq->i", hs, weight, y)
    return lam, n_vec


@linalg.highp
def solve(hs, weight, real_obs, computed_obs) -> Solution:
    """x̂0 = Λ^{-1} N, P0 = Λ^{-1} (reference: Solve batch.go:64-79)."""
    lam, n_vec = accumulate(hs, weight, real_obs, computed_obs)
    p0 = linalg.sym(jnp.linalg.inv(lam))
    x0 = p0 @ n_vec
    return Solution(x0, p0, lam, n_vec)
