"""Noise models as explicit, key-threaded samplers.

JAX rebuild of the reference's Noise interface (reference:
noise.go:13-164).  The three reference implementations map to:

- Noiseless  -> `noiseless(Q, R)`: zero sqrt factors, sampling returns 0
- BatchNoise -> pre-recorded (w, v) arrays threaded through the scan
               inputs (see filters.vanilla.run's `ws`/`vs` arguments)
- AWGN       -> `awgn(Q, R)`: multivariate-normal draws via the
               Cholesky factor and an explicit jax.random key.  The
               reference reseeds from the wall clock on Reset
               (noise.go:146); here every stream is a deterministic
               function of its key — reproducible by construction,
               and each Monte-Carlo run just folds its run index into
               the key.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Noise(NamedTuple):
    """Process/measurement noise model.

    Q, R are the covariances exposed to the filters (noise.go:16-17);
    sqrt_q / sqrt_r are lower-triangular factors used for sampling and
    by the square-root filters.  For a noiseless model the sqrt factors
    are zero, so samples are exactly zero with no branching.
    """

    q: jax.Array  # [n, n] process noise covariance
    r: jax.Array  # [p, p] measurement noise covariance
    sqrt_q: jax.Array  # [n, n] lower factor used for sampling (zeros => no noise)
    sqrt_r: jax.Array  # [p, p]


def _safe_chol(m: jax.Array) -> jax.Array:
    """Sampling factor B with B Bᵀ = m: zeros for an all-zero matrix,
    Cholesky when it exists in this precision, eigh square root as the
    extreme-conditioning fallback (f32 chol of cond ≳ 1e8 inputs goes
    indefinite -> NaN; draws through the eigh factor have the same
    covariance).  Bit-identical to the historical behavior wherever
    chol succeeds."""
    from . import linalg

    is_zero = jnp.all(m == 0)
    jitter = jnp.eye(m.shape[-1], dtype=m.dtype)
    l = linalg.chol_or_eigh_sqrt(jnp.where(is_zero, jitter, m))
    return jnp.where(is_zero, jnp.zeros_like(m), l)


def noiseless(q, r) -> Noise:
    """Zero-sampling noise carrying Q and R (reference: noise.go:23-64)."""
    q = jnp.atleast_2d(jnp.asarray(q))
    r = jnp.atleast_2d(jnp.asarray(r))
    return Noise(q, r, jnp.zeros_like(q), jnp.zeros_like(r))


def awgn(q, r) -> Noise:
    """Additive white Gaussian noise (reference: noise.go:109-164)."""
    q = jnp.atleast_2d(jnp.asarray(q))
    r = jnp.atleast_2d(jnp.asarray(r))
    return Noise(q, r, _safe_chol(q), _safe_chol(r))


class BatchNoise(NamedTuple):
    """Pre-recorded noise sequences (reference: noise.go:67-106).

    The arrays feed straight into the scan drivers:
    `vanilla.run(..., ws=bn.ws, ws2=bn.ws, vs=bn.vs)` replays the exact
    recorded draws (the reference returns the same vector for both
    Process() calls at a step, hence ws2=ws).  Unlike the reference,
    running past the recorded length is a trace-time shape error rather
    than a runtime panic.
    """

    ws: jax.Array  # [T, n] process noise draws
    vs: jax.Array  # [T, p] measurement noise draws


def batch(ws, vs) -> BatchNoise:
    return BatchNoise(jnp.asarray(ws), jnp.asarray(vs))


def process_sample(noise: Noise, key: jax.Array) -> jax.Array:
    """Draw w ~ N(0, Q) (reference: noise.go:133-136)."""
    z = jax.random.normal(key, (noise.q.shape[-1],), dtype=noise.q.dtype)
    return noise.sqrt_q @ z

def measurement_sample(noise: Noise, key: jax.Array) -> jax.Array:
    """Draw v ~ N(0, R) (reference: noise.go:139-142)."""
    z = jax.random.normal(key, (noise.r.shape[-1],), dtype=noise.r.dtype)
    return noise.sqrt_r @ z
