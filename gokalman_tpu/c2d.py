"""Continuous-to-discrete conversion (Van Loan method).

JAX rebuild of the reference's c2d tier (reference: c2d.go:13-75).
The matrix exponential runs as jittable XLA (expm is a fixed Pade
series — compiler-friendly); the Nyquist aliasing check needs a
general (non-symmetric) eigendecomposition, which is host-only, so it
runs in numpy at setup time and is reported as a flag rather than an
exception (this is config-time code, never on the hot path).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import expm

from . import linalg


def nyquist_ok(a, dt: float) -> bool:
    """Nyquist criterion 2*|lambda_max|*dt < pi (reference: c2d.go:16-28).

    Mirrors the reference's selection rule: among the eigenvalues of A,
    take the one with the largest imaginary part, then test its
    magnitude.  Host-side numpy (a general eig on the host, once).
    """
    lams = np.linalg.eigvals(np.asarray(a, dtype=np.float64))
    lam_max = lams[int(np.argmax(lams.imag))]
    return bool(2.0 * np.abs(lam_max) * dt < np.pi)


@linalg.highp
def van_loan(a, gamma, w, dt: float, check_nyquist: bool = True):
    """Discretize a CT LTI system: returns (F, Q, ok).

    Builds M = [[-A*dt, G W G^T * dt], [0, A^T * dt]], exponentiates,
    and extracts F = exp(A dt) and Q = F * (F^{-1} Q) from the blocks
    (reference: c2d.go:31-74).  `ok` is the Nyquist flag — the
    reference returns an error alongside valid results; here the
    results are always returned and the flag says whether dt aliases.
    """
    a = jnp.asarray(a)
    gamma = jnp.asarray(gamma)
    w = jnp.asarray(w)
    n = a.shape[0]

    gwg = gamma @ w @ gamma.T * dt
    ap = a * dt
    m = jnp.block([[-ap, gwg], [jnp.zeros_like(ap), ap.T]])
    em = expm(m)
    # Top-right block is F^{-1} Q; bottom-right is F^T.
    f = em[n:, n:].T
    f1q = em[:n, n:]
    q = f @ f1q
    q = 0.5 * (q + q.T)
    ok = nyquist_ok(a, dt) if check_nyquist else True
    return f, q, ok


def van_loan_host(a, gamma, w, dt: float):
    """Host-side (numpy/scipy) Van Loan: identical block algebra to
    `van_loan`, returning plain numpy (F, Q).

    For trace-time/static-config discretization (e.g. the OD harness's
    DMC process noise): when all inputs are static Python/numpy config
    there is nothing to trace, so discretize once on the host and embed
    the result as a constant instead of compiling an expm into the
    program.
    """
    import scipy.linalg as sla

    a = np.asarray(a, dtype=np.float64)
    gamma = np.asarray(gamma, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    n = a.shape[0]
    gwg = gamma @ w @ gamma.T * dt
    m = np.block([[-a * dt, gwg], [np.zeros_like(a), a.T * dt]])
    em = sla.expm(m)
    f = em[n:, n:].T
    q = f @ em[:n, n:]
    return f, 0.5 * (q + q.T)
