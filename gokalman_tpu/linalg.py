"""Small-matrix linear algebra for state estimation in JAX.

This is the JAX rebuild of the reference's helper tier (reference:
helper.go:13-172).  Everything here is a pure, jittable, vmappable
function over statically-shaped jnp arrays.  The mutable gonum idioms
(in-place Householder, SymDense conversion-with-check) become
functional transforms; dimension checks become Python-time (trace-time)
assertions since shapes are static under XLA.
"""

from __future__ import annotations

import functools

import math

import jax
import jax.numpy as jnp


def highp(fn):
    """Run `fn` with float32 matmul precision.

    On the GPU a float32 matmul at default precision may run on the
    tensor cores in TF32, which keeps a 10-bit mantissa (about three
    decimal digits); for covariance recursions that turns 1e-7 roundoff
    into ~1e-3 per step and can destroy NEES calibration over long
    scans.  "float32" asks XLA for full-precision f32 products (no
    TF32).  Every filter step and ensemble pipeline is wrapped with
    this — the matrices are tiny, so the tensor cores have nothing to
    win there.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapper


@highp
def factor_product(s) -> jax.Array:
    """S Sᵀ at full f32 matmul precision.

    Factor-carrying estimates (sqrt/srukf/srif/udu) reconstruct P from
    their factors lazily in properties, outside the filter step; those
    products must NOT run at the default matmul precision (TF32 on the
    GPU) or the reconstructed covariance (and anything downstream,
    e.g. NEES) silently loses ~4 digits — the filter recursion itself is
    already under `highp`.
    """
    return s @ jnp.swapaxes(s, -1, -2)


def identity(n: int, dtype=None) -> jax.Array:
    """Identity matrix (reference: helper.go:44)."""
    return jnp.eye(n, dtype=dtype)


def scaled_identity(n: int, s, dtype=None) -> jax.Array:
    """s * I_n (reference: helper.go:13)."""
    return jnp.eye(n, dtype=dtype) * s


def is_nil(m) -> bool:
    """Whether a matrix is None or all-zero (reference: helper.go:49-62).

    Python-time helper: used to decide statically whether a control path
    participates in the traced computation at all.
    """
    if m is None:
        return True
    import numpy as np

    return not np.any(np.asarray(m))


def sym(a: jax.Array) -> jax.Array:
    """Symmetrize: (A + A^T)/2.

    Replaces the reference's AsSymDense *check* (helper.go:65-84) on the
    hot path: under jit we cannot raise data-dependently, and the
    numerically right move for a covariance that drifted off-symmetric
    is to project it back.
    """
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def is_symmetric(a, atol: float = 1e-6, rtol: float = 1e-2) -> bool:
    """Host-side symmetry check mirroring helper.go:75 tolerances."""
    import numpy as np

    a = np.asarray(a)
    if a.shape[-1] != a.shape[-2]:
        return False
    at = np.swapaxes(a, -1, -2)
    return bool(np.all(np.abs(a - at) <= atol + rtol * np.abs(at)))


def check_dims(shape1, shape2, name1: str, name2: str, method: str) -> None:
    """Static dimension-agreement check (reference: helper.go:99-130).

    Since XLA shapes are static, this runs at trace time and raises a
    plain ValueError, giving the same fail-fast behavior as the
    reference's constructor checks.
    """
    r1, c1 = shape1
    r2, c2 = shape2
    msg = f"dimensions must agree: {name1}({r1}x{c1}) {name2}({r2}x{c2}) [{method}]"
    ok = {
        "rows2cols": r1 == c2,
        "cols2rows": c1 == r2,
        "cols2cols": c1 == c2,
        "rows2rows": r1 == r2,
        "rowsAndcols": (r1 == r2) and (c1 == c2),
    }[method]
    if not ok:
        raise ValueError(msg)


def sign_db(v: jax.Array, deadband: float = 1e-12) -> jax.Array:
    """Sign with a deadband mapping |v|<=1e-12 to +1 (reference: helper.go:133-138)."""
    return jnp.where(jnp.abs(v) <= deadband, jnp.ones_like(v), jnp.sign(v))


@functools.partial(jax.jit, static_argnames=("n", "m"))
def householder_triangularize(a: jax.Array, n: int, m: int) -> jax.Array:
    """Householder triangularization of the top-left n columns of A.

    Functional rewrite of the reference's in-place elementwise kernel
    (helper.go:142-172): each of the n reflection steps is expressed as
    one masked rank-1 update over the whole (n+m, c) block, so the inner
    loops vectorize and the function vmaps cleanly over a
    leading batch axis.  `n` is the number of columns to eliminate, `m`
    the number of extra rows (A has n+m rows and at least n+1 columns).

    Matches the reference bit-for-bit on its sign convention:
    sigma = sign(A[k,k]) * ||A[k:,k]||, diag set to -sigma.
    """
    rows = n + m
    if a.shape[-2] != rows:
        raise ValueError(f"A must have n+m={rows} rows, got {a.shape}")
    row_idx = jnp.arange(rows, dtype=jnp.int32)

    def body(k, a):
        col = a[:, k]
        mask = row_idx >= k
        akk = a[k, k]
        sigma = jnp.sqrt(jnp.sum(jnp.where(mask, col * col, 0.0))) * sign_db(akk)
        # Householder vector: u_k = A[k,k] + sigma, u_i = A[i,k] for i>k.
        u = jnp.where(row_idx == k, akk + sigma, jnp.where(mask, col, 0.0))
        denom = sigma * (akk + sigma)
        beta = jnp.where(denom == 0.0, 0.0, 1.0 / denom)
        gammas = beta * (u @ a)  # [cols]; for already-eliminated columns this is 0
        a = a - jnp.outer(u, gammas)
        # The eliminated column is exactly [-sigma; 0...] by construction;
        # write it explicitly so no 1e-14 rank-1-update residue survives
        # (the reference also stores these exactly, helper.go:151, 167-169).
        newcol = jnp.where(row_idx == k, -sigma, jnp.where(mask, 0.0, a[:, k]))
        return a.at[:, k].set(newcol)

    return jax.lax.fori_loop(0, n, body, a) if n > 8 else _unrolled(body, n, a)


def _unrolled(body, n, a):
    for k in range(n):
        a = body(k, a)
    return a


def qr_r(a: jax.Array) -> jax.Array:
    """Upper-triangular R factor of a QR decomposition.

    The square-root filters only ever need R (the reference extracts
    RFromQR, squareroot.go:179, 222); XLA's QR on small static shapes
    fuses well and the Q factor is dead code the compiler removes.
    """
    return jnp.linalg.qr(a, mode="r")


def sqrt_factor_psd(a: jax.Array) -> jax.Array:
    """A square factor B with B Bᵀ = A for PSD A, robust to extreme
    conditioning: eigh + clipped sqrt(eigenvalues).

    Cholesky in f32 goes indefinite (NaN) once cond(A) approaches
    1/eps_f32 ~ 1e7-1e9 because roundoff in the large entries swamps
    the small pivots; eigh has no pivots to lose, and clipping tiny
    negative eigenvalues to zero yields the nearest-PSD factor.  B is
    NOT triangular — use only where a general square root is
    acceptable (e.g. rows of an orthogonal-triangularization
    pre-array, where any B with B Bᵀ = A produces the same AᵀA).
    """
    w, u = jnp.linalg.eigh(a)
    return u * jnp.sqrt(jnp.maximum(w, 0.0))[None, :]


def chol_or_eigh_sqrt(a: jax.Array) -> jax.Array:
    """Lower Cholesky factor when it exists in this precision, else the
    eigh factor from sqrt_factor_psd.

    Bit-identical to cholesky whenever cholesky is finite — callers
    that feed the factor to a PRNG keep their exact historical draws —
    and degrades gracefully (instead of NaN) on cond ≳ 1e8 f32 inputs.
    """
    l = jnp.linalg.cholesky(a)
    return jnp.where(jnp.all(jnp.isfinite(l)), l, sqrt_factor_psd(a))


def chol_lower(a: jax.Array) -> jax.Array:
    """Lower Cholesky factor, L L^T = A (reference uses LFromCholesky)."""
    return jnp.linalg.cholesky(a)


def solve_tri_lower(l: jax.Array, b: jax.Array) -> jax.Array:
    return jax.scipy.linalg.solve_triangular(l, b, lower=True)


def solve_tri_upper(u: jax.Array, b: jax.Array) -> jax.Array:
    return jax.scipy.linalg.solve_triangular(u, b, lower=False)


def inv_tri_upper(u: jax.Array) -> jax.Array:
    return solve_tri_upper(u, jnp.eye(u.shape[-1], dtype=u.dtype))


def solve_psd(a: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for symmetric positive-definite A via Cholesky."""
    l = jnp.linalg.cholesky(a)
    y = jax.scipy.linalg.solve_triangular(l, b, lower=True)
    return jax.scipy.linalg.solve_triangular(l.T, y, lower=False)


def inv_psd(a: jax.Array) -> jax.Array:
    return solve_psd(a, jnp.eye(a.shape[-1], dtype=a.dtype))


def chol_update(l: jax.Array, v: jax.Array, weight) -> jax.Array:
    """Rank-1 Cholesky update/downdate: L' with L' L'^T = L L^T + w v v^T.

    `weight` may be negative (downdate) — the caller guarantees the
    result stays positive definite.  The classic sequential column
    algorithm (LINPACK dchud/dchdd) as a fori_loop with row masks; the
    factors here are tiny (n <= 8), so the serial column chain is
    negligible.  Needed by the square-root UKF, whose center sigma
    point carries a weight of either sign (srukf.py).
    """
    l = jnp.asarray(l)
    v = jnp.asarray(v)
    n = l.shape[-1]
    w = jnp.asarray(weight, l.dtype)
    sign = jnp.where(w < 0, -1.0, 1.0).astype(l.dtype)
    x = v * jnp.sqrt(jnp.abs(w))
    idx = jnp.arange(n)

    def body(k, carry):
        lmat, xv = carry
        lkk = lmat[k, k]
        xk = xv[k]
        r = jnp.sqrt(lkk * lkk + sign * xk * xk)
        c = r / lkk
        s = xk / lkk
        below = idx > k
        col = lmat[:, k]
        newcol = jnp.where(below, (col + sign * s * xv) / c, col)
        newcol = newcol.at[k].set(r)
        xv = jnp.where(below, c * xv - s * newcol, xv)
        return lmat.at[:, k].set(newcol), xv

    l, _ = jax.lax.fori_loop(0, n, body, (l, x))
    return l


def solve_qr(a: jax.Array, b: jax.Array) -> jax.Array:
    """General solve A x = b via Householder QR instead of LU.

    QR is backward-stable without pivoting, so it needs no
    data-dependent row exchanges, and its error grows with cond(A)
    rather than with a pivot growth factor; for the small, possibly
    ill-conditioned general matrices here (STM inverses, H-infinity's
    M) that is the safer solve.  SPD systems use `solve_psd`
    (Cholesky) instead."""
    q, r = jnp.linalg.qr(a)
    vector_rhs = b.ndim == a.ndim - 1  # batched-vector b, like jnp.linalg.solve
    y = jnp.swapaxes(q, -1, -2) @ (b[..., None] if vector_rhs else b)
    x = jax.scipy.linalg.solve_triangular(r, y, lower=False)
    return x[..., 0] if vector_rhs else x


def inv_qr(a: jax.Array) -> jax.Array:
    eye = jnp.broadcast_to(jnp.eye(a.shape[-1], dtype=a.dtype), a.shape)
    return solve_qr(a, eye)


@functools.partial(jax.jit, static_argnames=("iterations",))
@highp
def solve_dare(f: jax.Array, h: jax.Array, q: jax.Array, r: jax.Array,
               iterations: int = 25) -> jax.Array:
    """Steady-state predicted covariance: the discrete algebraic Riccati
    equation P = F P Fᵀ - F P Hᵀ (H P Hᵀ + R)⁻¹ H P Fᵀ + Q, solved by
    the structure-preserving doubling algorithm (quadratic convergence;
    25 doublings ≈ 2^25 filter steps).  Jittable and differentiable —
    nothing like it exists in the reference, which re-propagates the
    covariance on every Update call forever (vanilla.go:149-168).
    """
    n = f.shape[0]
    eye = jnp.eye(n, dtype=f.dtype)
    # Standard SDA form X = AᵀXA - AᵀXB(R+BᵀXB)⁻¹BᵀXA + Q with A = Fᵀ.
    a = f.T
    g = h.T @ solve_psd(r, h)
    x = q

    def body(_, carry):
        a, g, x = carry
        igx = eye + g @ x
        a_next = a @ jnp.linalg.solve(igx, a)
        g_next = g + a @ jnp.linalg.solve(igx, g @ a.T)
        x_next = x + a.T @ x @ jnp.linalg.solve(igx, a)
        return a_next, sym(g_next), sym(x_next)

    _, _, x = jax.lax.fori_loop(0, iterations, body, (a, g, x))
    return x


def quadratic_form(v: jax.Array, a: jax.Array) -> jax.Array:
    """v^T A v for a single vector (vmappable for batches)."""
    return v @ (a @ v)


def is_within_nsigma(state: jax.Array, covar: jax.Array, n_sigma) -> jax.Array:
    """Whether every component of `state` lies within n_sigma * sqrt(diag(P)).

    Reference: vanilla.go:231-239 (same logic repeated in every
    estimate type).  Returns a traced bool; batched inputs broadcast.
    """
    bound = n_sigma * jnp.sqrt(jnp.diagonal(covar, axis1=-2, axis2=-1))
    return jnp.all(jnp.abs(state) <= bound, axis=-1)


def golden_section(obj, lo, hi, iters: int):
    """Branch-free golden-section minimizer of a unimodal scalar
    `obj` on [lo, hi]: fixed `iters` fori_loop, exactly ONE objective
    evaluation per iteration (the surviving probe's value is carried —
    the golden-ratio identity gr^2 = 1 - gr makes the reused probe
    land exactly on the new grid point).  Returns the bracket
    midpoint.  Shared by fusion.covariance_intersection / inverse CI and
    setmembership.step (previously three diverging copies)."""
    lo = jnp.asarray(lo)
    hi = jnp.asarray(hi)
    dt = lo.dtype
    gr = jnp.asarray(0.5 * (math.sqrt(5.0) - 1.0), dt)

    def body(_, carry):
        lo_, hi_, c_, d_, fc, fd = carry
        go_left = fc < fd
        lo2 = jnp.where(go_left, lo_, c_)
        hi2 = jnp.where(go_left, d_, hi_)
        c2 = hi2 - gr * (hi2 - lo2)
        d2 = lo2 + gr * (hi2 - lo2)
        f_new = obj(jnp.where(go_left, c2, d2))
        return (lo2, hi2, c2, d2,
                jnp.where(go_left, f_new, fd),
                jnp.where(go_left, fc, f_new))

    c0 = hi - gr * (hi - lo)
    d0 = lo + gr * (hi - lo)
    lo_f, hi_f, _, _, _, _ = jax.lax.fori_loop(
        0, iters, body, (lo, hi, c0, d0, obj(c0), obj(d0)))
    return 0.5 * (lo_f + hi_f)
