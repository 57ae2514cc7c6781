"""Linear-Gaussian system identification by expectation-maximization.

The reference tunes Q and R by hand against chi-square consistency
plots (the workflow its Monte-Carlo + NEES/NIS tier exists to support,
montecarlo.go / chisquare.go); this module closes the loop and *fits*
them from data.  Two complementary estimators ship:

- gradient ascent on `vanilla.innovations_log_likelihood` (the filter
  scan is differentiable end-to-end — tests/test_differentiable.py),
  good when the parameters live in a small custom parameterization;
- this module's EM (Shumway & Stoffer 1982): closed-form M-steps for
  any subset of {Q, R, F, H, x0/P0}, no step sizes, monotone
  likelihood by construction — the workhorse for full covariances.

E-step = one Kalman filter pass + one RTS smoother pass (both
`lax.scan`, so the whole fit jits to a single XLA program; the
per-iteration loop is itself a `lax.scan`).  The lag-one smoothed
cross-covariances the M-step needs are exact without any extra
recursion: Cov(x_{k+1}, x_k | Y_T) = P_{k+1|T} C_kᵀ, because
p(x_k | x_{k+1}, Y_T) is the backward conditional with the RTS gain
C_k as its regression matrix.

Design notes: everything runs under `linalg.highp` (f32 matmul drift
compounds over T-step scans); solves are Cholesky-based (the normal
matrices are SPD).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from . import linalg
from .noise import noiseless
from .filters import smoothing, vanilla

_FITTABLE = ("q", "r", "f", "h", "x0")


class EMResult(NamedTuple):
    model: vanilla.Model  # fitted model (F/H/Q/R per `fit`)
    state: vanilla.State  # fitted initial state (if "x0" in fit)
    log_liks: jax.Array  # [iters + 1] innovations log-likelihood trace


def _project(m: jax.Array, structure: str) -> jax.Array:
    """Constrain an M-step covariance update to a structure class.

    For "diag"/"scalar" the constrained M-step maximizer of the
    expected complete-data log-likelihood is exactly the diagonal /
    scaled-identity part of the unconstrained update, so monotonicity
    is preserved.
    """
    if structure == "full":
        return linalg.sym(m)
    if structure == "diag":
        return jnp.diag(jnp.diagonal(m))
    if structure == "scalar":
        n = m.shape[-1]
        return jnp.eye(n, dtype=m.dtype) * (jnp.trace(m) / n)
    raise ValueError(f"unknown structure {structure!r}")


@linalg.highp
def smoothed_moments(model: vanilla.Model, state: vanilla.State,
                     measurements, controls=None):
    """E-step sufficient statistics: filter + RTS smooth one batch.

    Returns (means [T+1,n], covs [T+1,n,n], cross [T,n,n], log_lik)
    where index 0 is the prior epoch, means[k] = E[x_k | Y_T], and
    cross[k] = Cov(x_{k+1}, x_k | Y_T).
    """
    f, q = model.f, model.noise.q
    t = measurements.shape[0]
    n = state.x.shape[0]
    _, ests = vanilla.run(model, state, measurements, controls)
    ll = vanilla.innovations_log_likelihood(model, ests)

    means_all = jnp.concatenate([state.x[None], ests.state], axis=0)
    covs_all = jnp.concatenate([state.p[None], ests.covariance], axis=0)
    phis = jnp.broadcast_to(f, (t + 1, n, n))
    offsets = None
    if controls is not None and model.g is not None:
        b = controls @ model.g.T
        offsets = jnp.concatenate([jnp.zeros((1, n), b.dtype), b], axis=0)
    ms, ps = smoothing.rts_smoother(phis, q, means_all, covs_all, offsets)

    def rts_gain(p_filt):
        p_pred = f @ p_filt @ f.T + q
        return linalg.solve_psd(p_pred, f @ p_filt.T).T

    cs = jax.vmap(rts_gain)(covs_all[:-1])  # C_k, k = 0..T-1
    cross = jnp.einsum("tij,tkj->tik", ps[1:], cs)  # P_{k+1|T} C_k^T
    return ms, ps, cross, ll


@linalg.highp
def em_fit(
    model: vanilla.Model,
    state: vanilla.State,
    measurements,
    controls=None,
    iters: int = 20,
    fit: Sequence[str] = ("q", "r"),
    structure: str = "full",
) -> EMResult:
    """Fit model parameters by EM on one measurement sequence.

    `fit` selects any subset of {"q", "r", "f", "h", "x0"} (x0 fits the
    prior mean AND covariance); `structure` constrains the Q/R updates
    to "full" | "diag" | "scalar".  Every selected update is the exact
    (conditional) M-step, so the returned `log_liks` trace — evaluated
    at the parameters entering each iteration, with the final fit
    appended — is non-decreasing up to roundoff; tests assert it.

    The M-steps (Shumway & Stoffer 1982; controls enter as known
    offsets c_k = G u_k):

        F  = (Σ cross_k + m_{k+1} m_kᵀ − c_{k+1} m_kᵀ) S00⁻¹
        Q  = 1/T Σ E[(x_{k+1} − F x_k − c_{k+1})(·)ᵀ | Y_T]
        H  = (Σ y_k m_kᵀ) (Σ P_k + m_k m_kᵀ)⁻¹
        R  = 1/T Σ (y_k − H m_k)(·)ᵀ + H P_k Hᵀ
        x0, P0 = m_{0|T}, P_{0|T}

    Masked / padded time-varying measurement schedules are out of
    scope here — fit on the densely measured segments.
    """
    for name in fit:
        if name not in _FITTABLE:
            raise ValueError(f"unknown fit target {name!r}; pick from {_FITTABLE}")
    measurements = jnp.asarray(measurements)
    t = measurements.shape[0]

    def iteration(carry, _):
        f, h, q, r, x0, p0 = carry
        m = model._replace(f=f, h=h, noise=noiseless(q, r))
        st = vanilla.State(x0, p0, jnp.int32(0))
        ms, ps, cross, ll = smoothed_moments(m, st, measurements, controls)

        ex0, ex1 = ms[:-1], ms[1:]
        p0s, p1s = ps[:-1], ps[1:]
        if controls is not None and m.g is not None:
            cks = controls @ m.g.T  # c_{k+1} aligned with ex1
        else:
            cks = jnp.zeros_like(ex1)

        f_new = f
        if "f" in fit:
            s10 = jnp.sum(cross, 0) + ex1.T @ ex0
            s00 = jnp.sum(p0s, 0) + ex0.T @ ex0
            sc0 = cks.T @ ex0
            f_new = linalg.solve_psd(s00, (s10 - sc0).T).T

        q_new = q
        if "q" in fit:
            e = ex1 - ex0 @ f_new.T - cks
            m_q = (
                jnp.sum(p1s, 0)
                - jnp.sum(cross, 0) @ f_new.T
                - f_new @ jnp.sum(cross, 0).T
                + f_new @ jnp.sum(p0s, 0) @ f_new.T
                + e.T @ e
            )
            q_new = _project(m_q / t, structure)

        h_new = h
        if "h" in fit:
            syx = measurements.T @ ex1
            sxx = jnp.sum(p1s, 0) + ex1.T @ ex1
            h_new = linalg.solve_psd(sxx, syx.T).T

        r_new = r
        if "r" in fit:
            res = measurements - ex1 @ h_new.T
            m_r = res.T @ res + jnp.einsum(
                "ij,tjk,lk->il", h_new, p1s, h_new
            )
            r_new = _project(m_r / t, structure)

        x0_new, p0_new = (ms[0], linalg.sym(ps[0])) if "x0" in fit else (x0, p0)
        return (f_new, h_new, q_new, r_new, x0_new, p0_new), ll

    init = (model.f, model.h, model.noise.q, model.noise.r, state.x, state.p)
    (f, h, q, r, x0, p0), lls = jax.lax.scan(iteration, init, None, length=iters)

    fitted_model = model._replace(f=f, h=h, noise=noiseless(q, r))
    fitted_state = vanilla.State(x0, p0, jnp.int32(0))
    _, ests = vanilla.run(fitted_model, fitted_state, measurements, controls)
    final_ll = vanilla.innovations_log_likelihood(fitted_model, ests)
    return EMResult(fitted_model, fitted_state,
                    jnp.concatenate([lls, final_ll[None]]))


class N4SIDResult(NamedTuple):
    f: jax.Array  # [n, n] identified A (arbitrary state basis)
    g: jax.Array  # [n, m] identified B (zeros-shaped [n, 0] if no input)
    h: jax.Array  # [p, n] identified C
    d: jax.Array  # [p, m] identified D
    q: jax.Array  # [n, n] process-noise covariance
    r: jax.Array  # [p, p] measurement-noise covariance
    s: jax.Array  # [n, p] process/measurement cross-covariance
    singular_values: jax.Array  # [horizon * p] projection SVs (order pick)
    states: jax.Array  # [j, n] estimated state sequence (windows i..)


def _block_hankel(z: jax.Array, i: int, j: int) -> jax.Array:
    """[T, d] signal -> [i*d, j] block Hankel; column t stacks
    z[t], z[t+1], ..., z[t+i-1]."""
    d = z.shape[1]
    rows = jnp.stack([jax.lax.dynamic_slice_in_dim(z, k, j) for k in range(i)])
    return rows.transpose(0, 2, 1).reshape(i * d, j)


def _regress(y: jax.Array, z: jax.Array) -> jax.Array:
    """Least-squares row-space regression L = Y Zt (Z Zt)^-1 with a
    relative ridge (deterministic or collinear regressor blocks make
    Z Zt singular; the ridge only touches the projected-out nullspace).

    The ridge scales with the dtype's eps: a fixed 1e-10 sits far
    below f32 machine epsilon, so the singular gram's own rounding
    noise (~eps * scale) dwarfs it and cholesky NaNs (measured on a
    noise-free f32 system)."""
    gram = z @ z.T
    rel = jnp.maximum(1e-10, 100.0 * jnp.finfo(gram.dtype).eps)
    lam = rel * (jnp.trace(gram) / gram.shape[0] + 1.0)
    gram = gram + lam * jnp.eye(gram.shape[0], dtype=gram.dtype)
    return linalg.solve_psd(gram, (y @ z.T).T).T


@linalg.highp
def n4sid_fit(measurements, controls=None, order: int = 2,
              horizon: int = 10) -> N4SIDResult:
    """Subspace identification (N4SID, Van Overschee & De Moor 1994):
    a NON-ITERATIVE complement to `em_fit` — no initial model, no local
    optima, one shot of dense linear algebra (Hankel regressions + one
    SVD), which batches well.

    Combined deterministic-stochastic algorithm via regressions:
    the oblique projection O_i = Y_f /_{U_f} W_p is computed by
    regressing Y_f jointly on [W_p; U_f] and keeping the W_p part; the
    SVD of O_i gives the extended observability matrix (its singular
    values expose the order — inspect `singular_values` when `order` is
    unknown); Kalman state sequences X_i, X_{i+1} come from the
    Moore-Penrose split, and one final least squares over
    [X_{i+1}; Y_i] = [[A,B],[C,D]] [X_i; U_i] + residual yields the
    system matrices with (Q, S, R) from the residual covariance.

    The identified (A, B, C, D) sit in an ARBITRARY state basis:
    compare eigenvalues / transfer functions / innovations likelihood,
    not raw matrix entries.  `em_fit` on the N4SID output is the
    standard polish step.  TIMING NOTE on `s`: the residual pairing
    here is s = E[w_k v_k^T] with y_k = C x_k + v_k and
    x_{k+1} = A x_k + w_k — the cross term between a measurement and
    the process noise generating the NEXT state.  That is NOT the M
    that `vanilla.run_correlated` consumes (its M = E[w_k v_{k+1}^T]
    pairs the noise driving a prediction with the measurement
    assimilated right after it — one step off).  For a plain
    `vanilla.Model`, drop s; it is exported for innovations-form /
    spectral-factorization use.

    Stochastic-only identification: pass controls=None — the projection
    degenerates to the orthogonal projection of Y_f onto Y_p (CVA-style
    stochastic subspace ID).
    """
    y = jnp.asarray(measurements)
    if y.ndim != 2:
        raise ValueError(f"measurements must be [T, p] (got {y.shape})")
    t, p = y.shape
    i = int(horizon)
    n = int(order)
    j = t - 2 * i + 1
    u = None if controls is None else jnp.asarray(controls)
    m = 0 if u is None else u.shape[1]
    # the shifted observability split drops one block row, so the
    # state regression needs rank n from (i-1) block rows (measured:
    # order == horizon*p passes the naive check and returns garbage)
    if n > (i - 1) * p:
        raise ValueError(
            f"order {n} exceeds (horizon-1)*p = {(i - 1) * p}; raise horizon")
    if j < i * (2 * p + 2 * m + 2) + n:
        raise ValueError(
            f"T={t} too short for horizon {i} with {m} inputs (needs "
            f"well over {i * (2 * p + 2 * m + 2)} regression columns; "
            "shrink horizon or bring more data)")

    yh = _block_hankel(y, 2 * i, j)
    y_p, y_f = yh[: i * p], yh[i * p:]
    y_pp = yh[: (i + 1) * p]        # past extended by one block row
    y_fm = yh[(i + 1) * p:]         # future shifted by one block row
    if u is not None:
        uh = _block_hankel(u, 2 * i, j)
        u_p, u_f = uh[: i * m], uh[i * m:]
        u_pp, u_fm = uh[: (i + 1) * m], uh[(i + 1) * m:]
        w_p = jnp.concatenate([u_p, y_p])
        w_pp = jnp.concatenate([u_pp, y_pp])
        l_full = _regress(y_f, jnp.concatenate([w_p, u_f]))
        o_i = l_full[:, : w_p.shape[0]] @ w_p
        l_m = _regress(y_fm, jnp.concatenate([w_pp, u_fm]))
        o_im = l_m[:, : w_pp.shape[0]] @ w_pp
    else:
        o_i = _regress(y_f, y_p) @ y_p
        o_im = _regress(y_fm, y_pp) @ y_pp

    uu, sv, _ = jnp.linalg.svd(o_i, full_matrices=False)
    gam = uu[:, :n] * jnp.sqrt(sv[:n])[None, :]      # [i*p, n]
    gam_m = gam[: (i - 1) * p]                       # drop last block row
    x_i = _regress(o_i.T, gam.T).T                   # pinv(gam) @ o_i
    x_ip = _regress(o_im.T, gam_m.T).T               # [n, j]

    y_ii = yh[i * p: (i + 1) * p]                    # Y_i|i, [p, j]
    lhs = jnp.concatenate([x_ip, y_ii])              # [n + p, j]
    if u is not None:
        u_ii = uh[i * m: (i + 1) * m]
        rhs = jnp.concatenate([x_i, u_ii])           # [n + m, j]
    else:
        rhs = x_i
    theta = _regress(lhs, rhs)                       # [n+p, n(+m)]
    a_id, c_id = theta[:n, :n], theta[n:, :n]
    if u is not None:
        b_id, d_id = theta[:n, n:], theta[n:, n:]
    else:
        b_id = jnp.zeros((n, 0), y.dtype)
        d_id = jnp.zeros((p, 0), y.dtype)
    resid = lhs - theta @ rhs
    cov = (resid @ resid.T) / j
    q_id = linalg.sym(cov[:n, :n])
    r_id = linalg.sym(cov[n:, n:])
    s_id = cov[:n, n:]
    return N4SIDResult(a_id, b_id, c_id, d_id, q_id, r_id, s_id, sv,
                       x_i.T)
