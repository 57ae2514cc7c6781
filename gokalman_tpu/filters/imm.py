"""Interacting multiple model (IMM) estimator.

Beyond the reference: the standard maneuvering-target architecture
(Blom & Bar-Shalom 1988) — a bank of M mode-matched Kalman filters
whose priors are remixed each step through a Markov mode-transition
matrix, with mode probabilities updated by each filter's innovation
likelihood.

Static-shape design: the mode bank is a *stacked* `vanilla.Model` pytree
(leaves carry a leading [M] axis) and the whole per-mode tier — mixing,
M Joseph-form CKF updates, likelihood evaluation — is one `vmap` over
that axis, so the step compiles to a single fused batched-linalg
program.  M is small (2-5 modes); everything stays resident and the
scan over time is the only sequential axis.  The filter bank reuses
`vanilla.step` verbatim — the IMM is pure composition, no new filter
math (cf. the reference's single-model LDKF contract, kalman.go:35-47,
which this generalizes).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from . import vanilla


class Model(NamedTuple):
    modes: vanilla.Model  # stacked: leaves have leading [M] axis
    trans: jax.Array  # [M, M] row-stochastic: trans[i, j] = P(i -> j)


class State(NamedTuple):
    xs: jax.Array  # [M, n] per-mode means
    ps: jax.Array  # [M, n, n] per-mode covariances
    mu: jax.Array  # [M] mode probabilities (sums to 1)
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array  # [n] moment-matched combined mean
    covariance: jax.Array  # [n, n] combined covariance (incl. mode spread)
    mode_probs: jax.Array  # [M]
    innovation: jax.Array  # [M, p] per-mode innovations
    log_likelihood: jax.Array  # [] log p(y_k | y_{1:k-1}) under the IMM
    # Per-mode filtered moments — what the IMM smoother consumes.
    mode_states: jax.Array = None  # [M, n]
    mode_covariances: jax.Array = None  # [M, n, n]

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _bank_init(trans, x0, p0, mu0, mode_count: int):
    """Shared constructor validation/state for both mode-bank flavors."""
    trans = jnp.asarray(trans)
    m = trans.shape[0]
    if trans.shape != (m, m):
        raise ValueError(f"transition matrix must be square, got {trans.shape}")
    if mode_count != m:
        raise ValueError(f"{mode_count} modes but {m}x{m} transition matrix")
    # Validate on the host (numpy): a device allclose would force eager
    # computation and raise TracerBoolConversionError when the
    # constructor runs under jit / with traced inputs — skip the value
    # check for tracers (shape checks above still apply).
    if not isinstance(trans, jax.core.Tracer):
        import numpy as np

        rows = np.asarray(trans).sum(axis=1)
        if not np.allclose(rows, 1.0, atol=1e-6):
            raise ValueError("transition matrix rows must sum to 1")
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    mu0 = jnp.full((m,), 1.0 / m, x0.dtype) if mu0 is None else jnp.asarray(mu0)
    xs = jnp.broadcast_to(x0, (m, x0.shape[0]))
    ps = jnp.broadcast_to(p0, (m,) + p0.shape)
    return trans, State(xs, ps, mu0, jnp.int32(0))


def _mix(state: State, trans: jax.Array, eps):
    """Interaction/mixing: c_j = sum_i trans[i,j] mu_i;
    w[i,j] = trans[i,j] mu_i / c_j; mixed per-mode moments."""
    c = state.mu @ trans  # [M]
    w = trans * state.mu[:, None] / jnp.maximum(c[None, :], eps)
    xs_mix = w.T @ state.xs  # [M, n]
    dev = state.xs[None, :, :] - xs_mix[:, None, :]  # [j, i, n]
    ps_mix = jnp.einsum("ij,ikl->jkl", w, state.ps) + jnp.einsum(
        "ij,jin,jik->jnk", w, dev, dev
    )
    return c, xs_mix, ps_mix


def _gaussian_loglik(innovation, s):
    ls = jnp.linalg.cholesky(s)
    e = linalg.solve_tri_lower(ls, innovation)
    p = innovation.shape[0]
    return (
        -0.5 * jnp.dot(e, e)
        - jnp.sum(jnp.log(jnp.diagonal(ls)))
        - 0.5 * p * jnp.log(2.0 * jnp.pi)
    )


def _mode_posterior(c, lls, eps):
    log_mu = jnp.log(jnp.maximum(c, eps)) + lls
    log_norm = jax.scipy.special.logsumexp(log_mu)
    return jnp.exp(log_mu - log_norm), log_norm


def new(x0, p0, models, trans, mu0=None):
    """Build the IMM from a list/stack of per-mode `vanilla.Model`s, a
    row-stochastic transition matrix, and optional initial mode
    probabilities (uniform by default).  All modes share (x0, P0)."""
    if isinstance(models, (list, tuple)):
        models = jax.tree.map(lambda *xs: jnp.stack(xs), *models)
    trans, state = _bank_init(trans, x0, p0, mu0,
                              int(models.f.shape[0]))
    return Model(models, trans), state


def _moment_match(xs, ps, w):
    """Mean/covariance of a Gaussian mixture: the IMM's moment-matched
    combination (covariance picks up the spread-of-means term)."""
    mean = w @ xs  # [n]
    dev = xs - mean[None, :]  # [M, n]
    cov = jnp.einsum("m,mij->ij", w, ps) + jnp.einsum(
        "m,mi,mj->ij", w, dev, dev
    )
    return mean, linalg.sym(cov)


@linalg.highp
def step(model: Model, state: State, measurement, control=None, has=None):
    """One IMM cycle: interact (mix), mode-matched filtering, mode
    probability update, moment-matched combination.

    `has` masks the measurement update: a masked step runs the mixing
    and the per-mode time updates only (mode probabilities evolve by
    the Markov chain alone), matching the masked-scan convention of the
    other filters."""
    eps = jnp.asarray(1e-30, state.mu.dtype)
    c, xs_mix, ps_mix = _mix(state, model.trans, eps)

    # Mode-matched filtering: one vanilla CKF step per mode (vmap).
    def mode_step(mode_model, x, p):
        return vanilla.step(
            mode_model, vanilla.State(x, p, state.k), measurement, control
        )

    (sts, ests) = jax.vmap(mode_step)(model.modes, xs_mix, ps_mix)

    # Per-mode innovation log-likelihoods under S = H P^- H^T + R,
    # then mode probabilities mu_j ∝ c_j Λ_j (log-space for f32).
    def loglik(mode_model, est):
        s = mode_model.h @ est.pred_covariance @ mode_model.h.T + (
            mode_model.noise.r
        )
        return _gaussian_loglik(est.innovation, s)

    lls = jax.vmap(loglik)(model.modes, ests)  # [M]
    mu, log_norm = _mode_posterior(c, lls, eps)

    if has is not None:
        # Masked step: keep the time-update-only bank and Markov
        # priors.  The mean prediction is recomputed from the mixed
        # prior rather than recovered as x^+ - K innov: the subtraction
        # form would re-introduce measurement-value dependence
        # (catastrophic cancellation with large padded innovations, or
        # NaN propagation from NaN-padded measurements) on a path that
        # must be measurement-independent.  P^- is reused from the
        # step's own output (measurement-free by construction).
        def mode_x_pred(mode_model, x):
            xp = mode_model.f @ x
            if control is not None and mode_model.g is not None:
                xp = xp + mode_model.g @ control
            return xp

        xs_pred = jax.vmap(mode_x_pred)(model.modes, xs_mix)
        ps_pred = ests.pred_covariance
        xs_new = jnp.where(has, sts.x, xs_pred)
        ps_new = jnp.where(has, sts.p, ps_pred)
        mu = jnp.where(has, mu, c)
        log_norm = jnp.where(has, log_norm, jnp.zeros_like(log_norm))
        innov = jnp.where(has, ests.innovation, jnp.zeros_like(ests.innovation))
    else:
        xs_new, ps_new, innov = sts.x, sts.p, ests.innovation

    # 4. Moment-matched output.
    mean, cov = _moment_match(xs_new, ps_new, mu)
    est = Estimate(
        state=mean,
        covariance=cov,
        mode_probs=mu,
        innovation=innov,
        log_likelihood=log_norm,
        mode_states=xs_new,
        mode_covariances=ps_new,
    )
    return State(xs_new, ps_new, mu, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None,
        meas_masks=None):
    """lax.scan driver over the time axis (masked steps are pure
    Markov-mixed time updates)."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))


class UKFModel(NamedTuple):
    modes: object  # stacked ukf.Model (leaves carry a leading [M] axis)
    trans: jax.Array  # [M, M] row-stochastic


def new_ukf(x0, p0, models, trans, mu0=None):
    """IMM over a bank of UKF modes (nonlinear dynamics/measurement):
    `models` is a list/stack of per-mode `ukf.Model`s (noise + UT
    params), all sharing the same fx/hx callables — modes differ by
    their noise levels / UT parameterization, the standard maneuvering
    setup.  Same contract as `new` otherwise."""
    if isinstance(models, (list, tuple)):
        models = jax.tree.map(lambda *xs: jnp.stack(xs), *models)
    trans, state = _bank_init(trans, x0, p0, mu0,
                              int(models.noise.q.shape[0]))
    return UKFModel(models, trans), state


@linalg.highp
def step_ukf(model: UKFModel, state: State, measurement, fx, hx,
             control=None, has=None):
    """One IMM cycle with unscented mode-matched filtering: the mixing,
    probability update, and moment-matched combination are identical to
    `step`; the per-mode filter is `ukf.step` (vmapped over the stacked
    mode models) and the likelihood uses the unscented innovation
    covariance the UKF estimate now carries."""
    from . import ukf

    eps = jnp.asarray(1e-30, state.mu.dtype)
    c, xs_mix, ps_mix = _mix(state, model.trans, eps)

    def mode_step(mode_model, x, p):
        return ukf.step(mode_model, ukf.State(x, p, state.k), measurement,
                        fx, hx, control, has=has)

    sts, ests = jax.vmap(mode_step)(model.modes, xs_mix, ps_mix)

    lls = jax.vmap(
        lambda est: _gaussian_loglik(est.innovation,
                                     est.innovation_covariance)
    )(ests)
    mu, log_norm = _mode_posterior(c, lls, eps)

    if has is not None:
        # Masked step: ukf.step already reduced to the pure unscented
        # prediction (zero gain); keep Markov-chain mode priors.
        mu = jnp.where(has, mu, c)
        log_norm = jnp.where(has, log_norm, jnp.zeros_like(log_norm))

    mean, cov = _moment_match(sts.x, sts.p, mu)
    est = Estimate(
        state=mean,
        covariance=cov,
        mode_probs=mu,
        innovation=ests.innovation,
        log_likelihood=log_norm,
        mode_states=sts.x,
        mode_covariances=sts.p,
    )
    return State(sts.x, sts.p, mu, state.k + 1), est


@linalg.highp
def run_ukf(model: UKFModel, state: State, measurements, fx, hx,
            controls=None, meas_masks=None):
    """lax.scan driver for the UKF-mode IMM."""

    def body(carry, xs):
        meas, u, has = xs
        return step_ukf(model, carry, meas, fx, hx, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))


@linalg.highp
def rts_smoother(model: Model, ests: Estimate):
    """Fixed-interval IMM smoother (Kim 1994, the mode-matched RTS
    form): given an `imm.run` trace, runs M² per-mode-pair RTS backward
    recursions, collapses each origin mode over the destination modes
    with the (approximate) backward mode weights, and smooths the mode
    probabilities through the Markov chain:

        per pair (i -> j):  x̂ᵢⱼ = x̂ᵢ|k + Cᵢⱼ (x̂ⱼ|T − Fⱼ x̂ᵢ|k)
        collapse over j with  W(j|i) ∝ trans[i,j] μⱼ|T
        mode smoothing:      μᵢ|T = Σⱼ μⱼ|T · trans[i,j] μᵢ|k / (μ|k trans)ⱼ

    Exact only when the mode sequence is degenerate (M=1 or identical
    modes, == RTS pinned in tests); otherwise the standard Gaussian-
    collapse approximation every IMM variant makes.  Returns
    (x_smoothed [T, n], p_smoothed [T, n, n], mu_smoothed [T, M]).
    """
    xs_f = ests.mode_states  # [T, M, n]
    ps_f = ests.mode_covariances  # [T, M, n, n]
    mus_f = ests.mode_probs  # [T, M]
    t, m, n = xs_f.shape
    eps = jnp.asarray(1e-30, xs_f.dtype)

    def backward(carry, xs):
        x_next, p_next, mu_next = carry  # smoothed at k+1, per mode [M,...]
        x_f, p_f, mu_f, is_last = xs  # filtered at k

        def pair(i_x, i_p):
            # smooth mode i against every destination mode j
            def against(model_j, x_sj, p_sj):
                x_pred = model_j.f @ i_x
                p_pred = model_j.f @ i_p @ model_j.f.T + model_j.noise.q
                c = linalg.solve_psd(p_pred, model_j.f @ i_p.T).T
                x_s = i_x + c @ (x_sj - x_pred)
                p_s = linalg.sym(i_p + c @ (p_sj - p_pred) @ c.T)
                return x_s, p_s

            return jax.vmap(against)(model.modes, x_next, p_next)

        x_ij, p_ij = jax.vmap(pair)(x_f, p_f)  # [M_i, M_j, ...]

        # Kim's joint factorization: P(m_k=i, m_{k+1}=j | Z_T) ≈
        # μⱼ|T · u[i,j] with u[i,j] = P(m_k=i | m_{k+1}=j, Z_k)
        # = trans[i,j] μᵢ|k / c_j (the forward mixing posterior).
        c_j = mu_f @ model.trans  # [M]
        u = model.trans * mu_f[:, None] / jnp.maximum(c_j[None, :], eps)
        joint = u * mu_next[None, :]  # [i, j]
        mu_s = joint.sum(axis=1)  # smoothed mode probs
        mu_s = mu_s / jnp.maximum(mu_s.sum(), eps)
        # collapse weights W(j|i) = joint / μᵢ|T
        w = joint / jnp.maximum(joint.sum(axis=1, keepdims=True), eps)
        x_si = jnp.einsum("ij,ijn->in", w, x_ij)
        dev = x_ij - x_si[:, None, :]
        p_si = jnp.einsum("ij,ijnk->ink", w, p_ij) + jnp.einsum(
            "ij,ijn,ijk->ink", w, dev, dev)

        x_out = jnp.where(is_last, x_f, x_si)
        p_out = jnp.where(is_last, p_f, p_si)
        mu_out = jnp.where(is_last, mu_f, mu_s)
        return (x_out, p_out, mu_out), (x_out, p_out, mu_out)

    is_last = jnp.arange(t) == (t - 1)
    init = (xs_f[-1], ps_f[-1], mus_f[-1])
    _, (xs_s, ps_s, mus_s) = jax.lax.scan(
        backward, init, (xs_f, ps_f, mus_f, is_last), reverse=True)

    def combine(x_s, p_s, mu_s):
        return _moment_match(x_s, p_s, mu_s)

    x_c, p_c = jax.vmap(combine)(xs_s, ps_s, mus_s)
    return x_c, p_c, mus_s


@linalg.highp
def step_pdaf(model: Model, state: State, candidates, cand_mask,
              pd, clutter_density, gate, control=None):
    """One IMM-PDAF cycle (Bar-Shalom's IMMPDAF): maneuvering targets
    IN CLUTTER — each mode runs a full PDAF measurement update (gated
    soft association, combined innovation, spread-of-innovations
    covariance) against the SAME candidate frame, and the mode
    probabilities update with each mode's association likelihood
    p(Z | mode) = Π-style PDAF evidence

        Λ_j ∝ (1 − PD·PG) + (PD/λ) Σᵢ N(ν_ij; 0, S_j)

    (the same log-space bookkeeping as pdaf.step).  Mixing and the
    moment-matched output are the standard IMM tier.  With identical
    modes this reduces to the single-model PDAF, and with one
    always-valid candidate at PD→1, λ→0 it reduces to the plain IMM
    (both pinned).

    `candidates` [m_max, p] padded detections + `cand_mask` [m_max];
    pd/clutter_density/gate as in pdaf.new.
    """
    from . import pdaf as _pdaf

    eps = jnp.asarray(1e-30, state.mu.dtype)
    dt = state.mu.dtype
    c, xs_mix, ps_mix = _mix(state, model.trans, eps)
    pd = jnp.asarray(pd, dt)
    lam = jnp.asarray(clutter_density, dt)
    gate = jnp.asarray(gate, dt)

    def mode_step(mode_model, x, p):
        pmodel = _pdaf.Model(mode_model, pd, lam, gate)
        st, est = _pdaf.step(pmodel, _pdaf.State(x, p, state.k),
                             candidates, cand_mask, control)
        # association evidence computed ONCE inside pdaf.step from the
        # same gating/S the update used (Estimate.log_evidence) — a
        # review pass caught the first version rebuilding the geometry
        # from est.state - K@innovation, the exact cancellation-prone
        # recovery imm.step's masked path documents against.
        return st, est, est.log_evidence

    sts, ests, lls = jax.vmap(mode_step)(model.modes, xs_mix, ps_mix)
    mu, log_norm = _mode_posterior(c, lls, eps)
    mean, cov = _moment_match(sts.x, sts.p, mu)
    est = Estimate(
        state=mean,
        covariance=cov,
        mode_probs=mu,
        innovation=ests.innovation,
        log_likelihood=log_norm,
        mode_states=sts.x,
        mode_covariances=sts.p,
    )
    return State(sts.x, sts.p, mu, state.k + 1), est


@linalg.highp
def run_pdaf(model: Model, state: State, candidates, cand_masks,
             pd, clutter_density, gate, controls=None):
    """lax.scan driver for the IMM-PDAF over [T, m_max, p] frames."""

    def body(carry, xs):
        cands, mask, u = xs
        return step_pdaf(model, carry, cands, mask, pd, clutter_density,
                         gate, u)

    return jax.lax.scan(body, state,
                        (jnp.asarray(candidates), jnp.asarray(cand_masks),
                         controls))
