"""Gaussian-sum filter (GSF).

Beyond the reference: the Sorenson-Alspach (1971) mixture estimator —
the posterior is carried as an M-component Gaussian mixture, each
component propagated by its own Kalman recursion and reweighted each
step by its innovation likelihood.  Where the IMM (filters/imm.py)
models *switching dynamics* through a Markov mode chain, the GSF
models *non-Gaussian uncertainty*: multimodal priors (ambiguous
initialization, multiple launch/target hypotheses), mixture process or
measurement noise (per-component models), and — with the UKF flavor —
multimodal posteriors induced by symmetric nonlinear measurements
(range-only, angle ambiguity).

Static-shape design: like the IMM, the component bank is one `vmap` over
a leading [M] axis — M Joseph-form CKF (or unscented) updates compile
to a single batched-linalg program; log-space weights (f32-safe); the
scan over time is the only sequential axis.  Component count M is
static; `reduce_mixture` (Runnalls 2007) merges a grown mixture back
to a target size under jit with static shapes throughout.

The per-component filter is `vanilla.step` / `ukf.step` verbatim —
the GSF is pure composition, no new filter math (cf. the reference's
single-model LDKF contract, kalman.go:35-47, which this generalizes
the same way imm.py does).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from . import vanilla
from .imm import _gaussian_loglik, _moment_match


class Model(NamedTuple):
    """components: a `vanilla.Model` — either SHARED (2-D leaves, every
    mixture component sees the same dynamics/noise) or STACKED (leaves
    carry a leading [M] axis, e.g. mixture process/measurement noise).
    The flavor is detected statically from f.ndim."""

    components: vanilla.Model


class State(NamedTuple):
    xs: jax.Array  # [M, n] component means
    ps: jax.Array  # [M, n, n] component covariances
    logw: jax.Array  # [M] log component weights (logsumexp == 0)
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array  # [n] moment-matched mixture mean
    covariance: jax.Array  # [n, n] mixture covariance (incl. spread of means)
    weights: jax.Array  # [M] posterior component weights
    innovation: jax.Array  # [M, p] per-component innovations
    log_likelihood: jax.Array  # [] log p(y_k | y_{1:k-1}) under the mixture

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _normalize_logw(logw):
    return logw - jax.scipy.special.logsumexp(logw)


def new(x0s, p0s, model: vanilla.Model, w0=None):
    """Build (Model, State) from M initial hypotheses.

    x0s: [M, n] component means.  p0s: [M, n, n] per-component
    covariances, or a single [n, n] shared by all components.
    `model` is a single shared `vanilla.Model`, or a list/tuple of M
    per-component models (stacked into leading-[M] leaves).  w0: [M]
    initial weights (uniform by default)."""
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be [M, n], got {x0s.shape}")
    m, n = x0s.shape
    p0s = jnp.asarray(p0s)
    if p0s.ndim == 2:
        p0s = jnp.broadcast_to(p0s, (m,) + p0s.shape)
    if p0s.shape != (m, n, n):
        raise ValueError(f"p0s must be [M={m}, n={n}, n], got {p0s.shape}")
    # NB: vanilla.Model is itself a (named) tuple — only a plain
    # list/tuple OF models is the per-component path.
    if isinstance(model, (list, tuple)) and not isinstance(
            model, vanilla.Model):
        if len(model) != m:
            raise ValueError(f"{m} hypotheses but {len(model)} models")
        model = jax.tree.map(lambda *xs: jnp.stack(xs), *model)
    if w0 is None:
        logw = jnp.zeros((m,), x0s.dtype) - jnp.log(float(m))
    else:
        logw = _normalize_logw(jnp.log(jnp.asarray(w0, x0s.dtype)))
    return Model(model), State(x0s, p0s, logw, jnp.int32(0))


def _component_axes(model: Model):
    """Static stacked/shared detection: vmap in_axes for the bank."""
    return 0 if model.components.f.ndim == 3 else None


@linalg.highp
def step(model: Model, state: State, measurement, control=None, has=None):
    """One GSF cycle: M parallel CKF steps, likelihood reweighting,
    moment-matched combined output.  Unlike the IMM there is no
    mixing — components evolve independently and only the weights
    interact (through normalization).

    `has` masks the measurement update: a masked step runs the
    per-component time updates only and leaves the weights untouched
    (no likelihood information arrives), matching the masked-scan
    convention of the other filters."""
    eps = jnp.asarray(1e-30, state.logw.dtype)
    axes = _component_axes(model)

    def comp_step(comp_model, x, p):
        return vanilla.step(
            comp_model, vanilla.State(x, p, state.k), measurement, control
        )

    sts, ests = jax.vmap(comp_step, in_axes=(axes, 0, 0))(
        model.components, state.xs, state.ps
    )

    # Per-component innovation log-likelihoods under S = H P^- H^T + R.
    def loglik(comp_model, est):
        s = comp_model.h @ est.pred_covariance @ comp_model.h.T + (
            comp_model.noise.r
        )
        return _gaussian_loglik(est.innovation, s)

    lls = jax.vmap(loglik, in_axes=(axes, 0))(model.components, ests)  # [M]
    # log p(y | past) = logsumexp(logw + ll); posterior weights by
    # log-space Bayes (f32-safe under weight collapse).
    log_norm = jax.scipy.special.logsumexp(state.logw + lls)
    logw = state.logw + lls - log_norm

    if has is not None:
        # Masked step: per-component pure time update, weights frozen.
        # Mean prediction recomputed from the prior (measurement-
        # independent by construction — same rationale as imm.step);
        # P^- reused from the step's own measurement-free output.
        def comp_x_pred(comp_model, x):
            xp = comp_model.f @ x
            if control is not None and comp_model.g is not None:
                xp = xp + comp_model.g @ control
            return xp

        xs_pred = jax.vmap(comp_x_pred, in_axes=(axes, 0))(
            model.components, state.xs
        )
        xs_new = jnp.where(has, sts.x, xs_pred)
        ps_new = jnp.where(has, sts.p, ests.pred_covariance)
        logw = jnp.where(has, logw, state.logw)
        log_norm = jnp.where(has, log_norm, jnp.zeros_like(log_norm))
        innov = jnp.where(has, ests.innovation,
                          jnp.zeros_like(ests.innovation))
    else:
        xs_new, ps_new, innov = sts.x, sts.p, ests.innovation

    w = jnp.exp(logw)
    mean, cov = _moment_match(xs_new, ps_new, jnp.maximum(w, eps) /
                              jnp.maximum(w.sum(), eps))
    est = Estimate(
        state=mean,
        covariance=cov,
        weights=w,
        innovation=innov,
        log_likelihood=log_norm,
    )
    return State(xs_new, ps_new, logw, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None,
        meas_masks=None):
    """lax.scan driver over the time axis (masked steps are pure
    per-component time updates with frozen weights)."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))


# ---------------------------------------------------------------------------
# Mixture reduction (Runnalls 2007): static-shape pairwise merging.


def _pair_merge_moments(xs, ps, w):
    """All-pairs moment-matched merges: means [M,M,n], covs [M,M,n,n].

    mu_ij = (w_i x_i + w_j x_j) / (w_i + w_j)
    P_ij  = (w_i (P_i + d_i d_i^T) + w_j (P_j + d_j d_j^T)) / (w_i + w_j)
    with d = x - mu_ij.  Moment-matched merging preserves the overall
    mixture mean and covariance exactly."""
    wij = w[:, None] + w[None, :]  # [M, M]
    safe = jnp.maximum(wij, jnp.asarray(1e-30, w.dtype))
    mu = (w[:, None, None] * xs[:, None, :] +
          w[None, :, None] * xs[None, :, :]) / safe[:, :, None]  # [M,M,n]
    di = xs[:, None, :] - mu  # [M, M, n]
    dj = xs[None, :, :] - mu
    pij = (
        w[:, None, None, None] * (ps[:, None] +
                                  di[..., :, None] * di[..., None, :])
        + w[None, :, None, None] * (ps[None, :] +
                                    dj[..., :, None] * dj[..., None, :])
    ) / safe[:, :, None, None]  # [M, M, n, n]
    return mu, pij


def _logdet_psd(p):
    ls = jnp.linalg.cholesky(p)
    return 2.0 * jnp.sum(jnp.log(jnp.maximum(
        jnp.diagonal(ls, axis1=-2, axis2=-1),
        jnp.asarray(1e-30, p.dtype))), axis=-1)


def cluster_reduce(xs, ps, w, m_out: int, dist2: float = 4.0):
    """Vo & Ma 2006 (Table II) cluster merge for GM intensities: pick
    the heaviest remaining component, moment-match-merge every
    remaining component within squared Mahalanobis distance `dist2` of
    it (measured in the seed's covariance), write one output slot,
    repeat `m_out` times.  Raw-weight domain; the output weights are
    rescaled so Σw_out == Σw exactly (mass IS cardinality for the
    PHD/CPHD — proportional redistribution of any slot-starved
    leftover keeps the intensity-mass/cardinality identity that the
    exact-Bayes pins test).

    Why this exists next to `reduce_mixture` (Runnalls): the pairwise
    merge materializes [M, M, n, n] merged-covariance tensors inside a
    fori_loop, which compiles in MINUTES at bank scale (every sub-op
    compiles fine on its own; the combination does not).  This cluster form is O(m_out · M) with
    [M, n] intermediates, one 4x4 inverse per iteration, and no
    pairwise tensor at all — and it is the merge the GM-PHD literature
    actually prescribes.  Runnalls remains the better choice for the
    small GSF hypothesis banks it was built for.

    Returns (xs [m_out, n], ps [m_out, n, n], w [m_out] raw weights).
    """
    xs, ps = jnp.asarray(xs), jnp.asarray(ps)
    w = jnp.asarray(w)
    m, n = xs.shape
    if not 1 <= m_out:
        raise ValueError(f"m_out must be >= 1, got {m_out}")
    if m_out >= m:
        pad = m_out - m
        return (jnp.pad(xs, ((0, pad), (0, 0))),
                jnp.pad(ps, ((0, pad), (0, 0), (0, 0))),
                jnp.pad(w, (0, pad)))
    dt = xs.dtype
    tiny = jnp.asarray(1e-300 if dt == jnp.float64 else 1e-30, dt)
    idx = jnp.arange(m)

    def body(k, carry):
        rem, w_out, xs_out, ps_out = carry
        wr = jnp.where(rem, w, 0.0)
        i = jnp.argmax(wr)
        e = (idx == i).astype(dt)
        x_star = e @ xs
        p_star = jnp.einsum("m,mij->ij", e, ps)
        d = xs - x_star
        p_inv = linalg.inv_psd(p_star)
        md2 = jnp.einsum("mi,ij,mj->m", d, p_inv, d)
        cl = rem & (md2 < dist2) & (wr > 0)
        wc = jnp.where(cl, w, 0.0)
        wsum = jnp.sum(wc)
        safe = jnp.maximum(wsum, tiny)
        mu = (wc @ xs) / safe
        dc = xs - mu
        pm = (jnp.einsum("m,mij->ij", wc, ps)
              + jnp.einsum("m,mi,mj->ij", wc, dc, dc)) / safe
        has = wsum > 0
        w_out = w_out.at[k].set(jnp.where(has, wsum, 0.0))
        xs_out = xs_out.at[k].set(jnp.where(has, mu, jnp.zeros(n, dt)))
        ps_out = ps_out.at[k].set(
            jnp.where(has, linalg.sym(pm), jnp.eye(n, dtype=dt)))
        return rem & ~cl, w_out, xs_out, ps_out

    _, w_out, xs_out, ps_out = jax.lax.fori_loop(
        0, m_out, body,
        (w > 0, jnp.zeros(m_out, dt), jnp.zeros((m_out, n), dt),
         jnp.broadcast_to(jnp.eye(n, dtype=dt), (m_out, n, n))))
    total = jnp.sum(w)
    w_out = w_out * (total / jnp.maximum(jnp.sum(w_out), tiny))
    return xs_out, ps_out, w_out


def reduce_mixture(xs, ps, logw, m_out: int, pool: int = None):
    """Reduce an M-component Gaussian mixture to `m_out` components by
    repeated cheapest pairwise moment-matched merges (Runnalls 2007).

    Merge cost is Runnalls' KL upper bound
      B(i,j) = 0.5 [ (w_i+w_j) ln det P_ij - w_i ln det P_i
                     - w_j ln det P_j ],
    which merges near-duplicate/overlapping components before distinct
    modes.  Pure static-shape jit: M - m_out `fori_loop` iterations,
    each an argmin over the [M, M] cost matrix; retired slots are
    masked with +inf cost and compacted out at the end.  Every merge
    preserves the overall mixture mean and covariance exactly.

    `pool` (optional, >= m_out) first truncates to the `pool` largest
    weights and renormalizes, then merges pool -> m_out.  The pairwise
    work drops from O((M-m_out) M^2) to O((pool-m_out) pool^2) — the
    Vo & Ma 2006 prune-then-cap recipe with Runnalls merging on top.
    Necessity: a vmapped 256-scene GM-PHD bank at the post-update
    M=234 needs a 28.7 GB [B, M, M, n, n] pairwise tensor; pool=2*j_max runs in 1/100 the memory and the
    dropped mass (weights below the top-pool) is redistributed by the
    normalization.

    Returns (xs [m_out, n], ps [m_out, n, n], logw [m_out] normalized).
    """
    m = xs.shape[0]
    if not 1 <= m_out <= m:
        raise ValueError(f"m_out must be in [1, {m}], got {m_out}")
    if pool is not None and pool < m:
        if pool < m_out:
            raise ValueError(f"pool={pool} must be >= m_out={m_out}")
        _, idx = jax.lax.top_k(logw, pool)
        xs, ps, logw = xs[idx], ps[idx], logw[idx]
        m = pool
    if m_out == m:
        return xs, ps, _normalize_logw(logw)
    w0 = jnp.exp(_normalize_logw(logw))
    inf = jnp.asarray(jnp.inf, xs.dtype)

    def merge_once(_, carry):
        xs, ps, w, valid = carry
        mu, pij = _pair_merge_moments(xs, ps, w)
        cost = 0.5 * (
            (w[:, None] + w[None, :]) * _logdet_psd(pij)
            - (w * _logdet_psd(ps))[:, None]
            - (w * _logdet_psd(ps))[None, :]
        )
        pair_ok = (valid[:, None] & valid[None, :]
                   & (jnp.arange(m)[:, None] < jnp.arange(m)[None, :]))
        cost = jnp.where(pair_ok, cost, inf)
        flat = jnp.argmin(cost)
        i, j = flat // m, flat % m
        xs = xs.at[i].set(mu[i, j])
        ps = ps.at[i].set(linalg.sym(pij[i, j]))
        w = w.at[i].set(w[i] + w[j]).at[j].set(0.0)
        valid = valid.at[j].set(False)
        return xs, ps, w, valid

    xs, ps, w, valid = jax.lax.fori_loop(
        0, m - m_out, merge_once,
        (xs, ps, w0, jnp.ones((m,), bool)),
    )
    # Compact the m_out surviving slots to the front (stable order).
    order = jnp.argsort(jnp.where(valid, 0, 1), stable=True)[:m_out]
    logw_out = _normalize_logw(jnp.log(jnp.maximum(
        w[order], jnp.asarray(1e-300 if w.dtype == jnp.float64 else 1e-30,
                              w.dtype))))
    return xs[order], ps[order], logw_out


# ---------------------------------------------------------------------------
# Unscented flavor: Gaussian sum of UKF components (nonlinear fx/hx).


class UKFModel(NamedTuple):
    components: object  # ukf.Model — shared, or stacked [M] leaves


def new_ukf(x0s, p0s, model, w0=None):
    """GSF over UKF components: `model` is a single shared `ukf.Model`
    or a list/stack of M per-component ones (all sharing the fx/hx
    callables passed at step time).  Same (x0s, p0s, w0) contract as
    `new`."""
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be [M, n], got {x0s.shape}")
    m, n = x0s.shape
    p0s = jnp.asarray(p0s)
    if p0s.ndim == 2:
        p0s = jnp.broadcast_to(p0s, (m,) + p0s.shape)
    if p0s.shape != (m, n, n):
        raise ValueError(f"p0s must be [M={m}, n={n}, n], got {p0s.shape}")
    from . import ukf

    if isinstance(model, (list, tuple)) and not isinstance(model, ukf.Model):
        if len(model) != m:
            raise ValueError(f"{m} hypotheses but {len(model)} models")
        model = jax.tree.map(lambda *xs: jnp.stack(xs), *model)
    if w0 is None:
        logw = jnp.zeros((m,), x0s.dtype) - jnp.log(float(m))
    else:
        logw = _normalize_logw(jnp.log(jnp.asarray(w0, x0s.dtype)))
    return UKFModel(model), State(x0s, p0s, logw, jnp.int32(0))


@linalg.highp
def step_ukf(model: UKFModel, state: State, measurement, fx, hx,
             control=None, has=None):
    """One unscented GSF cycle: M vmapped ukf.steps, likelihoods from
    the unscented innovation covariance, log-space reweighting,
    moment-matched output.  Masked steps reduce to M pure unscented
    predictions with frozen weights (ukf.step's own `has` contract)."""
    from . import ukf

    axes = 0 if model.components.noise.q.ndim == 3 else None

    def comp_step(comp_model, x, p):
        return ukf.step(comp_model, ukf.State(x, p, state.k), measurement,
                        fx, hx, control, has=has)

    sts, ests = jax.vmap(comp_step, in_axes=(axes, 0, 0))(
        model.components, state.xs, state.ps
    )

    lls = jax.vmap(
        lambda est: _gaussian_loglik(est.innovation,
                                     est.innovation_covariance)
    )(ests)
    log_norm = jax.scipy.special.logsumexp(state.logw + lls)
    logw = state.logw + lls - log_norm
    if has is not None:
        logw = jnp.where(has, logw, state.logw)
        log_norm = jnp.where(has, log_norm, jnp.zeros_like(log_norm))

    w = jnp.exp(logw)
    mean, cov = _moment_match(sts.x, sts.p, w / jnp.maximum(
        w.sum(), jnp.asarray(1e-30, w.dtype)))
    est = Estimate(
        state=mean,
        covariance=cov,
        weights=w,
        innovation=ests.innovation,
        log_likelihood=log_norm,
    )
    return State(sts.x, sts.p, logw, state.k + 1), est


@linalg.highp
def run_ukf(model: UKFModel, state: State, measurements, fx, hx,
            controls=None, meas_masks=None):
    """lax.scan driver for the unscented GSF."""

    def body(carry, xs):
        meas, u, has = xs
        return step_ukf(model, carry, meas, fx, hx, u, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks))
