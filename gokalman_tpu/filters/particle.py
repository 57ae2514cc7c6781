"""Bootstrap particle filter (sequential importance resampling).

Beyond the reference: completes the nonlinear tier past the Gaussian
family (hybrid/UKF/EnKF) for genuinely non-Gaussian posteriors.  The
design is the framework's standard shape — a pure
`step(state, inputs) -> (state, estimate)` scanned over time — with the
particle cloud as the batch axis, so propagation and weighting are one
`vmap` each and the whole filter is a single fused XLA computation.

Design choices:
- static shapes throughout: the particle count never changes, and
  resampling is an unconditional gather whose *indices* switch between
  systematic-resample positions and `iota` under `jnp.where` — no
  data-dependent control flow, so the scan body stays a straight-line
  compiled program (`lax.cond` on the ESS would force both branches to
  be compiled anyway; the gather IS the cheap part).
- systematic resampling via `searchsorted` on the weight CDF: O(N log N)
  as sorted lookups, fully batched, minimal-variance (one shared
  uniform), reproducible from the step key.
- log-space weights with `logsumexp` normalization: f32-safe even when
  a tight likelihood collapses the ensemble.

The per-step normalizer is the incremental marginal likelihood, so the
filter doubles as a differentiable-in-model-parameters likelihood
estimator (same role as vanilla.innovations_log_likelihood on the
linear tier).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from .enkf import _member_normals, _psum  # shared sharding helpers


def _global_logsumexp(lw, axis_name=None):
    """logsumexp over the (possibly device-sharded) particle axis."""
    if axis_name is None:
        return jax.scipy.special.logsumexp(lw)
    m = jax.lax.pmax(jnp.max(lw), axis_name)
    return m + jnp.log(_psum(jnp.sum(jnp.exp(lw - m)), axis_name))


class State(NamedTuple):
    particles: jax.Array  # [N, n]
    log_weights: jax.Array  # [N], normalized: logsumexp == 0
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    state: jax.Array  # [n] posterior (weighted) mean
    covariance: jax.Array  # [n, n] posterior (weighted) sample covariance
    ess: jax.Array  # [] effective sample size, in [1, N]
    log_likelihood: jax.Array  # [] incremental log p(y_k | y_{1:k-1})
    resampled: jax.Array  # [] bool, whether this step resampled

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, n_particles: int, key: jax.Array,
        member_offset=0, n_total=None) -> State:
    """Initial cloud: x_i ~ N(x0, P0), uniform weights.

    Draws are keyed per GLOBAL particle index (fold_in), so a
    device-sharded cloud built shard-by-shard with the matching
    `member_offset`/`n_total` reproduces the unsharded one exactly."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    z = _member_normals(key, n_particles, x0.shape[0], x0.dtype,
                        member_offset)
    pts = x0[None, :] + z @ jnp.linalg.cholesky(p0).T
    n = n_particles if n_total is None else n_total
    lw = jnp.full((n_particles,), -jnp.log(float(n)), x0.dtype)
    return State(pts, lw, jnp.int32(0))


def additive_dynamics(fx: Callable, noise: Noise) -> Callable:
    """Propagator x' = fx(x[, u]) + w, w ~ N(0, Q): the bootstrap
    proposal for the framework's standard additive-noise models."""

    def propagate(x, key, u=None):
        z = jax.random.normal(key, x.shape, dtype=x.dtype)
        drift = fx(x) if u is None else fx(x, u)
        return drift + noise.sqrt_q @ z

    return propagate


def gaussian_log_likelihood(hx: Callable, noise: Noise) -> Callable:
    """log p(y | x) for y = hx(x) + v, v ~ N(0, R) — the standard
    weighting function (whitened through chol(R); constant included so
    the log-marginal estimate is properly normalized)."""
    lr = jnp.linalg.cholesky(noise.r)
    p = noise.r.shape[0]
    const = -0.5 * p * jnp.log(2.0 * jnp.pi) - jnp.sum(
        jnp.log(jnp.diagonal(lr))
    )

    def loglik(x, y):
        e = linalg.solve_tri_lower(lr, y - hx(x))
        return const - 0.5 * jnp.dot(e, e)

    return loglik


def _resample_from_positions(log_weights: jax.Array, positions: jax.Array):
    """Shared CDF inversion for the position-based resampling schemes
    (normalization + f32-roundoff guard at the top of the CDF)."""
    n = log_weights.shape[0]
    w = jnp.exp(log_weights - jax.scipy.special.logsumexp(log_weights))
    cdf = jnp.cumsum(w)
    cdf = cdf / cdf[-1]  # guard f32 roundoff at the top
    return jnp.clip(
        jnp.searchsorted(cdf, positions, side="left"), 0, n - 1
    ).astype(jnp.int32)


def systematic_resample_indices(log_weights: jax.Array, key: jax.Array):
    """Minimal-variance systematic resampling: one uniform offset u,
    positions (i + u)/N against the weight CDF.  Returns [N] int32
    ancestor indices; a weight w_i spawns floor(N w_i) or ceil(N w_i)
    copies, so the resampled counts have the smallest possible
    variance among unbiased schemes."""
    n = log_weights.shape[0]
    u = jax.random.uniform(key, (), dtype=log_weights.dtype)
    positions = (jnp.arange(n, dtype=log_weights.dtype) + u) / n
    return _resample_from_positions(log_weights, positions)


def stratified_resample_indices(log_weights: jax.Array, key: jax.Array):
    """Stratified resampling: one independent uniform per stratum,
    positions (i + u_i)/N — unbiased, variance between multinomial and
    systematic.  Same contract as systematic_resample_indices."""
    n = log_weights.shape[0]
    u = jax.random.uniform(key, (n,), dtype=log_weights.dtype)
    positions = (jnp.arange(n, dtype=log_weights.dtype) + u) / n
    return _resample_from_positions(log_weights, positions)


def multinomial_resample_indices(log_weights: jax.Array, key: jax.Array):
    """Plain multinomial (iid categorical) resampling — highest
    variance of the three, provided for completeness/comparisons."""
    n = log_weights.shape[0]
    return jax.random.categorical(key, log_weights, shape=(n,)).astype(
        jnp.int32
    )


def effective_sample_size(log_weights: jax.Array) -> jax.Array:
    """ESS = 1 / sum(w_i^2) for normalized weights (Kong et al. 1994)."""
    lw = log_weights - jax.scipy.special.logsumexp(log_weights)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * lw))


@linalg.highp
def step(state: State, measurement, propagate: Callable, loglik: Callable,
         key: jax.Array, control=None, resample_threshold: float = 0.5,
         has=None, member_offset=0, n_total=None, axis_name=None,
         local_resampling: bool = False, n_shards=None):
    """One SIR step: propagate through the bootstrap proposal, reweight
    by the measurement likelihood, systematic-resample when the ESS
    falls below `resample_threshold * N`.

    `has` (traced bool) masks the measurement: a masked step keeps the
    weights (and skips resampling) so it reduces to pure propagation —
    the same masked-scan convention as the other nonlinear filters.

    `member_offset`/`n_total`/`axis_name` distribute the particle axis
    over a device mesh (see parallel.sharded_particle_run): noise is
    keyed per global particle index, normalization/moments/ESS use
    collectives, and resampling all-gathers the (weights, particles) —
    small at filter scale — so every device selects its slice of the
    globally-identical systematic ancestors.

    `local_resampling=True` (with axis_name) replaces the all-gather
    with the RNA scheme (Bolic, Djuric & Hong 2005; island PF, Vergé
    et al. 2015): each shard systematic-resamples N_local ancestors
    from its own weights, keeps its island weight W_d attached
    (uniform W_d/N_local per particle), then ring-ppermutes half its
    particles — WITH their weights — to the next shard.  Each half is
    an exactly-unbiased within-island resample and the shift is a pure
    permutation of the global weighted measure, so the filter stays
    unbiased while per-shard memory is O(N_local) and the only
    collectives are the O(1) normalization/moment psums plus one
    point-to-point neighbor transfer (no O(N) gather).  The trade:
    results are statistically — not bit — equal to the unsharded
    filter, and island weights homogenize over ~n_shards resampling
    events rather than instantly.
    """
    n_local = state.particles.shape[0]
    n = n_local if n_total is None else n_total
    k_prop, k_res = jax.random.split(key)
    pkeys = jax.vmap(lambda i: jax.random.fold_in(k_prop, i))(
        member_offset + jnp.arange(n_local)
    )

    if control is not None:
        pts = jax.vmap(lambda x, k: propagate(x, k, control))(
            state.particles, pkeys
        )
    else:
        pts = jax.vmap(propagate)(state.particles, pkeys)

    ll = jax.vmap(lambda x: loglik(x, measurement))(pts)  # [N]
    if has is not None:
        ll = jnp.where(has, ll, jnp.zeros_like(ll))
    lw = state.log_weights + ll
    # Incremental evidence: logsumexp of (normalized prev + loglik).
    log_inc = _global_logsumexp(lw, axis_name)
    lw = lw - log_inc
    if has is not None:
        # Masked step carries exactly zero evidence (the computed
        # logsumexp of re-normalized weights is only zero to roundoff).
        log_inc = jnp.where(has, log_inc, jnp.zeros_like(log_inc))

    w = jnp.exp(lw)
    mean = _psum(w @ pts, axis_name)
    dev = pts - mean[None, :]
    # Unbiased weighted covariance; the divisor is guarded against the
    # fully-degenerate case (all weight on one particle -> divisor 0).
    cov = _psum((dev * w[:, None]).T @ dev, axis_name) / jnp.maximum(
        1.0 - _psum(jnp.sum(w**2), axis_name), 1e-12
    )
    ess = jnp.exp(-_global_logsumexp(2.0 * lw, axis_name))

    do_res = ess < resample_threshold * n
    if has is not None:
        do_res = jnp.logical_and(do_res, has)
    if axis_name is None:
        idx = systematic_resample_indices(lw, k_res)
        take = jnp.where(do_res, idx, jnp.arange(n, dtype=jnp.int32))
        pts = jnp.take(pts, take, axis=0)
        lw = jnp.where(
            do_res, jnp.full_like(lw, -jnp.log(float(n))), jnp.take(lw, take)
        )
    elif local_resampling:
        # RNA / island resampling: no gather.  Island log-weight
        # logW_d = logsumexp(local lw) (lw is globally normalized, so
        # psum_d(W_d) = 1); resample locally from lw/W_d with a
        # per-shard key, assign the uniform within-island weight
        # W_d/N_local, then ring-shift half the particles — weights
        # attached — to the next shard (a pure permutation of the
        # global weighted measure, exactly unbiased; the shift is what
        # homogenizes island weights over ~n_shards resampling events).
        if n_shards is None:
            raise ValueError("local_resampling needs static n_shards")
        me = jax.lax.axis_index(axis_name)
        k_local = jax.random.fold_in(k_res, me)
        log_wd = jax.scipy.special.logsumexp(lw)
        idx = systematic_resample_indices(lw - log_wd, k_local)
        keep = jnp.arange(n_local, dtype=jnp.int32)
        take = jnp.where(do_res, idx, keep)
        pts_r = jnp.take(pts, take, axis=0)
        lw_r = jnp.where(
            do_res,
            jnp.full((n_local,), log_wd - jnp.log(float(n_local)), lw.dtype),
            jnp.take(lw, take),
        )
        half = n_local // 2
        if half > 0 and n_shards > 1:
            perm = [(d, (d + 1) % n_shards) for d in range(n_shards)]
            moved_pts = jax.lax.ppermute(pts_r[half:], axis_name, perm)
            moved_lw = jax.lax.ppermute(lw_r[half:], axis_name, perm)
            # Shift only on resample steps (do_res is computed from
            # global psums, so every shard takes the same branch).
            pts = jnp.where(do_res,
                            jnp.concatenate([pts_r[:half], moved_pts]),
                            pts_r)
            lw = jnp.where(do_res,
                           jnp.concatenate([lw_r[:half], moved_lw]), lw_r)
        else:
            pts, lw = pts_r, lw_r
    else:
        # Gather the full (weights, particles) — [N] + [N, n_x] floats,
        # small at filter scale — compute the globally-identical
        # ancestor vector on every device, and keep this shard's slice.
        lw_all = jax.lax.all_gather(lw, axis_name, tiled=True)
        pts_all = jax.lax.all_gather(pts, axis_name, tiled=True)
        idx_all = systematic_resample_indices(lw_all, k_res)
        my_idx = jax.lax.dynamic_slice_in_dim(idx_all, member_offset,
                                              n_local)
        keep = member_offset + jnp.arange(n_local, dtype=jnp.int32)
        take = jnp.where(do_res, my_idx, keep)
        pts = jnp.take(pts_all, take, axis=0)
        lw = jnp.where(
            do_res, jnp.full((n_local,), -jnp.log(float(n)), lw.dtype),
            jnp.take(lw_all, take),
        )

    est = Estimate(
        state=mean,
        covariance=linalg.sym(cov),
        ess=ess,
        log_likelihood=log_inc,
        resampled=do_res,
    )
    return State(pts, lw, state.k + 1), est


@linalg.highp
def run(state: State, measurements, propagate: Callable, loglik: Callable,
        key: jax.Array, controls=None, meas_masks=None,
        resample_threshold: float = 0.5):
    """lax.scan driver.  Returns (final_state, estimates); the total
    log marginal likelihood is `estimates.log_likelihood.sum()`."""
    t = measurements.shape[0]
    keys = jax.random.split(key, t)

    def body(carry, xs):
        meas, u, has, k = xs
        return step(carry, meas, propagate, loglik, k, u,
                    resample_threshold, has)

    return jax.lax.scan(body, state, (measurements, controls, meas_masks, keys))


@linalg.highp
def run_ffbs(state: State, measurements, propagate: Callable,
             loglik: Callable, trans_logpdf: Callable, key: jax.Array,
             controls=None, meas_masks=None,
             resample_threshold: float = 0.5):
    """Forward-filter backward-smoother (FFBS, marginal form; Doucet,
    Godsill & Andrieu 2000): particle fixed-interval smoothing.  The
    forward pass is the bootstrap SIR filter emitting each step's cloud
    (particles, log-weights); the backward pass reweights WITHOUT
    moving any particle:

        W_T = w_T
        W_k^i ∝ w_k^i Σ_j W_{k+1}^j f(x_{k+1}^j | x_k^i)
                              / Σ_l w_k^l f(x_{k+1}^j | x_k^l)

    — all in log-space (one [N, N] transition-density matrix per step,
    O(N²T) total, batched matrix work).

    `trans_logpdf(x_next, x_prev[, u])` is the transition DENSITY the
    sampler `propagate` draws from (the bootstrap proposal); it must be
    supplied because a sampler's density is not derivable from it.
    `controls[k+1]` drives the k -> k+1 transition, matching the
    filter's inputs.

    Returns (xs_smoothed [T, n], ps_smoothed [T, n, n], particles
    [T, N, n], log_smooth_weights [T, N]).  The last step equals the
    filter exactly (pinned); on linear-Gaussian models the smoothed
    moments land on the RTS smoother as N grows (pinned at N=2048).
    """
    t = measurements.shape[0]
    keys = jax.random.split(key, t)

    def fwd_body(carry, xs):
        meas, u, has, k = xs
        new_state, est = step(carry, meas, propagate, loglik, k, u,
                              resample_threshold, has)
        return new_state, (new_state.particles, new_state.log_weights)

    _, (clouds, logws) = jax.lax.scan(
        fwd_body, state, (measurements, controls, meas_masks, keys))

    if controls is None:
        u_next_arr = None
    else:
        u_next_arr = jnp.concatenate([controls[1:], controls[-1:]], axis=0)

    def bwd_body(carry, xs):
        logw_next_sm = carry  # [N] log smoothing weights at k+1
        cloud_k, logw_k, cloud_next, u_n, is_last = xs

        def pairdens(x_next):
            if u_next_arr is not None:
                return jax.vmap(
                    lambda x_prev: trans_logpdf(x_next, x_prev, u_n))(
                        cloud_k)
            return jax.vmap(lambda x_prev: trans_logpdf(x_next, x_prev))(
                cloud_k)

        log_a = jax.vmap(pairdens)(cloud_next)  # [N_next_j, N_prev_i]
        # denominator per j: logsumexp_l (log w_k^l + log A_jl)
        log_den = jax.scipy.special.logsumexp(
            log_a + logw_k[None, :], axis=1)  # [N_j]
        inner = jax.scipy.special.logsumexp(
            logw_next_sm[:, None] + log_a - log_den[:, None], axis=0)
        logw_sm = logw_k + inner
        logw_sm = logw_sm - jax.scipy.special.logsumexp(logw_sm)
        logw_out = jnp.where(is_last, logw_k, logw_sm)
        return logw_out, logw_out

    is_last = jnp.arange(t) == (t - 1)
    cloud_next = jnp.roll(clouds, -1, axis=0)
    xs_in = (clouds, logws, cloud_next,
             u_next_arr if u_next_arr is not None
             else jnp.zeros((t, 1), clouds.dtype), is_last)
    _, logw_smooth = jax.lax.scan(bwd_body, logws[-1], xs_in, reverse=True)

    def moments(cloud, logw):
        w = jnp.exp(logw - jax.scipy.special.logsumexp(logw))
        mean = w @ cloud
        dev = cloud - mean[None, :]
        # same unbiased weighted covariance as step()
        cov = jnp.einsum("i,ij,ik->jk", w, dev, dev) / jnp.maximum(
            1.0 - jnp.sum(w**2), 1e-12)
        return mean, linalg.sym(cov)

    xs_sm, ps_sm = jax.vmap(moments)(clouds, logw_smooth)
    return xs_sm, ps_sm, clouds, logw_smooth
