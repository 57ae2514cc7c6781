"""Ensemble Kalman filter (EnKF) family.

Beyond the reference: gokalman's filters all carry an explicit [n, n]
covariance (vanilla.go:149-152), which caps them at small state
dimensions.  The EnKF replaces the covariance with an ensemble of N
state samples whose anomalies *are* the square-root factor — the
analysis becomes a handful of [N, n] x [n, p] matmuls, which is exactly
the shape matrix units want: large, batched, static.  No n x n matrix
is ever formed on the critical path (the Estimate's covariance field is
derived output), so the same code scales from the reference's 6-state
trackers to 1e5-state geophysical systems.

Two analysis schemes:

- `step` (stochastic EnKF, perturbed observations; Evensen 2003): each
  member assimilates `y + v_i`, `v_i ~ N(0, R)`.  Exact in expectation,
  O(1/sqrt(N)) sampling noise, supports covariance localization.
- `step_etkf` (ensemble transform KF; Bishop et al. 2001, Hunt et al.
  2007 formulation): deterministic right-transform of the anomalies in
  the N-dimensional ensemble space — no observation perturbations, so
  with a full-rank ensemble and linear models it reproduces the exact
  Kalman filter (pinned in tests/test_enkf.py).

Both are pure `(model_fns, state, inputs) -> (state, estimate)` steps,
scanned with `run`, vmappable over filter banks like every other module
here.  Dynamics/measurement functions are jittable callables applied
with one `vmap` over the member axis (the SURVEY.md §7 stance: the
ensemble is the batch axis).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise


class State(NamedTuple):
    ensemble: jax.Array  # [N, n] member states
    k: jax.Array  # [] int32 step counter


class Estimate(NamedTuple):
    state: jax.Array  # [n] ensemble mean
    measurement: jax.Array  # [p] predicted measurement (mean of h(X))
    innovation: jax.Array  # [p] y - h_mean
    covariance: jax.Array  # [n, n] posterior sample covariance
    pred_covariance: jax.Array  # [n, n] forecast sample covariance
    gain: jax.Array  # [n, p]

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, n_ens: int, key=None) -> State:
    """Initial ensemble: with a key, X_i = x0 + L0 z_i (random draws,
    montecarlo.go:29-31); without, the exact-moment deterministic
    symmetric ensemble (the right choice for ETKF parity runs).  The
    noise model enters only at step/run time — the prior draw is fully
    specified by (x0, P0).
    """
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    if key is None:
        ens = deterministic_ensemble(x0, p0, n_ens)
    else:
        # Per-member keyed draws (fold_in on the global member index):
        # a device-sharded ensemble initialised shard-by-shard with the
        # matching member_offset reproduces this exactly.
        z = _member_normals(key, n_ens, x0.shape[0], x0.dtype, 0)
        ens = x0[None, :] + z @ jnp.linalg.cholesky(p0).T
    return State(ens, jnp.int32(0))


def deterministic_ensemble(x0, p0, n_ens: int) -> jax.Array:
    """Symmetric (sigma-point style) ensemble: paired members
    x0 ± c L e_i with c chosen so the *sample* covariance (1/(N-1)
    normalization) is exactly P0 and the sample mean exactly x0.
    Requires n_ens >= 2n and even."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    n = x0.shape[0]
    if n_ens < 2 * n or n_ens % 2:
        raise ValueError(f"deterministic ensemble needs even n_ens >= {2 * n}")
    l = jnp.linalg.cholesky(p0)
    half = n_ens // 2
    cols = jnp.zeros((half, n), x0.dtype).at[:n].set(l.T)  # rows = scaled axes
    c = jnp.sqrt((n_ens - 1) / 2.0).astype(x0.dtype)
    dev = jnp.concatenate([c * cols, -c * cols], axis=0)  # [N, n], zero mean
    return x0[None, :] + dev


def gaspari_cohn(dist, c):
    """Gaspari & Cohn (1999) 5th-order piecewise-rational taper:
    1 at distance 0, compactly supported (exactly 0 beyond 2c).
    `dist` is any array of non-negative distances; `c` the half-width.
    Used to build localization masks for `step(loc_xy=, loc_yy=)`."""
    r = jnp.abs(jnp.asarray(dist)) / c
    near = (
        -0.25 * r**5 + 0.5 * r**4 + 0.625 * r**3 - (5.0 / 3.0) * r**2 + 1.0
    )
    r_safe = jnp.maximum(r, 1e-12)
    far = (
        (1.0 / 12.0) * r_safe**5 - 0.5 * r_safe**4 + 0.625 * r_safe**3
        + (5.0 / 3.0) * r_safe**2 - 5.0 * r_safe + 4.0 - (2.0 / 3.0) / r_safe
    )
    out = jnp.where(r <= 1.0, near, jnp.where(r <= 2.0, far, 0.0))
    return jnp.maximum(out, 0.0)


def _member_normals(key, n_members: int, dim: int, dtype, member_offset=0):
    """[n_members, dim] standard normals keyed PER GLOBAL MEMBER INDEX
    (fold_in(key, offset + i)), so a sharded ensemble draws exactly the
    same noise as the unsharded one — sharded == unsharded to the bit,
    not just in distribution (pinned in tests/test_shard_enkf.py)."""
    idx = member_offset + jnp.arange(n_members)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
    return jax.vmap(lambda k: jax.random.normal(k, (dim,), dtype=dtype))(keys)


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _global_moments(ens: jax.Array, n_total: int, axis_name=None):
    """Mean over the (possibly device-sharded) member axis + local
    deviations; one tiny [n] all-reduce when axis_name is given."""
    mean = _psum(jnp.sum(ens, axis=0), axis_name) / n_total
    dev = ens - mean[None, :]
    return mean, dev


def _forecast(state: State, noise: Noise, fx: Callable, key, control,
              inflation, member_offset=0, n_total=None, axis_name=None):
    """Propagate every member through fx (+ process noise), return the
    forecast ensemble with inflated anomalies."""
    prop = jax.vmap((lambda s: fx(s, control)) if control is not None else fx)(
        state.ensemble
    )
    if key is not None:
        z = _member_normals(key, prop.shape[0], prop.shape[1], prop.dtype,
                            member_offset)
        prop = prop + z @ noise.sqrt_q.T
    n_total = prop.shape[0] if n_total is None else n_total
    mean, dev = _global_moments(prop, n_total, axis_name)
    return mean + dev * inflation, mean, dev * inflation


def _moments(ens: jax.Array):
    mean = jnp.mean(ens, axis=0)
    dev = ens - mean[None, :]
    return mean, dev


@linalg.highp
def step(noise: Noise, state: State, measurement, fx: Callable, hx: Callable,
         key: jax.Array, control=None, inflation=1.0, has=None,
         loc_xy=None, loc_yy=None, member_offset=0, n_total=None,
         axis_name=None):
    """One stochastic-EnKF step (forecast + perturbed-obs analysis).

    The key drives both the process-noise draws and the observation
    perturbations (split internally — deterministic given the key, the
    noise.go:146 wall-clock reseed made reproducible as everywhere in
    this framework).  `inflation` multiplies the forecast anomalies
    (multiplicative covariance inflation).  `has` masks the analysis
    (masked step = pure ensemble forecast), the same convention as
    ukf.step / srif.step.  `loc_xy` [n, p] / `loc_yy` [p, p] are
    optional Schur-product localization tapers on the cross- and
    innovation-covariances (build with `gaspari_cohn`).
    """
    n_ens = state.ensemble.shape[0] if n_total is None else n_total
    k_q, k_r = jax.random.split(key)
    if has is not None:
        # Inflation is per ASSIMILATION, not per forecast step: on a
        # sparse-measurement scan (the OD arcs), inflating every masked
        # step would compound catastrophically (1.02^2160 ~ 1e18).
        inflation = jnp.where(has, inflation, 1.0)
    ens_f, x_pred, dev = _forecast(state, noise, fx, k_q, control, inflation,
                                   member_offset, n_total, axis_name)
    p_pred = _psum(dev.T @ dev, axis_name) / (n_ens - 1)

    ys = jax.vmap(hx)(ens_f)  # [N_local, p]
    y_mean, y_dev = _global_moments(ys, n_ens, axis_name)
    pxy = _psum(dev.T @ y_dev, axis_name) / (n_ens - 1)  # [n, p]
    s_yy = _psum(y_dev.T @ y_dev, axis_name) / (n_ens - 1)
    pyy = s_yy + noise.r  # [p, p]
    if loc_xy is not None:
        pxy = pxy * loc_xy
    if loc_yy is not None:
        pyy = s_yy * loc_yy + noise.r
    k_gain = linalg.solve_psd(pyy, pxy.T).T  # [n, p]

    # Perturbed observations: each member assimilates y + v_i.  Center
    # the perturbations so the analysis mean is exact for any N.
    v = _member_normals(k_r, ys.shape[0], ys.shape[1], ys.dtype,
                        member_offset) @ noise.sqrt_r.T
    v = v - (_psum(jnp.sum(v, axis=0), axis_name) / n_ens)[None, :]
    innovation = measurement - y_mean
    if has is not None:
        k_gain = jnp.where(has, k_gain, jnp.zeros_like(k_gain))
        innovation = jnp.where(has, innovation, jnp.zeros_like(innovation))
    ens_a = ens_f + (innovation[None, :] + v - y_dev) @ k_gain.T

    x, dev_a = _global_moments(ens_a, n_ens, axis_name)
    est = Estimate(
        state=x,
        measurement=y_mean,
        innovation=innovation,
        covariance=_psum(dev_a.T @ dev_a, axis_name) / (n_ens - 1),
        pred_covariance=p_pred,
        gain=k_gain,
    )
    return State(ens_a, state.k + 1), est


@linalg.highp
def step_etkf(noise: Noise, state: State, measurement, fx: Callable,
              hx: Callable, key=None, control=None, inflation=1.0, has=None):
    """One deterministic ETKF step (Hunt et al. 2007 ensemble-space
    form).  With key=None the forecast is noise-free (pair with
    inflation>1 or Q folded into the dynamics); with a key, process
    noise is added stochastically as in `step`.

    Analysis in ensemble space: with S = R^{-1/2} Ydev,
      P_tilde = [(N-1) I + Sᵀ S]⁻¹           (via eigh, [N, N])
      w_mean  = P_tilde Sᵀ R^{-1/2} (y - ȳ)
      W       = sqrt(N-1) P_tilde^{1/2}       (symmetric square root)
      X_a     = x̄ + dev (w_mean + W)
    The symmetric square root keeps the analysis mean-preserving and
    reproduces the exact KF posterior for linear models with a
    full-rank ensemble (tests/test_enkf.py pins this to 1e-8).
    """
    n_ens = state.ensemble.shape[0]
    if has is not None:
        # Per-ASSIMILATION inflation, as in `step`: masked (pure
        # forecast) steps must not inflate, or a sparse-measurement
        # scan compounds it catastrophically.
        inflation = jnp.where(has, inflation, 1.0)
    ens_f, x_pred, dev = _forecast(state, noise, fx, key, control, inflation)
    p_pred = dev.T @ dev / (n_ens - 1)

    ys = jax.vmap(hx)(ens_f)
    y_mean, y_dev = _moments(ys)
    # Whiten in measurement space: S = R^{-1/2} applied to anomalies.
    lr = jnp.linalg.cholesky(noise.r)
    s = linalg.solve_tri_lower(lr, y_dev.T).T  # [N, p]
    d = linalg.solve_tri_lower(lr, measurement - y_mean)  # [p]

    # Eigendecomposition of (N-1)I + SSᵀ in ensemble space.
    evals, evecs = jnp.linalg.eigh(s @ s.T)  # [N], [N, N]
    inv_l = 1.0 / (evals + (n_ens - 1.0))
    p_tilde = (evecs * inv_l[None, :]) @ evecs.T
    w_mean = p_tilde @ (s @ d)  # [N]
    w_sqrt = (evecs * jnp.sqrt((n_ens - 1.0) * inv_l)[None, :]) @ evecs.T

    if has is not None:
        w_mean = jnp.where(has, w_mean, jnp.zeros_like(w_mean))
        w_sqrt = jnp.where(has, w_sqrt, jnp.eye(n_ens, dtype=w_sqrt.dtype))
    weights = w_mean[:, None] + w_sqrt  # [N, N] per-member weight columns
    ens_a = x_pred[None, :] + (dev.T @ weights).T  # [N, n]

    innovation = measurement - y_mean
    if has is not None:
        innovation = jnp.where(has, innovation, jnp.zeros_like(innovation))
    x, dev_a = _moments(ens_a)
    # Implied gain (diagnostic): Δx = devᵀ P̃ s L⁻¹ innov, so
    # K = (devᵀ P̃ s) L⁻¹, solved against the triangular factor.
    m = dev.T @ p_tilde @ s  # [n, p]
    k_gain = linalg.solve_tri_upper(lr.T, m.T).T  # [n, p]
    est = Estimate(
        state=x,
        measurement=y_mean,
        innovation=innovation,
        covariance=dev_a.T @ dev_a / (n_ens - 1),
        pred_covariance=p_pred,
        gain=k_gain,
    )
    return State(ens_a, state.k + 1), est


@linalg.highp
def run(noise: Noise, state: State, measurements, fx: Callable, hx: Callable,
        key=None, controls=None, inflation=1.0, meas_masks=None,
        method: str = "stochastic", loc_xy=None, loc_yy=None):
    """lax.scan driver over the time axis.

    method='stochastic' (perturbed observations, needs `key`) or
    'etkf' (deterministic transform; key optional — None means
    noise-free forecasts).  `meas_masks` ([T] bool) marks measurement
    steps, as in ukf.run.
    """
    t = measurements.shape[0]
    keys = None
    if key is not None:
        keys = jax.random.split(key, t)

    if method == "stochastic":
        if keys is None:
            raise ValueError("stochastic EnKF requires a PRNG key")

        def body(carry, xs):
            meas, u, has, k = xs
            return step(noise, carry, meas, fx, hx, k, u, inflation, has,
                        loc_xy, loc_yy)
    elif method == "etkf":
        if loc_xy is not None or loc_yy is not None:
            raise ValueError(
                "localization tapers apply to the stochastic EnKF only; "
                "the ETKF transform has no localized form here"
            )

        def body(carry, xs):
            meas, u, has, k = xs
            return step_etkf(noise, carry, meas, fx, hx, k, u, inflation, has)
    else:
        raise ValueError(f"unknown EnKF method {method!r}")

    return jax.lax.scan(body, state, (measurements, controls, meas_masks, keys))


def linear_fns(f, h, g=None):
    """Convenience: (fx, hx) callables for a linear model, so EnKF runs
    can be compared 1:1 against vanilla.run on the same system."""
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    if g is None:
        fx = lambda x: f @ x
    else:
        gm = jnp.asarray(g)
        fx = lambda x, u: f @ x + gm @ u
    hx = lambda x: h @ x
    return fx, hx


@linalg.highp
def run_enks(noise: Noise, state: State, measurements, fx: Callable,
             hx: Callable, lag: int, key: jax.Array, controls=None,
             inflation=1.0, meas_masks=None):
    """Fixed-lag ensemble Kalman SMOOTHER (EnKS; Evensen & van Leeuwen
    2000): x_{j | j+lag} for every j, the ensemble counterpart of
    smoothing.fixed_lag_smoother — for exactly the systems the EnKF
    exists for (no [n, n] covariance ever formed, no adjoint/backward
    model needed).

    Mechanics: the scan carries a ring of the last lag+1 ANALYSIS
    ensembles.  Each new measurement's member update term
    U_i = (y − ȳ) + v_i − (h(x_i) − ȳ) — the exact same term the
    stochastic EnKF applies to the current ensemble — also updates
    every lagged ensemble through ITS cross-covariance with the
    predicted observations:  X_j += U K_jᵀ,  K_j = Cov(X_j, Y) P_yy⁻¹.
    Because the ensembles carry the cross-time correlations implicitly,
    no backward pass and no stored gains are needed; the smoother is
    strictly forward, streaming, O(lag·N·n) memory.

    Returns (final_state, xs_smoothed [T, n], ps_smoothed [T, n, n])
    with entry j = moments of the ensemble at time j after assimilating
    measurements through min(j+lag, T-1) — lag 0 IS the EnKF filter
    trace (pinned), lag >= T approaches the full ensemble smoother.
    """
    if lag < 0:
        raise ValueError(f"lag must be >= 0 (got {lag})")
    t = measurements.shape[0]
    if lag >= t:
        raise ValueError(f"lag ({lag}) must be < T ({t})")
    n_ens, n = state.ensemble.shape
    keys = jax.random.split(key, t)
    # buffer[l] = analysis ensemble at time k - l (l = 0 newest)
    buf0 = jnp.broadcast_to(state.ensemble, (lag + 1, n_ens, n))

    def body(carry, xs):
        kf_state, buf = carry
        meas, u, has, k_step = xs
        k_q, k_r = jax.random.split(k_step)
        infl = inflation if has is None else jnp.where(has, inflation, 1.0)
        ens_f, x_pred, dev = _forecast(kf_state, noise, fx, k_q, u, infl)
        ys = jax.vmap(hx)(ens_f)
        y_mean, y_dev = _global_moments(ys, n_ens)
        pyy = y_dev.T @ y_dev / (n_ens - 1) + noise.r
        v = _member_normals(k_r, n_ens, ys.shape[1], ys.dtype) @ noise.sqrt_r.T
        v = v - jnp.mean(v, axis=0)[None, :]
        innovation = jnp.asarray(meas) - y_mean
        upd = innovation[None, :] + v - y_dev  # [N, p]
        if has is not None:
            upd = jnp.where(has, upd, jnp.zeros_like(upd))
        # shift the ring: slot 0 becomes the new forecast ensemble
        buf = jnp.concatenate([ens_f[None], buf[:-1]], axis=0)

        def assimilate(ens_l):
            mean_l, dev_l = _moments(ens_l)
            pxy = dev_l.T @ y_dev / (n_ens - 1)  # [n, p]
            k_l = linalg.solve_psd(pyy, pxy.T).T
            return ens_l + upd @ k_l.T

        buf = jax.vmap(assimilate)(buf)
        kf_new = State(buf[0], kf_state.k + 1)
        oldest_mean, oldest_dev = _moments(buf[-1])
        oldest_cov = oldest_dev.T @ oldest_dev / (n_ens - 1)
        return (kf_new, buf), (oldest_mean, oldest_cov)

    (kf_final, buf_final), (means_out, covs_out) = jax.lax.scan(
        body, (state, buf0), (measurements, controls, meas_masks, keys))

    if lag == 0:
        return kf_final, means_out, covs_out
    # emitted entry at step k (k >= lag) is time j = k - lag; the final
    # ring holds the tail j = T-lag .. T-1 at l = lag-1 .. 0.
    tail = buf_final[:lag][::-1]  # [lag, N, n], j ascending

    def tail_moments(ens_l):
        mean_l, dev_l = _moments(ens_l)
        return mean_l, dev_l.T @ dev_l / (n_ens - 1)

    tail_means, tail_covs = jax.vmap(tail_moments)(tail)
    xs = jnp.concatenate([means_out[lag:], tail_means], axis=0)
    ps = jnp.concatenate([covs_out[lag:], tail_covs], axis=0)
    return kf_final, xs, ps
