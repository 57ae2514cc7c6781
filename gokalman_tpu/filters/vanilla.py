"""Vanilla (classic) discrete Kalman filter.

Rebuild of the reference CKF (reference: vanilla.go:21-284) as pure
functions over pytrees:

- the mutable `Vanilla` struct (vanilla.go:65-74) becomes an immutable
  `(Model, State)` pair; `Update` becomes `step(model, state, inputs)`
  returning a fresh `(State, Estimate)`;
- the user's per-measurement Go loop (README.md:14-22) becomes
  `run(...)` — a single `lax.scan` over the time axis, jitted once;
- `NewPurePredictorVanilla` (vanilla.go:43-62) is `prediction_only=True`
  (a static flag, so XLA compiles a branch-free predictor);
- the scalar-measurement special case (vanilla.go:185-190) disappears:
  batched linalg handles p=1 uniformly;
- AsSymDense's O(n^2) per-step symmetry *check* (vanilla.go:207-215)
  becomes an O(n^2) symmetrization — same cost, better numerics, and
  no data-dependent failure inside jit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise, measurement_sample, process_sample


class Model(NamedTuple):
    """Time-invariant CKF model {F, G, H, noise}.

    Time-varying systems pass per-step (H_k, R_k, ...) through `run`'s
    scanned inputs instead of mutating the model (the reference mutates
    via SetMeasurementMatrix mid-stream, examples/jerkcar/main.go:141-158).
    """

    f: jax.Array  # [n, n] state transition
    g: Optional[jax.Array]  # [n, m] control matrix or None
    h: jax.Array  # [p, n] measurement matrix
    noise: Noise


class State(NamedTuple):
    x: jax.Array  # [n] state estimate
    p: jax.Array  # [n, n] covariance
    k: jax.Array  # [] int32 step counter


class Estimate(NamedTuple):
    """Per-step output record (reference: vanilla.go:224-284)."""

    state: jax.Array  # \hat{x}_{k+1}^{+}
    measurement: jax.Array  # \hat{y}_{k} = H x_k (+ v)
    innovation: jax.Array  # y_{k} - H \hat{x}_{k+1}^{-}
    covariance: jax.Array  # P_{k+1}^{+}
    pred_covariance: jax.Array  # P_{k+1}^{-}
    gain: jax.Array  # K_{k+1}

    def within_nsigma(self, n_sigma) -> jax.Array:
        """IsWithinNσ (reference: vanilla.go:231-239)."""
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def mask_measurement(h, r, measurement, mask):
    """Static-shape support for time-varying measurement sizes.

    The reference mutates H and R mid-stream to switch between a 1x4
    and a 2x4 measurement (examples/jerkcar/main.go:94-105, 141-158);
    XLA needs static shapes, so measurements are padded to the max size
    with a per-row validity mask.  Masked rows get a zero H row, a unit
    R diagonal (keeping S invertible), and a zero measurement — the
    resulting gain column is exactly zero, so the update equals the
    unpadded update on the valid rows.
    """
    m = mask.astype(h.dtype)
    h = h * m[:, None]
    r = r * (m[:, None] * m[None, :]) + jnp.diag(1.0 - m)
    y = None if measurement is None else measurement * m
    return h, r, y


def new(x0, p0, f, g, h, noise: Noise):
    """Build (Model, State) with trace-time dim checks (vanilla.go:21-40)."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    g = None if g is None or linalg.is_nil(g) else jnp.asarray(g)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
    return Model(f, g, h, noise), State(x0, p0, jnp.int32(0))


@linalg.highp
def predict(model: Model, state: State, control=None, w=None):
    """Time update: x^- = F x (+ G u + w), P^- = F P F^T + Q.

    Reference: vanilla.go:138-152.
    """
    x = model.f @ state.x
    if model.g is not None and control is not None:
        x = x + model.g @ control
    if w is not None:
        x = x + w
    p = linalg.sym(model.f @ state.p @ model.f.T + model.noise.q)
    return x, p


@linalg.highp
def gain(model: Model, p_pred: jax.Array) -> jax.Array:
    """K = P^- H^T (H P^- H^T + R)^{-1} (reference: vanilla.go:160-168)."""
    pht = p_pred @ model.h.T
    s = model.h @ pht + model.noise.r
    return linalg.solve_psd(s, pht.T).T


@linalg.highp
def joseph_update(p_pred, k_gain, h, r):
    """Joseph-form P^+ = (I-KH) P^- (I-KH)^T + K R K^T (vanilla.go:197-205)."""
    n = p_pred.shape[-1]
    ikh = jnp.eye(n, dtype=p_pred.dtype) - k_gain @ h
    return linalg.sym(ikh @ p_pred @ ikh.T + k_gain @ r @ k_gain.T)


@linalg.highp
def step(
    model: Model,
    state: State,
    measurement=None,
    control=None,
    w=None,
    w2=None,
    v=None,
    prediction_only: bool = False,
    h=None,
    r=None,
    meas_mask=None,
):
    """One full CKF update (reference: vanilla.go:128-220).

    `w`/`w2`/`v` are explicit noise draws: the reference calls
    Noise.Process(k) both in the prediction (vanilla.go:146) and after
    the measurement update (vanilla.go:195), and Noise.Measurement(k)
    for the estimated measurement (vanilla.go:157).  Passing None means
    zero (Noiseless).  `prediction_only` is static — the pure-predictor
    variant compiles without the measurement branch (vanilla.go:170-179).

    `h`/`r` override the model's measurement matrices for this step
    (the SetMeasurementMatrix/SetNoise mid-stream idiom); `meas_mask`
    ([p] bool) marks valid measurement rows for padded time-varying
    measurement sizes (see mask_measurement).
    """
    if h is not None or r is not None or meas_mask is not None:
        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement, meas_mask)
        model = model._replace(
            h=h_k, noise=model.noise._replace(r=r_k)
        )
    x_pred, p_pred = predict(model, state, control, w)
    # Estimated measurement from the *previous* state (vanilla.go:155-157).
    y_hat = model.h @ state.x
    if v is not None:
        y_hat = y_hat + v
    k_gain = gain(model, p_pred)

    if prediction_only:
        est = Estimate(
            state=x_pred,
            measurement=y_hat,
            innovation=jnp.zeros_like(y_hat),
            covariance=p_pred,
            pred_covariance=p_pred,
            gain=k_gain,
        )
        return State(x_pred, p_pred, state.k + 1), est

    innovation = measurement - model.h @ x_pred
    x = x_pred + k_gain @ innovation
    if w2 is not None:
        x = x + w2
    p = joseph_update(p_pred, k_gain, model.h, model.noise.r)
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=p,
        pred_covariance=p_pred,
        gain=k_gain,
    )
    return State(x, p, state.k + 1), est


@linalg.highp
def gated_step(model: Model, state: State, measurement, control=None,
               nis_gate: float = 9.0):
    """CKF step with chi-square innovation gating (outlier rejection).

    Computes the normalized innovation squared (NIS) against the
    predicted innovation covariance; if it exceeds `nis_gate` (e.g. the
    chi-square 99% quantile for p degrees of freedom), the measurement
    is rejected and the step degrades to a pure prediction.  The
    reference can only *observe* its injected outlier through IsWithinNσ
    warnings (vanilla_test.go:61-68); this actually protects the state.
    Returns (state, estimate, accepted: bool).

    Single-compute form: one predict, one Cholesky of S shared by the
    gain and the NIS whitening; rejection zeroes the gain, which makes
    the update *exactly* the pure prediction (no second `step` call).
    """
    x_pred, p_pred = predict(model, state, control)
    y_hat = model.h @ state.x
    pht = p_pred @ model.h.T
    s = model.h @ pht + model.noise.r
    chol_s = jnp.linalg.cholesky(s)
    k_gain = jax.scipy.linalg.cho_solve((chol_s, True), pht.T).T
    innovation = measurement - model.h @ x_pred
    white = jax.scipy.linalg.solve_triangular(chol_s, innovation, lower=True)
    nis = white @ white
    accept = nis <= nis_gate

    k_eff = jnp.where(accept, k_gain, jnp.zeros_like(k_gain))
    x = x_pred + k_eff @ innovation
    p = joseph_update(p_pred, k_eff, model.h, model.noise.r)
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=jnp.where(accept, innovation, jnp.zeros_like(innovation)),
        covariance=p,
        pred_covariance=p_pred,
        gain=k_eff,
    )
    return State(x, p, state.k + 1), est, accept


@linalg.highp
def run_gated(model: Model, state: State, measurements, controls=None,
              nis_gate: float = 9.0):
    """Scan driver for gated_step; also returns the accept mask [T]."""

    def body(carry, xs):
        meas, u = xs
        st, est, ok = gated_step(model, carry, meas, u, nis_gate)
        return st, (est, ok)

    final, (ests, accepted) = jax.lax.scan(body, state, (measurements, controls))
    return final, ests, accepted


@linalg.highp
def robust_step(model: Model, state: State, measurement, control=None,
                huber_k: float = 1.345, iters: int = 2):
    """Huber M-estimator measurement update (Karlgaard-style IRLS):
    per-component standardized residuals e_i = innov_i / sqrt(S_ii) get
    weights w_i = min(1, k/|e_i|), and the measurement noise is
    reweighted R' = diag(1/w) R diag(1/w) for a fixed (static) number
    of iterations.

    Inliers (|e_i| <= k for all i) give w = 1 and the step equals the
    standard CKF step EXACTLY; an outlying component is smoothly
    down-weighted instead of hard-rejected (contrast `gated_step`,
    which drops the whole vector).  k = 1.345 is the classic 95%-
    Gaussian-efficiency constant.  Returns (state, estimate,
    weights [p]).

    The standardization scale is the ORIGINAL innovation sd
    sqrt(diag S₀), S₀ = H P⁻ Hᵀ + R, and stays FIXED across
    iterations — this is deliberate, and both alternatives were
    measured worse: re-standardizing each iterate by the inflated S'
    (or by the posterior residual's own covariance (I−HK) S' (I−HK)ᵀ,
    which inherits R/w² from S') shrinks |e| by exactly the factor the
    weighting introduced and relaxes a 5σ spike's weight from <0.1
    back to ~0.87 — a positive feedback loop that undoes the
    robustification.  With the fixed prior scale, iters>1 re-evaluates
    the residual at the provisional posterior, Gauss-Newton style;
    posterior residuals are smaller than prior ones, so weights relax
    *partially* toward the IRLS fixed point w = ψ(e*)/e* at the
    converged estimate — intentional M-estimator behavior (Karlgaard
    & Schaub-style robust CKF), not a softening bug: a genuine outlier
    barely moves the posterior and keeps its small weight, while a
    borderline residual the state can absorb is progressively
    re-trusted.
    """
    x_pred, p_pred = predict(model, state, control)
    y_hat = model.h @ state.x
    innovation = measurement - model.h @ x_pred
    r = model.noise.r
    tiny = jnp.asarray(1e-30, r.dtype)

    s0 = model.h @ p_pred @ model.h.T + r
    sd = jnp.sqrt(jnp.maximum(jnp.diagonal(s0), tiny))
    pht = p_pred @ model.h.T

    resid = innovation
    w = jnp.ones(r.shape[0], r.dtype)
    for _ in range(max(iters, 1)):
        w = jnp.minimum(1.0, huber_k / jnp.maximum(jnp.abs(resid / sd), tiny))
        r_eff = r / (w[:, None] * w[None, :])
        s = model.h @ p_pred @ model.h.T + r_eff
        k_gain = linalg.solve_psd(s, pht.T).T
        # Residual at the provisional posterior, vs the prediction.
        resid = innovation - model.h @ (k_gain @ innovation)

    x = x_pred + k_gain @ innovation
    p = joseph_update(p_pred, k_gain, model.h, r_eff)
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=p,
        pred_covariance=p_pred,
        gain=k_gain,
    )
    return State(x, p, state.k + 1), est, w


@linalg.highp
def run_robust(model: Model, state: State, measurements, controls=None,
               huber_k: float = 1.345, iters: int = 2):
    """Scan driver for robust_step; also returns the weight trace [T, p]."""

    def body(carry, xs):
        meas, u = xs
        st, est, w = robust_step(model, carry, meas, u, huber_k, iters)
        return st, (est, w)

    final, (ests, ws) = jax.lax.scan(body, state, (measurements, controls))
    return final, ests, ws


def steady_state(model: Model):
    """Steady-state (P^-, K, P^+) from the DARE (linalg.solve_dare).

    For time-invariant models the gain converges geometrically; serving
    deployments can run the constant-gain filter below and skip the
    whole covariance recursion.
    """
    p_pred = linalg.solve_dare(model.f, model.h, model.noise.q, model.noise.r)
    k_gain = gain(model, p_pred)
    p_plus = joseph_update(p_pred, k_gain, model.h, model.noise.r)
    return p_pred, k_gain, p_plus


@linalg.highp
def run_steady_state(model: Model, x0, measurements, controls=None):
    """Constant-gain (steady-state) filter: x' = F x (+ G u) + K(y - HFx).

    The asymptotically optimal filter at a fraction of the per-step
    cost — no covariance propagation, no solves in the loop.  Returns
    (states [T, n], (p_pred, k, p_plus)).
    """
    p_pred, k_gain, p_plus = steady_state(model)
    f, h = model.f, model.h
    a = f - k_gain @ (h @ f)

    def body(x, xs):
        y, u = xs
        x = a @ x + k_gain @ y
        if model.g is not None and u is not None:
            x = x + (jnp.eye(f.shape[0], dtype=f.dtype) - k_gain @ h) @ (model.g @ u)
        return x, x

    _, states = jax.lax.scan(body, jnp.asarray(x0), (measurements, controls))
    return states, (p_pred, k_gain, p_plus)


@linalg.highp
def innovations_log_likelihood(model: Model, ests: Estimate) -> jax.Array:
    """Gaussian innovations log-likelihood of a filtered run:
    sum_k -1/2 [ innov_k^T S_k^{-1} innov_k + log det S_k + p log 2pi ]
    with S_k = H P^-_k H^T + R.

    Nothing like this exists in the reference — it is the payoff of the
    functional rebuild: `run` is differentiable end-to-end, so noise
    covariances (or any model parameter) can be *fitted* by gradient
    ascent on this likelihood instead of hand-tuned (see
    tests/test_differentiable.py).
    """
    h, r = model.h, model.noise.r
    s = jnp.einsum("ij,tjk,lk->til", h, ests.pred_covariance, h) + r
    chol = jnp.linalg.cholesky(s)
    white = jax.scipy.linalg.solve_triangular(
        chol, ests.innovation[..., None], lower=True
    )[..., 0]
    maha = jnp.sum(white**2, axis=-1)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1
    )
    p = h.shape[0]
    return -0.5 * jnp.sum(maha + logdet + p * jnp.log(2.0 * jnp.pi))


def run(
    model: Model,
    state: State,
    measurements=None,
    controls=None,
    key=None,
    ws=None,
    ws2=None,
    vs=None,
    steps: Optional[int] = None,
    prediction_only: bool = False,
    hs=None,
    rs=None,
    meas_masks=None,
):
    """Scan `step` over the time axis (the README.md:14-22 loop, fused).

    measurements: [T, p] or None; controls: [T, m] or None;
    ws/ws2/vs: [T, n]/[T, n]/[T, p] pre-recorded noise (BatchNoise,
    noise.go:67-106) or None; key: PRNG key enabling AWGN draws.
    hs/rs: [T, p, n]/[T, p, p] per-step measurement model overrides and
    meas_masks: [T, p] row-validity masks — the static-shape form of
    the reference's mid-stream SetMeasurementMatrix/SetNoise calls
    (examples/jerkcar/main.go:141-158).
    Returns (final_state, stacked Estimates with leading T axis).
    """
    if steps is None:
        for arr in (measurements, controls, ws, ws2, vs, hs, rs, meas_masks):
            if arr is not None:
                steps = jnp.shape(arr)[0]
                break
    if steps is None:
        raise ValueError("cannot infer step count: pass `steps` or an input array")

    keys = None if key is None else jax.random.split(key, steps)

    def body(carry, xs):
        meas, ctrl, w, w2, v, k, h_k, r_k, mask = xs
        if k is not None:
            kw, kw2, kv = jax.random.split(k, 3)
            w = process_sample(model.noise, kw) if w is None else w
            w2 = process_sample(model.noise, kw2) if w2 is None else w2
            if v is None:
                if r_k is not None:
                    # Per-step R override: draw the estimated-measurement
                    # noise from the step's own covariance so the y-hat
                    # trace stays consistent with the step's noise model
                    # (the Go SetNoise swap replaces the sampler too).
                    z = jax.random.normal(kv, (r_k.shape[-1],), dtype=r_k.dtype)
                    v = jnp.linalg.cholesky(r_k) @ z
                else:
                    v = measurement_sample(model.noise, kv)
        new_state, est = step(
            model, carry, meas, ctrl, w, w2, v,
            prediction_only=prediction_only, h=h_k, r=r_k, meas_mask=mask,
        )
        return new_state, est

    xs = (measurements, controls, ws, ws2, vs, keys, hs, rs, meas_masks)
    final, ests = jax.lax.scan(body, state, xs, length=steps)
    return final, ests


@linalg.highp
def oosm_update(model: Model, state: State, est_k: Estimate, y_tau,
                f2, q2, h_tau=None, r_tau=None, offset=None):
    """EXACT out-of-sequence measurement update (Bar-Shalom 2002, the
    one-step-lag "Bl1" algorithm): a measurement y_τ taken at a time
    τ ∈ (t_{k-1}, t_k] arrives AFTER the filter has already processed
    the step at t_k — late radar returns, network delays, multi-sensor
    skew.  Rather than rolling the filter back and replaying (which
    requires buffering every input), the posterior at t_k is corrected
    in place, exactly.

    `est_k` is the Estimate the filter emitted at t_k (the current
    step); `f2`/`q2` are the transition Φ(t_k, τ) and its accumulated
    process noise Q(t_k, τ) over [τ, t_k]; `h_tau`/`r_tau` default to
    the model's H/R.  The step at t_k must have been a measurement
    update with the model's H/R (that step's innovation/gain are what
    make the exact retrodiction possible).

    CONTROLLED systems: `offset` ([n]) is the deterministic input term
    over [τ, t_k] (b = G₂ u for x_k = F₂ x_τ + b + w) — without it the
    retrodiction is biased by F₂⁻¹ b while the covariance stays exact,
    an error invisible to NEES-style self-checks (measured 0.8 state
    error on a controlled CV test before this parameter existed).

    Derivation (all by joint-Gaussian conditioning; w = process noise
    over [τ, t_k], ν_k/S_k/K_k the step-k innovation quantities):

        ŵ|k    = Q Hᵀ S_k⁻¹ ν_k            Cov(w, ν_k) = Q Hᵀ
        P_w|k  = Q − Q Hᵀ S_k⁻¹ H Q
        P_xw|k = (I − K_k H) Q
        x̂_τ|k  = F⁻¹ (x̂_k|k − ŵ|k)         retrodiction
        P_τ|k  = F⁻¹ (P_k|k + P_w|k − P_xw|k − P_xw|kᵀ) F⁻ᵀ
        P_kτ|k = (P_k|k − P_xw|k) F⁻ᵀ       cross-covariance
        ν_τ = y_τ − H_τ x̂_τ|k,  S_τ = H_τ P_τ|k H_τᵀ + R_τ
        x̂_k|k,τ = x̂_k|k + P_kτ|k H_τᵀ S_τ⁻¹ ν_τ
        P_k|k,τ = P_k|k − (P_kτ|k H_τᵀ) S_τ⁻¹ (P_kτ|k H_τᵀ)ᵀ

    Exactness is pinned in tests against re-running the filter with the
    measurements in correct time order (split-step reference).

    Returns (state, estimate) with the corrected posterior at t_k; the
    estimate's measurement/innovation fields describe the OOSM.
    """
    h_k, r_k = model.h, model.noise.r
    h_tau = h_k if h_tau is None else jnp.asarray(h_tau)
    r_tau = r_k if r_tau is None else jnp.asarray(r_tau)
    f2 = jnp.asarray(f2)
    q2 = jnp.asarray(q2)

    s_k = h_k @ est_k.pred_covariance @ h_k.T + r_k
    qht = q2 @ h_k.T
    w_hat = qht @ linalg.solve_psd(s_k, est_k.innovation)
    p_w = linalg.sym(q2 - qht @ linalg.solve_psd(s_k, qht.T))
    n = q2.shape[0]
    p_xw = (jnp.eye(n, dtype=q2.dtype) - est_k.gain @ h_k) @ q2

    # Retrodict through Φ(t_k, τ)⁻¹ (QR-based general solve:
    # backward-stable for a general, possibly ill-conditioned Φ).
    x_det = est_k.state - w_hat
    if offset is not None:
        x_det = x_det - jnp.asarray(offset)
    x_tau = linalg.solve_qr(f2, x_det)
    p_mid = est_k.covariance + p_w - p_xw - p_xw.T
    f2_inv = linalg.inv_qr(f2)
    p_tau = linalg.sym(f2_inv @ p_mid @ f2_inv.T)
    p_cross = (est_k.covariance - p_xw) @ f2_inv.T  # Cov(x_k, x_τ | Z_k)

    nu_tau = jnp.asarray(y_tau) - h_tau @ x_tau
    s_tau = linalg.sym(h_tau @ p_tau @ h_tau.T + r_tau)
    gain_arm = p_cross @ h_tau.T  # [n, p]
    k_tau = linalg.solve_psd(s_tau, gain_arm.T).T
    x_new = est_k.state + k_tau @ nu_tau
    p_new = linalg.sym(est_k.covariance - k_tau @ s_tau @ k_tau.T)

    est = Estimate(
        state=x_new,
        measurement=h_tau @ x_tau,
        innovation=nu_tau,
        covariance=p_new,
        pred_covariance=est_k.covariance,  # pre-OOSM posterior
        gain=k_tau,
    )
    return State(x_new, p_new, state.k), est


@linalg.highp
def fading_step(model: Model, state: State, measurement, control=None,
                alpha: float = 1.0, h=None, r=None, meas_mask=None):
    """Fading-memory CKF step (Simon, Optimal State Estimation §5.5):
    the predicted covariance is inflated by α² ≥ 1,

        P⁻ = α² F P Fᵀ + Q

    which exponentially discounts old data (effective memory
    ~1/(α²−1) steps) — the classical defense against slow unmodeled
    drift/model bias, predating H∞ (hinf) and covariance-matching
    (adaptive): where those estimate or bound the mismatch, this just
    refuses to let the gain converge.  α=1 IS the vanilla CKF (pinned).
    """
    x_pred, p_pred = predict(model, state, control)
    p_pred = linalg.sym(alpha**2 * (p_pred - model.noise.q) + model.noise.q)
    h_k = model.h if h is None else h
    r_k = model.noise.r if r is None else r
    if meas_mask is not None:
        h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement,
                                                 meas_mask)
    # inline measurement update (NOT a re-entry into step(): that would
    # run a second predict and emit y_hat = H x_pred, breaking the
    # documented Estimate.measurement = H previous-state convention,
    # vanilla.go:155-157 — measured 0.04 divergence before this fix)
    y_hat = h_k @ state.x
    pht = p_pred @ h_k.T
    s_cov = h_k @ pht + r_k
    k_gain = linalg.solve_psd(s_cov, pht.T).T
    innovation = measurement - h_k @ x_pred
    x = x_pred + k_gain @ innovation
    p = joseph_update(p_pred, k_gain, h_k, r_k)
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=p,
        pred_covariance=p_pred,
        gain=k_gain,
    )
    return State(x, p, state.k + 1), est


@linalg.highp
def run_fading(model: Model, state: State, measurements, controls=None,
               alpha: float = 1.0, hs=None, rs=None, meas_masks=None):
    """lax.scan driver for the fading-memory filter."""

    def body(carry, xs):
        meas, u, h_k, r_k, mask = xs
        return fading_step(model, carry, meas, u, alpha, h_k, r_k, mask)

    return jax.lax.scan(body, state,
                        (measurements, controls, hs, rs, meas_masks))


@linalg.highp
def correlated_step(model: Model, state: State, measurement, m_cross,
                    control=None):
    """CKF step with CORRELATED process/measurement noise (Simon OSE
    §7.1): E[w v'ᵀ] = M between the process noise w driving THIS
    prediction and the measurement noise v' of the measurement being
    assimilated.  The optimal gain picks up the cross term:

        S = H P⁻ Hᵀ + R + H M + Mᵀ Hᵀ
        K = (P⁻ Hᵀ + M) S⁻¹
        P⁺ = P⁻ − K (H P⁻ + Mᵀ)      (general-gain form)

    M=0 reduces exactly to the vanilla step (pinned); correctness is
    pinned against brute-force joint-Gaussian conditioning over the
    whole trajectory (tests/test_classic.py).

    M must be consistent: the JOINT noise covariance [[Q, M], [Mᵀ, R]]
    has to be PSD, else the recursion can produce an indefinite
    posterior and diverge (measured: NaN within a few hundred steps at
    a 10x-too-large M).  Checked host-side at trace time for concrete
    inputs."""
    m_cross = jnp.asarray(m_cross)  # [n, p]
    if not isinstance(m_cross, jax.core.Tracer) and not isinstance(
            model.noise.q, jax.core.Tracer):
        import numpy as _np

        q_np = _np.asarray(model.noise.q)
        r_np = _np.asarray(model.noise.r)
        m_np = _np.asarray(m_cross)
        joint = _np.block([[q_np, m_np], [m_np.T, r_np]])
        w_min = float(_np.linalg.eigvalsh(joint).min())
        if w_min < -1e-9 * max(1.0, float(_np.abs(joint).max())):
            raise ValueError(
                "correlated_step: joint noise covariance [[Q, M], [M', R]] "
                f"is not PSD (min eigenvalue {w_min:.3e}); shrink M")
    x_pred, p_pred = predict(model, state, control)
    h = model.h
    y_hat = h @ state.x
    pht_m = p_pred @ h.T + m_cross
    s = linalg.sym(h @ p_pred @ h.T + model.noise.r
                   + h @ m_cross + m_cross.T @ h.T)
    k_gain = linalg.solve_psd(s, pht_m.T).T
    innovation = measurement - h @ x_pred
    x = x_pred + k_gain @ innovation
    # K is no longer the Joseph-compatible gain w.r.t. (H, R) alone:
    # use the general-gain covariance P⁺ = P⁻ − K S Kᵀ (exact for the
    # optimal K above).
    p = linalg.sym(p_pred - k_gain @ s @ k_gain.T)
    est = Estimate(
        state=x,
        measurement=y_hat,
        innovation=innovation,
        covariance=p,
        pred_covariance=p_pred,
        gain=k_gain,
    )
    return State(x, p, state.k + 1), est


@linalg.highp
def run_correlated(model: Model, state: State, measurements, m_cross,
                   controls=None):
    """lax.scan driver for the correlated-noise filter."""

    def body(carry, xs):
        meas, u = xs
        return correlated_step(model, carry, meas, m_cross, u)

    return jax.lax.scan(body, state, (measurements, controls))
