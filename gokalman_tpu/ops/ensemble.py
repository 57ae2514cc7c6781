"""Fused ensemble Monte-Carlo + chi-square pipelines.

The reference's throughput workload (SURVEY.md §3.2) is
runs × steps × Vanilla.Update with everything materialized per step
(montecarlo.go:108-117, chisquare.go:37-79).  Two structural facts make
the fused version orders of magnitude faster than a literal vmap:

1. **The covariance path is run-independent.**  With shared (F, H, Q, R)
   the P/K/NEES-weight recurrences do not depend on the data, so they
   are computed once per step ([n,n] work) instead of once per run
   (vanilla.go:149-168 recomputes them inside every Update call).
   The per-run work collapses to matvec recurrences + quadratic forms.

2. **Nothing needs to be materialized.**  Truth generation and the
   chi-square replay are fused into one lax.scan: the measurement is
   consumed the step it is produced, and only the [T]-shaped NEES/NIS
   means (plus optional [T, n] ensemble stats) leave the chip.  The Go
   pipeline writes runs×steps estimate objects to heap; this writes
   O(T·n) floats to HBM.

Layout: ensembles are [n, S] (state dim first, the 100k ensemble
last and contiguous), so every op is an elementwise op over S or an
[n,n]x[n,S] matmul.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..filters import vanilla


class ChiSquareResult(NamedTuple):
    nis_means: jax.Array  # [T]
    nees_means: jax.Array  # [T]
    mean: jax.Array  # [T, n] truth-ensemble mean per step
    stddev: jax.Array  # [T, n] truth-ensemble stddev (ddof=1) per step


@linalg.highp
def _covariance_path_sequential(model: vanilla.Model, p0, steps: int):
    """Shared covariance recurrence: per-step (K, S^{-1}, (P^+)^{-1}).

    One scan of [n,n] ops replacing the per-run gain computation
    (vanilla.go:149-168, chisquare.go:50-77).
    """
    f, h = model.f, model.h
    q, r = model.noise.q, model.noise.r

    def body(p, _):
        p_pred = linalg.sym(f @ p @ f.T + q)
        pht = p_pred @ h.T
        s = h @ pht + r
        s_inv = linalg.inv_psd(s)
        k_gain = pht @ s_inv
        p_plus = vanilla.joseph_update(p_pred, k_gain, h, r)
        p_plus_inv = linalg.inv_psd(p_plus)
        return p_plus, (k_gain, s_inv, p_plus_inv)

    _, path = jax.lax.scan(body, p0, None, length=steps)
    return path  # each leaf [T, ...]


@linalg.highp
def _covariance_path(model: vanilla.Model, p0, steps: int):
    """Parallel-depth covariance path.

    The sequential T-step recurrence above costs ~20 ms of serial tiny
    ops at T=1000 and dominates the fused pipeline's fixed overhead.
    The data-*independent* part of the parallel-filter elements
    (ops.assoc_scan: A, C, J — b and eta carry the measurements) obeys
    the same associative combination, so all filtered covariances
    P^+_k = C_k come out of one associative_scan in O(log T) depth;
    the per-step (K, S^{-1}, (P^+)^{-1}) then follow as batched [T,n,n]
    ops.  Matches the sequential path to f32 roundoff.
    """
    f, h = model.f, model.h
    q, r = model.noise.q, model.noise.r
    n = f.shape[0]
    dtype = f.dtype
    eye = jnp.eye(n, dtype=dtype)

    # Generic (A, C, J) element shared by steps k >= 1.
    s_g = h @ q @ h.T + r
    k_g = linalg.solve_psd(s_g, h @ q.T).T
    ikh_g = eye - k_g @ h
    a_g = ikh_g @ f
    c_g = linalg.sym(ikh_g @ q)
    j_g = linalg.sym(f.T @ h.T @ linalg.solve_psd(s_g, h @ f))
    # First element conditions on the prior.
    p_pred0 = linalg.sym(f @ p0 @ f.T + q)
    s0 = h @ p_pred0 @ h.T + r
    k0 = linalg.solve_psd(s0, h @ p_pred0.T).T
    c_0 = linalg.sym((eye - k0 @ h) @ p_pred0)

    a = jnp.broadcast_to(a_g, (steps, n, n)).at[0].set(jnp.zeros((n, n), dtype))
    cc = jnp.broadcast_to(c_g, (steps, n, n)).at[0].set(c_0)
    j = jnp.broadcast_to(j_g, (steps, n, n)).at[0].set(jnp.zeros((n, n), dtype))

    def combine(ei, ej):
        ai, ci, ji = ei
        aj, cj, jj = ej
        icj = eye + ci @ jj
        a_out = aj @ jnp.linalg.solve(icj, ai)
        c_out = linalg.sym(
            aj @ jnp.linalg.solve(icj, ci) @ jnp.swapaxes(aj, -1, -2) + cj
        )
        ijc = eye + jj @ ci
        ait = jnp.swapaxes(ai, -1, -2)
        j_out = linalg.sym(ait @ jnp.linalg.solve(ijc, jj) @ ai + ji)
        return a_out, c_out, j_out

    _, p_plus, _ = jax.lax.associative_scan(combine, (a, cc, j))

    # Batched per-step quantities from the filtered covariances.
    p_prev = jnp.concatenate([p0[None], p_plus[:-1]], axis=0)
    p_pred = linalg.sym(jnp.einsum("ij,tjk,lk->til", f, p_prev, f) + q)
    pht = p_pred @ h.T  # [T, n, p]
    s = jnp.einsum("ij,tjk->tik", h, pht) + r
    k_gain = jnp.swapaxes(jnp.linalg.solve(s, jnp.swapaxes(pht, -1, -2)), -1, -2)
    p_plus_inv = jnp.linalg.inv(p_plus)
    s_inv = jnp.linalg.inv(s)
    return k_gain, s_inv, p_plus_inv


def _masked_schedule(model: vanilla.Model, hs, rs, meas_masks):
    """Normalize a per-step (hs, rs, meas_masks) measurement schedule
    into masked ([T,p,n] hs, [T,p,p] rs, [T,p,p] chol(rs)) arrays.

    Masked rows get a zero H row and a unit R diagonal (see
    vanilla.mask_measurement), so the downstream algebra needs no mask
    concept at all — the static-shape form of the reference's
    mid-stream SetMeasurementMatrix/SetNoise (jerkcar/main.go:141-158).
    """
    t = jnp.shape(hs if hs is not None else rs)[0]
    hs = jnp.broadcast_to(model.h, (t,) + model.h.shape) if hs is None else jnp.asarray(hs)
    r = model.noise.r
    rs = jnp.broadcast_to(r, (t,) + r.shape) if rs is None else jnp.asarray(rs)
    if meas_masks is not None:
        hs, rs, _ = jax.vmap(
            lambda h, rr, m: vanilla.mask_measurement(h, rr, None, m)
        )(hs, rs, meas_masks)
    lrs = jnp.linalg.cholesky(rs)
    if meas_masks is not None:
        # Masked rows carry a unit R diagonal only to keep S invertible;
        # they must not inject measurement noise — zero their chol rows
        # so generated measurements are exactly 0 there (innovation 0,
        # zero gain column => the padded update equals the unpadded one).
        lrs = lrs * meas_masks[..., None].astype(lrs.dtype)
    return hs, rs, lrs


@linalg.highp
def _covariance_path_tv(model: vanilla.Model, p0, hs, rs):
    """Time-varying covariance path: per-step (K, S^{-1}, (P^+)^{-1})
    for an already-masked (hs, rs) measurement schedule.

    Still run-independent — one [n,n] scan shared by the whole ensemble
    (the TV analogue of _covariance_path_sequential).
    """
    f, q = model.f, model.noise.q

    def body(p, xs):
        h, r = xs
        p_pred = linalg.sym(f @ p @ f.T + q)
        pht = p_pred @ h.T
        s = h @ pht + r
        s_inv = linalg.inv_psd(s)
        k_gain = pht @ s_inv
        p_plus = vanilla.joseph_update(p_pred, k_gain, h, r)
        return p_plus, (k_gain, s_inv, linalg.inv_psd(p_plus))

    _, path = jax.lax.scan(body, p0, (hs, rs))
    return path


@linalg.highp
def _covariance_path_sqrt(model: vanilla.Model, p0, steps=None, hs=None,
                          rs=None):
    """Factored (chol/QR) covariance path: same per-step
    (K, S^{-1}, (P^+)^{-1}) leaves as the moment recurrences, computed
    without ever forming or inverting a covariance.

    The carry is the lower posterior factor L (P^+ = L Lᵀ); each step
    runs the Morf–Kailath/Kaminski array (squareroot.go:21-50 is the
    reference's rationale for the same trick on the filter itself):

        qr([Lᵀ Fᵀ; Lqᵀ])                -> L̄ᵀ   (predicted factor)
        qr([[Lrᵀ, 0], [L̄ᵀHᵀ, L̄ᵀ]])     -> [[X, Y], [0, Z]]

    with XᵀX = S, K = Yᵀ X⁻ᵀ, ZᵀZ = P⁺ — so the worst conditioning any
    op sees is sqrt(kappa(P)).  Measured on cond(P0) ~ 1e9-1e10 f32
    models (tests/test_cov_path.py): the factored arrays are 10-50x
    closer to the x64 truth than the moment recurrence's (S⁻¹ max rel
    err 0.15 vs 38 at cond 1e9) and the pipeline NEES tail lands
    within 0.05 of n where the moment path misses by ~0.2.  Honest
    limit, also pinned by the tests: for models where the f32 ENSEMBLE
    REPLAY itself is unstable (some cond-1e10 draws), feeding exact
    x64 arrays still blows up — past that point the precompute is not
    the binding constraint and only an f32-robust filter form (SRIF /
    square-root, filters/srif.py) helps.  The kernel body is
    unchanged: it consumes the same per-step arrays.

    Pass `steps` for the time-invariant schedule or (hs, rs) for a
    masked time-varying one (rs rows for masked steps carry the unit
    diagonal from _masked_schedule, keeping chol well-posed).
    """
    f = model.f
    # Factor the ALGEBRA matrices q/r/p0, not the sampling factors
    # sqrt_q/sqrt_r (zero for `noiseless` models, which still carry
    # real q/r).  eigh-based factors, not chol: f32 chol of a
    # cond ~1e9 input goes indefinite->NaN, and the pre-array rows
    # only need B Bᵀ = A, not triangularity (linalg.sqrt_factor_psd).
    lq = linalg.sqrt_factor_psd(model.noise.q)
    n = f.shape[0]
    eye_n = jnp.eye(n, dtype=f.dtype)

    def body(l_post, xs):
        h, lr = xs
        p = h.shape[0]
        pre_t = jnp.concatenate([l_post.T @ f.T, lq.T], axis=0)  # [2n, n]
        l_pred_t = linalg.qr_r(pre_t)  # upper = L̄ᵀ
        a = jnp.block([
            [lr.T, jnp.zeros((p, n), f.dtype)],
            [l_pred_t @ h.T, l_pred_t],
        ])
        ru = linalg.qr_r(a)
        x = ru[:p, :p]  # upper, XᵀX = S
        y = ru[:p, p:]  # X⁻ᵀ H P̄
        z = ru[p:, p:]  # upper, ZᵀZ = P⁺
        # K = P̄Hᵀ S⁻¹ = Yᵀ X⁻¹ X⁻ᵀ · X = Yᵀ X⁻ᵀ, i.e. Kᵀ = X⁻¹ Y.
        k_gain = jax.scipy.linalg.solve_triangular(x, y, lower=False).T
        x_inv = jax.scipy.linalg.solve_triangular(
            x, jnp.eye(p, dtype=f.dtype), lower=False)
        s_inv = x_inv @ x_inv.T
        z_inv = jax.scipy.linalg.solve_triangular(z, eye_n, lower=False)
        p_plus_inv = z_inv @ z_inv.T
        return z.T, (k_gain, s_inv, p_plus_inv)

    l0 = linalg.sqrt_factor_psd(jnp.asarray(p0))
    if hs is None:
        lr0 = linalg.sqrt_factor_psd(model.noise.r)
        t = steps
        hs = jnp.broadcast_to(model.h, (t,) + model.h.shape)
        lrs = jnp.broadcast_to(lr0, (t,) + lr0.shape)
    else:
        lrs = jax.vmap(linalg.sqrt_factor_psd)(jnp.asarray(rs))
    _, path = jax.lax.scan(body, l0, (jnp.asarray(hs), lrs))
    return path


@linalg.highp
def filter_bank(
    model: vanilla.Model,
    state0: vanilla.State,
    measurements: jax.Array,
    controls: Optional[jax.Array] = None,
    hs=None,
    rs=None,
    meas_masks=None,
    ensemble_sharding=None,
):
    """Fused bank of S independent CKFs sharing one (possibly
    time-varying) model — jerkcar-class workloads at ensemble speed.

    The reference runs side-by-side filters as separate mutable structs
    in a Go loop (examples/jerkcar/main.go:133-161); here S parallel
    measurement streams [T, p, S] (lanes-major) share ONE covariance
    path ([n,n] scan, computed once) and the per-stream work is a
    broadcast matvec recurrence.  Stream-wise identical to
    vanilla.run(...) with the same padded (hs, rs, meas_masks) schedule
    (tests/test_filter_bank.py pins 1e-9 agreement in f64).

    measurements: [T, p, S]; controls: [T, m] (shared) or None.
    Returns (states [T, n, S], innovations [T, p, S],
    (k_path, s_inv_path, p_inv_path) each [T, ...]).
    """
    f, g = model.f, model.g
    if hs is None and rs is None:
        t = measurements.shape[0]
        rs = jnp.broadcast_to(model.noise.r, (t,) + model.noise.r.shape)
    hs, rs, _ = _masked_schedule(model, hs, rs, meas_masks)
    if meas_masks is not None:
        measurements = measurements * meas_masks[..., None].astype(
            measurements.dtype)

    path = _covariance_path_tv(model, state0.p, hs, rs)
    k_path, s_inv_path, p_inv_path = path

    x0 = jnp.tile(state0.x[:, None], (1, measurements.shape[-1]))
    if ensemble_sharding is not None:
        x0 = jax.lax.with_sharding_constraint(x0, ensemble_sharding)

    def body(x, xs):
        y, u, h_k, k_gain = xs
        x_pred = f @ x
        if g is not None and u is not None:
            x_pred = x_pred + (g @ u)[:, None]
        innov = y - h_k @ x_pred  # [p, S]
        x = x_pred + k_gain @ innov
        return x, (x, innov)

    _, (states, innovs) = jax.lax.scan(
        body, x0, (measurements, controls, hs, k_path)
    )
    return states, innovs, path


@linalg.highp
def mc_chi_square(
    model: vanilla.Model,
    state0: vanilla.State,
    samples: int,
    steps: int,
    key: jax.Array,
    controls: Optional[jax.Array] = None,
    ensemble_sharding=None,
    init_spread: bool = False,
    lagged_measurements: bool = True,
    hs=None,
    rs=None,
    meas_masks=None,
    cov_path: str = "moment",
) -> ChiSquareResult:
    """Fused Monte-Carlo truth generation + chi-square replay.

    Semantics match running NewMonteCarloRuns (pure-predictor AWGN
    truth, montecarlo.go:92-119) followed by NewChiSquare with a
    noiseless replay filter (chisquare.go:16-95, examples/robot/main.go
    wiring), computing per-step ensemble means of NEES and NIS plus the
    MC mean/stddev traces — without materializing any [S, T, ...] array.

    `ensemble_sharding` (a jax.sharding.NamedSharding over the S axis)
    shards the ensembles across devices; the per-step means become
    all-reduces inserted by XLA.  `init_spread=True` draws x0 ~
    N(state0.x, P0) per run (the robot example's random initial state).

    `lagged_measurements=True` reproduces the reference's semantics
    exactly: the recorded MC measurement is H·x(k-1)+v, generated from
    the *pre-predict* truth state (vanilla.go:155-157), while the
    replay filter models it as observing the post-predict state — a
    one-step lag that inflates NEES above the state dimension.  Set
    False for the physically consistent test (y_k = H·x_t(k)+v), which
    calibrates NEES to exactly n.

    `hs`/`rs`/`meas_masks` give a per-step padded measurement schedule
    (jerkcar-class time-varying workloads, see vanilla.run): truth
    measurements are generated through H_k with chol(R_k) noise and the
    covariance path follows the schedule.

    `cov_path` selects the precompute recurrence: "moment" (default;
    Joseph form — O(log T) parallel-depth when time-invariant) or
    "sqrt" (the chol/QR Morf–Kailath array in _covariance_path_sqrt)
    for f32 models around cond(P0) ~ 1e9+, where the moment form's
    Joseph cancellation degrades the per-step arrays and biases the
    NEES tail by ~0.2 (see _covariance_path_sqrt for the measured
    regime map and limits).  The scan body is identical either way —
    only the per-step (K, S⁻¹, P⁺⁻¹) arrays change.
    """
    if cov_path not in ("moment", "sqrt"):
        raise ValueError(f"unknown cov_path {cov_path!r}")
    n = state0.x.shape[0]
    p = model.h.shape[0]
    dtype = state0.x.dtype
    f, h = model.f, model.h
    lq, lr = model.noise.sqrt_q, model.noise.sqrt_r

    time_varying = hs is not None or rs is not None or meas_masks is not None
    if time_varying:
        hs_m, rs_m, lrs = _masked_schedule(model, hs, rs, meas_masks)
        if cov_path == "sqrt":
            k_path, s_inv_path, p_inv_path = _covariance_path_sqrt(
                model, state0.p, hs=hs_m, rs=rs_m
            )
        else:
            k_path, s_inv_path, p_inv_path = _covariance_path_tv(
                model, state0.p, hs_m, rs_m
            )
    else:
        hs_m = lrs = None
        if cov_path == "sqrt":
            k_path, s_inv_path, p_inv_path = _covariance_path_sqrt(
                model, state0.p, steps=steps
            )
        else:
            k_path, s_inv_path, p_inv_path = _covariance_path(
                model, state0.p, steps
            )

    key, k_init = jax.random.split(key)
    x_truth = jnp.tile(state0.x[:, None], (1, samples))
    if init_spread:
        l0 = linalg.chol_or_eigh_sqrt(state0.p)
        x_truth = x_truth + l0 @ jax.random.normal(k_init, (n, samples), dtype)
    x_est = jnp.tile(state0.x[:, None], (1, samples))
    if ensemble_sharding is not None:
        x_truth = jax.lax.with_sharding_constraint(x_truth, ensemble_sharding)
        x_est = jax.lax.with_sharding_constraint(x_est, ensemble_sharding)

    keys = jax.random.split(key, steps)

    def step_fn(carry, xs):
        x_t, x_e = carry
        k_gain, s_inv, p_inv, u, kk, h_k, lr_k = xs
        h_t = h if h_k is None else h_k
        lr_t = lr if lr_k is None else lr_k
        kw, kv = jax.random.split(kk)

        # --- truth (pure predictor, vanilla.go:138-146, 170-179) ---
        v = lr_t @ jax.random.normal(kv, (p, samples), dtype)
        w = lq @ jax.random.normal(kw, (n, samples), dtype)
        gu = 0.0 if (model.g is None or u is None) else (model.g @ u)[:, None]
        if lagged_measurements:
            y = h_t @ x_t + v  # pre-predict state (reference semantics)
            x_t = f @ x_t + gu + w
        else:
            x_t = f @ x_t + gu + w
            y = h_t @ x_t + v  # post-predict state (consistent test)

        # --- replay filter (noiseless draws, chisquare.go:41) ---
        x_pred = f @ x_e + gu
        innov = y - h_t @ x_pred  # [p, S]
        x_e = x_pred + k_gain @ innov

        # --- consistency statistics (chisquare.go:46-77) ---
        err = x_t - x_e  # [n, S]
        nees = jnp.sum(err * (p_inv @ err), axis=0)  # [S]
        nis = jnp.sum(innov * (s_inv @ innov), axis=0)  # [S]

        # --- streamed MC ensemble stats (montecarlo.go:18-59) ---
        mean = jnp.mean(x_t, axis=1)  # [n]
        var = jnp.sum((x_t - mean[:, None]) ** 2, axis=1) / (samples - 1)

        return (x_t, x_e), (jnp.mean(nis), jnp.mean(nees), mean, jnp.sqrt(var))

    (x_t, x_e), (nis, nees, means, devs) = jax.lax.scan(
        step_fn, (x_truth, x_est),
        (k_path, s_inv_path, p_inv_path, controls, keys, hs_m, lrs),
    )
    return ChiSquareResult(nis, nees, means, devs)


@linalg.highp
def mc_stats(
    model: vanilla.Model,
    state0: vanilla.State,
    samples: int,
    steps: int,
    key: jax.Array,
    controls: Optional[jax.Array] = None,
    ensemble_sharding=None,
):
    """Streamed pure-predictor Monte-Carlo: per-step ensemble mean and
    stddev only (the montecarlo.go:18-59 outputs) at O(T·n) HBM cost."""
    n = state0.x.shape[0]
    dtype = state0.x.dtype
    f = model.f
    lq = model.noise.sqrt_q

    x = jnp.tile(state0.x[:, None], (1, samples))
    if ensemble_sharding is not None:
        x = jax.lax.with_sharding_constraint(x, ensemble_sharding)
    keys = jax.random.split(key, steps)

    def step_fn(x, xs):
        u, kk = xs
        w = lq @ jax.random.normal(kk, (n, samples), dtype)
        gu = 0.0 if (model.g is None or u is None) else (model.g @ u)[:, None]
        x = f @ x + gu + w
        mean = jnp.mean(x, axis=1)
        var = jnp.sum((x - mean[:, None]) ** 2, axis=1) / (samples - 1)
        return x, (mean, jnp.sqrt(var))

    _, (means, devs) = jax.lax.scan(step_fn, x, (controls, keys))
    return means, devs
