"""Filter-health diagnostics: innovation whiteness, chi-square bounds,
covariance sanity.

The reference's only runtime health signal is the IsWithinNσ console
warning (vanilla.go:231-239) and the offline NEES/NIS means
(chisquare.go:85-92).  This module provides the standard quantitative
consistency toolkit (Bar-Shalom, Li & Kirubarajan ch. 5) as pure,
jittable reductions over a run's stacked estimates:

- a filter is CONSISTENT iff its innovations are zero-mean, white, and
  sized by the predicted covariance; each property gets its own test
  statistic with an acceptance region, so a broken Q/R shows up as a
  named failure instead of silent drift.

Everything operates on plain arrays ([T, p] innovations etc.), so it
applies to any filter family here — linear, hybrid, UKF, ensemble —
and to banks via vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import linalg


class WhitenessResult(NamedTuple):
    statistic: jax.Array  # [] Ljung-Box style Q over the tested lags
    autocorr: jax.Array  # [lags] pooled innovation autocorrelation
    threshold: float  # chi-square 95% acceptance bound
    passed: jax.Array  # [] bool


def chi2_interval(dof: float, n_samples: int, alpha: float = 0.05):
    """Two-sided acceptance interval for the MEAN of `n_samples` iid
    chi-square(dof) variables (the NEES/NIS gate of Bar-Shalom §5.4):
    [chi2.ppf(a/2, N*dof), chi2.ppf(1-a/2, N*dof)] / N.  Host-side
    (scipy) — this is config-time code."""
    from scipy.stats import chi2

    lo = chi2.ppf(alpha / 2.0, n_samples * dof) / n_samples
    hi = chi2.ppf(1.0 - alpha / 2.0, n_samples * dof) / n_samples
    return float(lo), float(hi)


def nees_test(nees_sequence, dof: int, alpha: float = 0.05):
    """(mean, lo, hi, passed) for a [T] NEES sequence: the time-average
    test with the exact chi-square interval.  Use on
    chisquare/ops.ensemble outputs or a single run's
    (x_true - x̂)ᵀ P⁻¹ (x_true - x̂) trace."""
    seq = jnp.asarray(nees_sequence)
    lo, hi = chi2_interval(dof, int(seq.shape[0]), alpha)
    mean = jnp.mean(seq)
    return mean, lo, hi, (mean >= lo) & (mean <= hi)


def innovation_whiteness(innovations, lags: int = 10,
                         alpha: float = 0.05) -> WhitenessResult:
    """Ljung-Box style whiteness test on a [T, p] innovation sequence.

    The innovations are first whitened by their SAMPLE covariance (the
    component-wise statistic is only chi-square if the p components are
    independent — a correlated sensor pair would otherwise double the
    false-alarm rate), then the per-component Ljung-Box statistics
    Q = T (T+2) Σ_l r_l²/(T-l) are summed: approximately
    chi-square(lags * p) under the white-noise hypothesis.  A filter
    with mis-sized Q/R or a biased model produces serially correlated
    innovations long before the state error is visible.
    """
    from scipy.stats import chi2

    y = jnp.asarray(innovations)
    if y.ndim == 1:
        y = y[:, None]
    t, p = y.shape
    if t <= lags:
        raise ValueError(f"need more than lags={lags} samples, got {t}")
    yc = y - jnp.mean(y, axis=0, keepdims=True)
    # Decorrelate components: z = L^{-1} yc with L L^T the sample cov.
    # Scale-aware jitter keeps the Cholesky finite when a component is
    # (near-)constant — e.g. a fully-masked padded measurement row.
    cov = yc.T @ yc / (t - 1)
    jitter = 1e-9 * (jnp.trace(cov) / p) + 1e-30
    l = jnp.linalg.cholesky(cov + jitter * jnp.eye(p, dtype=y.dtype))
    yc = jax.scipy.linalg.solve_triangular(l, yc.T, lower=True).T
    denom = jnp.sum(yc * yc, axis=0)  # [p]

    def r_at(lag):
        num = jnp.sum(yc[lag:] * yc[:-lag], axis=0)
        return num / jnp.maximum(denom, 1e-300)

    rs = jnp.stack([r_at(l) for l in range(1, lags + 1)])  # [lags, p]
    weights = jnp.asarray(
        [t * (t + 2.0) / (t - l) for l in range(1, lags + 1)]
    )
    q = jnp.sum(weights[:, None] * rs**2)
    thr = float(chi2.ppf(1.0 - alpha, lags * p))
    return WhitenessResult(
        statistic=q,
        autocorr=jnp.mean(rs, axis=1),
        threshold=thr,
        passed=q <= thr,
    )


def innovation_bias(innovations, pred_covariances, hs, rs):
    """Normalized innovation mean: sqrt(T) * mean(innov) whitened by
    the average innovation covariance — approximately N(0, I) for an
    unbiased filter, so components beyond ~3 flag bias."""
    y = jnp.asarray(innovations)
    t = y.shape[0]
    s = jnp.mean(
        jnp.einsum("tij,tjk,tlk->til", hs, pred_covariances, hs) + rs, axis=0
    )
    l = jnp.linalg.cholesky(s)
    m = jnp.mean(y, axis=0) * jnp.sqrt(float(t))
    return jax.scipy.linalg.solve_triangular(l, m, lower=True)


def covariance_health(covariances, atol: float = 0.0):
    """Per-step covariance sanity over a [T, n, n] trace: finite,
    symmetric, positive diagonal.  Returns a [T] bool mask of healthy
    steps (all True for a working filter) — cheap enough to gate on in
    serving."""
    p = jnp.asarray(covariances)
    finite = jnp.all(jnp.isfinite(p), axis=(1, 2))
    sym = jnp.all(
        jnp.abs(p - jnp.swapaxes(p, 1, 2)) <= 1e-6 * (jnp.abs(p) + 1.0),
        axis=(1, 2),
    )
    pos = jnp.all(jnp.diagonal(p, axis1=1, axis2=2) > atol, axis=1)
    return finite & sym & pos


def divergence_onset(nis_sequence, dof: int, window: int = 20,
                     alpha: float = 0.001):
    """Index (window end) of the first NON-OVERLAPPING window whose
    NIS mean leaves its chi-square acceptance interval, or -1: the
    standard online divergence detector.

    Non-overlapping windows keep the tests independent — a single
    heavy-tailed chi-square sample would otherwise contaminate ~window
    overlapping means and false-alarm; with T/window independent tests
    at the default alpha=1e-3 the arc-level false-alarm rate stays at
    the ~1% level.  Detection resolution is one window."""
    seq = jnp.asarray(nis_sequence)
    t = seq.shape[0]
    if t < window:
        raise ValueError(f"need at least window={window} samples, got {t}")
    lo, hi = chi2_interval(dof, window, alpha)
    n_win = t // window
    means = jnp.mean(
        seq[: n_win * window].reshape(n_win, window), axis=1
    )
    bad = (means < lo) | (means > hi)
    idx = jnp.argmax(bad)
    found = jnp.any(bad)
    return jnp.where(found, (idx + 1) * window - 1, -1)


def pcrb(phis, hs, q, r, j0):
    """Posterior Cramér-Rao bound (Tichavský, Muravchik & Nehorai 1998)
    for additive-Gaussian state-space models: the information recursion

        J_{k+1} = D22_k − D21_k (J_k + D11_k)⁻¹ D12_k
        D11 = E[F_kᵀ Q⁻¹ F_k],  D12 = −E[F_kᵀ] Q⁻¹,
        D22 = Q⁻¹ + E[H_{k+1}ᵀ R⁻¹ H_{k+1}]

    whose inverse lower-bounds the error covariance of ANY estimator —
    the yardstick that says whether a filter's RMS error is the
    filter's fault or the problem's.  The reference has no analogue;
    its consistency tier (chisquare.go) can only say a filter believes
    itself, not how far it sits from optimal.

    `phis` [T, n, n] are dynamics Jacobians (phis[k] maps step k to
    k+1) and `hs` [T, p, n] measurement Jacobians at steps 1..T — the
    alignment of a `vanilla.run`/`hybrid` trace.  For nonlinear systems
    pass SAMPLED Jacobian stacks [S, T, ...] evaluated along S truth
    trajectories; the expectations above are averaged over the sample
    axis (the Monte-Carlo PCRB).  `j0` is the prior information P0⁻¹.

    Returns (info [T, n, n], bounds [T, n, n]) with bounds[k] = J⁻¹
    aligned with the filter's posterior covariance at estimate index k.
    For a linear-Gaussian model the bound EQUALS the Kalman filter's
    posterior covariance sequence (pinned in tests/test_pcrb.py) — the
    KF is efficient.
    """
    phis = jnp.asarray(phis)
    hs = jnp.asarray(hs)
    q = jnp.atleast_2d(jnp.asarray(q))
    r = jnp.atleast_2d(jnp.asarray(r))
    qinv = _psd_inv(q)
    rinv = _psd_inv(r)

    if phis.ndim == 3:
        phis = phis[None]
    if hs.ndim == 3:
        hs = hs[None]
    # Matrix-inversion-lemma form of the recursion: the textbook
    # J = Q⁻¹ + HᵀR⁻¹H − Q⁻¹E[F](J + D11)⁻¹E[F]ᵀQ⁻¹ subtracts two
    # Q⁻¹-sized terms and loses ~κ(Q) digits (the reference-derived OD
    # models carry Q ~ 1e-15).  Writing D11 = E[F]ᵀQ⁻¹E[F] + ΔD11 with
    # the CENTERED sample covariance ΔD11 = E[(F−E[F])ᵀQ⁻¹(F−E[F])]
    # (exactly zero for deterministic Jacobians) turns it into
    #     J_{k+1} = (Q + E[F](J_k + ΔD11_k)⁻¹E[F]ᵀ)⁻¹ + E[HᵀR⁻¹H]
    # — algebraically identical, no cancellation, and in the
    # deterministic case literally the information-form Riccati
    # recursion, so the linear-KF parity test holds to roundoff.
    ef = jnp.mean(phis, 0)  # E[F_k]
    phic = phis - ef[None]
    dd11 = jnp.mean(jnp.einsum("stji,jk,stkl->stil", phic, qinv, phic), 0)
    hrh = jnp.mean(jnp.einsum("stji,jk,stkl->stil", hs, rinv, hs), 0)

    def body(j, xs):
        dd11_k, ef_k, hrh_k = xs
        inner = j + dd11_k
        # PSD (Cholesky) solves throughout: the matrices are SPD.
        chol = jnp.linalg.cholesky(_sym(inner))
        p_pred = q + ef_k @ jax.scipy.linalg.cho_solve((chol, True), ef_k.T)
        j_new = _sym(_psd_inv(p_pred) + hrh_k)
        return j_new, j_new

    _, info = jax.lax.scan(body, _sym(jnp.asarray(j0)), (dd11, ef, hrh))
    bounds = jax.vmap(_psd_inv)(info)
    return info, bounds


class ObservabilityResult(NamedTuple):
    gramian: jax.Array  # [n, n] information accumulated at the epoch
    eigvals: jax.Array  # [n] ascending eigenvalues
    rank: jax.Array  # [] numerical rank
    cond: jax.Array  # [] max/min-positive eigenvalue ratio


def observability_gramian(phis, hs, rs=None, rtol: float = 1e-9):
    """Stochastic observability Gramian at the initial epoch:
    G = Σ_k Φ(k,0)ᵀ H_kᵀ R_k⁻¹ H_k Φ(k,0) — the information an arc of
    measurements carries about x_0.  A rank-deficient G means some
    state direction is UNOBSERVABLE from the arc (its eigenvector says
    which); the condition number quantifies how ill-posed the epoch
    estimation problem is before any filter runs.

    This is the quantitative form of the question the reference's
    statOD workloads answer empirically by watching covariance traces
    (srif_test.go's 24h tracking arcs): e.g. a single short
    station pass yields a Gramian orders of magnitude worse-conditioned
    than the full multi-station day (tests/test_observability.py).

    `phis` [T, n, n]: phis[k] maps step k to k+1; `hs` [T, p, n]:
    measurement Jacobian at step k+1 — so entry k covers the
    measurement a filter assimilates at estimate index k, and
    Φ(k, 0) = phis[k-1] ⋯ phis[0] composed with phis[k]... the scan
    accumulates Φ ← phis[k] Φ before applying hs[k].  `rs` ([p, p] or
    [T, p, p]) defaults to identity (unweighted geometric Gramian).
    """
    phis = jnp.asarray(phis)
    hs = jnp.asarray(hs)
    t, _, n = phis.shape
    p = hs.shape[-2]
    if rs is None:
        rinvs = jnp.broadcast_to(jnp.eye(p, dtype=hs.dtype), (t, p, p))
    else:
        rs = jnp.asarray(rs)
        if rs.ndim == 2:
            rinvs = jnp.broadcast_to(_psd_inv(rs), (t, p, p))
        else:
            rinvs = jax.vmap(_psd_inv)(rs)

    def body(carry, xs):
        phi_cum, g = carry
        phi_k, h_k, rinv_k = xs
        phi_cum = phi_k @ phi_cum
        hphi = h_k @ phi_cum
        g = g + hphi.T @ rinv_k @ hphi
        return (phi_cum, g), None

    init = (jnp.eye(n, dtype=phis.dtype), jnp.zeros((n, n), dtype=phis.dtype))
    (_, g), _ = jax.lax.scan(body, init, (phis, hs, rinvs))
    g = _sym(g)
    w = jnp.linalg.eigvalsh(g)
    tol = rtol * jnp.maximum(w[-1], jnp.finfo(g.dtype).tiny)
    rank = jnp.sum(w > tol)
    w_floor = jnp.where(w > tol, w, w[-1])
    cond = w[-1] / jnp.min(w_floor)
    return ObservabilityResult(g, w, rank, cond)


def observability_matrix(f, h):
    """LTI observability matrix [H; HF; …; HF^{n-1}] ([n·p, n]) and its
    numerical rank — the structural (noise-free) test; use
    observability_gramian for the arc-and-weights version."""
    f = jnp.asarray(f)
    h = jnp.atleast_2d(jnp.asarray(h))
    n = f.shape[0]
    rows = [h]
    for _ in range(n - 1):
        rows.append(rows[-1] @ f)
    obs = jnp.concatenate(rows, axis=0)
    return obs, jnp.linalg.matrix_rank(obs)


def _sym(m):
    return 0.5 * (m + m.swapaxes(-1, -2))


def _psd_inv(m):
    """Cholesky-based symmetric inverse (the input is SPD)."""
    chol = jnp.linalg.cholesky(_sym(m))
    eye = jnp.eye(m.shape[-1], dtype=m.dtype)
    return jax.scipy.linalg.cho_solve((chol, True), eye)


def ospa(est_points, est_mask, truth_points, truth_mask, cutoff: float,
         order: float = 2.0):
    """OSPA distance (Schuhmacher, Vo & Vo 2008): THE standard
    multi-target performance metric — a true metric between point SETS
    that charges both localization error (distances of optimally
    assigned pairs, capped at `cutoff`) and cardinality error (every
    unmatched point costs `cutoff`):

        OSPA = [ (1/n_max) ( min_π Σ min(d(x_i, y_π(i)), c)^p
                             + c^p · |n_est − n_true| ) ]^{1/p}

    Inputs are the library's padded-set idiom: `est_points` [M, d] with
    `est_mask` [M], `truth_points` [N, d] with `truth_mask` [N] —
    exactly what tracker/phd/cphd emit (pass positions, e.g.
    states[:, ::2], and weight/status-derived masks).  The optimal
    assignment is computed EXACTLY by enumerating permutations of the
    padded size host-side (trace-time table; fine for the ≤8-target
    scenes these filters target — factorial growth, guarded at 8).

    Returns the scalar OSPA (0 when both sets are empty).  vmap over a
    time axis for a per-frame trace.
    """
    import itertools as _it

    import numpy as _np

    est_points = jnp.asarray(est_points)
    truth_points = jnp.asarray(truth_points)
    m = est_points.shape[0]
    n = truth_points.shape[0]
    if max(m, n) > 8:
        raise ValueError(
            f"ospa enumerates assignments exactly; padded sizes up to 8 "
            f"supported (got {m}x{n}) — split larger scenes")
    big = max(m, n)
    perms = jnp.asarray(
        _np.array(list(_it.permutations(range(big)))),
        jnp.int32)  # [big!, big]

    est_mask = jnp.asarray(est_mask, bool)
    truth_mask = jnp.asarray(truth_mask, bool)
    c = jnp.asarray(cutoff, est_points.dtype)
    # pairwise capped distances on the padded grid; pairs involving an
    # invalid point cost exactly c (the cardinality penalty), so the
    # padded assignment problem IS the OSPA assignment problem.
    d_pad = est_points.shape[1]
    ep = jnp.concatenate(
        [est_points, jnp.zeros((big - m, d_pad), est_points.dtype)], axis=0)
    tp = jnp.concatenate(
        [truth_points, jnp.zeros((big - n, d_pad), est_points.dtype)],
        axis=0)
    em = jnp.concatenate([est_mask, jnp.zeros((big - m,), bool)])
    tm = jnp.concatenate([truth_mask, jnp.zeros((big - n,), bool)])
    dist = jnp.linalg.norm(ep[:, None, :] - tp[None, :, :], axis=2)
    both = em[:, None] & tm[None, :]
    cost = jnp.where(both, jnp.minimum(dist, c) ** order, 0.0)
    # unmatched (one side valid, the other not): c^p; both invalid: 0
    one = em[:, None] ^ tm[None, :]
    cost = cost + jnp.where(one, c**order, 0.0)

    def perm_cost(perm):
        return jnp.sum(cost[jnp.arange(big), perm])

    best = jnp.min(jax.vmap(perm_cost)(perms))
    n_est = jnp.sum(em.astype(est_points.dtype))
    n_tru = jnp.sum(tm.astype(est_points.dtype))
    n_big = jnp.maximum(jnp.maximum(n_est, n_tru), 1.0)
    # `best` already includes the cardinality penalty via the xor rows;
    # normalize by the larger TRUE cardinality.
    val = (best / n_big) ** (1.0 / order)
    return jnp.where((n_est + n_tru) > 0, val,
                     jnp.zeros((), est_points.dtype))


class GLRResult(NamedTuple):
    glr: jax.Array  # [T] GLR statistic per onset hypothesis
    jump_mle: jax.Array  # [T, nd] MLE of the jump given onset k
    onset: jax.Array  # [] argmax onset
    detected: jax.Array  # [] bool: max GLR > threshold


def glr_detect(f, h, e, ests, threshold: float, window: int = 12,
               r=None):
    """Willsky-Jones (1976) generalized-likelihood-ratio jump detector
    over a filter's recorded innovations: the classic complement to
    `filters.sise` — SISE re-estimates a PERSISTENT unknown input every
    step; GLR asks whether a ONE-SHOT state jump E d happened at some
    onset, and when.

    An additive jump x_theta += E d that the filter does not model
    leaves a DETERMINISTIC signature on later innovations:

        E[nu_k] = H Phi_k(theta) E d,
        Phi_theta = I,   Phi_{k+1} = F (I - K_k H) Phi_k

    (the open-loop error transition of the filter).  For each onset
    hypothesis the jump's MLE and its likelihood-ratio statistic are
    weighted least squares over the `window` innovations after onset:

        A = sum s' S^-1 s,  b = sum s' S^-1 nu,
        d_mle = A^-1 b,     GLR = b' A^-1 b  ~  chi2(nd) under H0

    (calibration pinned by MC; the signature recursion pinned exactly
    against a brute-force with/without-jump noiseless simulation).
    Gate `threshold` at the chi2(nd) tail, e.g. 18.5 for nd=1 at
    ~1e-5.  Onsets within `window` of the end use the truncated sum —
    detection delay there is at most the remaining samples.

    `ests` is a stacked vanilla.run Estimate trace (uses innovation,
    pred_covariance, gain); `e` [n, nd] is the jump signature map.
    Host-side analysis tool (one vmap over onsets of a window scan).
    """
    f = jnp.asarray(f)
    h = jnp.asarray(h)
    e = jnp.asarray(e)
    nus = jnp.asarray(ests.innovation)  # [T, p]
    t = nus.shape[0]
    n = f.shape[0]
    eye = jnp.eye(n, dtype=f.dtype)
    gains = jnp.asarray(ests.gain)  # [T, n, p]
    pred = jnp.asarray(ests.pred_covariance)  # [T, n, n]
    if r is not None:
        # direct innovation covariance S = H P^- H' + R — REQUIRED for
        # padded/masked measurement schedules, whose masked components
        # have exactly-zero gain columns (the gain identity below goes
        # singular there and NaN-poisons every onset whose window
        # covers the step, measured)
        r_ = jnp.asarray(r)
        s_all = jax.vmap(
            lambda p_: linalg.sym(h @ p_ @ h.T + r_))(pred)
    else:
        # recover S from the gain identity K S = P^- H' via the
        # pseudo-inverse (robust to rank deficiency, exact when K has
        # full column rank — dense traces)
        def s_of(k_g, p_):
            return jnp.linalg.pinv(k_g) @ (p_ @ h.T)

        s_all = jax.vmap(s_of)(gains, pred)  # [T, p, p]

    # a measurement component the filter did not use that step (the
    # padded-mask idiom) has an exactly-zero gain column: it carries no
    # jump information, and leaving it in makes S singular -> NaN
    # (measured).  Excise such components from the statistic per step.
    comp_ok = jnp.sum(gains**2, axis=1) > 0  # [T, p]

    def one_onset(theta):
        def body(carry, k):
            phi, a, b = carry
            in_win = (k >= theta) & (k < theta + window) & (k < t)
            kk = jnp.clip(k, 0, t - 1)
            ok = comp_ok[kk]
            sig = jnp.where(ok[:, None], h @ phi @ e, 0.0)  # [p, nd]
            s_k = jnp.where(ok[:, None] & ok[None, :],
                            linalg.sym(s_all[kk]), 0.0) \
                + jnp.diag(jnp.where(ok, 0.0, 1.0).astype(f.dtype))
            sinv_sig = linalg.solve_psd(s_k, sig)
            a2 = a + jnp.where(in_win, sig.T @ sinv_sig, 0.0)
            b2 = b + jnp.where(in_win,
                               sinv_sig.T @ jnp.where(ok, nus[kk], 0.0),
                               0.0)
            phi2 = f @ (eye - gains[kk] @ h) @ phi
            phi2 = jnp.where(in_win, phi2, phi)
            return (phi2, a2, b2), None

        nd = e.shape[1]
        init = (eye, jnp.zeros((nd, nd), f.dtype),
                jnp.zeros((nd,), f.dtype))
        (phi, a, b), _ = jax.lax.scan(body, init,
                                      jnp.arange(t, dtype=jnp.int32))
        a = a + 1e-30 * jnp.eye(nd, dtype=f.dtype)
        d_mle = linalg.solve_psd(linalg.sym(a), b)
        return b @ d_mle, d_mle

    glr, d_mle = jax.vmap(one_onset)(jnp.arange(t, dtype=jnp.int32))
    onset = jnp.argmax(glr)
    return GLRResult(glr, d_mle, onset,
                     glr[onset] > jnp.asarray(threshold, f.dtype))


class GospaResult(NamedTuple):
    gospa: jax.Array  # [] the metric
    localization: jax.Array  # [] sum d^p over matched pairs
    missed: jax.Array  # [] (c^p / alpha) * n_missed_truths
    false: jax.Array  # [] (c^p / alpha) * n_false_estimates


def gospa(est_points, est_mask, truth_points, truth_mask, cutoff: float,
          order: float = 2.0, alpha: float = 2.0):
    """GOSPA (Rahmathullah, Garcia-Fernandez & Svensson 2017): the
    modern successor to OSPA — a multi-target metric that DECOMPOSES
    into localization error + missed-target cost + false-track cost
    (OSPA's single cardinality term cannot say WHICH side erred, and
    its 1/n_max normalization lets extra false tracks dilute the
    per-target error):

        GOSPA^p = min over assignments [ sum_matched d^p
                    + (c^p / alpha) (n_missed + n_false) ]

    with a pair only worth matching when d < c (at alpha = 2, the
    standard choice, matching beats paying both halves exactly when
    d^p < c^p).  Same padded-set inputs and exact trace-time
    permutation enumeration as `ospa` (sizes <= 8); a real-real
    non-match costs the full c^p (both sides' halves), a real-padded
    cell c^p/alpha, padded-padded 0 — the per-side accounting of
    fusion.associate_tracks.  Returns (gospa, localization, missed,
    false) with gospa = (loc + missed + false)^(1/p); vmap over time
    for traces.  Unnormalized by construction (GOSPA's point): more
    targets => larger metric.
    """
    import itertools as _it

    import numpy as _np

    est_points = jnp.asarray(est_points)
    truth_points = jnp.asarray(truth_points)
    m = est_points.shape[0]
    n = truth_points.shape[0]
    if max(m, n) > 8:
        raise ValueError(
            f"gospa enumerates assignments exactly; padded sizes up to "
            f"8 supported (got {m}x{n}) — split larger scenes")
    big = max(m, n)
    perms = jnp.asarray(
        _np.array(list(_it.permutations(range(big)))), jnp.int32)
    em = jnp.concatenate([jnp.asarray(est_mask, bool),
                          jnp.zeros((big - m,), bool)])
    tm = jnp.concatenate([jnp.asarray(truth_mask, bool),
                          jnp.zeros((big - n,), bool)])
    dt = est_points.dtype
    c = jnp.asarray(cutoff, dt)
    cp = c ** order
    d_pad = est_points.shape[1]
    ep = jnp.concatenate(
        [est_points, jnp.zeros((big - m, d_pad), dt)], axis=0)
    tp = jnp.concatenate(
        [truth_points, jnp.zeros((big - n, d_pad), dt)], axis=0)
    ep = jnp.where(em[:, None], ep, 0.0)
    tp = jnp.where(tm[:, None], tp, 0.0)
    dist = jnp.linalg.norm(ep[:, None, :] - tp[None, :, :], axis=2)
    both = em[:, None] & tm[None, :]
    one = em[:, None] ^ tm[None, :]
    matched_ok = both & (dist < c)
    # localization cost when matched; both-unmatched = 2 halves = c^p;
    # one-sided = c^p/alpha; both padded = 0
    cost = jnp.where(matched_ok, dist ** order,
                     jnp.where(both, cp,
                               jnp.where(one, cp / alpha, 0.0)))
    loc_part = jnp.where(matched_ok, dist ** order, 0.0)

    def perm_cost(perm):
        return jnp.sum(cost[jnp.arange(big), perm])

    costs = jax.vmap(perm_cost)(perms)
    k = jnp.argmin(costs)
    best_perm = perms[k]
    total = costs[k]
    rows = jnp.arange(big)
    match_flag = matched_ok[rows, best_perm]
    loc = jnp.sum(loc_part[rows, best_perm])
    n_matched = jnp.sum(match_flag.astype(dt))
    n_missed = jnp.sum(tm.astype(dt)) - n_matched
    n_false = jnp.sum(em.astype(dt)) - n_matched
    missed = cp / alpha * n_missed
    false_ = cp / alpha * n_false
    g = (loc + missed + false_) ** (1.0 / order)
    # sanity: the decomposition reproduces the optimized total
    return GospaResult(g, loc, missed, false_)
