"""Shared backward smoothing scans.

The reference implements the same Φ-inverse backward map twice
(hybrid.go:209-238, srif.go:165-192); here both filters call one
reverse lax.scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import linalg


@linalg.highp
def phi_inverse_smoother(phis, states, covs):
    """Backward map x_k = Φ_{k+1}^{-1} x_{k+1},
    P_k = Φ_{k+1}^{-1} P_{k+1} Φ_{k+1}^{-T} over stacked [T, ...] arrays;
    the last entry is returned unchanged.

    This is the reference's SmoothAll (a deterministic back-propagation
    of the final estimate, not an RTS smoother — for the statistically
    optimal version see ops.assoc_scan.smooth_parallel).
    """

    def body(carry, xs):
        x_next, p_next = carry
        phi_next, x_k, p_k, is_last = xs
        s = jnp.linalg.inv(phi_next)
        x_sm = s @ x_next
        p_sm = linalg.sym(s @ p_next @ s.T)
        x_out = jnp.where(is_last, x_k, x_sm)
        p_out = jnp.where(is_last, p_k, p_sm)
        return (x_out, p_out), (x_out, p_out)

    t = phis.shape[0]
    is_last = jnp.arange(t) == (t - 1)
    # Φ at k+1 drives the map k+1 -> k: shift left by one step.
    phi_next = jnp.roll(phis, -1, axis=0)
    init = (states[-1], covs[-1])
    _, (xs_sm, ps_sm) = jax.lax.scan(
        body, init, (phi_next, states, covs, is_last), reverse=True
    )
    return xs_sm, ps_sm


@linalg.highp
def rts_smoother(phis, q, means, covs, offsets=None):
    """Rauch-Tung-Striebel fixed-interval smoother for time-varying
    transitions: given filtered (means [T,n], covs [T,n,n]), the
    per-step STMs Φ_{k+1} ([T,n,n], phis[k] maps k-1 -> k) and process
    noise Q, returns the statistically optimal smoothed moments.

    `offsets` ([T, n] or None) are deterministic prediction offsets
    b_k with x^-_k = Φ_k x_{k-1} + b_k (e.g. b_k = G u_k for a
    controlled system); offsets[0] is unused, like phis[0].

    The reference has no RTS smoother at all — its SmoothAll is the
    deterministic Φ-inverse backmap (phi_inverse_smoother above).  For
    LTI systems the O(log T)-depth variant is ops.assoc_scan.smooth_parallel.
    """
    q = jnp.asarray(q)

    def body(carry, xs):
        x_next, p_next = carry
        phi_next, b_next, x_k, p_k, is_last = xs
        p_pred = phi_next @ p_k @ phi_next.T + q
        # C = P_k Φ^T P_pred^{-1} via a solve on the transpose.
        # PSD solve (Cholesky): P_pred is SPD.
        c = linalg.solve_psd(p_pred, phi_next @ p_k.T).T
        x_sm = x_k + c @ (x_next - (phi_next @ x_k + b_next))
        p_sm = linalg.sym(p_k + c @ (p_next - p_pred) @ c.T)
        x_out = jnp.where(is_last, x_k, x_sm)
        p_out = jnp.where(is_last, p_k, p_sm)
        return (x_out, p_out), (x_out, p_out)

    t = means.shape[0]
    is_last = jnp.arange(t) == (t - 1)
    phi_next = jnp.roll(phis, -1, axis=0)
    if offsets is None:
        b_next = jnp.zeros_like(means)
    else:
        b_next = jnp.roll(jnp.asarray(offsets), -1, axis=0)
    init = (means[-1], covs[-1])
    _, (xs_sm, ps_sm) = jax.lax.scan(
        body, init, (phi_next, b_next, means, covs, is_last), reverse=True
    )
    return xs_sm, ps_sm


@linalg.highp
def fixed_lag_smoother(phis, q, means, covs, lag: int):
    """Fixed-lag smoother: x_{k | k+lag} for every k, the streaming
    compromise between filtering (lag 0) and full RTS (lag >= T) —
    each estimate is refined by exactly `lag` future measurements, the
    latency a real-time consumer can afford.  Inputs match
    rts_smoother: STMs `phis` ([T, n, n], phis[k] maps k-1 -> k),
    process noise q, filtered means/covs.

    Implementation: the per-step smoother gains C_j and predicted
    covariances depend only on j, so they are computed ONCE (one vmap
    over j) and each output index k runs a lag-step backward recursion
    of pure matmuls from the filtered estimate at min(k+lag, T-1),
    vmapped over k — O(T) solves + O(T·lag) matmuls, fully parallel
    over output indices.  For k+lag beyond the end of the arc the
    result equals the full RTS smoother at k.
    """
    q = jnp.asarray(q)
    t = means.shape[0]
    if lag <= 0:
        return means, covs

    def gain(j):
        phi = phis[j]
        p_f = covs[j - 1]
        p_pred = phi @ p_f @ phi.T + q
        c = linalg.solve_psd(p_pred, phi @ p_f.T).T
        return c, p_pred

    cs, p_preds = jax.vmap(gain)(jnp.arange(1, t))  # entry i covers j=i+1

    def smooth_at(k):
        end = jnp.minimum(k + lag, t - 1)

        def body(i, carry):
            x_n, p_n = carry
            j = k + lag - i  # smoothing index j-1 from "next" index j
            valid = (j <= end) & (j >= k + 1)
            jc = jnp.clip(j, 1, t - 1)
            phi = phis[jc]
            x_f = means[jc - 1]
            p_f = covs[jc - 1]
            c = cs[jc - 1]
            p_pred = p_preds[jc - 1]
            x_s = x_f + c @ (x_n - phi @ x_f)
            p_s = linalg.sym(p_f + c @ (p_n - p_pred) @ c.T)
            return (
                jnp.where(valid, x_s, x_n),
                jnp.where(valid, p_s, p_n),
            )

        x0 = means[end]
        p0 = covs[end]
        return jax.lax.fori_loop(0, lag, body, (x0, p0))

    xs, ps = jax.vmap(smooth_at)(jnp.arange(t))
    return xs, ps


@linalg.highp
def fixed_point_smoother(f, h, r, means, covs, innovations, pred_covs, k0: int):
    """Fixed-point smoother: the streaming refinement x_{k0 | k} of ONE
    fixed past state (an injection epoch, a launch state, an anchor
    calibration instant) as measurements keep arriving — the third
    classical smoothing problem next to fixed-interval (rts_smoother)
    and fixed-lag (fixed_lag_smoother).  The reference has no smoothers
    beyond the Φ-inverse backmap (hybrid.go:209-238).

    Runs the standard augmented-state recursion without materializing
    the augmentation: carry the cross-covariance Σ_k = Cov(x_{k0}, x_k)
    and update with the filter's own innovations,

        Σ^-_k   = Σ_{k-1} Fᵀ
        B_k     = Σ^-_k Hᵀ S_k⁻¹          (fixed-point gain)
        x_{k0|k} = x_{k0|k-1} + B_k ν_k
        P_{k0|k} = P_{k0|k-1} − B_k S_k B_kᵀ
        Σ_k     = Σ^-_k (I − K_k H)ᵀ

    Inputs come straight from a `vanilla.run` trace: filtered `means`
    [T,n] / `covs` [T,n,n], `innovations` [T,p] and `pred_covs`
    [T,n,n] (Estimate.innovation / .pred_covariance).  `f`, `h`, `r`
    may be single matrices or stacked [T,...] schedules.  `k0` is the
    (0-based) index of the fixed estimate in the trace.

    Returns (x_fp [T,n], p_fp [T,n,n]) where entry k >= k0 is the
    moment pair of x_{k0} given y_{0..k}; entries before k0 pass the
    filtered trace through unchanged.  O(1) memory per step — suitable
    for streaming — and the final entry equals the fixed-interval RTS
    smoother at k0 (pinned in tests/test_smoothing.py).
    """
    t, n = means.shape
    f = jnp.broadcast_to(jnp.asarray(f), (t, n, n))
    h = jnp.asarray(h)
    h = jnp.broadcast_to(h, (t,) + h.shape[-2:])
    r = jnp.asarray(r)
    r = jnp.broadcast_to(r, (t,) + r.shape[-2:])
    eye = jnp.eye(n, dtype=means.dtype)

    def body(carry, xs):
        x_fp, p_fp, sigma = carry
        k, f_k, h_k, r_k, x_filt, p_filt, innov, p_pred = xs
        # k == k0: seed the recursion from the filtered moments.
        x0_new = jnp.where(k == k0, x_filt, x_fp)
        p0_new = jnp.where(k == k0, p_filt, p_fp)
        s0_new = jnp.where(k == k0, p_filt, sigma)
        # k > k0: innovation update of the fixed point.
        sigma_pred = sigma @ f_k.T
        s_k = h_k @ p_pred @ h_k.T + r_k
        b_gain = linalg.solve_psd(s_k, (sigma_pred @ h_k.T).T).T
        k_gain = linalg.solve_psd(s_k, (p_pred @ h_k.T).T).T
        x_upd = x_fp + b_gain @ innov
        p_upd = linalg.sym(p_fp - b_gain @ s_k @ b_gain.T)
        sigma_upd = sigma_pred @ (eye - k_gain @ h_k).T
        active = k > k0
        x_new = jnp.where(active, x_upd, x0_new)
        p_new = jnp.where(active, p_upd, p0_new)
        sigma_new = jnp.where(active, sigma_upd, s0_new)
        # Before k0 the fixed point does not exist yet: emit the
        # filtered trace so the output is total over [0, T).
        x_out = jnp.where(k < k0, x_filt, x_new)
        p_out = jnp.where(k < k0, p_filt, p_new)
        return (x_new, p_new, sigma_new), (x_out, p_out)

    init = (jnp.zeros(n, means.dtype), jnp.zeros((n, n), means.dtype),
            jnp.zeros((n, n), means.dtype))
    xs = (jnp.arange(t), f, h, r, means, covs, innovations, pred_covs)
    _, (x_fp, p_fp) = jax.lax.scan(body, init, xs)
    return x_fp, p_fp


@linalg.highp
def two_filter_smoother(phis, q, hs, rs, measurements, means, covs,
                        meas_masks=None, offsets=None):
    """Two-filter (Fraser-Potter / Mayne) fixed-interval smoother: the
    fourth classical smoother form, complementing rts_smoother (gain
    form), fixed_lag_smoother and fixed_point_smoother.  A BACKWARD
    INFORMATION filter accumulates the likelihood of the FUTURE
    measurements p(y_{k+1:T-1} | x_k) as an information pair (Λ_k, λ_k)
    — information form because that likelihood starts flat (Λ = 0 is
    representable where a covariance filter would need P = ∞) — and the
    smoothed posterior is the product with the forward filtered moments:

        backward dynamics (x_{k+1} = Φ_{k+1} x_k + b_{k+1} + w):
            B       = I + Λ_{k+1|k+1} Q
            Λ_k     = Φᵀ B⁻¹ Λ_{k+1|k+1} Φ
            λ_k     = Φᵀ B⁻¹ (λ_{k+1|k+1} − Λ_{k+1|k+1} b_{k+1})
        measurement include:  Λ_{k|k} = Λ_k + HᵀR⁻¹H,
                              λ_{k|k} = λ_k + HᵀR⁻¹ y_k
        combine (A = I + P_f Λ_k):
            x_s = A⁻¹ (x_f + P_f λ_k),   P_s = A⁻¹ P_f

    Why use it over RTS: the backward pass depends only on the model
    and data (not on the forward pass), so the two passes can run
    CONCURRENTLY on different devices and meet in the combine; and the
    combine at each k is independent — a map, not a scan.  Numerically
    it also avoids the RTS subtraction P_k − C(P_pred − P_next)Cᵀ.

    Inputs match rts_smoother (`phis[k]` maps k-1 -> k, `offsets[k]` =
    b_k, both entry 0 unused) plus the measurement model: `hs`/`rs`
    single [p,n]/[p,p] or stacked [T,...] schedules, `measurements`
    [T,p], `meas_masks` [T] bool marking steps whose measurement
    exists.  `means`/`covs` are the forward FILTERED moments
    (vanilla.run's Estimate.state/.covariance).  Returns (x_s, p_s);
    equals rts_smoother to roundoff (pinned in tests).
    """
    t, n = means.shape
    q = jnp.asarray(q)
    hs = jnp.asarray(hs)
    hs = jnp.broadcast_to(hs, (t,) + hs.shape[-2:])
    rs = jnp.asarray(rs)
    rs = jnp.broadcast_to(rs, (t,) + rs.shape[-2:])
    if meas_masks is None:
        meas_masks = jnp.ones((t,), bool)
    if offsets is None:
        offsets = jnp.zeros_like(means)
    else:
        offsets = jnp.asarray(offsets)
    phi_next = jnp.roll(phis, -1, axis=0)
    b_next = jnp.roll(offsets, -1, axis=0)
    eye = jnp.eye(n, dtype=means.dtype)

    def backward(carry, xs):
        lam_mat, lam_vec = carry  # Λ_{k+1|k+1}, λ_{k+1|k+1}
        phi_n, b_n, h_k, r_k, y_k, m_k, is_last = xs
        binv_lam = linalg.solve_qr(eye + lam_mat @ q, lam_mat)
        lam_fut = linalg.sym(phi_n.T @ binv_lam @ phi_n)
        lam_vec_fut = phi_n.T @ linalg.solve_qr(
            eye + lam_mat @ q, lam_vec - lam_mat @ b_n)
        lam_fut = jnp.where(is_last, jnp.zeros_like(lam_fut), lam_fut)
        lam_vec_fut = jnp.where(is_last, jnp.zeros_like(lam_vec_fut),
                                lam_vec_fut)
        # include this step's measurement for the NEXT (earlier) k
        rinv_h = linalg.solve_psd(r_k, h_k)
        m = m_k.astype(means.dtype)
        lam_inc = linalg.sym(lam_fut + m * h_k.T @ rinv_h)
        lam_vec_inc = lam_vec_fut + m * rinv_h.T @ y_k
        return (lam_inc, lam_vec_inc), (lam_fut, lam_vec_fut)

    is_last = jnp.arange(t) == (t - 1)
    init = (jnp.zeros((n, n), means.dtype), jnp.zeros(n, means.dtype))
    _, (lam_futs, lam_vec_futs) = jax.lax.scan(
        backward, init,
        (phi_next, b_next, hs, rs, measurements, meas_masks, is_last),
        reverse=True,
    )

    def combine(x_f, p_f, lam, lam_v):
        a = eye + p_f @ lam
        x_s = linalg.solve_qr(a, x_f + p_f @ lam_v)
        p_s = linalg.sym(linalg.solve_qr(a, p_f))
        return x_s, p_s

    return jax.vmap(combine)(means, covs, lam_futs, lam_vec_futs)
