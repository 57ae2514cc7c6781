r"""Gaussian-mixture CPHD filter (Vo, Vo & Cantoni 2007): the
cardinalized PHD — a full posterior DISTRIBUTION over the target
count, not just its mean.

The GM-PHD (filters/phd.py) propagates only the first moment of the
multi-target posterior; its cardinality estimate Σw is a Poisson-like
mean with variance ≈ mean, so a single missed detection at high PD
collapses a target's weight by (1−PD) for a frame (the documented
dip).  The CPHD additionally propagates the cardinality pmf ρ(n) and
couples it to the intensity through the exact IID-cluster-process
update — the count estimate averages over the WHOLE pmf, making it
dramatically steadier (pinned: the PHD's single-frame dips to ~0.05
expected targets become ≥0.9 MAP-correct frames here).

Recursion (Vo-Vo-Cantoni eqs. 13-16, Poisson clutter λc·c(z), uniform
c = 1/V):

  predict   intensity: survivors + birth (as PHD)
            ρ⁻ = (binomial ps-thinning of ρ) ⊛ Poisson(μ_birth)
  update    Ξ_z = PD Σᵢ wᵢ qᵢ(z) / c(z)          (per-measurement mass)
            Υᵘ(n) = Σⱼ λc^{|Z|−j} · n!/(n−j−u)! · (1−PD)^{n−j−u}
                          · ⟨1,w⟩^{−(j+u)} · eⱼ(Ξ)
            ρ(n) ∝ Υ⁰(n) ρ⁻(n)
            w_miss,i = wᵢ (1−PD) ⟨Υ¹[Z], ρ⁻⟩/⟨Υ⁰[Z], ρ⁻⟩
            w_det,i(z) = wᵢ PD qᵢ(z)/c(z) ⟨Υ¹[Z\{z}], ρ⁻⟩/⟨Υ⁰[Z], ρ⁻⟩

(The ⟨1,w⟩ powers inside Υ make the posterior intensity integrate to
the posterior mean count exactly — note this identity does NOT pin the
clutter convention (it is invariant to rescaling Ξ by 1/λc against the
λc^{|Z|−j} power — a review pass proved the first version exploited
exactly that blind spot); the cardinality pmf is therefore pinned
against EXACT brute-force multi-target Bayes in tests.)  eⱼ = elementary symmetric
functions, computed by the masked polynomial-product recursion, with
the leave-one-out values recomputed per measurement (m_max is small).

Static-shape design: everything the PHD does (fixed mixture slots, padded
[m_max, p] frames + where-masks, Runnalls merging) plus a static
[n_max+1] cardinality vector; Υ is one [n, j] logsumexp grid.  Model
carries static config — close over it when jitting (the phd/tracker
convention).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from . import gsf, vanilla


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: jax.Array
    p_detect: jax.Array
    clutter_rate: jax.Array  # [] λc: expected clutter count per frame
    clutter_pdf: jax.Array  # [] c(z): uniform spatial density 1/V
    birth_w: jax.Array  # [Jb]
    birth_m: jax.Array  # [Jb, n]
    birth_p: jax.Array  # [Jb, n, n]
    n_max: int  # static cardinality support cap
    j_max: int  # static mixture cap
    trunc: float
    adaptive_birth_w: float  # static: per-measurement birth weight (0 = off)
    merge_dist: float  # static Mahalanobis^2 cluster-merge threshold
    h_pinv: jax.Array  # [n, p]


class State(NamedTuple):
    w: jax.Array  # [j_max] intensity weights
    m: jax.Array  # [j_max, n]
    p: jax.Array  # [j_max, n, n]
    rho: jax.Array  # [n_max + 1] cardinality pmf
    k: jax.Array


class Estimate(NamedTuple):
    cardinality_mean: jax.Array  # [] Σ n ρ(n)
    cardinality_map: jax.Array  # [] argmax ρ
    cardinality_pmf: jax.Array  # [n_max + 1]
    weights: jax.Array  # [j_max] sorted descending
    states: jax.Array  # [j_max, n]
    covariances: jax.Array  # [j_max, n, n]


def new(f, g, h, noise: Noise, birth_w, birth_m, birth_p,
        p_survival: float = 0.99, p_detect: float = 0.9,
        clutter_rate: float = 1.0, volume: float = 1.0,
        n_max: int = 16, j_max: int = 32, trunc: float = 1e-5,
        adaptive_birth_w: float = 0.0, merge_dist: float = 4.0):
    """Build (Model, State) with an empty intensity and ρ = δ₀.
    `clutter_rate` is λc (expected clutter per frame, MUST be > 0);
    `volume` the surveillance volume (uniform clutter density 1/V).

    `adaptive_birth_w` > 0 births a component at every valid detection
    AFTER the update (the phd.py convention/ordering) — and, unlike the
    plain PHD, the cardinality pmf is simultaneously convolved with the
    matching Poisson(w·|Z|) so the intensity-mass == mean-count
    identity KEEPS holding (independent Poisson birth adds in intensity
    and convolves in cardinality; pinned in tests)."""
    if not clutter_rate > 0:
        raise ValueError("CPHD needs clutter_rate > 0 (the update "
                         "divides by the clutter intensity)")
    birth_m = jnp.asarray(birth_m)
    birth_p = jnp.asarray(birth_p)
    birth_w = jnp.asarray(birth_w)
    if birth_m.ndim != 2:
        raise ValueError(f"birth_m must be [Jb, n] (got {birth_m.shape})")
    jb, n = birth_m.shape
    if birth_w.shape != (jb,) or birth_p.shape != (jb, n, n):
        raise ValueError("birth_w/birth_p shapes must match birth_m")
    kf_model, _ = vanilla.new(jnp.zeros(n, birth_m.dtype), jnp.eye(n),
                              f, g, h, noise)
    dt = birth_m.dtype
    model = Model(kf_model, jnp.asarray(p_survival, dt),
                  jnp.asarray(p_detect, dt),
                  jnp.asarray(clutter_rate, dt),
                  jnp.asarray(1.0 / volume, dt),
                  birth_w, birth_m, birth_p, int(n_max), int(j_max),
                  float(trunc), float(adaptive_birth_w), float(merge_dist),
                  jnp.linalg.pinv(kf_model.h).astype(dt))
    rho0 = jnp.zeros((n_max + 1,), dt).at[0].set(1.0)
    state = State(jnp.zeros((j_max,), dt), jnp.zeros((j_max, n), dt),
                  jnp.broadcast_to(jnp.eye(n, dtype=dt), (j_max, n, n)),
                  rho0, jnp.int32(0))
    return model, state


def _masked_esf(xi, valid):
    """Elementary symmetric functions of the VALID entries of xi [M]
    (invalid entries absent, not zero), returned SCALED: (e_j / s^j,
    log s) with s = max(xi, 1) — e_j itself is ~xi^j and overflows
    float32 past xi ~ 6e4 at j = 8 (tight-R / large-volume scenes);
    the scaled values are bounded by C(M, j)."""
    m = xi.shape[0]
    s = jnp.maximum(jnp.max(jnp.where(valid, xi, 0.0)), 1.0)
    xs = xi / s
    e = jnp.zeros((m + 1,), xi.dtype).at[0].set(1.0)

    def body(i, e):
        shifted = jnp.concatenate([jnp.zeros((1,), xi.dtype), e[:-1]])
        return jnp.where(valid[i], e + xs[i] * shifted, e)

    return jax.lax.fori_loop(0, m, body, e), jnp.log(s)


def _log_upsilon(model: Model, esf_scaled, log_scale, n_valid,
                 log_sum_w, u: int):
    """log Υ^u(n) for n = 0..n_max over the esf of a measurement set
    with n_valid entries (Poisson clutter: (|Z|−j)! p_K(|Z|−j) =
    e^{−λc} λc^{|Z|−j}; the e^{−λc} cancels in every ratio and is
    dropped)."""
    dt = esf_scaled.dtype
    n_max = model.n_max
    mmax = esf_scaled.shape[0] - 1
    ns = jnp.arange(n_max + 1, dtype=dt)[:, None]  # [n, 1]
    js = jnp.arange(mmax + 1, dtype=dt)[None, :]  # [1, j]
    log_lam = jnp.log(model.clutter_rate)
    log_1mpd = jnp.log(jnp.maximum(1.0 - model.p_detect, 1e-300))
    expo = ns - js - u  # exponent of (1−PD)
    perm = jax.scipy.special.gammaln(ns + 1.0) - \
        jax.scipy.special.gammaln(jnp.maximum(expo, 0.0) + 1.0)
    log_e = (jnp.log(jnp.maximum(esf_scaled, 1e-300))
             + jnp.arange(mmax + 1, dtype=dt) * log_scale)[None, :]
    terms = ((n_valid.astype(dt) - js) * log_lam + perm
             + jnp.where(expo > 0, expo * log_1mpd, 0.0)
             - (js + u) * log_sum_w + log_e)
    ok = (js <= n_valid.astype(dt)) & (expo >= 0)
    terms = jnp.where(ok, terms, -jnp.inf)
    return jax.scipy.special.logsumexp(terms, axis=1)  # [n_max + 1]


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One GM-CPHD frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.w.dtype
    n = state.m.shape[1]
    m_max, p_dim = jnp.asarray(candidates).shape
    mask = jnp.asarray(cand_mask, bool)
    n_valid = jnp.sum(mask.astype(jnp.int32))

    # ---- intensity prediction (as PHD)
    w_pred = jnp.concatenate([model.p_survival * state.w, model.birth_w])
    m_pred = jnp.concatenate([state.m @ kf.f.T, model.birth_m], axis=0)
    p_surv = jnp.einsum("ij,kjl,ml->kim", kf.f, state.p, kf.f) \
        + kf.noise.q[None]
    p_pred = jnp.concatenate([p_surv, model.birth_p], axis=0)
    jp = w_pred.shape[0]

    # ---- cardinality prediction: binomial ps-thinning ⊛ Poisson birth
    nmax = model.n_max
    ls = jnp.arange(nmax + 1, dtype=dt)
    log_binom = (jax.scipy.special.gammaln(ls[:, None] + 1.0)
                 - jax.scipy.special.gammaln(ls[None, :] + 1.0)
                 - jax.scipy.special.gammaln(
                     jnp.maximum(ls[:, None] - ls[None, :], 0.0) + 1.0))
    log_ps = jnp.log(jnp.maximum(model.p_survival, 1e-300))
    log_1mps = jnp.log(jnp.maximum(1.0 - model.p_survival, 1e-300))
    lj = ls[:, None] - ls[None, :]  # l - j
    thin = jnp.where(
        ls[None, :] <= ls[:, None],
        jnp.exp(log_binom + ls[None, :] * log_ps
                + jnp.where(lj > 0, lj * log_1mps, 0.0)),
        0.0)  # [l, j]
    rho_surv = state.rho @ thin  # [j]
    mu_b = jnp.sum(model.birth_w)
    log_pb = -mu_b + ls * jnp.log(jnp.maximum(mu_b, 1e-300)) \
        - jax.scipy.special.gammaln(ls + 1.0)
    p_b = jnp.exp(log_pb)
    rho_pred = jnp.convolve(rho_surv, p_b)[:nmax + 1]
    rho_pred = rho_pred / jnp.maximum(jnp.sum(rho_pred), 1e-300)

    # ---- per-(component, measurement) Gaussian likelihoods
    eta = m_pred @ kf.h.T

    def geom(p_i):
        s = linalg.sym(kf.h @ p_i @ kf.h.T + kf.noise.r)
        k_g = linalg.solve_psd(s, (p_i @ kf.h.T).T).T
        p_u = vanilla.joseph_update(p_i, k_g, kf.h, kf.noise.r)
        _, logdet = jnp.linalg.slogdet(s)
        return k_g, p_u, s, logdet

    k_all, p_upd, s_all, logdets = jax.vmap(geom)(p_pred)
    diffs = jnp.asarray(candidates)[None, :, :] - eta[:, None, :]
    diffs = jnp.where(mask[None, :, None], diffs, 0.0)  # NaN-safe padding
    sol = jax.vmap(lambda s, d: linalg.solve_psd(s, d.T).T)(s_all, diffs)
    d2 = jnp.sum(diffs * sol, axis=2)
    log_q = (-0.5 * d2 - 0.5 * logdets[:, None]
             - 0.5 * p_dim * math.log(2 * math.pi))  # [Jp, m]

    # ---- Ξ, esf, Υ
    sum_w = jnp.maximum(jnp.sum(w_pred), 1e-300)
    log_sum_w = jnp.log(sum_w)
    log_mass = jax.scipy.special.logsumexp(
        jnp.log(jnp.maximum(w_pred, 1e-300))[:, None] + log_q, axis=0)
    # psi_z = PD <w, q_z> / c(z): divide by the clutter spatial pdf
    # ONLY — Upsilon already carries the lambda_c^(|Z|-j) cardinality
    # factor; dividing by lambda_c here too double-counts it (verified
    # against exact brute-force Bayes: the buggy version biased E[n]
    # low by 0.27 targets at lambda_c=3 while still passing the
    # mass==mean identity, which is provably blind to this constant).
    log_xi = (jnp.log(model.p_detect) + log_mass
              - jnp.log(model.clutter_pdf))
    xi = jnp.where(mask, jnp.exp(log_xi), 0.0)  # [m]
    esf_full, log_s_full = _masked_esf(xi, mask)
    # leave-one-out esf per measurement
    idx = jnp.arange(m_max)
    esf_loo, log_s_loo = jax.vmap(
        lambda z: _masked_esf(xi, mask & (idx != z)))(idx)  # [m, m+1]

    ups0 = _log_upsilon(model, esf_full, log_s_full, n_valid,
                        log_sum_w, 0)
    ups1 = _log_upsilon(model, esf_full, log_s_full, n_valid,
                        log_sum_w, 1)
    # leave-one-out sets have n_valid - 1 measurements
    ups1_loo = jax.vmap(lambda e, lg: _log_upsilon(
        model, e, lg, n_valid - 1, log_sum_w, 1))(
            esf_loo, log_s_loo)  # [m, n+1]

    log_rho_pred = jnp.log(jnp.maximum(rho_pred, 1e-300))
    log_den = jax.scipy.special.logsumexp(ups0 + log_rho_pred)
    log_miss_ratio = jax.scipy.special.logsumexp(ups1 + log_rho_pred) \
        - log_den
    log_det_ratio = jax.scipy.special.logsumexp(
        ups1_loo + log_rho_pred[None, :], axis=1) - log_den  # [m]

    # ---- posterior cardinality
    log_rho = ups0 + log_rho_pred
    rho = jnp.exp(log_rho - jax.scipy.special.logsumexp(log_rho))
    rho = rho / jnp.sum(rho)

    # ---- posterior intensity
    w_miss = w_pred * (1.0 - model.p_detect) * jnp.exp(log_miss_ratio)
    logw_det = (jnp.log(jnp.maximum(w_pred, 1e-300))[:, None]
                + jnp.log(model.p_detect) + log_q
                - jnp.log(model.clutter_pdf)
                + log_det_ratio[None, :])
    w_det = jnp.where(mask[None, :], jnp.exp(logw_det), 0.0)
    m_det = m_pred[:, None, :] + jnp.einsum("inp,imp->imn", k_all, diffs)

    w_all = jnp.concatenate([w_miss, w_det.reshape(-1)])
    m_all = jnp.concatenate([m_pred, m_det.reshape(jp * m_max, n)], axis=0)
    p_all = jnp.concatenate(
        [p_pred, jnp.broadcast_to(p_upd[:, None], (jp, m_max, n, n))
         .reshape(jp * m_max, n, n)], axis=0)
    if model.adaptive_birth_w > 0.0:
        # post-update measurement-driven births (phd.py ordering), with
        # the cardinality pmf convolved by the matching Poisson so the
        # intensity-mass == mean-count identity survives
        mask_f = mask.astype(dt)
        zb = jnp.where(mask[:, None], jnp.asarray(candidates), 0.0)
        m_ab = zb @ model.h_pinv.T
        w_ab = model.adaptive_birth_w * mask_f
        p_ab = jnp.broadcast_to(model.birth_p[0],
                                (m_max,) + model.birth_p[0].shape)
        w_all = jnp.concatenate([w_all, w_ab])
        m_all = jnp.concatenate([m_all, m_ab], axis=0)
        p_all = jnp.concatenate([p_all, p_ab], axis=0)
        mu_ab = jnp.sum(w_ab)
        log_pab = (-mu_ab + ls * jnp.log(jnp.maximum(mu_ab, 1e-300))
                   - jax.scipy.special.gammaln(ls + 1.0))
        rho = jnp.convolve(rho, jnp.exp(log_pab))[:nmax + 1]
        rho = rho / jnp.maximum(jnp.sum(rho), 1e-300)

    # ---- truncate + merge back to j_max (total weight restored)
    w_all = jnp.where(w_all > model.trunc, w_all, 0.0)
    m_red, p_red, w_red = gsf.cluster_reduce(
        m_all, p_all, w_all, model.j_max, model.merge_dist)
    order = jnp.argsort(-w_red)
    w_red, m_red, p_red = w_red[order], m_red[order], p_red[order]

    card_mean = jnp.sum(jnp.arange(nmax + 1, dtype=dt) * rho)
    est = Estimate(
        cardinality_mean=card_mean,
        cardinality_map=jnp.argmax(rho).astype(jnp.int32),
        cardinality_pmf=rho,
        weights=w_red,
        states=m_red,
        covariances=p_red,
    )
    return State(w_red, m_red, p_red, rho, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks):
    """lax.scan over [T, m_max, p] frames."""

    def body(carry, xs):
        cands, mask = xs
        return step(model, carry, cands, mask)

    return jax.lax.scan(body, state,
                        (jnp.asarray(candidates), jnp.asarray(cand_masks)))
