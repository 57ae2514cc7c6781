"""Gaussian-mixture PHD filter (Vo & Ma 2006): multi-target tracking
with an UNKNOWN, TIME-VARYING number of targets as first-class
uncertainty.

Where `tracker` manages explicit track identities with M/N heuristics
and `jpda` assumes a KNOWN target count, the PHD (probability
hypothesis density) filter propagates the first moment of the random-
finite-set multi-target posterior — an intensity function over state
space whose integral IS the expected target count.  With linear-
Gaussian single-target models, Gaussian births, and constant
survival/detection probabilities, the intensity stays a Gaussian
mixture with CLOSED-FORM prediction/update (Vo-Ma Table I-II):

    predict:  survivors w ps, (F m, F P Fᵀ + Q)  +  the birth mixture
    update:   missed terms (1−PD) w  plus, per measurement z,
              components  w_i PD N(z; Hm_i, S_i) / (κ + Σ_i' ...)
              at the Kalman-updated (m_ij, P_i)

Static-shape design: a FIXED bank of j_max mixture slots (weight 0 = unused
— the weights are UNNORMALIZED, their sum is the cardinality estimate);
measurements arrive as the library's padded [m_max, p] frames with
masks; the post-update (j_max + j_birth)(1 + m_max)-component mixture
is truncated and cluster-merged back to j_max by gsf.cluster_reduce
(the Vo & Ma 2006 Table-II merge: heaviest-seed Mahalanobis clusters,
moment-matched, total weight restored — O(j_max·M), no [M,M] pairwise
tensor; the Runnalls pairwise merge compiles in minutes at scene-bank
scale).
One lax.scan over frames, no data-dependent shapes anywhere.

NOTE Model carries static config (j_max, trunc): when jitting, close
over the model (jax.jit(lambda fr, ma: phd.run(model, state, fr, ma)))
rather than passing it as a traced argument — the tracker/mhe
convention for config-carrying models.
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
    p_survival: jax.Array  # []
    p_detect: jax.Array  # []
    clutter: jax.Array  # [] clutter intensity κ (per unit volume)
    birth_w: jax.Array  # [Jb] birth intensity weights
    birth_m: jax.Array  # [Jb, n]
    birth_p: jax.Array  # [Jb, n, n]
    j_max: int  # static mixture cap
    trunc: float  # static truncation threshold on weights
    adaptive_birth_w: float  # static: per-measurement birth weight (0 = off)
    merge_dist: float  # static Mahalanobis^2 cluster-merge threshold
    h_pinv: jax.Array  # [n, p] measurement pseudo-inverse (birth seed)


class State(NamedTuple):
    w: jax.Array  # [j_max] unnormalized weights (sum = E[#targets])
    m: jax.Array  # [j_max, n]
    p: jax.Array  # [j_max, n, n]
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    cardinality: jax.Array  # [] sum of weights
    weights: jax.Array  # [j_max] sorted descending
    states: jax.Array  # [j_max, n] sorted by weight
    covariances: jax.Array  # [j_max, n, n]
    n_extracted: jax.Array  # [] components with weight > 0.5


def new(f, g, h, noise: Noise, birth_w, birth_m, birth_p,
        p_survival: float = 0.99, p_detect: float = 0.9,
        clutter: float = 1e-3, j_max: int = 32, trunc: float = 1e-5,
        adaptive_birth_w: float = 0.0, merge_dist: float = 4.0):
    """Build (Model, State) with an EMPTY initial intensity.  The birth
    mixture (weights/covs/means, [Jb]-stacked) is injected every frame
    — put components where targets appear (sensor horizon, runway,
    launch sites) with birth_w = expected births/frame per component.

    `adaptive_birth_w` > 0 additionally births a component AT EVERY
    VALID MEASUREMENT (mean = pinv(H) z, covariance = birth_p[0]) with
    that weight — the standard measurement-driven birth for targets
    appearing at UNKNOWN locations (where a fixed birth mixture never
    acquires; pinned in tests).  Count it toward the clutter rate when
    tuning: each clutter point also births a (short-lived) component.

    `merge_dist` is the squared-Mahalanobis cluster radius of the
    Vo & Ma merge (U in their Table II; 4.0 = 2 sigma in the seed's
    own covariance is the literature default)."""
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
                  jnp.asarray(p_detect, dt), jnp.asarray(clutter, dt),
                  birth_w, birth_m, birth_p, int(j_max), float(trunc),
                  float(adaptive_birth_w), float(merge_dist),
                  jnp.linalg.pinv(kf_model.h).astype(dt))
    state = State(jnp.zeros((j_max,), dt),
                  jnp.zeros((j_max, n), dt),
                  jnp.broadcast_to(jnp.eye(n, dtype=dt), (j_max, n, n)),
                  jnp.int32(0))
    return model, state


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One GM-PHD frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.w.dtype
    n = state.m.shape[1]
    m_max, p_dim = jnp.asarray(candidates).shape

    # ---- prediction: survivors + births (+ measurement-driven births)
    w_pred = jnp.concatenate([model.p_survival * state.w, model.birth_w])
    m_surv = state.m @ kf.f.T
    p_surv = jnp.einsum("ij,kjl,ml->kim", kf.f, state.p, kf.f) \
        + kf.noise.q[None]
    m_pred = jnp.concatenate([m_surv, model.birth_m], axis=0)
    p_pred = jnp.concatenate([p_surv, model.birth_p], axis=0)
    jp = w_pred.shape[0]

    # ---- per-component measurement geometry
    eta = m_pred @ kf.h.T  # [Jp, p]

    def geom(p_i):
        s = linalg.sym(kf.h @ p_i @ kf.h.T + kf.noise.r)
        k_g = linalg.solve_psd(s, (p_i @ kf.h.T).T).T
        p_u = vanilla.joseph_update(p_i, k_g, kf.h, kf.noise.r)
        _, logdet = jnp.linalg.slogdet(s)
        return s, k_g, p_u, logdet

    s_all, k_all, p_upd, logdets = jax.vmap(geom)(p_pred)

    # ---- detection terms: log q_ij = log N(z_j; eta_i, S_i)
    diffs = jnp.asarray(candidates)[None, :, :] - eta[:, None, :]  # [Jp,m,p]
    sol = jax.vmap(lambda s, d: linalg.solve_psd(s, d.T).T)(s_all, diffs)
    d2 = jnp.sum(diffs * sol, axis=2)  # [Jp, m]
    log_q = (-0.5 * d2 - 0.5 * logdets[:, None]
             - 0.5 * p_dim * math.log(2 * math.pi))
    logw_det = jnp.log(jnp.maximum(model.p_detect * w_pred, 1e-300))[:, None] \
        + log_q  # [Jp, m]
    # NaN-safe masking: padded candidate slots may hold NaN/garbage —
    # jnp.where (not a multiply: NaN*0 = NaN) on both the weights and
    # the updated means, the jpda/pdaf convention.
    mask = jnp.asarray(cand_mask, bool)[None, :]
    logw_det = jnp.where(mask, logw_det, -jnp.inf)
    # per-measurement normalizer κ + Σ_i exp(logw_det)
    denom = model.clutter + jnp.exp(
        jax.scipy.special.logsumexp(logw_det, axis=0))  # [m]
    w_det = jnp.where(mask, jnp.exp(logw_det) / denom[None, :], 0.0)
    m_det = m_pred[:, None, :] + jnp.einsum(
        "inp,imp->imn", k_all, jnp.where(mask[..., None], diffs, 0.0))

    # ---- stack miss + detection components
    w_miss = (1.0 - model.p_detect) * w_pred
    w_all = jnp.concatenate([w_miss, w_det.reshape(-1)])
    m_all = jnp.concatenate([m_pred, m_det.reshape(jp * m_max, n)], axis=0)
    p_all = jnp.concatenate(
        [p_pred, jnp.broadcast_to(p_upd[:, None], (jp, m_max, n, n))
         .reshape(jp * m_max, n, n)], axis=0)
    if model.adaptive_birth_w > 0.0:
        # Measurement-driven births join AFTER the update (the Ristic
        # 2012 convention): a component born from this frame's z must
        # NOT be updated by that same z — same-frame confirmation gives
        # every CLUTTER point an instant ~0.5-weight component
        # (measured: 3.1 expected targets for a 1-target scene before
        # this ordering fix).  Next frame's detections confirm or kill.
        mask_f = jnp.asarray(cand_mask, dt)
        zb = jnp.where(jnp.asarray(cand_mask, bool)[:, None],
                       jnp.asarray(candidates), 0.0)
        m_ab = zb @ model.h_pinv.T  # [m_max, n]
        w_ab = model.adaptive_birth_w * mask_f
        p_ab = jnp.broadcast_to(model.birth_p[0],
                                (m_max,) + model.birth_p[0].shape)
        w_all = jnp.concatenate([w_all, w_ab])
        m_all = jnp.concatenate([m_all, m_ab], axis=0)
        p_all = jnp.concatenate([p_all, p_ab], axis=0)

    # ---- truncate, merge back to j_max, restore the total weight
    w_all = jnp.where(w_all > model.trunc, w_all, 0.0)
    total = jnp.sum(w_all)
    m_red, p_red, w_red = gsf.cluster_reduce(
        m_all, p_all, w_all, model.j_max, model.merge_dist)

    # sort by weight descending for stable extraction
    order = jnp.argsort(-w_red)
    w_red, m_red, p_red = w_red[order], m_red[order], p_red[order]

    est = Estimate(
        cardinality=total,
        weights=w_red,
        states=m_red,
        covariances=p_red,
        n_extracted=jnp.sum((w_red > 0.5).astype(jnp.int32)),
    )
    return State(w_red, m_red, p_red, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks):
    """lax.scan over [T, m_max, p] frames."""

    def body(carry, xs):
        cands, mask = xs
        return step(model, carry, cands, mask)

    return jax.lax.scan(body, state,
                        (jnp.asarray(candidates), jnp.asarray(cand_masks)))
