"""Labeled multi-Bernoulli (LMB) filter: the labeled-RFS tracker.

Completes the labeled random-finite-set tier above `pmb`: the LMB
filter (Reuter, Vo, Vo & Dietmayer 2014, "The labeled multi-Bernoulli
filter") propagates a multi-target posterior of labeled Bernoulli
components

    { (r_l, p_l(x)) : l in L },   label l = (birth frame, birth slot)

with NO Poisson component — every target, including undiscovered ones,
is an explicit labeled track hypothesis seeded by the birth model.  It
is the single-hypothesis marginalization of the delta-GLMB filter: the
delta-GLMB update produces a weighted set of global hypotheses, and
the LMB filter collapses them to per-label existence/association
MARGINALS after every update (Reuter 2014 §IV; the same
match-then-marginalize structure as `pmb`'s TOMB/P step but with
labeled Bernoulli birth instead of a Poisson birth intensity).

Association marginals (track i claims measurement j, or nothing):

    l_i(0) = 1 - r_i PD              (dead, or alive and missed)
    l_i(j) = r_i PD N(z_j; Hx_i, S_i) / kappa      (alive, detected)

over one-to-one joint events.  Two backends:

  assoc="exact"  enumerates the joint events host-side at new() into a
      static table (the `jpda` idiom; guard ~500k rows) and
      marginalizes EXACTLY — this makes the filter pin digit-level
      against brute-force labeled multi-target Bayes in tests.
  assoc="bp"     Williams-Lau belief propagation (`pmb.bp_marginals`),
      O(iters * t_max * m_max), for scenes past the factorial guard.

Per-label Bernoulli posterior (exact given the marginals):

    r'   = beta_0 * r(1-PD)/(1 - r PD) + sum_j beta_j
    p'(x)= [beta_0 * r(1-PD)/(1-r PD) * predicted
            + sum_j beta_j * KF-updated_j] / r'   (moment-matched)

Moment matching preserves the mixture's mean/covariance exactly, so
the brute-force pins check r, mean AND covariance digit-level.

Static-shape design: t_max static labeled track slots (r == 0 marks empty),
padded [m_max, p] frames + masks, births injected at PREDICT into the
slot pool with a top-t_max existence sort (adaptive measurement-driven
birth optionally post-update, the Ristic ordering validated in
phd/cphd).  Labels ride integer (birth_frame, birth_slot) pairs through
every sort, like `pmb`.

No reference counterpart (the reference stops at single-target
filters); shared-machinery anchors: vanilla.go:160 (Joseph update),
the jpda/pdaf padded-frame conventions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from . import vanilla
from .jpda import _enumerate_events
from .pmb import _mixture_moments, bp_marginals


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: jax.Array
    p_detect: jax.Array
    clutter: jax.Array  # clutter density kappa (per unit volume)
    gate: jax.Array  # chi-square gate on d^2 (inf disables)
    birth_r: jax.Array  # [Jb]
    birth_m: jax.Array  # [Jb, n]
    birth_p: jax.Array  # [Jb, n, n]
    t_max: int
    r_prune: float
    assoc: str  # "exact" | "bp"
    bp_iters: int
    events: jax.Array  # [n_events, t_max] (exact mode; [1,1] dummy)
    event_onehot: jax.Array  # [n_events, t_max, m_max+1]
    adaptive_birth_r: float
    h_pinv: jax.Array


class State(NamedTuple):
    r: jax.Array  # [t_max] existence (0 == empty slot)
    m: jax.Array  # [t_max, n]
    p: jax.Array  # [t_max, n, n]
    labels: jax.Array  # [t_max, 2] int32 (birth frame, birth slot)
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    n_targets: jax.Array  # [] sum of existence
    existence: jax.Array  # [t_max] sorted descending
    states: jax.Array  # [t_max, n] sorted by existence
    covariances: jax.Array  # [t_max, n, n]
    labels: jax.Array  # [t_max, 2] sorted with their tracks
    n_confirmed: jax.Array  # [] tracks with r > 0.5
    # association marginals (col 0 = claims nothing), permuted to the
    # sorted track order above
    assoc: jax.Array  # [t_max, m_max + 1]


def new(f, g, h, noise: Noise, birth_r, birth_m, birth_p, m_max: int,
        p_survival: float = 0.99, p_detect: float = 0.9,
        clutter: float = 1e-3, gate: float = 16.0, t_max: int = 8,
        r_prune: float = 1e-3, assoc: str = "exact", bp_iters: int = 20,
        adaptive_birth_r: float = 0.0):
    """Build (Model, State) with an empty track table.

    `birth_*` is the labeled Bernoulli birth model ([Jb]-stacked
    existence/means/covs) injected every frame at prediction; size
    `t_max` to confirmed targets + births + a few tentatives.  `m_max`
    (static) is the padded per-frame candidate count.

    `assoc="exact"` builds the joint-event table host-side (factorial
    in (t_max, m_max); the same 500k guard as jpda) — exact marginals.
    `assoc="bp"` runs Williams-Lau BP instead (exact on trees, tight
    in general; pinned <= 0.05 vs exact in tests).

    `adaptive_birth_r` > 0 additionally births a track at every valid
    measurement post-update with existence `adaptive_birth_r * u_j`
    where u_j is the marginal probability that NO existing track
    claimed z_j (Ristic et al. 2012 measurement-driven birth; the
    post-update ordering validated for phd/cphd — same-frame
    confirmation measurably over-births).  Its labels use birth slot
    Jb + j so fixed and adaptive births cannot collide."""
    birth_m = jnp.asarray(birth_m)
    birth_p = jnp.asarray(birth_p)
    birth_r = jnp.asarray(birth_r)
    if birth_m.ndim != 2:
        raise ValueError(f"birth_m must be [Jb, n] (got {birth_m.shape})")
    jb, n = birth_m.shape
    if birth_r.shape != (jb,) or birth_p.shape != (jb, n, n):
        raise ValueError("birth_r/birth_p shapes must match birth_m")
    if jb > t_max:
        raise ValueError(f"t_max={t_max} must hold the {jb} birth slots")
    if assoc not in ("exact", "bp"):
        raise ValueError(f"assoc must be 'exact' or 'bp' (got {assoc!r})")
    kf_model, _ = vanilla.new(jnp.zeros(n, birth_m.dtype), jnp.eye(n),
                              f, g, h, noise)
    dt = birth_m.dtype
    if assoc == "exact":
        n_events = sum(
            math.comb(t_max, k) * math.perm(m_max, k)
            for k in range(min(t_max, m_max) + 1))
        if n_events > 500_000:
            raise ValueError(
                f"exact LMB event table would have {n_events} rows for "
                f"{t_max} slots x {m_max} candidates; use assoc='bp' "
                "or shrink t_max")
        import numpy as np

        events = _enumerate_events(t_max, m_max)
        onehot = np.zeros((events.shape[0], t_max, m_max + 1), np.float32)
        np.put_along_axis(onehot, events[:, :, None], 1.0, axis=2)
        events_j = jnp.asarray(events)
        onehot_j = jnp.asarray(onehot, dt)
    else:
        events_j = jnp.zeros((1, 1), jnp.int32)
        onehot_j = jnp.zeros((1, 1, 1), dt)
    model = Model(kf_model, jnp.asarray(p_survival, dt),
                  jnp.asarray(p_detect, dt), jnp.asarray(clutter, dt),
                  jnp.asarray(gate, dt), birth_r, birth_m, birth_p,
                  int(t_max), float(r_prune), assoc, int(bp_iters),
                  events_j, onehot_j, float(adaptive_birth_r),
                  jnp.linalg.pinv(kf_model.h).astype(dt))
    state = State(
        jnp.zeros((t_max,), dt),
        jnp.zeros((t_max, n), dt),
        jnp.broadcast_to(jnp.eye(n, dtype=dt), (t_max, n, n)),
        jnp.full((t_max, 2), -1, jnp.int32),
        jnp.int32(0))
    return model, state


def cardinality_pmf(existence) -> jax.Array:
    """Exact multi-Bernoulli cardinality pmf (a Poisson-binomial): the
    [t_max + 1] distribution of the number of targets given per-track
    existence probabilities.  O(t_max^2) dynamic program, jit-safe.
    Identities pinned in tests: sum_k k pmf_k == sum_i r_i exactly."""
    r = jnp.asarray(existence)
    t = r.shape[0]

    def body(pmf, ri):
        shifted = jnp.concatenate([jnp.zeros((1,), pmf.dtype), pmf[:-1]])
        return (1.0 - ri) * pmf + ri * shifted, None

    pmf0 = jnp.zeros((t + 1,), r.dtype).at[0].set(1.0)
    pmf, _ = jax.lax.scan(body, pmf0, r)
    return pmf


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One LMB frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.r.dtype
    n = state.m.shape[1]
    candidates = jnp.asarray(candidates)
    m_max, p_dim = candidates.shape
    mask = jnp.asarray(cand_mask, bool)
    tiny = 1e-300 if dt == jnp.float64 else 1e-30
    jb = model.birth_r.shape[0]

    # ---- predict: survivors + labeled birth, top-t_max by existence
    r_all = jnp.concatenate([model.p_survival * state.r, model.birth_r])
    m_all = jnp.concatenate([state.m @ kf.f.T, model.birth_m], axis=0)
    p_all = jnp.concatenate(
        [jnp.einsum("ij,kjl,ml->kim", kf.f, state.p, kf.f)
         + kf.noise.q[None], model.birth_p], axis=0)
    lab_birth = jnp.stack(
        [jnp.full((jb,), state.k, jnp.int32),
         jnp.arange(jb, dtype=jnp.int32)], axis=1)
    lab_all = jnp.concatenate([state.labels, lab_birth], axis=0)
    order = jnp.argsort(-r_all)[:model.t_max]
    r_pred = r_all[order]
    m_pred = m_all[order]
    p_pred = p_all[order]
    labels = jnp.where((r_pred > 0)[:, None], lab_all[order], -1)
    # births are NOT KF-predicted in their birth frame (they enter the
    # update directly from the birth prior) — pmb's convention; the
    # single-target KF-parity test seeds its comparison filter
    # accordingly.

    # ---- measurement geometry per slot (jpda idiom, NaN-safe padding)
    def geom(x_pred, p_i):
        pht = p_i @ kf.h.T
        s = linalg.sym(kf.h @ pht + kf.noise.r)
        k_g = linalg.solve_psd(s, pht.T).T
        nus = candidates - x_pred @ kf.h.T  # [m, p]
        sinv_nus = linalg.solve_psd(s, nus.T).T
        d2 = jnp.sum(nus * sinv_nus, axis=1)  # [m]
        _, logdet = jnp.linalg.slogdet(s)
        # zero padded rows AFTER d2: their beta is exactly 0 but
        # 0 * NaN = NaN downstream (poison-fuzz rule)
        nus = jnp.where(mask[:, None], nus, 0.0)
        p_u = vanilla.joseph_update(p_i, k_g, kf.h, kf.noise.r)
        return s, k_g, nus, d2, logdet, p_u

    s_t, k_t, nus_t, d2_t, ld_t, pu_t = jax.vmap(geom)(m_pred, p_pred)

    valid = mask[None, :] & (d2_t <= model.gate) & (r_pred > 0)[:, None]
    log_norm = -0.5 * (ld_t + p_dim * jnp.log(jnp.asarray(
        2 * math.pi, dt)))
    # l_i(j) = r PD N(nu; 0, S) / kappa;  l_i(0) = 1 - r PD
    log_det_lik = (jnp.log(jnp.maximum(r_pred * model.p_detect,
                                       tiny))[:, None]
                   - jnp.log(model.clutter)
                   + log_norm[:, None] - 0.5 * d2_t)  # [t_max, m]
    log_det_lik = jnp.where(valid, log_det_lik, -jnp.inf)
    rho_miss = 1.0 - r_pred * model.p_detect  # [t_max]

    if model.assoc == "exact":
        laug = jnp.concatenate(
            [jnp.log(jnp.maximum(rho_miss, tiny))[:, None],
             log_det_lik], axis=1)  # [t_max, m+1]
        t_idx = jnp.arange(model.t_max)
        ev_logp = jnp.sum(laug[t_idx[None, :], model.events], axis=1)
        log_z = jax.scipy.special.logsumexp(ev_logp)
        ev_p = jnp.exp(ev_logp - log_z)
        ev_p = ev_p / jnp.sum(ev_p)  # exact renorm (f32 exp residuals)
        betas = jnp.einsum("e,eti->ti", ev_p, model.event_onehot)
        betas = betas / jnp.maximum(
            jnp.sum(betas, axis=1, keepdims=True), tiny)
        u_j = 1.0 - jnp.sum(betas[:, 1:], axis=0)  # unclaimed mass
    else:
        # psi_ij = l_i(j) / l_i(0) with the representable cap (pmb rule)
        big = 1e12 if dt == jnp.float64 else 1e6
        psi = jnp.exp(log_det_lik) / jnp.maximum(rho_miss, tiny)[:, None]
        psi = jnp.minimum(jnp.where(valid, psi, 0.0), big)
        betas, u_j = bp_marginals(psi, model.bp_iters)

    u_j = jnp.clip(u_j, 0.0, 1.0) * mask.astype(dt)

    # ---- per-label Bernoulli update (exact given the marginals)
    r_miss = r_pred * (1.0 - model.p_detect) / jnp.maximum(rho_miss,
                                                           tiny)
    r_upd = betas[:, 0] * r_miss + jnp.sum(betas[:, 1:], axis=1)
    m_det = m_pred[:, None, :] + jnp.einsum("inp,imp->imn", k_t, nus_t)
    beta_mix = jnp.concatenate(
        [(betas[:, :1] * r_miss[:, None]), betas[:, 1:]], axis=1)
    beta_mix = beta_mix / jnp.maximum(
        jnp.sum(beta_mix, axis=1, keepdims=True), tiny)
    means_i = jnp.concatenate([m_pred[:, None, :], m_det], axis=1)
    covs_i = jnp.concatenate(
        [p_pred[:, None], jnp.broadcast_to(
            pu_t[:, None], (model.t_max, m_max, n, n))], axis=1)
    m_upd, p_upd = jax.vmap(_mixture_moments)(beta_mix, means_i, covs_i)
    alive = (r_pred > 0)[:, None]
    m_upd = jnp.where(alive, m_upd, m_pred)
    p_upd = jnp.where(alive[..., None], p_upd, p_pred)

    # ---- optional adaptive (measurement-driven) birth, post-update
    if model.adaptive_birth_r > 0.0:
        safe_c = jnp.where(mask[:, None], candidates, 0.0)
        m_ad = safe_c @ model.h_pinv.T  # [m_max, n]
        p_ad = jnp.broadcast_to(model.birth_p[0], (m_max, n, n))
        r_ad = model.adaptive_birth_r * u_j
        lab_ad = jnp.stack(
            [jnp.full((m_max,), state.k, jnp.int32),
             jb + jnp.arange(m_max, dtype=jnp.int32)], axis=1)
        r_cat = jnp.concatenate([r_upd, r_ad])
        m_cat = jnp.concatenate([m_upd, m_ad], axis=0)
        p_cat = jnp.concatenate([p_upd, p_ad], axis=0)
        lab_cat = jnp.concatenate([labels, lab_ad], axis=0)
        assoc_ad = jnp.concatenate(
            [jnp.zeros((m_max, 1), dt), jnp.eye(m_max, dtype=dt)],
            axis=1)
        assoc_cat = jnp.concatenate([betas, assoc_ad], axis=0)
    else:
        r_cat, m_cat, p_cat = r_upd, m_upd, p_upd
        lab_cat, assoc_cat = labels, betas

    # ---- prune + keep top-t_max by existence
    r_cat = jnp.where(r_cat > model.r_prune, r_cat, 0.0)
    order2 = jnp.argsort(-r_cat)[:model.t_max]
    r_k = r_cat[order2]
    m_k = m_cat[order2]
    p_k = p_cat[order2]
    lab_k = jnp.where((r_k > 0)[:, None], lab_cat[order2], -1)
    assoc_k = assoc_cat[order2]

    new_state = State(r_k, m_k, p_k, lab_k, state.k + 1)
    est = Estimate(
        n_targets=jnp.sum(r_k),
        existence=r_k,
        states=m_k,
        covariances=p_k,
        labels=lab_k,
        n_confirmed=jnp.sum((r_k > 0.5).astype(jnp.int32)),
        assoc=assoc_k,
    )
    return new_state, est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks):
    """lax.scan over [T, m_max, p] frames."""

    def body(carry, xs):
        cands, m_ = xs
        return step(model, carry, cands, m_)

    return jax.lax.scan(body, state,
                        (jnp.asarray(candidates),
                         jnp.asarray(cand_masks, bool)))
