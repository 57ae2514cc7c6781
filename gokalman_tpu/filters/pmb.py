"""Poisson multi-Bernoulli (PMB / TOMB-P) filter: labeled multi-target
tracking with principled track-existence probabilities.

Completes the RFS tracking tier above `phd`/`cphd`: the PHD family
propagates only intensity moments — it has no track identity and its
"extracted targets" jump between components frame to frame.  The PMB
filter (Williams 2015, "Marginal multi-Bernoulli/Poisson" = TOMB/P;
also the single-hypothesis limit of the PMBM filter of Garcia-Fernandez
et al. 2018) represents the multi-target posterior as

    Poisson point process  (targets never yet detected, a GM intensity)
  x multi-Bernoulli        (one Bernoulli per TRACK: existence r_i plus
                            a Gaussian density, plus a birth LABEL)

Prediction is closed-form per component.  The update marginalizes the
data association with the Williams-Lau (2014) belief-propagation scheme
instead of enumerating joint events (`jpda` is exact but factorial;
this is O(bp_iters * t_max * m_max) and fully vectorized):

    psi_ij = rho_ij / (rho_i0 * rho_uj)        pairwise match ratios
    mu_ij  = psi_ij / (1 + sum_{j'!=j} psi_ij' nu_j'i)   track -> meas
    nu_ji  = 1 / (1 + sum_{i'!=i} mu_i'j)                meas -> track

with rho_ij = r_i PD N(z_j; eta_i, S_i) (track i detected as z_j),
rho_i0 = 1 - r_i PD (track i not detected), and rho_uj = kappa + e_j
(z_j is clutter or a FIRST detection, e_j = the PPP's detection mass).
BP on this bipartite matching graph is exact on trees (single track or
single measurement) and observed tight in general (Williams-Lau); each
track then moment-matches a PDAF-style mixture over {miss, z_1..z_m}
with the BP marginals, and every measurement spawns a NEW Bernoulli
track with existence r = q_j0 * e_j / (kappa + e_j) (q_j0 = BP marginal
that no existing track claims z_j) seeded from the updated PPP — so
acquisition needs no adaptive-birth heuristics, it falls out of the
Poisson component.

Static-shape design: t_max static track slots (r = 0 marks an empty slot),
j_max static PPP mixture slots (PHD convention), padded [m_max, p]
candidate frames with masks, BP as a fixed-iteration lax.fori_loop,
slot management = top-t_max by existence over the [t_max + m_max]
candidate set.  Track identity rides in an integer label (birth_frame,
birth_measurement) that is carried with the track through every sort —
a track keeps its label for life, which is what `tracker`'s M/N
machinery approximates heuristically.

No reference counterpart (the reference stops at single-target
filters); reference anchors for the shared machinery: vanilla.go:160
(Joseph update), the jpda/pdaf padded-frame conventions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from . import gsf, vanilla
from .imm import _moment_match


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: jax.Array  # []
    p_detect: jax.Array  # []
    clutter: jax.Array  # [] clutter intensity kappa (per unit volume)
    birth_w: jax.Array  # [Jb] PPP birth intensity weights
    birth_m: jax.Array  # [Jb, n]
    birth_p: jax.Array  # [Jb, n, n]
    j_max: int  # static PPP mixture cap
    t_max: int  # static Bernoulli track cap
    r_prune: float  # static: tracks below this existence are dropped
    bp_iters: int  # static belief-propagation iteration count


class State(NamedTuple):
    # Poisson (undetected-target) intensity, a GM bank a la phd.State:
    ppp_w: jax.Array  # [j_max] unnormalized intensity weights
    ppp_m: jax.Array  # [j_max, n]
    ppp_p: jax.Array  # [j_max, n, n]
    # Bernoulli tracks (r == 0 marks an unused slot):
    r: jax.Array  # [t_max] existence probabilities
    m: jax.Array  # [t_max, n]
    p: jax.Array  # [t_max, n, n]
    labels: jax.Array  # [t_max, 2] int32 (birth frame, birth meas idx)
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    n_targets: jax.Array  # [] sum r + PPP mass (expected count)
    existence: jax.Array  # [t_max] r, sorted descending
    states: jax.Array  # [t_max, n] sorted by existence
    covariances: jax.Array  # [t_max, n, n]
    labels: jax.Array  # [t_max, 2] sorted with their tracks
    n_confirmed: jax.Array  # [] tracks with r > 0.5
    # BP marginals (col 0 = miss), PERMUTED to match the sorted track
    # rows above; a track born this frame gets a one-hot row at its
    # birth measurement.
    assoc: jax.Array  # [t_max, m_max + 1]


def new(f, g, h, noise: Noise, birth_w, birth_m, birth_p,
        p_survival: float = 0.99, p_detect: float = 0.9,
        clutter: float = 1e-3, j_max: int = 16, t_max: int = 16,
        r_prune: float = 1e-3, bp_iters: int = 20):
    """Build (Model, State) with an empty posterior (no tracks, zero
    PPP — the birth intensity is injected every frame at prediction, so
    frame 0 already acquires).  `birth_*` is the PPP birth mixture
    ([Jb]-stacked weights/means/covs); birth_w sums to the expected
    births/frame.  Tracks past `t_max` (by existence) are dropped —
    size t_max to the scene (confirmed targets + a few tentatives)."""
    birth_m = jnp.asarray(birth_m)
    birth_p = jnp.asarray(birth_p)
    birth_w = jnp.asarray(birth_w)
    if birth_m.ndim != 2:
        raise ValueError(f"birth_m must be [Jb, n] (got {birth_m.shape})")
    jb, n = birth_m.shape
    if birth_w.shape != (jb,) or birth_p.shape != (jb, n, n):
        raise ValueError("birth_w/birth_p shapes must match birth_m")
    if jb > j_max:
        raise ValueError(f"j_max={j_max} must hold the {jb} birth slots")
    kf_model, _ = vanilla.new(jnp.zeros(n, birth_m.dtype), jnp.eye(n),
                              f, g, h, noise)
    dt = birth_m.dtype
    model = Model(kf_model, jnp.asarray(p_survival, dt),
                  jnp.asarray(p_detect, dt), jnp.asarray(clutter, dt),
                  birth_w, birth_m, birth_p, int(j_max), int(t_max),
                  float(r_prune), int(bp_iters))
    state = State(
        jnp.zeros((j_max,), dt),
        jnp.zeros((j_max, n), dt),
        jnp.broadcast_to(jnp.eye(n, dtype=dt), (j_max, n, n)),
        jnp.zeros((t_max,), dt),
        jnp.zeros((t_max, n), dt),
        jnp.broadcast_to(jnp.eye(n, dtype=dt), (t_max, n, n)),
        jnp.full((t_max, 2), -1, jnp.int32),
        jnp.int32(0))
    return model, state


def bp_marginals(psi, iters: int):
    """Williams-Lau (2014) BP for bipartite matching marginals.

    `psi` [n_i, n_j] >= 0: pairwise weights RELATIVE to the two
    unmatched hypotheses (psi_ij = rho_ij / (rho_i0 rho_uj)); a zero
    entry excludes the pair.  Returns (p [n_i, n_j + 1], q0 [n_j]):
    p[:, 0] is the miss marginal per row, p[:, 1:] the match marginals;
    q0[j] the marginal that column j matches NO row.  Exact whenever
    the association graph is a tree (e.g. one row or one column —
    pinned in tests); a few tens of iterations converge in general."""
    nu0 = jnp.ones_like(psi)

    def body(_, nu):
        pn = psi * nu
        mu = psi / (1.0 + jnp.sum(pn, axis=1, keepdims=True) - pn)
        return 1.0 / (1.0 + jnp.sum(mu, axis=0, keepdims=True) - mu)

    nu = jax.lax.fori_loop(0, iters, body, nu0)
    pn = psi * nu
    denom_i = 1.0 + jnp.sum(pn, axis=1, keepdims=True)
    p = jnp.concatenate([1.0 / denom_i, pn / denom_i], axis=1)
    mu = psi / (denom_i - pn)
    q0 = 1.0 / (1.0 + jnp.sum(mu, axis=0))
    return p, q0


def _mixture_moments(w, means, covs):
    """Moment-match a mixture with weights `w` [M] (already
    normalized): imm's helper with the pmb argument order."""
    return _moment_match(means, covs, w)


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One PMB frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.r.dtype
    n = state.m.shape[1]
    candidates = jnp.asarray(candidates)
    m_max, p_dim = candidates.shape
    mask = jnp.asarray(cand_mask, bool)
    maskf = mask.astype(dt)
    tiny = 1e-300 if dt == jnp.float64 else 1e-30

    # ---- predict: PPP survivors + birth, reduced back to j_max slots
    ppp_w = jnp.concatenate([model.p_survival * state.ppp_w, model.birth_w])
    ppp_m = jnp.concatenate([state.ppp_m @ kf.f.T, model.birth_m], axis=0)
    ppp_p = jnp.concatenate(
        [jnp.einsum("ij,kjl,ml->kim", kf.f, state.ppp_p, kf.f)
         + kf.noise.q[None], model.birth_p], axis=0)
    total = jnp.sum(ppp_w)
    logw = jnp.log(jnp.maximum(ppp_w, tiny))
    ppp_m, ppp_p, logw_red = gsf.reduce_mixture(ppp_m, ppp_p, logw,
                                                model.j_max)
    ppp_w = jnp.exp(logw_red) * total  # reduce_mixture normalizes

    # ---- predict: Bernoulli tracks
    r_pred = model.p_survival * state.r
    m_pred = state.m @ kf.f.T
    p_pred = jnp.einsum("ij,kjl,ml->kim", kf.f, state.p, kf.f) \
        + kf.noise.q[None]

    # ---- measurement geometry (tracks and PPP components alike)
    def geom(p_i):
        s = linalg.sym(kf.h @ p_i @ kf.h.T + kf.noise.r)
        k_g = linalg.solve_psd(s, (p_i @ kf.h.T).T).T
        p_u = vanilla.joseph_update(p_i, k_g, kf.h, kf.noise.r)
        _, logdet = jnp.linalg.slogdet(s)
        return s, k_g, p_u, logdet

    def log_gauss(zs, eta, s, logdet):
        d = jnp.where(mask[:, None], zs - eta[None, :], 0.0)  # [m, p]
        sol = linalg.solve_psd(s, d.T).T
        return (-0.5 * jnp.sum(d * sol, axis=1) - 0.5 * logdet
                - 0.5 * p_dim * math.log(2 * math.pi))  # [m]

    s_t, k_t, pu_t, ld_t = jax.vmap(geom)(p_pred)
    eta_t = m_pred @ kf.h.T  # [t_max, p]
    logq_t = jax.vmap(log_gauss, in_axes=(None, 0, 0, 0))(
        candidates, eta_t, s_t, ld_t)  # [t_max, m_max]

    s_u, k_u, pu_u, ld_u = jax.vmap(geom)(ppp_p)
    eta_u = ppp_m @ kf.h.T
    logq_u = jax.vmap(log_gauss, in_axes=(None, 0, 0, 0))(
        candidates, eta_u, s_u, ld_u)  # [j_max, m_max]

    # ---- association weights
    # rho_ij = r_i PD q_ij; rho_i0 = 1 - r_i PD; rho_uj = kappa + e_j
    pd = model.p_detect
    log_c = jnp.log(jnp.maximum(pd * ppp_w, tiny))[:, None] + logq_u
    log_c = jnp.where(mask[None, :], log_c, -jnp.inf)  # [j_max, m_max]
    e_j = jnp.exp(jax.scipy.special.logsumexp(log_c, axis=0))  # [m_max]
    rho_u = model.clutter + e_j
    rho_det = r_pred[:, None] * pd * jnp.exp(logq_t)  # [t_max, m_max]
    rho_miss = 1.0 - r_pred * pd  # [t_max]
    # guarded ratio: rho_miss -> 0 (r = PD = 1) means a certain match —
    # a large-but-finite psi keeps BP stable and drives p_miss -> 0.
    # The cap must keep 1 + psi exactly representable (ulp(cap) < 1) or
    # the BP "leave-one-out" subtractions cancel to 0 and produce
    # inf/NaN when several saturated tracks share a measurement.
    big = 1e12 if dt == jnp.float64 else 1e6
    psi = rho_det / jnp.maximum(rho_miss[:, None] * rho_u[None, :], tiny)
    psi = jnp.minimum(psi, big)
    psi = jnp.where(mask[None, :] & (r_pred[:, None] > 0), psi, 0.0)

    # ---- marginal association via belief propagation
    assoc, q0 = bp_marginals(psi, model.bp_iters)  # [t_max, m+1], [m]

    # ---- track update: moment-match {miss, z_1..z_m} with BP marginals
    r_miss = r_pred * (1.0 - pd) / jnp.maximum(rho_miss, tiny)
    r_new_t = assoc[:, 0] * r_miss + jnp.sum(assoc[:, 1:], axis=1)
    diffs = jnp.where(mask[None, :, None],
                      candidates[None, :, :] - eta_t[:, None, :], 0.0)
    m_det = m_pred[:, None, :] + jnp.einsum("inp,imp->imn", k_t, diffs)
    beta = jnp.concatenate(
        [(assoc[:, :1] * r_miss[:, None]), assoc[:, 1:]], axis=1)
    beta = beta / jnp.maximum(jnp.sum(beta, axis=1, keepdims=True), tiny)
    means_i = jnp.concatenate([m_pred[:, None, :], m_det], axis=1)
    covs_i = jnp.concatenate(
        [p_pred[:, None], jnp.broadcast_to(
            pu_t[:, None], (model.t_max, m_max, n, n))], axis=1)
    m_upd, p_upd = jax.vmap(_mixture_moments)(beta, means_i, covs_i)
    # empty slots (r == 0) keep their placeholders untouched
    alive = (r_pred > 0)[:, None]
    m_upd = jnp.where(alive, m_upd, m_pred)
    p_upd = jnp.where(alive[..., None], p_upd, p_pred)

    # ---- new tracks: one Bernoulli per measurement, seeded by the PPP
    c = jnp.where(mask[None, :], jnp.exp(log_c), 0.0)  # [j_max, m_max]
    cw = c / jnp.maximum(e_j, tiny)[None, :]
    m_det_u = ppp_m[:, None, :] + jnp.einsum("knp,kmp->kmn", k_u,
                                             jnp.where(mask[None, :, None],
                                                       candidates[None]
                                                       - eta_u[:, None, :],
                                                       0.0))
    covs_u = jnp.broadcast_to(pu_u[:, None], (model.j_max, m_max, n, n))
    m_new, p_new = jax.vmap(_mixture_moments, in_axes=(1, 1, 1))(
        cw, m_det_u, covs_u)  # [m_max, n], [m_max, n, n]
    r_new = q0 * e_j / jnp.maximum(rho_u, tiny) * maskf
    # degenerate frames (no PPP mass under z) leave identity placeholders
    seeded = (e_j > 0)[:, None]
    m_new = jnp.where(seeded, m_new, 0.0)
    p_new = jnp.where(seeded[..., None], p_new,
                      jnp.eye(n, dtype=dt)[None])
    lab_new = jnp.stack(
        [jnp.full((m_max,), state.k, jnp.int32) + 1,
         jnp.arange(m_max, dtype=jnp.int32)], axis=1)

    # ---- PPP missed-detection update
    ppp_w = (1.0 - pd) * ppp_w

    # ---- prune + keep the top-t_max tracks by existence
    r_all = jnp.concatenate([r_new_t, r_new])
    r_all = jnp.where(r_all > model.r_prune, r_all, 0.0)
    m_all = jnp.concatenate([m_upd, m_new], axis=0)
    p_all = jnp.concatenate([p_upd, p_new], axis=0)
    lab_all = jnp.concatenate([state.labels, lab_new], axis=0)
    assoc_new = jnp.concatenate(
        [jnp.zeros((m_max, 1), dt), jnp.eye(m_max, dtype=dt)], axis=1)
    assoc_all = jnp.concatenate([assoc, assoc_new], axis=0)
    order = jnp.argsort(-r_all)[:model.t_max]
    r_k, m_k, p_k = r_all[order], m_all[order], p_all[order]
    lab_k = jnp.where((r_k > 0)[:, None], lab_all[order], -1)
    assoc_k = assoc_all[order]

    new_state = State(ppp_w, ppp_m, ppp_p, r_k, m_k, p_k, lab_k,
                      state.k + 1)
    est = Estimate(
        n_targets=jnp.sum(r_k) + jnp.sum(ppp_w),
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
                        (jnp.asarray(candidates), jnp.asarray(cand_masks)))
