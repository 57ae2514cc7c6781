"""Joint Probabilistic Data Association (JPDA): multi-target tracking
in clutter with SHARED measurements.

The PDAF (filters/pdaf.py) assumes one target per frame; with several
targets whose gates overlap, running independent PDAFs double-counts
any detection that falls in two gates — both tracks claim it, drift
toward each other, and coalesce.  JPDA (Fortmann, Bar-Shalom & Scheffe
1983) fixes this by computing association probabilities over JOINT
events that respect the exclusivity rules (a measurement originates
from at most one target, a target produces at most one measurement);
each track then does its own PDAF-style combined update with the
MARGINAL β's of the joint posterior.

Static-shape design: the joint-event table is finite and static — every
feasible assignment a ∈ {0..m_max}^{n_targets} with distinct nonzero
entries — so it is enumerated ONCE host-side at construction (numpy,
trace time) and baked into the compiled program as an integer table
plus its one-hot expansion.  A step is then: per-target/candidate
Mahalanobis grid (one vmap), one gather + sum for every event's
log-probability, one logsumexp, one einsum for the marginals — no
data-dependent control flow anywhere.  Event count is
Σ_k C(n_t, k)·m!/(m−k)! (229 for 3 targets × 6 candidates, 3393 for
4 × 8) — trivially small for one batched gather; `new` refuses
past 500k.

Targets share the (f, g, h, q, r) model (the common radar setup);
per-target state/covariance are stacked leading axes, so everything
vmaps.  All-masked / all-gated frames reduce per-target to the pure
prediction, and a single target reduces EXACTLY to the PDAF (pinned).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from . import vanilla


class Model(NamedTuple):
    kf: vanilla.Model
    pd: jax.Array  # [] detection probability
    clutter_density: jax.Array  # [] lambda
    gate: jax.Array  # [] chi-square gate
    events: jax.Array  # [n_events, n_targets] int32, 0 = missed
    event_onehot: jax.Array  # [n_events, n_targets, m_max + 1]


class State(NamedTuple):
    xs: jax.Array  # [n_targets, n]
    ps: jax.Array  # [n_targets, n, n]
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    states: jax.Array  # [n_targets, n]
    innovations: jax.Array  # [n_targets, p] combined innovations
    covariances: jax.Array  # [n_targets, n, n]
    pred_covariances: jax.Array  # [n_targets, n, n]
    betas: jax.Array  # [n_targets, m_max + 1]; column 0 = beta_0 (miss)
    n_gated: jax.Array  # [n_targets]


def _enumerate_events(n_targets: int, m_max: int) -> np.ndarray:
    """All feasible joint assignments: rows over targets, values in
    {0 (miss), 1..m_max}, nonzero values distinct."""
    rows = []

    def rec(t, used, cur):
        if t == n_targets:
            rows.append(list(cur))
            return
        rec(t + 1, used, cur + [0])
        for i in range(1, m_max + 1):
            if i not in used:
                rec(t + 1, used | {i}, cur + [i])

    rec(0, frozenset() | set(), [])
    return np.asarray(rows, np.int32)


def new(x0s, p0s, f, g, h, noise: Noise, m_max: int, pd: float = 0.9,
        clutter_density: float = 1e-3, gate: float = 16.0):
    """Build (Model, State) for `x0s` [n_targets, n] initial states and
    `p0s` [n_targets, n, n] (or one [n, n] shared) covariances.
    `m_max` (static) is the padded candidate count per frame."""
    x0s = jnp.asarray(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be [n_targets, n] (got {x0s.shape})")
    n_targets, n = x0s.shape
    p0s = jnp.asarray(p0s)
    if p0s.ndim == 2:
        p0s = jnp.broadcast_to(p0s, (n_targets, n, n))
    kf_model, _ = vanilla.new(x0s[0], p0s[0], f, g, h, noise)
    n_events = sum(
        math.comb(n_targets, k) * math.perm(m_max, k)
        for k in range(min(n_targets, m_max) + 1))
    if n_events > 500_000:
        raise ValueError(
            f"JPDA joint-event table would have {n_events} rows for "
            f"{n_targets} targets x {m_max} candidates; split the "
            "scene (cluster targets with disjoint gates) instead")
    events = _enumerate_events(n_targets, m_max)
    onehot = np.zeros((events.shape[0], n_targets, m_max + 1), np.float32)
    np.put_along_axis(onehot, events[:, :, None], 1.0, axis=2)
    dt = p0s.dtype
    model = Model(kf_model, jnp.asarray(pd, dt),
                  jnp.asarray(clutter_density, dt), jnp.asarray(gate, dt),
                  jnp.asarray(events), jnp.asarray(onehot, dt))
    return model, State(x0s, p0s, jnp.int32(0))


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask, control=None):
    """One JPDA frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.ps.dtype
    p_dim = kf.h.shape[0]
    m_max = model.event_onehot.shape[2] - 1

    def tgt_predict(x, p):
        return vanilla.predict(kf, vanilla.State(x, p, state.k), control)

    x_preds, p_preds = jax.vmap(tgt_predict)(state.xs, state.ps)

    def tgt_geometry(x_pred, p_pred):
        pht = p_pred @ kf.h.T
        s = linalg.sym(kf.h @ pht + kf.noise.r)
        k_gain = linalg.solve_psd(s, pht.T).T
        nus = jnp.asarray(candidates) - x_pred @ kf.h.T  # [m, p]
        sinv_nus = linalg.solve_psd(s, nus.T).T
        d2 = jnp.sum(nus * sinv_nus, axis=1)  # [m]
        _, logdet = jnp.linalg.slogdet(s)
        # zero the padded rows: their beta is exactly 0 but 0*NaN = NaN
        # in the combine (d2's NaN fails the gate on its own)
        nus = jnp.where(jnp.asarray(cand_mask, bool)[:, None], nus, 0.0)
        return s, k_gain, nus, d2, logdet

    s_all, k_all, nus_all, d2_all, logdet_all = jax.vmap(tgt_geometry)(
        x_preds, p_preds)

    valid = jnp.asarray(cand_mask, bool)[None, :] & (d2_all <= model.gate)
    n_gated = jnp.sum(valid.astype(jnp.int32), axis=1)

    # Per-(target, candidate) association log-likelihood ratios
    # (PD·N(ν; 0, S)/λ), -inf outside the gate/mask.
    log_norm = -0.5 * (logdet_all
                       + p_dim * jnp.log(jnp.asarray(2 * math.pi, dt)))
    log_li = (jnp.log(model.pd) - jnp.log(model.clutter_density)
              + log_norm[:, None] - 0.5 * d2_all)  # [T, m]
    log_li = jnp.where(valid, log_li, -jnp.inf)
    log_miss = jnp.log(jnp.maximum(1.0 - model.pd, 1e-12))
    laug = jnp.concatenate(
        [jnp.full((log_li.shape[0], 1), log_miss, dt), log_li], axis=1
    )  # [T, m+1]

    # Joint-event log-probs: one gather over the static table + sum.
    n_t = laug.shape[0]
    ev_logp = jnp.sum(
        laug[jnp.arange(n_t)[None, :], model.events], axis=1
    )  # [n_events]
    log_z = jax.scipy.special.logsumexp(ev_logp)
    ev_p = jnp.exp(ev_logp - log_z)
    ev_p = ev_p / jnp.sum(ev_p)  # exact renormalization (f32 exp residuals)

    betas = jnp.einsum("e,eti->ti", ev_p, model.event_onehot)  # [T, m+1]
    betas = betas / jnp.sum(betas, axis=1, keepdims=True)

    def tgt_update(x_pred, p_pred, k_gain, nus, b, s, none):
        beta0, bi = b[0], b[1:]
        nu_comb = bi @ nus
        x = x_pred + k_gain @ nu_comb
        p_upd = vanilla.joseph_update(p_pred, k_gain, kf.h, kf.noise.r)
        spread = jnp.einsum("m,mi,mj->ij", bi, nus, nus) - jnp.outer(
            nu_comb, nu_comb)
        p_new = linalg.sym(beta0 * p_pred + (1.0 - beta0) * p_upd
                           + k_gain @ spread @ k_gain.T)
        x = jnp.where(none, x_pred, x)
        p_new = jnp.where(none, p_pred, p_new)
        return x, p_new, nu_comb

    none = n_gated == 0
    xs, ps, nu_combs = jax.vmap(tgt_update)(
        x_preds, p_preds, k_all, nus_all, betas, s_all, none)

    betas_out = jnp.where(
        none[:, None],
        jnp.concatenate([jnp.ones((n_t, 1), dt),
                         jnp.zeros((n_t, m_max), dt)], axis=1),
        betas)
    est = Estimate(
        states=xs,
        innovations=nu_combs,
        covariances=ps,
        pred_covariances=p_preds,
        betas=betas_out,
        n_gated=n_gated,
    )
    return State(xs, ps, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, controls=None):
    """lax.scan over [T, m_max, p] candidate frames."""

    def body(carry, xs):
        cands, mask, ctrl = xs
        return step(model, carry, cands, mask, ctrl)

    return jax.lax.scan(body, state,
                        (jnp.asarray(candidates), jnp.asarray(cand_masks),
                         controls))
