"""Probabilistic Data Association Filter (PDAF): tracking in clutter.

The reference tracks with a known measurement origin (every filter
consumes THE measurement, vanilla.go:128); real sensors return m
candidate detections per frame — at most one from the target
(detection probability PD), the rest clutter.  The PDAF (Bar-Shalom &
Tse 1975; Bar-Shalom, Willett & Tiwari 2011) is the classic Bayesian
answer that keeps single-Gaussian complexity: gate the candidates,
weight each by its association probability β_i, update with the
combined innovation, and inflate the covariance by the
spread-of-innovations term (plus the β_0 chance that none was the
target).

Static-shape design: candidates arrive as a PADDED [m_max, p] array with a
validity mask (the same static-shape idiom as the padded time-varying
measurements, vanilla.mask_measurement); gating folds into the mask, β
weights are computed in log-space softmax style over masked entries,
and `run` is one lax.scan over [T, m_max, p] frames.  Everything under
linalg.highp.

Limiting behavior (pinned in tests): one valid candidate, PD -> 1,
clutter_density -> 0 reduces EXACTLY to the vanilla CKF step; an
all-masked (or all-gated-out) frame is exactly the pure prediction.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from . import vanilla


class Model(NamedTuple):
    kf: vanilla.Model  # dynamics/measurement core
    pd: jax.Array  # [] detection probability
    clutter_density: jax.Array  # [] lambda: expected clutter per unit volume
    gate: jax.Array  # [] chi-square gate on nu' S^-1 nu (e.g. 16 for p=2)


class State(NamedTuple):
    x: jax.Array
    p: jax.Array
    k: jax.Array


class Estimate(NamedTuple):
    state: jax.Array
    innovation: jax.Array  # combined (beta-weighted) innovation
    covariance: jax.Array
    pred_covariance: jax.Array
    gain: jax.Array
    beta0: jax.Array  # [] posterior prob that NO candidate was the target
    betas: jax.Array  # [m_max] per-candidate association probabilities
    n_gated: jax.Array  # [] candidates surviving the gate
    # log association evidence log[(1-PD) + (PD/λ)Σ N(ν;0,S)] — what a
    # mode-bank consumer (imm.step_pdaf) weighs modes by; exported here
    # so it is computed ONCE from the same gating/S the update used.
    log_evidence: jax.Array = None
    pred_state: jax.Array = None  # [n] x̄ (measurement-independent)

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, f, g, h, noise: Noise, pd: float = 0.9,
        clutter_density: float = 1e-3, gate: float = 16.0):
    """Build (Model, State).  `clutter_density` is the spatial clutter
    intensity λ (expected false detections per unit measurement
    volume); `gate` is the chi-square gate on the normalized innovation
    squared."""
    kf_model, kf_state = vanilla.new(x0, p0, f, g, h, noise)
    dt = jnp.asarray(p0).dtype
    return (Model(kf_model, jnp.asarray(pd, dt),
                  jnp.asarray(clutter_density, dt), jnp.asarray(gate, dt)),
            State(kf_state.x, kf_state.p, kf_state.k))


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask, control=None):
    """One PDAF frame: `candidates` [m_max, p] padded detections,
    `cand_mask` [m_max] validity."""
    kf = model.kf
    dt = state.p.dtype
    p_dim = kf.h.shape[0]

    x_pred, p_pred = vanilla.predict(kf, vanilla.State(state.x, state.p,
                                                       state.k), control)
    pht = p_pred @ kf.h.T
    s = linalg.sym(kf.h @ pht + kf.noise.r)
    k_gain = linalg.solve_psd(s, pht.T).T

    nus = jnp.asarray(candidates) - x_pred @ kf.h.T  # [m, p]
    sinv_nus = linalg.solve_psd(s, nus.T).T  # [m, p]
    d2 = jnp.sum(nus * sinv_nus, axis=1)  # [m] Mahalanobis^2
    valid = jnp.asarray(cand_mask, bool) & (d2 <= model.gate)
    n_gated = jnp.sum(valid.astype(jnp.int32))
    # padded slots may hold NaN/inf garbage: their beta is exactly 0,
    # but 0*NaN = NaN, so the combine below needs where-zeroed rows
    # (d2/valid above are already NaN-safe — NaN <= gate is False)
    nus = jnp.where(jnp.asarray(cand_mask, bool)[:, None], nus, 0.0)

    # Association log-likelihoods (parametric PDAF, Bar-Shalom 2011
    # eq. 38): beta_i ∝ PD·N(nu_i; 0, S)/lambda, beta_0 ∝ 1 − PD·PG.
    _, logdet = jnp.linalg.slogdet(s)
    log_norm = -0.5 * (logdet + p_dim * jnp.log(jnp.asarray(2 * math.pi, dt)))
    log_li = (jnp.log(model.pd) - jnp.log(model.clutter_density)
              + log_norm - 0.5 * d2)
    log_li = jnp.where(valid, log_li, -jnp.inf)
    # PG ~ chi-square mass inside the gate; with the standard ellipsoidal
    # gate at g >= 16 it is ~1 — fold the residual miss prob into b0.
    log_b0 = jnp.log(jnp.maximum(1.0 - model.pd, 1e-12))
    log_all = jnp.concatenate([log_b0[None], log_li])
    log_z = jax.scipy.special.logsumexp(log_all)
    betas_all = jnp.exp(log_all - log_z)
    # exact renormalization: f32 exp residuals otherwise leave the
    # probability sum ~1e-4 off in f32
    betas_all = betas_all / jnp.sum(betas_all)
    beta0, betas = betas_all[0], betas_all[1:]

    # Combined update + spread-of-innovations covariance.
    nu_comb = betas @ nus  # [p]
    x = x_pred + k_gain @ nu_comb
    p_upd = vanilla.joseph_update(p_pred, k_gain, kf.h, kf.noise.r)
    spread = jnp.einsum("m,mi,mj->ij", betas, nus, nus) - jnp.outer(
        nu_comb, nu_comb)
    p_new = linalg.sym(beta0 * p_pred + (1.0 - beta0) * p_upd
                       + k_gain @ spread @ k_gain.T)

    # No surviving candidate: pure prediction (beta0 -> 1 handles the
    # mean; force it exactly for the covariance path too).
    none = n_gated == 0
    x = jnp.where(none, x_pred, x)
    p_new = jnp.where(none, p_pred, p_new)

    est = Estimate(
        state=x,
        innovation=nu_comb,
        covariance=p_new,
        pred_covariance=p_pred,
        gain=k_gain,
        beta0=jnp.where(none, jnp.asarray(1.0, dt), beta0),
        betas=jnp.where(none, jnp.zeros_like(betas), betas),
        n_gated=n_gated,
        log_evidence=log_z,
        pred_state=x_pred,
    )
    return State(x, p_new, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, controls=None):
    """lax.scan over [T, m_max, p] candidate frames."""
    def body(carry, xs):
        cands, mask, ctrl = xs
        return step(model, carry, cands, mask, ctrl)

    return jax.lax.scan(body, state,
                        (jnp.asarray(candidates), jnp.asarray(cand_masks),
                         controls))
