"""Hybrid CKF/EKF for linearized nonlinear systems.

Rebuild of the reference hybrid filter (reference: hybrid.go:23-308),
the statOD workhorse: a KF linearized about a reference trajectory,
runtime-switchable between CKF (deviation state) and EKF (full-state
reset each step), with optional state-noise compensation (SNC) via Γ.

Mapping from the reference's mutable protocol to pure functions:
- Prepare(Φ, H̃)/locked (hybrid.go:78-82, 105-107)  ->  Φ, H̃ are args;
- EnableEKF/DisableEKF (hybrid.go:49-61)  ->  `ekf` is a (traced or
  static) bool argument, so the mode can flip mid-scan as the OD
  harness does (hybrid_test.go:270-279);
- PreparePNT(Γ)/snc disarm-after-update (hybrid.go:86-89, 140, 201) ->
  pass `gamma` for exactly the steps where SNC is armed (or a [T,...]
  array with a per-step `snc_mask` in `run`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise
from .vanilla import joseph_update


class Model(NamedTuple):
    noise: Noise
    meas_size: int


class State(NamedTuple):
    x: jax.Array  # [n] deviation (CKF) or full-state correction (EKF)
    p: jax.Array  # [n, n]
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    """Hybrid estimate (reference: hybrid.go:242-308)."""

    phi: jax.Array  # STM (kept for smoothing)
    state: jax.Array
    measurement: jax.Array  # real observation
    innovation: jax.Array
    obs_dev: jax.Array  # y = realObs - computedObs (hybrid.go:156-157)
    covariance: jax.Array
    pred_covariance: jax.Array
    gain: jax.Array
    htilde: jax.Array  # [p, n] measurement Jacobian (for smoothing /
    # post-run consider covariance analysis, schmidt.consider_analysis)

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, noise: Noise, meas_size: int):
    """Build (Model, State) (reference: hybrid.go:23-34)."""
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    return Model(noise, meas_size), State(x0, p0, jnp.int32(0))


def _p_bar(model: Model, state: State, phi, gamma):
    """P̄ = Φ P Φ^T (+ Γ Q Γ^T when SNC armed) (hybrid.go:114-123)."""
    p_bar = phi @ state.p @ phi.T
    if gamma is not None:
        p_bar = p_bar + gamma @ model.noise.q @ gamma.T
    return linalg.sym(p_bar)


@linalg.highp
def predict(model: Model, state: State, phi, gamma=None, ekf=False):
    """Pure time update (reference: hybrid.go:125-143).

    In EKF mode the predicted deviation is zero (the reference hardcodes
    a 6-vector, hybrid.go:127-129; here it is zeros_like(x)).
    """
    phi = jnp.asarray(phi)
    p_bar = _p_bar(model, state, phi, gamma)
    x_bar = jnp.where(ekf, jnp.zeros_like(state.x), phi @ state.x)
    p = model.meas_size
    zeros_p = jnp.zeros((p,), dtype=state.x.dtype)
    est = Estimate(
        phi=phi,
        state=x_bar,
        measurement=zeros_p,
        innovation=zeros_p,
        obs_dev=zeros_p,
        covariance=p_bar,
        pred_covariance=p_bar,
        gain=jnp.zeros((state.x.shape[0], p), dtype=state.x.dtype),
        htilde=jnp.zeros((p, state.x.shape[0]), dtype=state.x.dtype),
    )
    return State(x_bar, p_bar, state.k + 1), est


@linalg.highp
def update(
    model: Model,
    state: State,
    phi,
    htilde,
    real_obs,
    computed_obs,
    gamma=None,
    ekf=False,
    gain_mask=None,
):
    """Full time + measurement update (reference: hybrid.go:104-204).

    `gain_mask` ([n] 0/1) zeroes gain rows before the (gain-generic)
    Joseph update — the Schmidt-consider constraint on an augmented
    deviation state (see filters/schmidt.py and od.run_consider_od):
    masked components' means never move while the joint covariance
    tracks the constrained estimator exactly.
    """
    phi = jnp.asarray(phi)
    htilde = jnp.asarray(htilde)
    p_bar = _p_bar(model, state, phi, gamma)

    pht = p_bar @ htilde.T
    s = htilde @ pht + model.noise.r
    k_gain = linalg.solve_psd(s, pht.T).T
    if gain_mask is not None:
        k_gain = k_gain * jnp.asarray(gain_mask, k_gain.dtype)[:, None]

    y = jnp.asarray(real_obs) - jnp.asarray(computed_obs)

    # CKF branch (hybrid.go:163-173).
    x_bar = phi @ state.x
    innov_ckf = y - htilde @ x_bar
    x_ckf = x_bar + k_gain @ innov_ckf
    # EKF branch (hybrid.go:160-162): x̂ = K y, innovation left zero.
    x_ekf = k_gain @ y
    x_hat = jnp.where(ekf, x_ekf, x_ckf)
    innovation = jnp.where(ekf, jnp.zeros_like(innov_ckf), innov_ckf)

    p = joseph_update(p_bar, k_gain, htilde, model.noise.r)
    est = Estimate(
        phi=phi,
        state=x_hat,
        measurement=jnp.asarray(real_obs),
        innovation=innovation,
        obs_dev=y,
        covariance=p,
        pred_covariance=p_bar,
        gain=k_gain,
        htilde=htilde,
    )
    return State(x_hat, p, state.k + 1), est


@linalg.highp
def iekf_update(model: Model, state: State, phi, obs_fn, real_obs,
                iters: int = 3):
    """Iterated EKF measurement update (Gauss-Newton MAP iteration).

    `obs_fn(deviation) -> (computed_obs, htilde)` evaluates the
    nonlinear measurement and its Jacobian at the *current* posterior
    (reference trajectory + deviation) — relinearizing what the plain
    CKF/EKF freezes at the reference (hybrid.go:104-204).  With
    iters=1 this reduces exactly to the EKF update.  Beyond anything in
    the reference.
    """
    phi = jnp.asarray(phi)
    p_bar = linalg.sym(phi @ state.p @ phi.T)
    x_bar = phi @ state.x

    x_i = x_bar
    k_gain = None
    h_i = None
    for _ in range(max(iters, 1)):
        comp, h_i = obs_fn(x_i)
        pht = p_bar @ h_i.T
        s = h_i @ pht + model.noise.r
        k_gain = linalg.solve_psd(s, pht.T).T
        # Gauss-Newton step: innovation relinearized about x_i.
        innov_i = (jnp.asarray(real_obs) - comp) + h_i @ (x_i - x_bar)
        x_i = x_bar + k_gain @ innov_i

    p = joseph_update(p_bar, k_gain, h_i, model.noise.r)
    comp_last, _ = obs_fn(x_i)
    est = Estimate(
        phi=phi,
        state=x_i,
        measurement=jnp.asarray(real_obs),
        innovation=jnp.asarray(real_obs) - comp_last,
        obs_dev=jnp.asarray(real_obs) - comp_last,
        covariance=p,
        pred_covariance=p_bar,
        gain=k_gain,
        htilde=h_i,
    )
    return State(x_i, p, state.k + 1), est


@linalg.highp
def step(
    model: Model,
    state: State,
    phi,
    htilde,
    real_obs,
    computed_obs,
    has_meas,
    gamma=None,
    snc=None,
    ekf=False,
    gain_mask=None,
):
    """Masked predict-or-update step for scan-with-cond OD harnesses.

    `snc` (traced bool) arms the ΓQΓ^T term for this step only — the
    per-step analogue of PreparePNT's disarm-after-update protocol.
    """
    g = None
    if gamma is not None:
        g = gamma if snc is None else jnp.where(snc, gamma, jnp.zeros_like(gamma))
    st_u, est_u = update(model, state, phi, htilde, real_obs, computed_obs, g,
                         ekf, gain_mask)
    st_p, est_p = predict(model, state, phi, g, ekf)
    pick = lambda a, b: jnp.where(has_meas, a, b)
    return jax.tree.map(pick, st_u, st_p), jax.tree.map(pick, est_u, est_p)


@linalg.highp
def run(
    model: Model,
    state: State,
    phis,
    htildes,
    real_obs,
    computed_obs,
    has_meas,
    gammas=None,
    snc_mask=None,
    ekf=False,
    ekf_mask=None,
):
    """Scan the masked step over prepared (Φ, H̃) trajectories.

    `ekf_mask` ([T] bool) flips CKF/EKF per step, reproducing the OD
    harness's runtime EKF trigger (hybrid_test.go:270-279) without any
    goroutine lockstep.
    """

    def body(carry, xs):
        phi, ht, ro, co, hm, g, sm, em = xs
        mode = ekf if em is None else em
        return step(model, carry, phi, ht, ro, co, hm, g, sm, mode)

    xs = (phis, htildes, real_obs, computed_obs, has_meas, gammas, snc_mask, ekf_mask)
    return jax.lax.scan(body, state, xs)


@linalg.highp
def smooth_all(estimates: Estimate) -> Estimate:
    """Backward smoother (reference: SmoothAll hybrid.go:209-238):
    x_k <- Φ_{k+1}^{-1} x_{k+1}, P_k <- Φ^{-1} P_{k+1} Φ^{-T}.

    The reference panics when SNC was armed (hybrid.go:233-235); this
    implementation applies the same Φ-inverse map regardless — the
    caller is responsible for only smoothing SNC-free arcs if strict
    reference parity is needed.
    """
    from .smoothing import phi_inverse_smoother

    xs_sm, ps_sm = phi_inverse_smoother(
        estimates.phi, estimates.state, estimates.covariance
    )
    return estimates._replace(state=xs_sm, covariance=ps_sm)


@linalg.highp
def smooth_all_rts(estimates: Estimate) -> Estimate:
    """Optimal (RTS) fixed-interval smoother over a hybrid-CKF arc,
    INCLUDING SNC-armed steps — the reference's SmoothAll panics 'not
    yet implemented' when Γ was used (hybrid.go:233-235).

    No process-noise bookkeeping is needed: the per-step recorded
    predicted covariance P̄_{k+1} (pred_covariance) already contains
    the Γ Q Γᵀ term exactly as the filter applied it (hybrid._p_bar),
    so the smoother gain C_k = P_k Φ_{k+1}ᵀ P̄_{k+1}^{-1} is exact
    whatever the SNC schedule was.  CKF arcs only: across an EKF
    reference reset the deviation coordinates change meaning and
    deviation-space smoothing is ill-defined.
    """
    phis = estimates.phi
    xs = estimates.state
    ps = estimates.covariance
    p_preds = estimates.pred_covariance

    t = xs.shape[0]
    is_last = jnp.arange(t) == (t - 1)
    # Align step k with (Φ_{k+1}, P̄_{k+1}).
    phi_next = jnp.roll(phis, -1, axis=0)
    ppred_next = jnp.roll(p_preds, -1, axis=0)

    def body(carry, xs_):
        x_next, p_next = carry
        phi_n, ppred_n, x_k, p_k, last = xs_
        c = linalg.solve_psd(ppred_n, phi_n @ p_k.T).T
        x_sm = x_k + c @ (x_next - phi_n @ x_k)
        p_sm = linalg.sym(p_k + c @ (p_next - ppred_n) @ c.T)
        x_out = jnp.where(last, x_k, x_sm)
        p_out = jnp.where(last, p_k, p_sm)
        return (x_out, p_out), (x_out, p_out)

    _, (xs_sm, ps_sm) = jax.lax.scan(
        body, (xs[-1], ps[-1]), (phi_next, ppred_next, xs, ps, is_last),
        reverse=True,
    )
    return estimates._replace(state=xs_sm, covariance=ps_sm)
