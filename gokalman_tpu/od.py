"""Orbit-determination scenario harness.

The scan-with-cond recast of the reference's OD loops
(hybridFullODExample hybrid_test.go:67-372, _SRIFFullODExample
srif_test.go:66-341): the reference runs the propagator in a goroutine
feeding a channel, with a WaitGroup forcing lockstep in EKF mode
because the filter mutates the propagator's orbit mid-flight
(hybrid_test.go:358-366).  Here the reference trajectory lives inside
the scan carry, so the EKF full-state reset is a pure carry update and
the whole scenario jit-compiles into one fused loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import linalg
from .dynamics import constants as c
from .dynamics import gravity, integrators, stations as st
from .dynamics.propagate import MeasurementSet
from .filters import hybrid, srif


class ODResult(NamedTuple):
    """Per-step OD outputs.  Convention: `est_states = ref_states +
    deviations` always holds.  The linearized paths (hybrid/SRIF) carry
    a genuine reference trajectory and deviation state; the
    derivative-free paths (run_ukf_od / run_enkf_od) estimate the full
    state directly — for them `ref_states` IS the estimate and
    `deviations` is exactly zero."""

    est_states: jax.Array  # [T, 6] full-state estimates (reference + deviation)
    deviations: jax.Array  # [T, 6] filter deviation states (zero for ukf/enkf)
    covariances: jax.Array  # [T, 6, 6]
    innovations: jax.Array  # [T, p]
    ref_states: jax.Array  # [T, 6] reference trajectory (post EKF resets)
    has_meas: jax.Array  # [T]
    estimates: object  # stacked filter Estimate pytree (for smoothing)
    accepted: object = None  # [T] gate decisions (None when ungated)
    truth: object = None  # [T, 6] co-propagated truth (truth0 mode only)


def _computed_obs(station_list, state, theta, idx, has):
    """Observation + Jacobian of `state` by station `idx` (the station
    that produced the real measurement), zero when no measurement."""
    obs = jnp.stack([st.range_range_rate(s, state, theta) for s in station_list])
    hts = jnp.stack([st.measurement_jacobian(s, state, theta) for s in station_list])
    safe = jnp.maximum(idx, 0)
    return (
        jnp.where(has, obs[safe], jnp.zeros_like(obs[0])),
        jnp.where(has, hts[safe], jnp.zeros_like(hts[0])),
    )


def ric_dcm(state: jnp.ndarray) -> jnp.ndarray:
    """ECI->RIC direction cosine matrix from a PV state: rows are the
    radial, in-track, cross-track unit vectors (the DCM the reference
    builds from Orbit.R/H for RIC-rotated SNC, hybrid_test.go:297-311)."""
    r = state[:3]
    v = state[3:]
    r_hat = r / jnp.linalg.norm(r)
    h = jnp.cross(r, v)
    c_hat = h / jnp.linalg.norm(h)
    i_hat = jnp.cross(c_hat, r_hat)
    return jnp.stack([r_hat, i_hat, c_hat])


def snc_gamma(dt: float, dtype=jnp.float64) -> jnp.ndarray:
    """The PV process-noise mapping Γ = [Δt²/2·I; Δt·I] used when SNC is
    armed (hybrid_test.go:295-327)."""
    i3 = jnp.eye(3, dtype=dtype)
    return jnp.concatenate([0.5 * dt * dt * i3, dt * i3], axis=0)


@linalg.highp
def run_hybrid_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    ekf_mask: Optional[jnp.ndarray] = None,
    snc_mask: Optional[jnp.ndarray] = None,
    snc_ric: bool = False,
    t0: float = 0.0,
    iekf_iters: int = 0,
    nis_gate: Optional[float] = None,
    dmc_tau: Optional[float] = None,
    dmc_sigma: Optional[float] = None,
    dmc_w_p0: float = 1e-12,
    truth0=None,
) -> ODResult:
    """Hybrid CKF/EKF orbit determination over a measurement stream.

    `truth0` enables self-consistent in-scan measurement generation
    (see run_srif_od: batched truth+reference propagation/observation,
    the one-propagator structure of the reference's own tests and the
    only way to hold reference-strict gates on emulated-x64 hardware).
    Incompatible with DMC (the truth would need the augmented filter
    dynamics rather than its own).

    Per step (hybrid_test.go:228-372): propagate the reference orbit one
    step with its STM, compute the reference observation by the same
    station that produced the real one, run the masked hybrid step, and
    in EKF mode fold the estimated correction back into the reference
    trajectory (carry update replacing the goroutine lockstep).

    `snc_ric=True` interprets noise.q as the acceleration PSD in the
    radial/in-track/cross-track frame and rotates it to ECI per step
    from the reference state (the sncRIC branch, hybrid_test.go:295-327)
    by composing Γ with the RIC DCM transpose.

    `iekf_iters > 0` replaces the CKF measurement update with an
    iterated (Gauss-Newton) update that relinearizes the station
    observation about the current posterior — robust to deviations far
    beyond the plain CKF's linearization range.  Applies to CKF-mode
    measurement steps only and does not combine with SNC.

    `nis_gate` enables chi-square innovation gating: measurements whose
    normalized innovation squared exceeds the gate are rejected (the
    step degrades to pure prediction) — protection against corrupted
    observations that the reference can only log via IsWithinNσ.

    `dmc_tau`/`dmc_sigma` enable dynamic model compensation (beyond the
    reference; Tapley/Schutz/Born §4.9 DMC): the state is augmented
    with a first-order Gauss-Markov unmodeled acceleration w
    (ẇ = -w/τ + u, u ~ N(0, σ² I)), so mismodeled dynamics are
    *estimated* rather than merely covered by SNC's white noise.  The
    discrete 9x9 process noise comes from the exact LTI Van Loan
    solution of the triple-integrator + GM chain; the station
    measurement Jacobian gets zero w-columns.  Incompatible with
    `snc_mask` (pick one compensation scheme).  `dmc_w_p0` is the
    initial variance of each w component.  The returned states and
    covariances are 9-dimensional (r, v, w).
    """
    x0_ref = jnp.asarray(x0_ref)
    dtype = x0_ref.dtype
    steps = meas.obs.shape[0]
    use_dmc = dmc_tau is not None
    use_snc = snc_mask is not None
    self_consistent = truth0 is not None
    if use_dmc and self_consistent:
        raise ValueError("truth0 (self-consistent measurements) is "
                         "incompatible with DMC")
    if use_dmc and use_snc:
        raise ValueError("DMC and SNC are alternative compensation schemes")
    if use_dmc and snc_ric:
        raise ValueError("snc_ric applies to SNC, not DMC")
    if use_dmc and dmc_sigma is None:
        raise ValueError("DMC requires dmc_sigma (driving-noise intensity)")

    if use_dmc:
        nstate = 9
        base_eom = functools.partial(gravity.eom, degree=degree)

        def eom(x):
            pv = base_eom(x[:6])
            acc = pv[3:6] + x[6:9]  # unmodeled acceleration estimate
            wdot = -x[6:9] / dmc_tau
            return jnp.concatenate([pv[:3], acc, wdot])

        # Exact discrete Q for the LTI chain r'' = w, w' = -w/τ + u.
        # Discretized on the HOST at trace time (all inputs are static
        # config, so there is nothing to trace) — c2d.van_loan_host
        # shares the block algebra with the jittable c2d.van_loan.
        import numpy as _np

        from . import c2d

        i3 = jnp.eye(3, dtype=dtype)
        i3n = _np.eye(3)
        z3n = _np.zeros((3, 3))
        a_lti = _np.block([
            [z3n, i3n, z3n], [z3n, z3n, i3n], [z3n, z3n, -i3n / dmc_tau],
        ])
        gamma_u = _np.concatenate([z3n, z3n, i3n], axis=0)
        _, q_dmc = c2d.van_loan_host(a_lti, gamma_u, dmc_sigma**2 * i3n, dt)
        noise = noise._replace(q=jnp.asarray(q_dmc, dtype))
        x0_ref = jnp.concatenate([x0_ref, jnp.zeros(3, dtype)])
        p0 = jnp.asarray(p0)
        if p0.shape == (6, 6):
            p0 = jnp.block([
                [p0, jnp.zeros((6, 3), dtype)],
                [jnp.zeros((3, 6), dtype), dmc_w_p0 * i3],
            ])
        gamma = jnp.eye(9, dtype=dtype)  # Q enters each step via "SNC"
        snc_mask = jnp.ones(steps, bool)
    else:
        nstate = 6
        eom = functools.partial(gravity.eom, degree=degree)
        # SNC needs the 3x3 acceleration PSD as Q (Γ is 6x3); without a
        # mask the ΓQΓ^T term is compiled out (hybrid.go:117-123).
        if use_snc and noise.q.shape != (3, 3):
            raise ValueError(
                "SNC requires noise.q to be the 3x3 acceleration PSD"
            )
        gamma = snc_gamma(dt, dtype) if use_snc else None

    phi_flow = integrators.flow(eom, dt, method, substeps)
    model, hstate0 = hybrid.new(jnp.zeros(nstate, dtype), jnp.asarray(p0),
                                noise, 2)
    times = t0 + dt * jnp.arange(1, steps + 1, dtype=dtype)

    ekf_mask = jnp.zeros(steps, bool) if ekf_mask is None else ekf_mask
    if not use_dmc:
        snc_mask = jnp.zeros(steps, bool) if snc_mask is None else snc_mask
        if not use_snc:
            snc_mask = None

    def computed_obs(x_full, theta, idx, has):
        obs, ht = _computed_obs(stations_list, x_full[:6], theta, idx, has)
        if nstate > 6:
            ht = jnp.concatenate(
                [ht, jnp.zeros(ht.shape[:1] + (nstate - 6,), ht.dtype)],
                axis=1,
            )
        return obs, ht

    def body(carry, xs):
        if self_consistent:
            x_truth, x_ref, hstate = carry
        else:
            x_ref, hstate = carry
        real_obs, idx, has, ekf, snc, t = xs
        hstate_pre = hstate
        g = gamma if snc is not None else None
        if g is not None and snc_ric:
            # Γ_eff = Γ R^T so that Γ_eff Q_ric Γ_eff^T = Γ (R^T Q_ric R) Γ^T.
            g = gamma @ ric_dcm(x_ref).T
        # Entering an EKF step, fold any existing deviation into the
        # reference first (no-op in steady EKF where the deviation is
        # already zero).  The reference drops the deviation instead
        # (hybrid.go:160-162 ignores the prior state), which is only
        # safe because its test switches modes with a ~zero deviation;
        # with a converged CKF deviation that discard makes the filter
        # inconsistent and diverges — folding is the correct transition.
        pre = jnp.where(ekf, hstate.x, jnp.zeros_like(hstate.x))
        x_ref = x_ref + pre
        hstate = hstate._replace(x=hstate.x - pre)
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        if self_consistent:
            # Batched truth+reference propagation and observation (see
            # run_srif_od): identical compiled arithmetic for the pair.
            pair = jnp.stack([x_truth, x_ref])
            pair_new, stms = jax.vmap(
                lambda x: integrators.x_and_jac(phi_flow, x))(pair)
            x_truth = pair_new[0]
            x_ref = pair_new[1]
            stm = stms[1]
            obs_pair, ht_pair = jax.vmap(
                lambda x: computed_obs(x, theta, idx, has))(pair_new)
            real_obs = obs_pair[0]
            comp_obs, htilde = obs_pair[1], ht_pair[1]
        else:
            x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
            comp_obs, htilde = computed_obs(x_ref, theta, idx, has)
        accept = jnp.asarray(True)
        if nis_gate is not None:
            # CKF-form innovation (in EKF mode the prior deviation is
            # ~0 so this reduces to the raw observation deviation).
            innov_g = (real_obs - comp_obs) - htilde @ (stm @ hstate_pre.x)
            p_bar_g = stm @ hstate_pre.p @ stm.T
            if g is not None:
                # Match the filter's own P̄ (hybrid._p_bar): on SNC-armed
                # steps the gate's innovation covariance must include
                # ΓQΓ^T or measurements are over-rejected.
                g_armed = g if snc is None else jnp.where(
                    snc, g, jnp.zeros_like(g))
                p_bar_g = p_bar_g + g_armed @ model.noise.q @ g_armed.T
            s_g = htilde @ p_bar_g @ htilde.T + model.noise.r
            nis_g = innov_g @ linalg.solve_psd(s_g, innov_g)
            accept = nis_g <= nis_gate
            has = has & accept
        hstate, est = hybrid.step(
            model, hstate, stm, htilde, real_obs, comp_obs, has,
            gamma=g, snc=snc, ekf=ekf,
        )
        if iekf_iters > 0:
            # Iterated (Gauss-Newton) measurement update: relinearize
            # the station observation about the current posterior.
            xr = x_ref  # capture post-propagation reference

            def obs_fn(dev):
                return computed_obs(xr + dev, theta, idx, has)

            # lax.cond, not select: measurement steps are sparse on an
            # OD arc (~5%), so the Gauss-Newton iterations only execute
            # when a CKF measurement actually lands — no 2x per-step
            # tax.  Re-runs the update from the pre-step filter state
            # (carry[1]; the EKF pre-fold is a no-op on CKF steps, the
            # only ones the IEKF replaces).
            use_it = has & ~ekf
            hstate, est = jax.lax.cond(
                use_it,
                lambda: hybrid.iekf_update(
                    model, carry[1], stm, obs_fn, real_obs,
                    iters=iekf_iters,
                ),
                lambda: (hstate, est),
            )
        # EKF reference-trajectory reset (hybrid_test.go:358-366).
        shift = jnp.where(ekf & has, hstate.x, jnp.zeros_like(hstate.x))
        x_ref = x_ref + shift
        hstate = hstate._replace(x=hstate.x - shift)
        full = x_ref + hstate.x
        out = (full, hstate.x, est.covariance, est.innovation, x_ref, est, accept)
        if self_consistent:
            return (x_truth, x_ref, hstate), out + (x_truth,)
        return (x_ref, hstate), out

    xs = (meas.obs, meas.station_idx, meas.has_meas, ekf_mask, snc_mask, times)
    if self_consistent:
        carry0 = (jnp.asarray(truth0, dtype), x0_ref, hstate0)
        _, (full, dev, cov, innov, refs, ests, accepted, truths) = jax.lax.scan(
            body, carry0, xs
        )
        return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests,
                        accepted if nis_gate is not None else None, truths)
    _, (full, dev, cov, innov, refs, ests, accepted) = jax.lax.scan(
        body, (x0_ref, hstate0), xs
    )
    return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests,
                    accepted if nis_gate is not None else None)


@linalg.highp
def run_consider_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    bias_sigmas,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    snc_mask=None,
    snc_ric: bool = False,
    t0: float = 0.0,
    truth0=None,
    true_biases=None,
    range_row: int = 0,
) -> ODResult:
    """Schmidt-consider orbit determination: the ONLINE counterpart of
    `consider_bias_analysis` (TSB §6.6; Schmidt 1966).

    Runs the CKF-mode hybrid OD loop on an augmented deviation state
    [δx(6); δb(n_st)] where δb are per-station range biases with
    a-priori sigmas `bias_sigmas` [n_st] (km) that are deliberately
    NOT estimated: the gain's bias rows are zero-masked
    (hybrid.update(gain_mask=...); Joseph is gain-generic so the
    constrained update is exact).  The reported position/velocity
    covariance is then the TRUE error covariance of a filter flying
    through biased stations — where the plain `run_hybrid_od` goes
    overconfident (NEES blows up over bias draws; pinned in
    tests/test_od_consider.py).

    Biases are constant considers (Φ_aug = blkdiag(Φ, I)); they enter
    the measurement as Hc = e_{range_row} ⊗ onehot(station) on
    measurement steps.  SNC (`snc_mask`/`snc_ric`) acts on the
    position/velocity block exactly as in run_hybrid_od.

    `truth0` enables self-consistent in-scan measurement generation
    (see run_hybrid_od); `true_biases` [n_st] (km), only meaningful
    with truth0, adds the actual station biases to the generated range
    observations — the Monte-Carlo-over-bias-draws harness.

    Reference anchor: the reference estimates full states only
    (srif_test.go); its problem domain (ground-station OD,
    hybrid_test.go:79-117) is exactly where consider filtering is
    standard practice.
    """
    x0_ref = jnp.asarray(x0_ref)
    dtype = x0_ref.dtype
    steps = meas.obs.shape[0]
    bias_sigmas = jnp.asarray(bias_sigmas, dtype)
    n_st = bias_sigmas.shape[0]
    naug = 6 + n_st
    use_snc = snc_mask is not None
    self_consistent = truth0 is not None
    if true_biases is not None and not self_consistent:
        raise ValueError("true_biases requires truth0 (self-consistent "
                         "measurement generation)")
    if use_snc and noise.q.shape != (3, 3):
        raise ValueError("SNC requires noise.q to be the 3x3 acceleration PSD")

    eom = functools.partial(gravity.eom, degree=degree)
    phi_flow = integrators.flow(eom, dt, method, substeps)
    gamma = None
    if use_snc:
        gamma = jnp.concatenate(
            [snc_gamma(dt, dtype), jnp.zeros((n_st, 3), dtype)], axis=0)

    p0_aug = jax.scipy.linalg.block_diag(
        jnp.asarray(p0, dtype), jnp.diag(bias_sigmas**2))
    model, hstate0 = hybrid.new(jnp.zeros(naug, dtype), p0_aug, noise, 2)
    gain_mask = (jnp.arange(naug) < 6).astype(dtype)
    eye_b = jnp.eye(n_st, dtype=dtype)
    times = t0 + dt * jnp.arange(1, steps + 1, dtype=dtype)
    tb = (jnp.zeros(n_st, dtype) if true_biases is None
          else jnp.asarray(true_biases, dtype))

    def body(carry, xs):
        if self_consistent:
            x_truth, x_ref, hstate = carry
        else:
            x_ref, hstate = carry
        real_obs, idx, has, snc, t = xs
        g = gamma if snc is not None else None
        if g is not None and snc_ric:
            g = gamma @ ric_dcm(x_ref).T
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        if self_consistent:
            pair = jnp.stack([x_truth, x_ref])
            pair_new, stms = jax.vmap(
                lambda x: integrators.x_and_jac(phi_flow, x))(pair)
            x_truth, x_ref = pair_new[0], pair_new[1]
            stm = stms[1]
            obs_pair, ht_pair = jax.vmap(
                lambda x: _computed_obs(stations_list, x, theta, idx, has))(
                    pair_new)
            safe = jnp.maximum(idx, 0)
            bias_vec = jnp.zeros(obs_pair.shape[-1], dtype).at[range_row].set(
                jnp.where(has, tb[safe], 0.0))
            real_obs = obs_pair[0] + bias_vec
            comp_obs, htilde = obs_pair[1], ht_pair[1]
        else:
            x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
            comp_obs, htilde = _computed_obs(stations_list, x_ref, theta,
                                             idx, has)
        safe = jnp.maximum(idx, 0)
        onehot = (jnp.arange(n_st) == safe).astype(dtype) * has.astype(dtype)
        hc = jnp.zeros((htilde.shape[0], n_st), dtype).at[range_row].set(onehot)
        h_aug = jnp.concatenate([htilde, hc], axis=1)
        stm_aug = jax.scipy.linalg.block_diag(stm, eye_b)
        hstate, est = hybrid.step(
            model, hstate, stm_aug, h_aug, real_obs, comp_obs, has,
            gamma=g, snc=snc, gain_mask=gain_mask,
        )
        full = x_ref + hstate.x[:6]
        out = (full, hstate.x[:6], est.covariance[:6, :6], est.innovation,
               x_ref, est)
        if self_consistent:
            return (x_truth, x_ref, hstate), out + (x_truth,)
        return (x_ref, hstate), out

    snc_xs = snc_mask if use_snc else None
    xs = (meas.obs, meas.station_idx, meas.has_meas, snc_xs, times)
    if self_consistent:
        carry0 = (jnp.asarray(truth0, dtype), x0_ref, hstate0)
        _, (full, dev, cov, innov, refs, ests, truths) = jax.lax.scan(
            body, carry0, xs)
        return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests,
                        None, truths)
    _, (full, dev, cov, innov, refs, ests) = jax.lax.scan(
        body, (x0_ref, hstate0), xs)
    return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests)


@linalg.highp
def run_srif_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    non_tri_r: bool = False,
    t0: float = 0.0,
    snc_q=None,
    truth0=None,
) -> ODResult:
    """SRIF orbit determination (srif_test.go:66-341 recast as a scan).

    The SRIF is CKF-only (no reference reset) and carries the deviation
    in square-root information form; P0 must be diagonal (srif.go:22-26).

    `snc_q` (a [3, 3] acceleration PSD, the same quantity run_hybrid_od
    takes via noise.q + snc_mask) arms state-noise compensation through
    the Dyer–McReynolds factored time update (srif.smooth_all_q /
    srif._time_update): Q enters as √Q in a stacked Householder pass,
    never as a covariance — so the filter keeps square-root conditioning
    and runs in f32 where hybrid+SNC must run x64.  The reference's
    SRIF panics on process noise (srif.go:77-79).

    `truth0` (a [6] truth initial state) switches to SELF-CONSISTENT
    measurement generation: the truth is co-propagated inside the scan
    through the same batched integrator/station calls as the filter
    reference, and the observations are generated in-scan (meas.obs is
    ignored; has_meas/station_idx still schedule the passes).  This is
    how the reference's own tests work — one propagator instance feeds
    both truth and filter (srif_test.go:89-125).  A Q=0 truth-start
    filter cannot absorb any truth/filter propagator mismatch (two
    separately compiled programs may round differently); batching truth
    and reference through one compiled call makes such a discrepancy
    cancel in the innovation by construction.  The co-propagated truth is returned in
    ODResult.truth."""
    x0_ref = jnp.asarray(x0_ref)
    dtype = x0_ref.dtype
    steps = meas.obs.shape[0]
    eom = functools.partial(gravity.eom, degree=degree)
    phi_flow = integrators.flow(eom, dt, method, substeps)

    gamma = None
    if snc_q is not None:
        snc_q = jnp.asarray(snc_q, dtype)
        if snc_q.shape != (3, 3):
            raise ValueError("snc_q must be the 3x3 acceleration PSD")
        noise = noise._replace(q=snc_q)
        gamma = snc_gamma(dt, dtype)
    model, sstate0, _ = srif.new(jnp.zeros(6, dtype), jnp.asarray(p0), 2,
                                 non_tri_r, noise, gamma=gamma)
    times = t0 + dt * jnp.arange(1, steps + 1, dtype=dtype)
    self_consistent = truth0 is not None

    def body(carry, xs):
        if self_consistent:
            x_truth, x_ref, sstate = carry
        else:
            x_ref, sstate = carry
        real_obs, idx, has, t = xs
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        if self_consistent:
            # One BATCHED call propagates truth and reference and one
            # batched call observes both: identical compiled arithmetic
            # for the pair, so backend-level cross-program f64
            # discrepancies cancel in the innovation.
            pair = jnp.stack([x_truth, x_ref])
            pair_new, stms = jax.vmap(
                lambda x: integrators.x_and_jac(phi_flow, x))(pair)
            x_truth = pair_new[0]
            x_ref = pair_new[1]
            stm = stms[1]
            obs_pair, ht_pair = jax.vmap(
                lambda x: _computed_obs(stations_list, x, theta, idx, has)
            )(pair_new)
            real_obs = obs_pair[0]
            comp_obs, htilde = obs_pair[1], ht_pair[1]
        else:
            x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
            comp_obs, htilde = _computed_obs(stations_list, x_ref, theta,
                                             idx, has)
        sstate, est = srif.step(model, sstate, stm, htilde, real_obs, comp_obs, has)
        dev = est.state
        out = (x_ref + dev, dev, est.covariance, est.obs_dev, x_ref, est)
        if self_consistent:
            return (x_truth, x_ref, sstate), out + (x_truth,)
        return (x_ref, sstate), out

    xs = (meas.obs, meas.station_idx, meas.has_meas, times)
    if self_consistent:
        carry0 = (jnp.asarray(truth0, dtype), x0_ref, sstate0)
        _, (full, dev, cov, innov, refs, ests, truths) = jax.lax.scan(
            body, carry0, xs)
        return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests,
                        None, truths)
    _, (full, dev, cov, innov, refs, ests) = jax.lax.scan(body, (x0_ref, sstate0), xs)
    return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests)


@linalg.highp
def run_ukf_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    t0: float = 0.0,
    alpha: float = 1.0,
    beta: float = 2.0,
    kappa: float = 0.0,
) -> ODResult:
    """Full-state unscented orbit determination.

    No reference trajectory, no STM, no Jacobians: the sigma points are
    propagated through the orbital dynamics and the station measurement
    function directly (fx/hx are the actual nonlinear maps).  This is
    the estimator the reference's UKFType enum promises but never
    delivers — and it needs none of the Prepare(Φ, H̃) machinery.
    """
    from .filters import ukf

    x0_ref = jnp.asarray(x0_ref)
    dtype = x0_ref.dtype
    steps = meas.obs.shape[0]
    eom = functools.partial(gravity.eom, degree=degree)
    fx = integrators.flow(eom, dt, method, substeps)
    times = t0 + dt * jnp.arange(1, steps + 1, dtype=dtype)

    model, ustate0 = ukf.new(x0_ref, jnp.asarray(p0), noise, alpha, beta, kappa)

    def body(carry, xs):
        ustate = carry
        real_obs, idx, has, t = xs
        theta = theta0 + c.EARTH_ROTATION_RATE * t

        def hx(x):
            obs = jnp.stack([st.range_range_rate(s, x, theta) for s in stations_list])
            return obs[jnp.maximum(idx, 0)]

        # Masked step (symmetric with srif.step / hybrid.step): on
        # no-measurement steps the zeroed gain makes this exactly the
        # unscented time update — one computation, no select-of-two.
        ustate, est = ukf.step(model, ustate, real_obs, fx, hx, has=has)
        # Full-state estimator: no reference/deviation split (see
        # ODResult docstring) — ref_states carries the estimate,
        # deviations is identically zero.
        out = (est.state, jnp.zeros_like(est.state), est.covariance,
               est.innovation, est.state, est)
        return ustate, out

    xs = (meas.obs, meas.station_idx, meas.has_meas, times)
    _, (full, dev, cov, innov, refs, ests) = jax.lax.scan(body, ustate0, xs)
    return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests)


@linalg.highp
def run_enkf_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    key,
    n_ens: int = 64,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    t0: float = 0.0,
    inflation: float = 1.0,
) -> ODResult:
    """Ensemble (stochastic EnKF) orbit determination.

    Like run_ukf_od, fully derivative-free: no reference trajectory, no
    STM, no Jacobians — N ensemble members are integrated through the
    orbital dynamics and the station measurement map directly, and the
    perturbed-observation analysis replaces the linearized update.
    Useful when the state is later augmented beyond what sigma points
    cover economically, and as an independent cross-check on the
    CKF/UKF arcs.  `key` drives the initial spread, process-noise
    draws, and observation perturbations (deterministic given the key).
    """
    from .filters import enkf

    x0_ref = jnp.asarray(x0_ref)
    dtype = x0_ref.dtype
    steps = meas.obs.shape[0]
    eom = functools.partial(gravity.eom, degree=degree)
    fx = integrators.flow(eom, dt, method, substeps)
    times = t0 + dt * jnp.arange(1, steps + 1, dtype=dtype)

    k_init, k_run = jax.random.split(jnp.asarray(key))
    state0 = enkf.new(x0_ref, jnp.asarray(p0), n_ens, key=k_init)
    step_keys = jax.random.split(k_run, steps)

    def body(carry, xs):
        estate = carry
        real_obs, idx, has, t, k = xs
        theta = theta0 + c.EARTH_ROTATION_RATE * t

        def hx(x):
            obs = jnp.stack(
                [st.range_range_rate(s, x, theta) for s in stations_list]
            )
            return obs[jnp.maximum(idx, 0)]

        estate, est = enkf.step(noise, estate, real_obs, fx, hx, k,
                                inflation=inflation, has=has)
        # Full-state estimator: deviations ≡ 0, ref_states = estimate
        # (see ODResult docstring).
        out = (est.state, jnp.zeros_like(est.state), est.covariance,
               est.innovation, est.state, est)
        return estate, out

    xs = (meas.obs, meas.station_idx, meas.has_meas, times, step_keys)
    _, (full, dev, cov, innov, refs, ests) = jax.lax.scan(body, state0, xs)
    return ODResult(full, dev, cov, innov, refs, meas.has_meas, ests)


@linalg.highp
def run_batch_od(
    x0_ref,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    iterations: int = 1,
    t0: float = 0.0,
):
    """Iterated batch least-squares orbit determination.

    The classical Tapley batch processor the reference's batch filter
    implements the core of (batch.go:34-79; the reference stores Φ per
    measurement but never maps H to the epoch — batch.go:57): here
    H_k = H̃_k Φ(t_k, t_0) maps every observation to the epoch state,
    the normal equations are one einsum, and the whole
    propagate-accumulate-solve-correct iteration is jittable.

    Returns (x0_est [6], p0 [6,6], per-iteration residual RMS [it]).
    Note the weight passed to the normal equations is R^{-1} — the
    reference multiplies by whatever the caller supplies (batch.go:50),
    so its callers must pass inverse covariances; here it is explicit.
    """
    from .filters import batch as batch_ls

    x0 = jnp.asarray(x0_ref)
    dtype = x0.dtype
    steps = meas.obs.shape[0]
    eom = functools.partial(gravity.eom, degree=degree)
    phi_flow = integrators.flow(eom, dt, method, substeps)
    times = t0 + dt * jnp.arange(1, steps + 1, dtype=dtype)
    thetas = theta0 + c.EARTH_ROTATION_RATE * times
    r_inv = linalg.inv_psd(noise.r)

    def one_iteration(x0_i, _):
        def prop(carry, xs):
            x_ref, phi_acc = carry
            idx, has, theta = xs
            x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
            phi_acc = stm @ phi_acc  # Φ(t_k, t_0)
            comp, htilde = _computed_obs(stations_list, x_ref, theta, idx, has)
            h_k = htilde @ phi_acc  # maps epoch deviation to obs space
            return (x_ref, phi_acc), (comp, h_k)

        eye = jnp.eye(6, dtype=dtype)
        _, (comp_obs, hs) = jax.lax.scan(
            prop, (x0_i, eye), (meas.station_idx, meas.has_meas, thetas)
        )
        mask = meas.has_meas[:, None].astype(dtype)
        sol = batch_ls.solve(hs * mask[:, :, None], r_inv, meas.obs * mask,
                             comp_obs * mask)
        resid = (meas.obs - comp_obs) * mask
        rms = jnp.sqrt(jnp.sum(resid**2) / jnp.maximum(jnp.sum(meas.has_meas), 1))
        return x0_i + sol.x0, (rms, sol.p0)

    x0_est = x0
    rms_hist = []
    p0 = jnp.eye(6, dtype=dtype)
    for _ in range(iterations):
        x0_est, (rms, p0) = one_iteration(x0_est, None)
        rms_hist.append(rms)
    return x0_est, p0, jnp.stack(rms_hist)


def consider_bias_analysis(
    result: ODResult,
    meas: MeasurementSet,
    p0,
    r,
    bias_sigmas,
    range_row: int = 0,
):
    """Consider covariance analysis of an OD run for unestimated
    per-station range biases (TSB §6.6.2, the canonical statOD consider
    problem; the reference estimates full states only, srif_test.go).

    Answers, post-flight and without re-running the filter: "my OD
    solution ignored station range biases with a-priori sigmas
    `bias_sigmas` [n_stations] (km) — what is the TRUE error covariance
    of the states it produced?".  Uses the exact trace the hybrid run
    recorded (per-step STM, measurement Jacobian, gain), so the result
    is specific to THIS arc's pass geometry, not a generic bound.

    Mechanics: the per-step effective process noise the filter actually
    applied (SNC schedules, DMC Q, anything) is recovered exactly from
    the trace as Q_k = P̄_k − Φ_k P_{k-1} Φ_kᵀ, which makes the
    analysis's formal-covariance recursion reproduce `result.covariances`
    to roundoff (asserted in tests) — the consider recursion then rides
    on top via schmidt.consider_analysis.  The bias observation matrix
    is Hc_k = e_{range_row} ⊗ onehot(station_idx_k) on measurement
    steps, zero elsewhere.

    Returns schmidt.AnalysisResult ([T] stacks): `covariance` is the
    true error covariance (its formal counterpart understates it
    whenever a pass geometry makes the biases matter), and
    `cross_covariance` Cov(error, bias) shows which station's bias the
    estimate has absorbed.
    """
    from .filters import schmidt

    ests = result.estimates
    phis = ests.phi
    hs = ests.htilde
    gains = ests.gain
    t, n, _ = phis.shape
    p_meas = hs.shape[1]
    dtype = phis.dtype
    bias_sigmas = jnp.asarray(bias_sigmas, dtype)
    n_st = bias_sigmas.shape[0]
    p0 = jnp.asarray(p0, dtype)

    # Exact per-step additive process noise from the trace.
    prev_cov = jnp.concatenate([p0[None], result.covariances[:-1]], axis=0)
    q_eff = ests.pred_covariance - jnp.einsum(
        "tij,tjk,tlk->til", phis, prev_cov, phis)

    onehot = (jnp.arange(n_st)[None, :] == meas.station_idx[:, None]).astype(dtype)
    onehot = onehot * meas.has_meas[:, None].astype(dtype)
    if result.accepted is not None:
        onehot = onehot * result.accepted[:, None].astype(dtype)
    hc = jnp.zeros((t, p_meas, n_st), dtype)
    hc = hc.at[:, range_row, :].set(onehot)

    return schmidt.consider_analysis(
        phis, hs, gains, q_eff, jnp.asarray(r, dtype),
        consider_cov=jnp.diag(bias_sigmas**2), hc=hc, p0=p0,
    )


def rms_errors(result: ODResult, truth_states, tail: float = 0.5):
    """Position/velocity RMS of the estimation error over the last
    `tail` fraction of the arc (the srif_test.go:331-340 gate)."""
    # est_states may carry DMC's extra w components; compare PV only.
    err = result.est_states[:, :6] - jnp.asarray(truth_states)[:, :6]
    start = int(err.shape[0] * (1.0 - tail))
    pos = jnp.sqrt(jnp.mean(jnp.sum(err[start:, :3] ** 2, axis=1)))
    vel = jnp.sqrt(jnp.mean(jnp.sum(err[start:, 3:6] ** 2, axis=1)))
    return pos, vel
