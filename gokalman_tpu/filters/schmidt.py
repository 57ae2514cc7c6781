"""Schmidt-Kalman (consider) filter: account for parameters you refuse
to estimate.

The classic statOD problem (Schmidt 1966; Tapley, Schutz & Born §6.6):
the system depends on nuisance parameters c — station biases, gravity
coefficients, drag multipliers — whose values are uncertain but which
you deliberately do NOT estimate (too weakly observable, or estimating
them would soak up signal and alias errors into the state).  Ignoring
their uncertainty makes the filter overconfident (NEES blows past n);
estimating them may be impossible.  The consider filter is the third
way: carry the joint covariance

    P_a = [[Pxx, Pxc],
           [Pxc',Pcc]]

through the full augmented dynamics/measurement model, but constrain
the gain to K_a = [Kx; 0] — the consider-parameter mean NEVER moves,
while the state gain

    Kx = (Pxx^- H' + Pxc^- Hc') S^{-1},
    S  = H_a P_a^- H_a' + R,   H_a = [H, Hc]

sees both the direct innovation and the bias-induced correlation.  The
Joseph covariance update is valid for ANY gain, so the constrained
update is exact — the reported Pxx is the true error covariance of the
consider estimator, which is what keeps NEES calibrated where the
naive filter is overconfident (pinned in tests/test_schmidt.py).

The reference has no consider analysis (its statOD arcs estimate the
full state, srif_test.go); this closes a capability its own problem
domain calls for.

Design: rather than bespoke block algebra, the filter IS a
vanilla CKF on the augmented state with a zero-masked gain — one code
path, batched matmuls do blocks for free, and `run` is the usual single
`lax.scan`.  Augmented model (consider dynamics default to constant
parameters):

    [x]     [[F, B ],  [x]     [G]       [w]
    [c]_k+1 =[0, Fc]]  [c]_k + [0] u_k + [wc],   y = H x + Hc c + v.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise, noiseless
from . import vanilla


class Model(NamedTuple):
    aug: vanilla.Model  # augmented-state CKF model
    n: int  # estimated-state dimension (static)
    q: int  # consider-parameter dimension (static)


class State(NamedTuple):
    x: jax.Array  # [n + q] augmented mean; the c-block never moves
    p: jax.Array  # [n + q, n + q] joint covariance
    k: jax.Array  # [] int32 step counter


class Estimate(NamedTuple):
    """Per-step consider-filter output.

    `state`/`covariance` are the ESTIMATED blocks ([n], [n, n] — Pxx is
    the honest error covariance including consider inflation);
    `cross_covariance` is Pxc, `consider_covariance` the (time-updated)
    Pcc.  `full_covariance` carries the joint for downstream consider
    analysis / smoothing.
    """

    state: jax.Array  # [n] x^+
    consider: jax.Array  # [q] c̄ (constant by construction)
    measurement: jax.Array  # [p] ŷ from the previous state
    innovation: jax.Array  # [p]
    covariance: jax.Array  # [n, n] Pxx^+
    cross_covariance: jax.Array  # [n, q] Pxc^+
    consider_covariance: jax.Array  # [q, q] Pcc
    full_covariance: jax.Array  # [n+q, n+q]
    pred_covariance: jax.Array  # [n+q, n+q] joint prior
    gain: jax.Array  # [n, p] Kx

    def within_nsigma(self, n_sigma) -> jax.Array:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(
    x0,
    p0,
    f,
    h,
    noise: Noise,
    consider_cov,
    b=None,
    hc=None,
    g=None,
    consider_mean=None,
    fc=None,
    qc=None,
    cross_cov=None,
):
    """Build (Model, State) for n estimated states and q considers.

    `consider_cov` [q, q] is Pcc(0); `b` [n, q] couples c into the
    dynamics, `hc` [p, q] into the measurement (either may be None for
    zero).  `consider_mean` defaults to zeros — the a-priori parameter
    values, never updated.  `fc`/`qc` give the considers their own
    dynamics (default: constants — Fc = I, Qc = 0; pass a Gauss-Markov
    Fc = exp(-dt/τ) I with its Van Loan Qc for ECRV considers).
    `cross_cov` [n, q] seeds Pxc(0) (default zero).
    """
    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    f = jnp.asarray(f)
    h = jnp.atleast_2d(jnp.asarray(h))
    pcc = jnp.atleast_2d(jnp.asarray(consider_cov))
    n = x0.shape[0]
    q = pcc.shape[0]
    p_meas = h.shape[0]
    dt = p0.dtype

    b = jnp.zeros((n, q), dt) if b is None else jnp.asarray(b).reshape(n, q)
    hc = jnp.zeros((p_meas, q), dt) if hc is None else jnp.asarray(hc).reshape(p_meas, q)
    fc = jnp.eye(q, dtype=dt) if fc is None else jnp.atleast_2d(jnp.asarray(fc))
    qc = jnp.zeros((q, q), dt) if qc is None else jnp.atleast_2d(jnp.asarray(qc))
    cbar = jnp.zeros(q, dt) if consider_mean is None else jnp.asarray(consider_mean)
    pxc = jnp.zeros((n, q), dt) if cross_cov is None else jnp.asarray(cross_cov)
    linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (n, 1), "H", "x0", "cols2rows")
    linalg.check_dims(fc.shape, pcc.shape, "Fc", "Pcc", "rows2cols")

    f_a = jnp.block([[f, b], [jnp.zeros((q, n), dt), fc]])
    h_a = jnp.concatenate([h, hc], axis=1)
    q_a = jax.scipy.linalg.block_diag(jnp.asarray(noise.q), qc)
    g_a = None
    if g is not None and not linalg.is_nil(g):
        g = jnp.asarray(g)
        g_a = jnp.concatenate([g, jnp.zeros((q, g.shape[1]), dt)], axis=0)
    x_a = jnp.concatenate([x0, cbar])
    p_a = jnp.block([[p0, pxc], [pxc.T, pcc]])

    aug_noise = noise._replace(q=q_a)
    aug_model, aug_state = vanilla.new(x_a, p_a, f_a, g_a, h_a, aug_noise)
    return Model(aug_model, n, q), State(aug_state.x, aug_state.p, aug_state.k)


def _consider_mask(model: Model, dtype):
    return (jnp.arange(model.n + model.q) < model.n).astype(dtype)


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One consider update.  Exactly the augmented CKF time update +
    gain, with the gain's consider rows zeroed before the (gain-generic)
    Joseph covariance update — so Pxc/Pcc track the constrained
    estimator, not the would-be augmented filter."""
    m, n = model.aug, model.n
    x_pred, p_pred = vanilla.predict(m, State(state.x, state.p, state.k), control)
    y_hat = m.h @ state.x
    k_full = vanilla.gain(m, p_pred)
    k_eff = k_full * _consider_mask(model, k_full.dtype)[:, None]
    innovation = measurement - m.h @ x_pred
    x = x_pred + k_eff @ innovation
    p = vanilla.joseph_update(p_pred, k_eff, m.h, m.noise.r)
    est = Estimate(
        state=x[:n],
        consider=x[n:],
        measurement=y_hat,
        innovation=innovation,
        covariance=p[:n, :n],
        cross_covariance=p[:n, n:],
        consider_covariance=p[n:, n:],
        full_covariance=p,
        pred_covariance=p_pred,
        gain=k_eff[:n],
    )
    return State(x, p, state.k + 1), est


def run(model: Model, state: State, measurements, controls=None):
    """Scan `step` over [T, p] measurements (one jitted lax.scan)."""
    measurements = jnp.asarray(measurements)

    def body(st, inp):
        y, u = inp
        return step(model, st, y, u)

    if controls is None:
        controls = jnp.zeros((measurements.shape[0], 0))
        model = Model(model.aug._replace(g=None), model.n, model.q)
    return jax.lax.scan(body, state, (measurements, jnp.asarray(controls)))


class AnalysisResult(NamedTuple):
    covariance: jax.Array  # [T, n, n] TRUE error covariance of the run
    cross_covariance: jax.Array  # [T, n, q] Cov(error, c)
    formal_covariance: jax.Array  # [T, n, n] what the filter believed


@linalg.highp
def consider_analysis(
    phis,
    hs,
    gains,
    q,
    r,
    consider_cov,
    hc=None,
    b=None,
    fc=None,
    qc=None,
    p0=None,
):
    """Consider covariance ANALYSIS (TSB §6.6.2): given the gain
    sequence an already-designed filter actually used — a filter that
    IGNORED the consider parameters — compute the true error covariance
    of that filter's estimates.

    This is the post-design question the Schmidt filter's online form
    answers in-loop: "my flight filter doesn't model the station bias;
    how wrong is its covariance?".  The recursion propagates the error
    e = x̂ − x jointly with c (S = Cov(e, c)):

        e⁻ = Φ e − B c − w            S⁻ = Φ S − B Pcc
        e  = (I−KH) e⁻ + K Hc c + K v
        S  = (I−KH) S⁻ + K Hc Pcc
        P  = (I−KH) P⁻ (I−KH)' + K R K' + K Hc Pcc Hc' K'
             + (I−KH) S⁻ Hc' K' + (K Hc S⁻')(I−KH)'

    Exactness pins (tests/test_schmidt.py): with Hc = B = 0 the result
    IS the filter's formal covariance; fed the Schmidt filter's own
    gains it reproduces the Schmidt Pxx/Pxc to roundoff (the Schmidt
    covariance is the true covariance of the constrained estimator);
    against a Monte Carlo over bias draws it matches the naive filter's
    empirical error covariance.

    Sign convention: `cross_covariance` is S = Cov(e, c) with
    e = x̂ − x and c the parameter itself.  The Schmidt FILTER carries
    Cov(x̂−x, ĉ−c) = −S (its ĉ is pinned at the prior mean, so its
    c-error is −c); fed the Schmidt filter's own gains this recursion
    reproduces its Pxx exactly and its Pxc up to that sign
    (tests/test_od_consider.py pins both).

    `phis`/`hs`/`gains` are [T, n, n]/[T, p, n]/[T, n, p] stacks from a
    filter trace (e.g. `Estimate.gain` + the model matrices, or an OD
    run's `ests.phi`/`ests.htilde`/`ests.gain`); `q`/`r` may be single
    matrices or [T, ...] stacks.  `consider_cov` is Pcc(0); `fc`/`qc`
    give the considers dynamics (default constants).  `p0` is the
    filter's initial covariance (defaults: the true initial error
    covariance equals it, with zero initial cross-covariance).
    """
    phis = jnp.asarray(phis)
    t, n, _ = phis.shape
    hs = jnp.asarray(hs)
    gains = jnp.asarray(gains)
    pcc0 = jnp.atleast_2d(jnp.asarray(consider_cov))
    qdim = pcc0.shape[0]
    p = hs.shape[-2]
    dt = phis.dtype
    q = jnp.broadcast_to(jnp.atleast_2d(jnp.asarray(q)), (t, n, n))
    r = jnp.broadcast_to(jnp.atleast_2d(jnp.asarray(r)), (t, p, p))
    hc = (jnp.zeros((t, p, qdim), dt) if hc is None
          else jnp.broadcast_to(jnp.asarray(hc), (t, p, qdim)))
    b = (jnp.zeros((t, n, qdim), dt) if b is None
         else jnp.broadcast_to(jnp.asarray(b), (t, n, qdim)))
    fc = (jnp.broadcast_to(jnp.eye(qdim, dtype=dt), (t, qdim, qdim))
          if fc is None else jnp.broadcast_to(jnp.asarray(fc), (t, qdim, qdim)))
    qc = (jnp.zeros((t, qdim, qdim), dt) if qc is None
          else jnp.broadcast_to(jnp.asarray(qc), (t, qdim, qdim)))
    if p0 is None:
        raise ValueError("p0 (the filter's initial covariance) is required")
    p0 = jnp.asarray(p0)
    eye = jnp.eye(n, dtype=dt)

    def body(carry, xs):
        p_true, s, pcc = carry
        phi_k, h_k, k_k, q_k, r_k, hc_k, b_k, fc_k, qc_k = xs
        # time update of (e, c) jointly
        p_pred = (phi_k @ p_true @ phi_k.T + q_k
                  + b_k @ pcc @ b_k.T
                  - phi_k @ s @ b_k.T - b_k @ (phi_k @ s).T)
        s_pred = phi_k @ s @ fc_k.T - b_k @ pcc @ fc_k.T
        pcc_new = fc_k @ pcc @ fc_k.T + qc_k
        # measurement update with the GIVEN gain
        ikh = eye - k_k @ h_k
        khc = k_k @ hc_k
        p_new = (ikh @ p_pred @ ikh.T + k_k @ r_k @ k_k.T
                 + khc @ pcc_new @ khc.T
                 + ikh @ s_pred @ khc.T + khc @ s_pred.T @ ikh.T)
        s_new = ikh @ s_pred + khc @ pcc_new
        # the filter's own (consider-blind) formal covariance
        return ((linalg.sym(p_new), s_new, linalg.sym(pcc_new)),
                (linalg.sym(p_new), s_new))

    init = (p0, jnp.zeros((n, qdim), dt), pcc0)
    _, (p_true, s_out) = jax.lax.scan(
        body, init, (phis, hs, gains, q, r, hc, b, fc, qc))

    # formal covariances: same recursion with the considers zeroed
    def formal_body(pf, xs):
        phi_k, h_k, k_k, q_k, r_k = xs
        p_pred = phi_k @ pf @ phi_k.T + q_k
        ikh = eye - k_k @ h_k
        p_new = linalg.sym(ikh @ p_pred @ ikh.T + k_k @ r_k @ k_k.T)
        return p_new, p_new

    _, p_formal = jax.lax.scan(formal_body, p0, (phis, hs, gains, q, r))
    return AnalysisResult(p_true, s_out, p_formal)


@linalg.highp
def consider_inflation(model: Model, estimate: Estimate):
    """The consider contribution to Pxx: the conditional decomposition
    Pxx = P_{x|c} + Pxc Pcc⁻¹ Pcxᵀ splits the carried covariance into
    what would remain if c were known exactly (P_{x|c}) and the PSD
    part explained by consider uncertainty — returned here.  It is the
    standard consider-analysis diagnostic for "how much are these
    parameters costing me"; exactly zero when the considers are
    decoupled (B = Hc = 0, Pxc(0) = 0 — then the filter IS vanilla,
    pinned in tests)."""
    del model
    pxc = estimate.cross_covariance
    pcc = estimate.consider_covariance
    return linalg.sym(pxc @ linalg.solve_psd(pcc, pxc.T))
