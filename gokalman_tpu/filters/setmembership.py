"""Set-membership (ellipsoidal) filtering: unknown-but-BOUNDED noise,
guaranteed state enclosures.

The whole stochastic tier answers "what is the distribution of x?";
safety cases ask a different question — "what is a set that PROVABLY
contains x?"  When the noises carry no distribution at all, only
bounds (quantization, calibration envelopes, adversarial-but-bounded
disturbances), the Schweppe (1968) / Fogel-Huang (1982) recursion
propagates an ellipsoid E(c, X) = {x : (x-c)' X^-1 (x-c) <= 1} that
contains the true state AT EVERY STEP by construction (pinned over MC
with worst-case-ish noise draws — containment is 100%, not 95%):

  predict   x+ = F x + G u + w,  w in E(0, Q):
            the Minkowski sum is outer-bounded by the minimal-TRACE
            ellipsoid  X+ = (1 + 1/p) F X F' + (1 + p) Q  with
            p = sqrt(tr(F X F') / tr(Q))  (exact optimizer of the
            one-parameter family; support-function bound pinned).

  update    y = H x + v,  v in E(0, R):
            the measurement set {x : (y - Hx)' R^-1 (y - Hx) <= 1} is
            fused by the exact convex-combination outer bound: for any
            lam in [0, 1),
              Lam  = (1-lam) X^-1 + lam H'R^-1 H
              c'   = Lam^-1 ((1-lam) X^-1 c + lam H'R^-1 y)
              alpha= 1 - [(1-lam) c'X^-1 c + lam y'R^-1 y - c''Lam c']
            and E(c', alpha Lam^-1) contains the intersection (a
            completing-the-square identity, not an approximation —
            containment pinned by sampling).  lam minimizes
            tr(alpha Lam^-1) by the library's branch-free golden
            section; alpha < 0 certifies an EMPTY intersection
            (measurement inconsistent with the set — the fault flag).

Relation to the rest of the robust tier: `studentt` reweights
outliers, `hinf` bounds worst-case energy gain, this module gives
hard guarantees under hard bounds.  Complements the KF rather than
replacing it: the ellipsoid is a certificate, the KF a point estimate.

Design: pure step/run over NamedTuple pytrees, lax.scan, fixed
golden-section iterations, Cholesky solves (the shape matrices are SPD).
No reference counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import linalg
from ..noise import Noise


class Model(NamedTuple):
    f: jax.Array  # [n, n]
    g: Optional[jax.Array]  # [n, m] or None
    h: jax.Array  # [p, n]
    q: jax.Array  # [n, n] process-noise BOUND ellipsoid shape
    r: jax.Array  # [p, p] measurement-noise BOUND ellipsoid shape
    lam_iters: int  # static golden-section iterations


class State(NamedTuple):
    c: jax.Array  # [n] ellipsoid center
    x: jax.Array  # [n, n] ellipsoid shape (PSD)
    k: jax.Array  # [] int32


class Estimate(NamedTuple):
    center: jax.Array  # [n]
    shape: jax.Array  # [n, n] (x in E iff (x-c)' shape^-1 (x-c) <= 1)
    consistent: jax.Array  # [] bool: measurement intersected the set
    lam: jax.Array  # [] fusion weight chosen
    trace: jax.Array  # [] tr(shape) — the size the update minimizes


def new(x0, shape0, f, g, h, noise: Noise, lam_iters: int = 40):
    """Build (Model, State).  `noise.q`/`noise.r` are BOUND shapes: the
    guarantee requires w'Q^-1 w <= 1 and v'R^-1 v <= 1 always (e.g.
    for |w_i| <= b_i componentwise use Q = diag(n b^2) — the box's
    circumscribed ellipsoid).  `shape0` must contain the true x0."""
    x0, shape0 = jnp.asarray(x0), jnp.asarray(shape0)
    f, h = jnp.asarray(f), jnp.asarray(h)
    if x0.shape != (f.shape[0],) or shape0.shape != f.shape:
        raise ValueError(
            f"dimensions must agree: x0{x0.shape} shape0{shape0.shape} "
            f"F{f.shape} [setmembership.new]")
    g = None if g is None else jnp.asarray(g)
    return (Model(f, g, h, jnp.asarray(noise.q), jnp.asarray(noise.r),
                  int(lam_iters)),
            State(x0, shape0, jnp.int32(0)))


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One guaranteed-enclosure step."""
    f, h, q, r = model.f, model.h, model.q, model.r
    dt = state.x.dtype

    # ---- predict: minimal-trace Minkowski outer bound
    c_pred = f @ state.c
    if model.g is not None and control is not None:
        c_pred = c_pred + model.g @ control
    a = linalg.sym(f @ state.x @ f.T)
    p_opt = jnp.sqrt(jnp.maximum(jnp.trace(a), 1e-30)
                     / jnp.maximum(jnp.trace(q), 1e-30))
    x_pred = linalg.sym((1.0 + 1.0 / p_opt) * a + (1.0 + p_opt) * q)

    # ---- update: convex-combination fusion with the measurement set
    xinv = linalg.inv_psd(x_pred)
    hrh = linalg.sym(h.T @ linalg.solve_psd(r, h))
    hry = h.T @ linalg.solve_psd(r, measurement)
    yry = measurement @ linalg.solve_psd(r, measurement)
    cxc = c_pred @ xinv @ c_pred

    def fuse(lam):
        lam_m = (1.0 - lam) * xinv + lam * hrh
        p = linalg.inv_psd(linalg.sym(lam_m))
        c = p @ ((1.0 - lam) * (xinv @ c_pred) + lam * hry)
        alpha = 1.0 - ((1.0 - lam) * cxc + lam * yry
                       - c @ lam_m @ c)
        return c, p, alpha

    def obj(lam):
        _, p, alpha = fuse(lam)
        # minimize the bound's size; empty-intersection lam are +inf
        return jnp.where(alpha > 0, alpha * jnp.trace(p), jnp.inf)

    # lam in [0, 1): lam = 1 drops the prior entirely (H'R^-1H is
    # singular for p < n, so the pure-measurement end is excluded)
    lam = linalg.golden_section(obj, jnp.zeros((), dt),
                                jnp.asarray(0.999, dt), model.lam_iters)
    c_fit, p_fit, alpha = fuse(lam)
    consistent = alpha > 0
    # lam = 0 keeps the prediction EXACTLY (alpha = 1 by construction
    # — use c_pred/x_pred directly, not fuse(0), which would invert
    # xinv back and lose digits at high condition): the safe fallback
    # when every lam empties (inconsistent measurement) and also when
    # fusing would grow the set
    better = consistent & (alpha * jnp.trace(p_fit) < jnp.trace(x_pred))
    c_new = jnp.where(better, c_fit, c_pred)
    x_new = linalg.sym(jnp.where(better, alpha * p_fit, x_pred))
    lam_out = jnp.where(better, lam, 0.0)  # the weight ACTUALLY applied

    est = Estimate(c_new, x_new, consistent, lam_out, jnp.trace(x_new))
    return State(c_new, x_new, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None):
    """lax.scan over [T, p] measurements."""
    measurements = jnp.asarray(measurements)
    if controls is None:
        def body(carry, y):
            return step(model, carry, y)

        return jax.lax.scan(body, state, measurements)

    def body_u(carry, ys):
        y, u = ys
        return step(model, carry, y, u)

    return jax.lax.scan(body_u, state, (measurements,
                                        jnp.asarray(controls)))
