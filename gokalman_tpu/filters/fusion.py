"""Multi-sensor track-to-track fusion: covariance intersection and
association tests.

The tracking tier (pdaf/jpda/tracker/pmb) turns detection frames into
tracks per sensor; a surveillance NETWORK then has to decide which
tracks from different sensors are the same object and fuse them.  The
textbook product rule (`fuse_independent`) is only valid when the two
estimates' errors are independent — never true for tracks that share
process noise (same target!) or prior information.  Fusing as if
independent double-counts shared information and yields an overconfident
covariance (pinned in tests).

Covariance intersection (Julier & Uhlmann 1997) is the standard fix
when the cross-covariance is UNKNOWN: fuse in information space with a
convex weight,

    P_f^-1 = w Pa^-1 + (1-w) Pb^-1,
    x_f    = P_f (w Pa^-1 xa + (1-w) Pb^-1 xb),

which is CONSISTENT (P_f upper-bounds the true fused-error covariance)
for EVERY feasible cross-covariance — the Julier-Uhlmann theorem,
pinned here over random joint covariances.  The price is conservatism:
with Pa == Pb, CI returns P (no claimed information gain — it cannot
rule out that both tracks carry exactly the same information).

Static-shape design: the det-minimizing weight is found by fixed-iteration
golden-section search on the convex -logdet (one slogdet per
iteration) — branch-free, jit-safe, vmappable over track pairs; all
solves are Cholesky-based via linalg.solve_psd (the covariances are SPD).

No reference counterpart (the reference is single-sensor); the
association gate mirrors the chi-square machinery of chisquare.go.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import linalg


class FusedEstimate(NamedTuple):
    state: jax.Array  # [n]
    covariance: jax.Array  # [n, n]
    omega: jax.Array  # [] CI weight on estimate a (1.0 for independent)


@linalg.highp
def fuse_independent(xa, pa, xb, pb) -> FusedEstimate:
    """Bartlett/product fusion for INDEPENDENT errors:
    P^-1 = Pa^-1 + Pb^-1.  Equivalent to a Kalman update of (xa, Pa)
    with measurement xb, H = I, R = Pb (pinned) — use only when the
    two tracks genuinely share no information."""
    xa, pa = jnp.asarray(xa), jnp.asarray(pa)
    xb, pb = jnp.asarray(xb), jnp.asarray(pb)
    ia = linalg.inv_psd(pa)
    ib = linalg.inv_psd(pb)
    p = linalg.inv_psd(ia + ib)
    x = p @ (ia @ xa + ib @ xb)
    return FusedEstimate(x, linalg.sym(p), jnp.ones((), pa.dtype))


def _ci_at(w, ia, ib, ya, yb):
    pinv = w * ia + (1.0 - w) * ib
    p = linalg.inv_psd(pinv)
    x = p @ (w * ya + (1.0 - w) * yb)
    return x, linalg.sym(p)


@linalg.highp
def covariance_intersection(xa, pa, xb, pb, omega=None,
                            iters: int = 60) -> FusedEstimate:
    """CI fusion; `omega` fixes the weight, None picks the
    det-minimizing one (the standard criterion) by golden-section
    search — -logdet(w Ia + (1-w) Ib) is convex in w (logdet is
    concave and the argument is linear), so the bracket shrinks by
    0.618 per fixed iteration: branch-free, jit-safe, vmappable,
    ~1e-10 bracket width at the default 60 iterations."""
    xa, pa = jnp.asarray(xa), jnp.asarray(pa)
    xb, pb = jnp.asarray(xb), jnp.asarray(pb)
    dt = pa.dtype
    ia, ib = linalg.inv_psd(pa), linalg.inv_psd(pb)
    ya, yb = ia @ xa, ib @ xb
    if omega is not None:
        w = jnp.asarray(omega, dt)
        x, p = _ci_at(w, ia, ib, ya, yb)
        return FusedEstimate(x, p, w)

    def obj(w):
        # minimize logdet P_f = -logdet(w Ia + (1-w) Ib)
        _, ld = jnp.linalg.slogdet(w * ia + (1.0 - w) * ib)
        return -ld

    w = linalg.golden_section(obj, jnp.zeros((), dt), jnp.ones((), dt),
                              iters)
    x, p = _ci_at(w, ia, ib, ya, yb)
    return FusedEstimate(x, p, w)


@linalg.highp
def fuse_known_cross(xa, pa, xb, pb, p_cross) -> FusedEstimate:
    """Bar-Shalom-Campo (1986) fusion for a KNOWN cross-covariance
    Pab = E[ea eb']: the optimal linear unbiased combination

        x_f = xa + (Pa - Pab) S^-1 (xb - xa),
        P_f = Pa - (Pa - Pab) S^-1 (Pa - Pab)',
        S   = Pa + Pb - Pab - Pab'.

    Exact (not conservative): P_f IS the true fused-error covariance.
    Pab = 0 reduces to `fuse_independent` (pinned — the push-through
    identity Pa (Pa+Pb)^-1 = (Ia+Ib)^-1 Ib); when the cross-covariance
    is unknown use `covariance_intersection` instead.  The returned
    omega field is fixed at 1 (no CI weight applies)."""
    xa, pa = jnp.asarray(xa), jnp.asarray(pa)
    xb, pb = jnp.asarray(xb), jnp.asarray(pb)
    pab = jnp.asarray(p_cross)
    s = linalg.sym(pa + pb - pab - pab.T)
    w = linalg.solve_psd(s, (pa - pab).T).T  # (Pa - Pab) S^-1
    x = xa + w @ (xb - xa)
    p = linalg.sym(pa - w @ (pa - pab).T)
    return FusedEstimate(x, p, jnp.ones((), pa.dtype))


@linalg.highp
def t2t_statistic(xa, pa, xb, pb, p_cross=None):
    """Track-to-track association statistic (Bar-Shalom 1981):
    d = xa - xb, T = d' S^-1 d with S = Pa + Pb - Pab - Pab'
    (`p_cross` = Pab; None assumes independent errors).  Under the
    same-target hypothesis T ~ chi-square(n); gate at e.g. the 99%
    quantile.  Tracks of the SAME target estimated from shared process
    noise are positively correlated — omitting a known Pab makes S too
    big and the test too lenient (pinned)."""
    xa, pa = jnp.asarray(xa), jnp.asarray(pa)
    xb, pb = jnp.asarray(xb), jnp.asarray(pb)
    d = xa - xb
    s = pa + pb
    if p_cross is not None:
        pc = jnp.asarray(p_cross)
        s = s - pc - pc.T
    return d @ linalg.solve_psd(linalg.sym(s), d)


def associate_tracks(xa, pa, mask_a, xb, pb, mask_b, gate: float,
                     p_cross=None):
    """Optimal track-to-track association between two padded track
    sets: minimize the total `t2t_statistic` over one-to-one
    assignments, with any pair above `gate` (chi-square) left
    unmatched.  Exact — enumerates permutations of the padded size at
    trace time (the diagnostics.ospa idiom; sizes ≤ 8, the scale of
    the tracking tier), so it never falls into the greedy trap of
    locking a good pair that forces a terrible one.

    `xa` [Na, n] / `pa` [Na, n, n] / `mask_a` [Na] (same for b);
    `p_cross` optionally supplies a COMMON cross-covariance for all
    pairs (tracks of one target share process noise).  Returns
    (assignment [Na] int32 — index into b or -1, statistic [Na]).
    """
    import itertools as _it

    import numpy as _np

    xa, pa = jnp.asarray(xa), jnp.asarray(pa)
    xb, pb = jnp.asarray(xb), jnp.asarray(pb)
    mask_a = jnp.asarray(mask_a, bool)
    mask_b = jnp.asarray(mask_b, bool)
    na, nb = xa.shape[0], xb.shape[0]
    if max(na, nb) > 8:
        raise ValueError(
            f"associate_tracks enumerates assignments exactly; padded "
            f"sizes up to 8 supported (got {na}x{nb})")
    dt = pa.dtype
    g = jnp.asarray(gate, dt)

    stat = jax.vmap(lambda x1, p1: jax.vmap(
        lambda x2, p2: t2t_statistic(x1, p1, x2, p2, p_cross))(xb, pb))(
        xa, pa)  # [Na, Nb]
    valid = mask_a[:, None] & mask_b[None, :] & (stat <= g)
    # PER-SIDE unmatched accounting: the objective is
    #   sum(matched stats) + gate * (#unmatched_a + #unmatched_b).
    # In the padded square assignment, a real-real cell that is NOT a
    # match absorbs BOTH tracks, so it must cost 2*gate (a single-gate
    # cell lets the optimizer drop an in-gate pair because unmatching
    # both sides looked half price — measured: stats
    # [[15, inf], [14, 15.9]] at gate 16 returned [-1, 0] instead of
    # the correct [0, 1]); a real-padded cell drops one track (gate),
    # padded-padded is free.
    big = max(na, nb)
    row_real = jnp.concatenate(
        [mask_a, jnp.zeros((big - na,), bool)])
    col_real = jnp.concatenate(
        [mask_b, jnp.zeros((big - nb,), bool)])
    both = row_real[:, None] & col_real[None, :]
    one = row_real[:, None] ^ col_real[None, :]
    cost = jnp.where(one, g, 0.0).astype(dt)
    cost = cost.at[:na, :nb].set(
        jnp.where(valid, stat,
                  jnp.where(both[:na, :nb], 2.0 * g, cost[:na, :nb])))
    perms = jnp.asarray(
        _np.array(list(_it.permutations(range(big)))), jnp.int32)
    perm_costs = jax.vmap(
        lambda pr: jnp.sum(cost[jnp.arange(big), pr]))(perms)
    best = perms[jnp.argmin(perm_costs)]  # [big] b-index per a-slot
    best_a = best[:na]
    matched = valid[jnp.arange(na), jnp.clip(best_a, 0, nb - 1)] \
        & (best_a < nb)
    assignment = jnp.where(matched, best_a, -1).astype(jnp.int32)
    statistic = stat[jnp.arange(na), jnp.clip(best_a, 0, nb - 1)]
    statistic = jnp.where(matched, statistic, jnp.inf)
    return assignment, statistic


def associate_and_fuse(xa, pa, mask_a, xb, pb, mask_b, gate: float,
                       p_cross=None, omega=None):
    """Associate two track sets and fuse: matched pairs by covariance
    intersection (or `fuse_known_cross` when `p_cross` is given),
    unmatched tracks from BOTH sides passed through.  Returns a padded
    fused set (xs [Na+Nb, n], ps [Na+Nb, n, n], mask [Na+Nb]): slots
    0..Na-1 hold a-side tracks (fused where matched), the rest hold
    b's unmatched leftovers."""
    xa, pa = jnp.asarray(xa), jnp.asarray(pa)
    xb, pb = jnp.asarray(xb), jnp.asarray(pb)
    mask_a = jnp.asarray(mask_a, bool)
    mask_b = jnp.asarray(mask_b, bool)
    na, nb = xa.shape[0], xb.shape[0]
    assignment, _ = associate_tracks(xa, pa, mask_a, xb, pb, mask_b,
                                     gate, p_cross)
    matched = assignment >= 0
    idx = jnp.clip(assignment, 0, nb - 1)

    def fuse_one(x1, p1, x2, p2, m_):
        if p_cross is not None:
            fe = fuse_known_cross(x1, p1, x2, p2, p_cross)
        else:
            fe = covariance_intersection(x1, p1, x2, p2, omega=omega)
        return (jnp.where(m_, fe.state, x1),
                jnp.where(m_, fe.covariance, p1))

    xs_a, ps_a = jax.vmap(fuse_one)(xa, pa, xb[idx], pb[idx], matched)
    # b-side leftovers: any valid b-track not claimed by a match
    claimed = jnp.zeros((nb,), bool).at[idx].max(matched)
    leftover = mask_b & ~claimed
    xs = jnp.concatenate([xs_a, xb], axis=0)
    ps = jnp.concatenate([ps_a, pb], axis=0)
    mask = jnp.concatenate([mask_a, leftover])
    return xs, ps, mask


@linalg.highp
def inverse_covariance_intersection(xa, pa, xb, pb, omega=None,
                                    iters: int = 60) -> FusedEstimate:
    """Inverse covariance intersection (Noack, Sijs & Hanebeck 2017): tighter than CI while
    still consistent when the dependence between the two estimates
    comes from COMMON INFORMATION (shared prior, shared process noise
    — exactly how two trackers of one target correlate):

        P_f^-1 = Pa^-1 + Pb^-1 - (w Pa + (1-w) Pb)^-1
        x_f    = P_f (K xa + L xb),
        K = Pa^-1 - w (w Pa + (1-w) Pb)^-1,
        L = Pb^-1 - (1-w) (w Pa + (1-w) Pb)^-1

    (P_f K + P_f L = I, so the combination is unbiased for any w.)
    The subtracted term removes the double-counted common information
    that plain `fuse_independent` double-counts and CI bounds away;
    det(P_ICI) <= det(P_CI) always (pinned).  Use CI when the
    dependence may be ADVERSARIAL rather than common-information-
    shaped — inverse CI's consistency guarantee is the weaker (but usually
    realistic) one.  `omega` fixes the weight; None minimizes the
    fused logdet by the same golden-section scheme as CI."""
    xa, pa = jnp.asarray(xa), jnp.asarray(pa)
    xb, pb = jnp.asarray(xb), jnp.asarray(pb)
    dt = pa.dtype
    ia, ib = linalg.inv_psd(pa), linalg.inv_psd(pb)

    def fuse_at(w):
        mix_inv = linalg.inv_psd(linalg.sym(w * pa + (1.0 - w) * pb))
        lam = linalg.sym(ia + ib - mix_inv)
        p = linalg.inv_psd(lam)
        k = ia - w * mix_inv
        l_ = ib - (1.0 - w) * mix_inv
        x = p @ (k @ xa + l_ @ xb)
        return x, linalg.sym(p)

    if omega is not None:
        w = jnp.asarray(omega, dt)
        x, p = fuse_at(w)
        return FusedEstimate(x, p, w)

    def obj(w):
        mix_inv = linalg.inv_psd(linalg.sym(w * pa + (1.0 - w) * pb))
        _, ld = jnp.linalg.slogdet(ia + ib - mix_inv)
        return -ld

    w = linalg.golden_section(obj, jnp.zeros((), dt), jnp.ones((), dt),
                              iters)
    x, p = fuse_at(w)
    return FusedEstimate(x, p, w)


@linalg.highp
def covariance_intersection_n(xs, ps, sweeps: int = 8,
                              iters: int = 30) -> FusedEstimate:
    """N-estimate covariance intersection: P_f^-1 = sum_i w_i P_i^-1
    over the simplex (sum w = 1, w >= 0) — consistent for EVERY
    feasible joint correlation at ANY simplex point (each candidate is
    an upper bound; optimization only tightens).  Sequential pairwise
    CI is a valid but weight-suboptimal special case (pinned: the
    joint optimum is never looser).

    Weight search: cyclic coordinate descent on the simplex — each
    sweep golden-sections one weight against the rest (renormalized),
    `sweeps` passes of `iters` iterations; -logdet(sum w_i I_i) is
    convex over the simplex so coordinate descent converges.  N == 2
    reduces to `covariance_intersection` (pinned).

    `xs` [N, n], `ps` [N, n, n].  Returns omega = the weight on
    estimate 0."""
    xs, ps = jnp.asarray(xs), jnp.asarray(ps)
    n_est = xs.shape[0]
    dt = ps.dtype
    infos = jax.vmap(linalg.inv_psd)(ps)  # [N, n, n]
    ys = jnp.einsum("nij,nj->ni", infos, xs)  # [N, n]

    def obj_w(w):
        _, ld = jnp.linalg.slogdet(jnp.einsum("n,nij->ij", w, infos))
        return -ld

    def sweep_coord(w, i):
        # reoptimize w[i] = t against the others scaled by (1-t)
        others = w.at[i].set(0.0)
        others_sum = jnp.maximum(jnp.sum(others), 1e-30)
        others = others / others_sum

        def obj_t(t):
            return obj_w((1.0 - t) * others
                         + t * jnp.zeros_like(w).at[i].set(1.0))

        t = linalg.golden_section(obj_t, jnp.zeros((), dt),
                                  jnp.ones((), dt), iters)
        return (1.0 - t) * others + t * jnp.zeros_like(w).at[i].set(1.0)

    def one_sweep(w, _):
        w = jax.lax.fori_loop(0, n_est,
                              lambda i, w_: sweep_coord(w_, i), w)
        return w, None

    w0 = jnp.full((n_est,), 1.0 / n_est, dt)
    w, _ = jax.lax.scan(one_sweep, w0, None, length=sweeps)
    lam = jnp.einsum("n,nij->ij", w, infos)
    p = linalg.inv_psd(linalg.sym(lam))
    x = p @ jnp.einsum("n,ni->i", w, ys)
    return FusedEstimate(x, linalg.sym(p), w[0])
