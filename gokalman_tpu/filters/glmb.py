"""delta-GLMB filter: hypothesis-carrying labeled-RFS tracking.

The delta-generalized-labeled-multi-Bernoulli filter (Vo & Vo 2013,
"Labeled random finite sets and multi-object conjugate priors"; Vo, Vo
& Phung 2014 implementation) propagates the EXACT multi-target Bayes
posterior for the standard model as a weighted set of global
hypotheses

    pi(X) = sum_h  w_h  delta_{I_h}(L(X))  prod_{l in I_h} p_h(x, l),

each hypothesis h = (label set I_h, association history xi_h) carrying
its own per-label Gaussian.  `lmb` is the single-step marginalization
of this filter (Reuter 2014 derives LMB by collapsing the delta-GLMB
update to per-label marginals each frame); the delta-GLMB keeps the
joint, so multi-frame ambiguities (crossings, clutter near a gate
boundary) stay multi-modal instead of being moment-matched away, and
its cardinality distribution is exact:

    P(|X| = c) = sum_h w_h [|I_h| = c].

Joint predict-update (the Vo, Vo & Hoang 2017 formulation): per parent
hypothesis, every label slot takes one of m+2 outcomes

    dead          1 - P_S          (survivor)    1 - r_B   (birth slot)
    alive+missed  P_S (1 - PD)                   r_B (1 - PD)
    alive+det j   P_S PD N(z_j; HFx, S)/kappa    r_B PD N_j/kappa

one-to-one over measurements; a child hypothesis is one joint outcome
row.  Children are pruned to the top-`h_max` by weight (the only
approximation; with h_max >= the number of feasible histories the
filter IS exact multi-target Bayes — pinned digit-level in tests
against a first-principles history enumeration over multiple frames).

Static-shape design: static [h_max, t_max] hypothesis x label-slot tables
(log_w = -inf marks empty hypothesis rows, alive masks mark label
membership), the ternary outcome table enumerated host-side at new()
(the jpda/lmb static-event idiom, ~500k guard), children scored with
one [H, L, m+2] x [E, L, m+2] tensordot, pruned with lax.top_k, label
slots pruned back to t_max by marginal existence each frame.  No
data-dependent shapes anywhere; `run` is one lax.scan.

No reference counterpart (the reference stops at single-target
filters); shared machinery: jpda._enumerate_events, pmb mixture
moments, vanilla.joseph_update (vanilla.go:160).
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
from .pmb import _mixture_moments


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: jax.Array
    p_detect: jax.Array
    clutter: jax.Array  # clutter density kappa
    gate: jax.Array  # chi-square gate on d^2 (inf disables)
    birth_r: jax.Array  # [Jb]
    birth_m: jax.Array  # [Jb, n]
    birth_p: jax.Array  # [Jb, n, n]
    t_max: int
    h_max: int
    codes: jax.Array  # [E, L_tot] ternary outcome codes (0/1/2+j)
    onehot: jax.Array  # [E, L_tot, m_max + 2]
    assoc: str  # "exact" | "gibbs"
    n_samples: int  # gibbs: children sampled per parent
    gibbs_sweeps: int


class State(NamedTuple):
    log_w: jax.Array  # [h_max] hypothesis log-weights (-inf = empty)
    alive: jax.Array  # [h_max, t_max] bool label membership
    m: jax.Array  # [h_max, t_max, n]
    p: jax.Array  # [h_max, t_max, n, n]
    labels: jax.Array  # [t_max, 2] int32 (birth frame, birth slot)
    k: jax.Array  # [] int32 frame counter


class Estimate(NamedTuple):
    n_targets: jax.Array  # [] expected cardinality (exact)
    cardinality_pmf: jax.Array  # [t_max + 1] EXACT pmf over |X|
    map_cardinality: jax.Array  # [] int32 MAP target count
    existence: jax.Array  # [t_max] marginal per-label existence
    states: jax.Array  # [t_max, n] marginal (mixture) means
    covariances: jax.Array  # [t_max, n, n] marginal mixture covs
    labels: jax.Array  # [t_max, 2]
    map_alive: jax.Array  # [t_max] bool: best hypothesis at MAP card
    map_states: jax.Array  # [t_max, n] best-hypothesis track means
    hyp_log_w: jax.Array  # [h_max] (diagnostic)


def _enumerate_ternary(l_tot: int, m_max: int):
    """Ternary outcome table: rows over label slots with values in
    {0 dead, 1 miss, 2+j detected-by-z_j}, detections one-to-one.
    Built by splitting every undetected slot of the binary jpda event
    table into dead/miss."""
    import numpy as np

    base = _enumerate_events(l_tot, m_max)  # {0 miss, 1..m det}
    rows = []
    for ev in base:
        miss_idx = [i for i in range(l_tot) if ev[i] == 0]
        det = [0 if ev[i] == 0 else ev[i] + 1 for i in range(l_tot)]
        for bits in range(1 << len(miss_idx)):
            row = list(det)
            for b, i in enumerate(miss_idx):
                row[i] = 1 if (bits >> b) & 1 else 0
            rows.append(row)
    return np.asarray(rows, np.int32)


def n_ternary_events(l_tot: int, m_max: int) -> int:
    return sum(
        math.comb(l_tot, k) * math.perm(m_max, k) * 2 ** (l_tot - k)
        for k in range(min(l_tot, m_max) + 1))


def new(f, g, h, noise: Noise, birth_r, birth_m, birth_p, m_max: int,
        p_survival: float = 0.99, p_detect: float = 0.9,
        clutter: float = 1e-3, gate: float = 16.0, t_max: int = 4,
        h_max: int = 64, assoc: str = "exact", n_samples: int = 32,
        gibbs_sweeps: int = 4):
    """Build (Model, State) with the single empty hypothesis.

    `t_max` static label slots (>= expected simultaneous targets +
    births in flight), `h_max` static hypothesis slots — the truncation
    depth.

    `assoc="exact"` enumerates the ternary outcome table host-side —
    factorial in (t_max + Jb, m_max), guarded at 500k rows; with h_max
    >= the history count the filter IS exact multi-target Bayes.
    `assoc="gibbs"` (Vo, Vo & Hoang 2017) instead draws `n_samples`
    child hypotheses per parent with a `gibbs_sweeps`-sweep Gibbs
    sampler over the joint outcome vector (conditionals are the same
    laug table the exact mode sums; sampling only selects WHICH
    children materialize — each child's weight is computed exactly,
    duplicates within a parent are dropped).  step/run then need a PRNG
    `key`."""
    birth_m = jnp.asarray(birth_m)
    birth_p = jnp.asarray(birth_p)
    birth_r = jnp.asarray(birth_r)
    if birth_m.ndim != 2:
        raise ValueError(f"birth_m must be [Jb, n] (got {birth_m.shape})")
    jb, n = birth_m.shape
    if birth_r.shape != (jb,) or birth_p.shape != (jb, n, n):
        raise ValueError("birth_r/birth_p shapes must match birth_m")
    if assoc not in ("exact", "gibbs"):
        raise ValueError(f"assoc must be 'exact' or 'gibbs' (got {assoc!r})")
    dt = birth_m.dtype
    l_tot = t_max + jb
    import numpy as np

    if assoc == "exact":
        n_events = n_ternary_events(l_tot, m_max)
        if n_events > 500_000:
            raise ValueError(
                f"delta-GLMB ternary event table would have {n_events} "
                f"rows for {t_max}+{jb} slots x {m_max} candidates; use "
                "assoc='gibbs' or shrink the scene")
        codes = _enumerate_ternary(l_tot, m_max)
        onehot = np.zeros((codes.shape[0], l_tot, m_max + 2), np.float32)
        np.put_along_axis(onehot, codes[:, :, None], 1.0, axis=2)
    else:
        codes = np.zeros((1, 1), np.int32)
        onehot = np.zeros((1, 1, 1), np.float32)
    kf_model, _ = vanilla.new(jnp.zeros(n, dt), jnp.eye(n, dtype=dt),
                              f, g, h, noise)
    model = Model(kf_model, jnp.asarray(p_survival, dt),
                  jnp.asarray(p_detect, dt), jnp.asarray(clutter, dt),
                  jnp.asarray(gate, dt), birth_r, birth_m, birth_p,
                  int(t_max), int(h_max), jnp.asarray(codes),
                  jnp.asarray(onehot, dt), assoc, int(n_samples),
                  int(gibbs_sweeps))
    neg_inf = jnp.full((h_max,), -jnp.inf, dt).at[0].set(0.0)
    state = State(
        neg_inf,
        jnp.zeros((h_max, t_max), bool),
        jnp.zeros((h_max, t_max, n), dt),
        jnp.broadcast_to(jnp.eye(n, dtype=dt), (h_max, t_max, n, n)),
        jnp.full((t_max, 2), -1, jnp.int32),
        jnp.int32(0))
    return model, state


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask, key=None):
    """One delta-GLMB frame: `candidates` [m_max, p], `cand_mask`
    [m_max].  `key` is required (and consumed) in assoc="gibbs" mode
    only — it drives child sampling, never the weights, which are
    always computed exactly."""
    if model.assoc == "gibbs" and key is None:
        raise ValueError("assoc='gibbs' requires a PRNG key")
    kf = model.kf
    dt = state.m.dtype
    h_max, t_max, n = state.m.shape
    candidates = jnp.asarray(candidates)
    m_max, p_dim = candidates.shape
    mask = jnp.asarray(cand_mask, bool)
    tiny = 1e-300 if dt == jnp.float64 else 1e-30
    jb = model.birth_r.shape[0]
    l_tot = t_max + jb

    # ---- per-(hypothesis, slot) prediction; birth slots appended
    def predict_one(mh, ph):
        m_srv = mh @ kf.f.T
        p_srv = jnp.einsum("ij,kjl,ml->kim", kf.f, ph, kf.f) + kf.noise.q
        return (jnp.concatenate([m_srv, model.birth_m], axis=0),
                jnp.concatenate([p_srv, model.birth_p], axis=0))

    m_pred, p_pred = jax.vmap(predict_one)(state.m, state.p)  # [H,L,...]
    is_birth = jnp.arange(l_tot) >= t_max  # [L]
    alive_ext = jnp.concatenate(
        [state.alive, jnp.zeros((h_max, jb), bool)], axis=1)  # [H, L]
    lab_birth = jnp.stack(
        [jnp.full((jb,), state.k, jnp.int32),
         jnp.arange(jb, dtype=jnp.int32)], axis=1)
    labels_ext = jnp.concatenate([state.labels, lab_birth], axis=0)

    # ---- measurement geometry per (hypothesis, slot)
    def geom(x_pred, p_i):
        pht = p_i @ kf.h.T
        s = linalg.sym(kf.h @ pht + kf.noise.r)
        k_g = linalg.solve_psd(s, pht.T).T
        nus = candidates - x_pred @ kf.h.T  # [m, p]
        sinv_nus = linalg.solve_psd(s, nus.T).T
        d2 = jnp.sum(nus * sinv_nus, axis=1)
        _, logdet = jnp.linalg.slogdet(s)
        nus = jnp.where(mask[:, None], nus, 0.0)  # poison-fuzz rule
        m_det = x_pred + nus @ k_g.T  # [m, n]
        p_u = vanilla.joseph_update(p_i, k_g, kf.h, kf.noise.r)
        return m_det, p_u, d2, logdet

    m_det, p_upd, d2, logdet = jax.vmap(jax.vmap(geom))(m_pred, p_pred)
    # m_det [H, L, m, n]; p_upd [H, L, n, n]; d2/logdet [H, L, m]/[H, L]

    # ---- outcome log-weight table laug [H, L, m+2]
    log_norm = -0.5 * (logdet + p_dim * jnp.log(
        jnp.asarray(2 * math.pi, dt)))  # [H, L]
    # existence prior per slot: survivors P_S (conditioned on parent
    # aliveness), birth slots r_B (new, parent-independent)
    r_b_ext = jnp.concatenate(
        [jnp.zeros((t_max,), dt), model.birth_r])  # [L]
    log_ps = jnp.log(jnp.maximum(model.p_survival, tiny))
    log_1mps = jnp.log(jnp.maximum(1.0 - model.p_survival, tiny))
    log_rb = jnp.log(jnp.maximum(r_b_ext, tiny))  # [L]
    log_1mrb = jnp.log(jnp.maximum(1.0 - r_b_ext, tiny))
    log_pd = jnp.log(jnp.maximum(model.p_detect, tiny))
    log_1mpd = jnp.log(jnp.maximum(1.0 - model.p_detect, tiny))

    # dead column: survivors log(1-P_S); not-alive slots 0 (forced
    # dead, weight 1); birth slots log(1-r_B)
    col_dead = jnp.where(
        is_birth[None, :], log_1mrb[None, :],
        jnp.where(alive_ext, log_1mps, 0.0))  # [H, L]
    # miss column: alive log(P_S(1-PD)); birth log(r_B(1-PD));
    # not-alive -inf
    col_miss = jnp.where(
        is_birth[None, :], log_rb[None, :] + log_1mpd,
        jnp.where(alive_ext, log_ps + log_1mpd, -jnp.inf))
    # detection columns [H, L, m]
    loglik = log_norm[..., None] - 0.5 * d2 - jnp.log(
        jnp.maximum(model.clutter, tiny))
    valid = mask[None, None, :] & (d2 <= model.gate)
    col_det = jnp.where(
        is_birth[None, :, None], log_rb[None, :, None] + log_pd + loglik,
        jnp.where(alive_ext[..., None], log_ps + log_pd + loglik,
                  -jnp.inf))
    col_det = jnp.where(valid, col_det, -jnp.inf)
    laug = jnp.concatenate(
        [col_dead[..., None], col_miss[..., None], col_det], axis=2)

    # ---- child generation + exact scoring (-inf * 0 = NaN, so score
    # through a large-negative clamp instead)
    neg = jnp.asarray(-1e30, dt)
    laug_c = jnp.maximum(laug, neg)
    if model.assoc == "exact":
        # all children: [H, E] = sum_i laug[h, i, code[e, i]]
        child = jnp.tensordot(laug_c, model.onehot,
                              axes=[[1, 2], [1, 2]])
        child = child + state.log_w[:, None]  # [H, E]
        child = jnp.where(jnp.isfinite(state.log_w)[:, None], child,
                          -jnp.inf)
        child = jnp.where(child > 0.5 * neg, child, -jnp.inf)
        flat = child.reshape(-1)
        top_w, top_idx = jax.lax.top_k(flat, h_max)
        parent = top_idx // model.codes.shape[0]  # [h_max]
        codes_sel = model.codes[top_idx % model.codes.shape[0]]
    else:
        # Gibbs-sampled children (Vo, Vo & Hoang 2017): n_samples
        # outcome vectors per parent from sweeps of the conditional
        # p(gamma_i | rest) ∝ exp(laug[h, i, c]) over outcomes still
        # feasible (one-to-one on detections), then exact scoring.
        s_n = model.n_samples
        gamma0 = jnp.zeros((h_max, s_n, l_tot), jnp.int32)  # all-dead
        taken0 = jnp.zeros((h_max, s_n, m_max), bool)

        # One lax.scan over sweeps x slots: the original Python loop
        # UNROLLED gibbs_sweeps * l_tot sampling blocks into the
        # program — at serving configs (t_max 12, 4 sweeps = 64 blocks)
        # that is exactly the compile-size blow-up that makes compile
        # time superlinear (same failure mode as the dense-GN MHE).
        # Scan keeps the program one block regardless of budget; the
        # per-iteration key comes from fold_in (stream differs from the
        # old split sequence — sampling only selects which children
        # materialize, weights stay exact, tests pin statistics).
        def gibbs_iter(carry, it):
            gamma, taken = carry
            i = it % l_tot
            cur = jnp.take(gamma, i, axis=2)  # [H, S]
            det_oh = jax.nn.one_hot(cur - 2, m_max,
                                    dtype=bool)  # [H, S, m]
            taken = taken & ~det_oh
            logits = jnp.broadcast_to(
                jnp.take(laug_c, i, axis=1)[:, None, :],
                (h_max, s_n, m_max + 2))
            block = jnp.concatenate(
                [jnp.zeros((h_max, s_n, 2), bool), taken], axis=2)
            logits = jnp.where(block, neg, logits)
            c = jax.random.categorical(jax.random.fold_in(key, it),
                                       logits)  # [H, S]
            gamma = gamma.at[:, :, i].set(c.astype(jnp.int32))
            taken = taken | jax.nn.one_hot(c - 2, m_max, dtype=bool)
            return (gamma, taken), None

        (gamma, _), _ = jax.lax.scan(
            gibbs_iter, (gamma0, taken0),
            jnp.arange(model.gibbs_sweeps * l_tot))
        # sample 0 is pinned to the all-dead child: it is always
        # feasible and carries the n=0 tail mass Gibbs chains drift
        # away from (measured: P(n=0) mass lost entirely without it)
        gamma = gamma.at[:, 0, :].set(0)
        # exact weights of the sampled children
        gath = jnp.take_along_axis(
            jnp.broadcast_to(laug_c[:, None],
                             (h_max, s_n, l_tot, m_max + 2)),
            gamma[..., None], axis=3)[..., 0]  # [H, S, L]
        child = jnp.sum(gath, axis=2) + state.log_w[:, None]  # [H, S]
        child = jnp.where(jnp.isfinite(state.log_w)[:, None], child,
                          -jnp.inf)
        child = jnp.where(child > 0.5 * neg, child, -jnp.inf)
        # drop within-parent duplicates (they would double-count the
        # same history when the kept set is renormalized)
        eq = jnp.all(gamma[:, :, None, :] == gamma[:, None, :, :],
                     axis=-1)  # [H, S, S]
        earlier = jnp.arange(s_n)[None, :] < jnp.arange(s_n)[:, None]
        dup = jnp.any(eq & earlier[None], axis=2)  # [H, S]
        child = jnp.where(dup, -jnp.inf, child)
        flat = child.reshape(-1)
        top_w, top_idx = jax.lax.top_k(flat, h_max)
        parent = top_idx // s_n
        codes_sel = gamma.reshape(-1, l_tot)[top_idx]
    log_z = jax.scipy.special.logsumexp(top_w)
    new_log_w = top_w - log_z

    # ---- child per-slot posteriors (gathered from the parent rows)
    new_alive_ext = codes_sel >= 1  # [h_max, L]
    det_j = jnp.maximum(codes_sel - 2, 0)  # [h_max, L]
    m_par = m_pred[parent]  # [h_max, L, n]
    p_par = p_pred[parent]
    m_dets = jnp.take_along_axis(
        m_det[parent], det_j[..., None, None], axis=2)[:, :, 0]
    p_dets = p_upd[parent]
    detected = codes_sel >= 2
    m_new = jnp.where(detected[..., None], m_dets, m_par)
    p_new = jnp.where(detected[..., None, None], p_dets, p_par)

    # ---- prune label slots back to t_max by marginal existence
    w_lin = jnp.exp(new_log_w)  # [h_max]
    w_lin = jnp.where(jnp.isfinite(new_log_w), w_lin, 0.0)
    r_marg_ext = jnp.einsum("h,hl->l", w_lin,
                            new_alive_ext.astype(dt))  # [L]
    order = jnp.argsort(-r_marg_ext)[:t_max]
    alive_k = new_alive_ext[:, order]
    m_k = m_new[:, order]
    p_k = p_new[:, order]
    lab_k = jnp.where((r_marg_ext[order] > 0)[:, None],
                      labels_ext[order], -1)
    # dropping a slot that was alive in some hypothesis removes that
    # label from it (standard truncation); renormalize is not needed —
    # the weights stay a valid distribution over the kept histories.

    new_state = State(new_log_w, alive_k, m_k, p_k, lab_k, state.k + 1)

    # ---- estimate: exact cardinality pmf + marginals + MAP extraction
    card = jnp.sum(alive_k, axis=1)  # [h_max] |I_h|
    pmf = jnp.zeros((t_max + 1,), dt).at[card].add(w_lin)
    map_card = jnp.argmax(pmf)
    r_marg = jnp.einsum("h,hl->l", w_lin, alive_k.astype(dt))
    w_slot = w_lin[:, None] * alive_k.astype(dt)  # [h_max, t_max]
    w_norm = w_slot / jnp.maximum(r_marg[None, :], tiny)
    mm, pm = jax.vmap(_mixture_moments, in_axes=(1, 1, 1))(
        w_norm, m_k, p_k)
    mm = jnp.where((r_marg > 0)[:, None], mm, 0.0)
    pm = jnp.where((r_marg > 0)[:, None, None], pm,
                   jnp.eye(n, dtype=dt)[None])
    # best hypothesis AT the MAP cardinality (the standard delta-GLMB
    # estimator, Vo & Vo 2013 §V)
    sel = jnp.where(card == map_card, new_log_w, -jnp.inf)
    h_star = jnp.argmax(sel)
    est = Estimate(
        n_targets=jnp.sum(r_marg),
        cardinality_pmf=pmf,
        map_cardinality=map_card.astype(jnp.int32),
        existence=r_marg,
        states=mm,
        covariances=pm,
        labels=lab_k,
        map_alive=alive_k[h_star],
        map_states=m_k[h_star],
        hyp_log_w=new_log_w,
    )
    return new_state, est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, key=None):
    """lax.scan over [T, m_max, p] frames.  `key` required for
    assoc="gibbs" (split per frame)."""
    candidates = jnp.asarray(candidates)
    if model.assoc == "gibbs":
        if key is None:
            raise ValueError("assoc='gibbs' requires a PRNG key")
        keys = jax.random.split(key, candidates.shape[0])

        def body_g(carry, xs):
            cands, m_, k_ = xs
            return step(model, carry, cands, m_, key=k_)

        return jax.lax.scan(body_g, state,
                            (candidates, jnp.asarray(cand_masks, bool),
                             keys))

    def body(carry, xs):
        cands, m_ = xs
        return step(model, carry, cands, m_)

    return jax.lax.scan(body, state,
                        (candidates, jnp.asarray(cand_masks, bool)))
