"""Tracking/RFS/fusion-tier benchmark on the GPU.

Slope-timed throughput rows for the multi-target stack — PDAF, JPDA,
GNN tracker, GM-PHD, GM-CPHD, PMB, and track-to-track fusion — on
vmapped scene banks at serving scale.  Every row is gated on accuracy
bounds (maintained-scene set-RMS + track-loss rate for the bank
associators, tail OSPA for the intensity filters, cardinality bands)
so throughput cannot be bought with garbage estimates (the
consistency-gate idiom of the reference's chi-square harness,
chisquare.go:16-95, applied to the multi-target tier).

Timing methodology (identical to bench.py): each row jits the scene
bank at R=1 and R=3 repeats (data rolled per repeat so XLA cannot CSE
them), syncs with a single scalar device read, and reports the slope
(t3 - t1)/2 — the marginal per-bank cost with the fixed per-call
overhead subtracted.

Runs in one process and refuses to run without a GPU.  Prints one JSON
line per row (JSONL, like bench_od.py), each carrying the device.

Scenario (shared across rows): 2-D constant-velocity targets in a
100x100 surveillance box, PD = 0.95, sigma_r = 0.2, 6 uniform clutter
points per frame, padded to m_max = 8 candidate slots per frame.  The
two-target bank has the targets CROSSING mid-arc (the association
stress case); gates use the min-permutation set-RMS so an identity
swap at the crossing is not penalized (set metrics, not labels).
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from gokalman_tpu import diagnostics, profiling
from gokalman_tpu import noise as gn
from gokalman_tpu.filters import (cphd, fusion, glmb, jpda, lmb, pdaf,
                                  phd, pmb, tracker)

DTYPE = jnp.float32

B_SCENES = int(os.environ.get("BENCH_TRACKING_SCENES", 256))
T_FRAMES = int(os.environ.get("BENCH_TRACKING_FRAMES", 200))
M_MAX = 8
N_CLUTTER = 6
PD = 0.95
SIGMA_R = 0.2
BOX = 100.0  # clutter uniform over [-50, 50]^2
TAIL = T_FRAMES // 4  # frames scored: the last 3/4 (post-acquisition)


def _cv_system(dt=1.0, q_scale=1e-3, r_scale=0.04):
    """4-state [x, vx, y, vy] nearly-constant-velocity model (the
    tracking-literature standard; same system as tests/test_phd.py)."""
    f = jnp.asarray(np.kron(np.eye(2), np.array([[1.0, dt], [0.0, 1.0]])),
                    DTYPE)
    qb = np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]) * q_scale
    q = jnp.asarray(np.kron(np.eye(2), qb), DTYPE)
    h = jnp.asarray(np.kron(np.eye(2), np.array([[1.0, 0.0]])), DTYPE)
    r = jnp.asarray(r_scale * np.eye(2), DTYPE)
    return f, q, h, r


# Base initial states: A and B converge, cross near frame ~45, and
# separate — the standard association stress arc.
X0_A = np.array([-5.0, 0.12, -5.0, 0.10])
X0_B = np.array([5.0, -0.10, 5.0, -0.08])

# ---------------------------------------------------------------------------
# Lifecycle scene bank (round-4 judge task #2): staggered births and
# deaths, cardinality 2 -> 3 -> 4 -> 3 -> 2 over the scene — the
# problem the RFS tier exists for (unknown, time-varying target count),
# where the constant-cardinality bank above only stresses association.
# Spawn sites are FAR (±30) from every fixed birth prior (±5), so the
# intensity filters acquire exclusively through measurement-driven
# adaptive birth and the GNN tracker through its M/N initiation.
M_LC = 12  # 4 target slots + 6 clutter + 2 padding
N_LC = 4
LC_X0 = np.array([
    [-30.0, 0.10, -30.0, 0.08],
    [30.0, -0.10, 30.0, -0.08],
    [-30.0, 0.12, 30.0, -0.10],
    [30.0, -0.12, -30.0, 0.10],
])


def _lc_schedule(t=None):
    """Birth/death frames scaled to the scene length: births at
    0, 0, T/5, 2T/5; deaths at 3T/5, 4T/5, T, T."""
    t = T_FRAMES if t is None else t
    births = np.array([0, 0, t // 5, 2 * t // 5])
    deaths = np.array([3 * t // 5, 4 * t // 5, t, t])
    return births, deaths


def _gen_lifecycle_bank(key, b_scenes=None):
    """Truths [B, T, 4, 4], alive [T, 4] (static schedule), candidate
    frames [B, T, M_LC, 2], masks [B, T, M_LC].  A dead target's slot
    is never valid; clutter slots always are; per-frame shuffle as in
    `_gen_bank`."""
    b_scenes = B_SCENES if b_scenes is None else b_scenes
    f, q, h, r = _cv_system()
    lq = jnp.linalg.cholesky(q + 1e-12 * jnp.eye(4, dtype=DTYPE))
    births, deaths = _lc_schedule()
    alive_np = ((np.arange(T_FRAMES)[:, None] >= births)
                & (np.arange(T_FRAMES)[:, None] < deaths))  # [T, 4]
    alive = jnp.asarray(alive_np)
    x0s = jnp.asarray(LC_X0, DTYPE)

    def gen_scene(k):
        k0, kw, kv, kd, kc, kp = jax.random.split(k, 6)
        x0 = x0s + 0.5 * jax.random.normal(k0, (N_LC, 4), DTYPE) \
            * jnp.asarray([1.0, 0.05, 1.0, 0.05], DTYPE)
        ws = jax.random.normal(kw, (T_FRAMES, N_LC, 4), DTYPE) @ lq.T

        def body(x, w):
            xn = x @ f.T + w
            return xn, xn

        _, truth = jax.lax.scan(body, x0, ws)  # [T, 4, 4]
        z = truth[:, :, ::2] + SIGMA_R * jax.random.normal(
            kv, (T_FRAMES, N_LC, 2), DTYPE)
        detected = (jax.random.uniform(kd, (T_FRAMES, N_LC)) < PD) & alive
        cands = (BOX * (jax.random.uniform(kc, (T_FRAMES, M_LC, 2),
                                           dtype=DTYPE) - 0.5))
        cands = cands.at[:, :N_LC, :].set(z)
        mask = jnp.zeros((T_FRAMES, M_LC), bool)
        mask = mask.at[:, :N_LC].set(detected)
        mask = mask.at[:, N_LC:N_LC + N_CLUTTER].set(True)
        perm = jax.vmap(lambda kk: jax.random.permutation(kk, M_LC))(
            jax.random.split(kp, T_FRAMES))
        cands = jnp.take_along_axis(cands, perm[:, :, None], axis=1)
        mask = jnp.take_along_axis(mask, perm, axis=1)
        return truth, cands, mask

    keys = jax.random.split(key, b_scenes)
    with jax.default_matmul_precision("float32"):  # see _gen_bank note
        truth, cands, masks = jax.jit(jax.vmap(gen_scene))(keys)
        jax.block_until_ready((truth, cands, masks))
    return truth, cands, masks, alive_np


def _lifecycle_scores(pos, est_mask, card, truth, alive_np):
    """Shared read-out for the lifecycle rows.

    pos [B, T, K, 2] extracted positions with est_mask [B, T, K] bool,
    card [B, T] estimated cardinality, truth [B, T, 4, 4],
    alive_np [T, 4].  Returns the score dict; every number is gated by
    the caller.

    Frames are split into STEADY (>= 8 frames past the last birth/death
    transition, where the filter should hold the true count and track
    tightly) and TRANSITION windows (the 8 frames after each of the
    four mid-scene transitions, where OSPA legitimately spikes while
    the filter acquires/drops).  Gating steady and transition frames
    separately keeps the gates sharp: a filter that never reacts fails
    the steady plateaus, one that reacts slowly fails the transition
    recovery, and neither failure can hide in a pooled average.
    """
    alive = jnp.asarray(alive_np)
    card_true = jnp.asarray(alive_np.sum(1).astype(np.float32))  # [T]

    if pos.shape[2] > 8:
        # diagnostics.ospa enumerates assignments exactly and caps
        # padded sets at 8 slots; keep the 8 valid-first slots per
        # frame (a frame with > 8 EXTRACTED tracks is already deep in
        # cardinality-error territory — the dropped surplus would only
        # lower the charged OSPA, and the cardinality gates catch it).
        order = jnp.argsort(~est_mask, axis=-1, stable=True)[..., :8]
        pos = jnp.take_along_axis(pos, order[..., None], axis=2)
        est_mask = jnp.take_along_axis(est_mask, order, axis=2)

    def one(e, em, tp, am):
        return diagnostics.ospa(e, em, tp, am, 2.0)

    # lax.map over the scene axis, vmap only over frames: the flat
    # double-vmap materializes the 8-slot OSPA assignment table for
    # every (scene, frame) at once — f32[322560, 256, 200] = 66 GB
    # (OOM at AOT compile).  Sequential scenes
    # keep the peak at one scene's table (~0.26 GB); this is the
    # scoring path, not the timed row, so the serialization is free.
    def scene_ospa(args):
        e, em, tp = args
        return jax.vmap(one, in_axes=(0, 0, 0, 0))(e, em, tp, alive)

    o = jax.jit(lambda p_, m_, t_: jax.lax.map(
        scene_ospa, (p_, m_, t_)))(
        pos, est_mask, truth[:, :, :, ::2])  # [B, T]

    births, deaths = _lc_schedule()
    transitions = sorted({int(x) for x in np.concatenate([births, deaths])
                          if 0 < x < T_FRAMES})
    settle = 8
    frames = np.arange(T_FRAMES)
    steady = frames >= settle
    in_transition = np.zeros(T_FRAMES, bool)
    for tr in transitions:
        steady &= ~((frames >= tr) & (frames < tr + settle))
        in_transition |= (frames >= tr) & (frames < tr + settle)
    steady_j = jnp.asarray(steady)
    trans_j = jnp.asarray(in_transition)

    def masked_mean(x, m):
        m_b = jnp.broadcast_to(m, x.shape)
        return float(jnp.sum(x * m_b) / jnp.sum(m_b))

    card_err = jnp.abs(card - card_true[None, :])  # [B, T]
    scores = {
        "ospa_steady": masked_mean(o, steady_j[None, :]),
        "ospa_transition": masked_mean(o, trans_j[None, :]),
        "card_mae_steady": masked_mean(card_err, steady_j[None, :]),
        # plateau reads: the peak-cardinality window (all four alive)
        # and the final window (two died) — together they pin that
        # births AND deaths were both tracked, not one averaged lucky
        # number.
        "card_peak": masked_mean(
            card, jnp.asarray((frames >= 2 * T_FRAMES // 5 + settle)
                              & (frames < 3 * T_FRAMES // 5))[None, :]),
        "card_end": masked_mean(
            card, jnp.asarray(frames >= 4 * T_FRAMES // 5
                              + settle)[None, :]),
    }
    scores["gates_pass"] = bool(
        scores["ospa_steady"] < 0.6
        and scores["ospa_transition"] < 1.4
        and scores["card_mae_steady"] < 0.35
        and 3.5 < scores["card_peak"] < 4.5
        and 1.6 < scores["card_end"] < 2.4)
    return scores


def _gen_bank(key, n_targets):
    """Generate a scene bank on device: truths [B, T, n_targets, 4],
    candidate frames [B, T, M_MAX, 2], masks [B, T, M_MAX].

    Slot layout before the per-frame shuffle: slots 0..n_targets-1 are
    the target detections (valid w.p. PD), the next N_CLUTTER slots are
    always-valid uniform clutter, the rest stay invalid.  The shuffle
    permutes candidates and masks together so the filters cannot learn
    the layout.
    """
    f, q, h, r = _cv_system()
    lq = jnp.linalg.cholesky(q + 1e-12 * jnp.eye(4, dtype=DTYPE))
    x0s = jnp.asarray(np.stack([X0_A, X0_B])[:n_targets], DTYPE)

    def gen_scene(k):
        k0, kw, kv, kd, kc, kp = jax.random.split(k, 6)
        # per-scene jitter of the initial states (covered by p0 = 4 I)
        x0 = x0s + 0.5 * jax.random.normal(k0, (n_targets, 4), DTYPE) \
            * jnp.asarray([1.0, 0.05, 1.0, 0.05], DTYPE)
        ws = jax.random.normal(kw, (T_FRAMES, n_targets, 4), DTYPE) @ lq.T

        def body(x, w):
            xn = x @ f.T + w
            return xn, xn

        _, truth = jax.lax.scan(body, x0, ws)  # [T, n_targets, 4]
        z = truth[:, :, ::2] + SIGMA_R * jax.random.normal(
            kv, (T_FRAMES, n_targets, 2), DTYPE)
        detected = jax.random.uniform(kd, (T_FRAMES, n_targets)) < PD
        cands = (BOX * (jax.random.uniform(kc, (T_FRAMES, M_MAX, 2),
                                           dtype=DTYPE) - 0.5))
        cands = cands.at[:, :n_targets, :].set(z)
        mask = jnp.zeros((T_FRAMES, M_MAX), bool)
        mask = mask.at[:, :n_targets].set(detected)
        mask = mask.at[:, n_targets:n_targets + N_CLUTTER].set(True)
        perm = jax.vmap(lambda kk: jax.random.permutation(kk, M_MAX))(
            jax.random.split(kp, T_FRAMES))
        cands = jnp.take_along_axis(cands, perm[:, :, None], axis=1)
        mask = jnp.take_along_axis(mask, perm, axis=1)
        return truth, cands, mask

    keys = jax.random.split(key, B_SCENES)
    # Trace under f32 matmul precision: at a reduced-precision default
    # (TF32 on the GPU) the truth propagation (x @ f.T) injects
    # unmodeled quantization noise into the truths, a random walk the
    # filters' tiny Q cannot follow.
    with jax.default_matmul_precision("float32"):
        truth, cands, masks = jax.jit(jax.vmap(gen_scene))(keys)
        jax.block_until_ready((truth, cands, masks))
    return truth, cands, masks


def _tail_ospa(pos, weights, truth_pos, thresh=0.5, cutoff=2.0):
    """Tail-mean OSPA of the thresholded GM extraction (the standard
    Vo-Ma w > 0.5 read-out) against the 2-target truth.  Intensity
    filters drop a missed target's weight by (1-PD) for that frame —
    fixed top-2 extraction grabs junk in ~5% of frames and a plain
    set-RMS explodes (measured 3.06 at PD=0.95 where OSPA reads 0.25);
    OSPA charges those frames the bounded cardinality cost instead,
    which is exactly the metric's job (Schuhmacher 2008)."""
    def one(e, w, t):
        return diagnostics.ospa(e, w > thresh, t,
                                jnp.ones(t.shape[0], bool), cutoff)

    o = jax.jit(jax.vmap(jax.vmap(one)))(pos, weights, truth_pos)
    per_scene = jnp.mean(o[:, -TAIL:], axis=1)
    return float(jnp.mean(per_scene)), float(jnp.max(per_scene))


def _set_rms(est_pos, truth_pos):
    """Per-frame min-permutation assignment of 2 estimated positions to
    2 truths (exact for n=2: identity vs swap), averaged over the tail.
    est_pos/truth_pos: [B, T, 2, 2]."""
    d_id = jnp.sum((est_pos - truth_pos) ** 2, axis=(-2, -1))
    d_sw = jnp.sum((est_pos - truth_pos[:, :, ::-1, :]) ** 2,
                   axis=(-2, -1))
    mse = jnp.minimum(d_id, d_sw) / 4.0  # 2 targets x 2 coords
    return float(jnp.sqrt(jnp.mean(mse[:, -TAIL:])))


def _maintained_rms(est_pos, truth_pos, loss_thresh=2.0):
    """(tail set-RMS over MAINTAINED scenes, track-loss rate): the
    tracking-literature read-out that separates the two failure axes.
    A scene counts as lost when its own tail set-RMS exceeds
    `loss_thresh`.  Why not one pooled RMS: a single irrecoverably
    lost track (measured: 1 scene in 256 — an early clutter hijack
    inside the wide initial gate coasts out of the region with nothing
    left to gate on, the textbook loss mode of any fixed-bank
    associator with no re-initiation) contributes ~160 units of error
    at every tail frame and drags the pooled RMS from 0.17 to 10.0,
    i.e. the pooled number measures ONLY the loss event, not tracking
    quality.  Both numbers are emitted and BOTH are gated."""
    d_id = jnp.sum((est_pos - truth_pos) ** 2, axis=(-2, -1))
    d_sw = jnp.sum((est_pos - truth_pos[:, :, ::-1, :]) ** 2,
                   axis=(-2, -1))
    mse = jnp.minimum(d_id, d_sw) / 4.0
    per_scene = jnp.sqrt(jnp.mean(mse[:, -TAIL:], axis=1))  # [B]
    lost = per_scene > loss_thresh
    rms_kept = jnp.sqrt(jnp.mean(jnp.where(
        lost, 0.0, jnp.mean(mse[:, -TAIL:], axis=1))) /
        jnp.maximum(jnp.mean(~lost), 1e-9))
    return float(rms_kept), float(jnp.mean(lost))


def _slope_time(make_fn, sync_leaf):
    """R=1 vs R=3 slope with a single scalar-read sync (bench.py
    idiom).  make_fn(repeats) -> jitted fn(shift) -> pytree; sync_leaf
    picks one scalar off the output for the device sync."""
    f1, f3 = make_fn(1), make_fn(3)
    out1 = f1(jnp.int32(0))
    jax.block_until_ready(out1)
    jax.block_until_ready(f3(jnp.int32(0)))

    def timed(fn, s):
        t0 = time.perf_counter()
        out = fn(jnp.int32(s))
        _ = float(sync_leaf(out))
        return time.perf_counter() - t0

    t1 = min(timed(f1, s) for s in (1, 2, 3))
    t3 = min(timed(f3, s) for s in (1, 2, 3))
    return max((t3 - t1) / 2.0, 1e-9), out1


def _bank_runner(run_one, cands, masks, reduce_out, chunk=0):
    """Build make_fn(repeats): vmap run_one over the scene bank, roll
    the bank per repeat so XLA cannot share the computations.

    `chunk` > 0 streams the bank through lax.map(batch_size=chunk)
    instead of one flat vmap: peak HBM is one chunk's intermediates.
    Needed for the lifecycle intensity rows — the 32x13-component
    GM-PHD mixture update fused over 256 scenes x 200 frames tried a
    66 GB intermediate (OOM); 32-scene
    chunks fit comfortably and the throughput read-out is unchanged
    (the map is sequential, so the slope still measures per-scene
    marginal cost)."""

    def bank(c, m):
        if chunk:
            # lax.map(batch_size=k) vmaps k-element chunks internally
            # and scans over them — same results as the flat vmap,
            # peak memory of one chunk.
            return jax.lax.map(lambda cm: run_one(*cm), (c, m),
                               batch_size=chunk)
        return jax.vmap(run_one)(c, m)

    def make(repeats):
        @jax.jit
        def fn(shift):
            outs = []
            for i in range(repeats):
                c = jnp.roll(cands, shift + i, axis=0)
                m = jnp.roll(masks, shift + i, axis=0)
                outs.append(bank(c, m))
            return jax.tree.map(lambda *xs: sum(xs), *outs)

        return fn

    marginal, out0 = _slope_time(make, reduce_out)
    return marginal, out0


DEVICE = {}  # filled by main(): platform, device_kind, count, card


def emit(row):
    print(json.dumps({**row, "device": DEVICE}), flush=True)
    return row


def stage(name):
    """Stderr progress marker: a stall or timeout names the stage it
    died in."""
    print(f"[bench_tracking] {name}", file=sys.stderr, flush=True)


def bench_pdaf(bank1):
    """Single-target PDAF in clutter (pdaf.py; Bar-Shalom PDAF)."""
    truth, cands, masks = bank1
    f, q, h, r = _cv_system()
    x0 = jnp.asarray(X0_A, DTYPE)
    p0 = jnp.diag(jnp.asarray([4.0, 0.25, 4.0, 0.25], DTYPE))
    model, state = pdaf.new(x0, p0, f, None, h, gn.noiseless(q, r),
                            pd=PD, clutter_density=N_CLUTTER / BOX**2,
                            gate=16.0)

    def run_one(c, m):
        _, est = pdaf.run(model, state, c, m)
        return est.state[:, ::2]  # [T, 2] position track

    marginal, pos = _bank_runner(run_one, cands, masks,
                                 lambda o: o[-1, -1, 0])
    err = pos - truth[:, :, 0, ::2]
    rms = float(jnp.sqrt(jnp.mean(err[:, -TAIL:] ** 2)))
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "pdaf_frames_per_sec", "value": frames / marginal,
        "unit": "frames/s", "bank_ms": 1e3 * marginal,
        "scenes": B_SCENES, "frames": T_FRAMES, "m_max": M_MAX,
        "tail_pos_rms": rms, "gates_pass": bool(rms < 1.0),
    })


def bench_jpda(bank2):
    """Two crossing targets, joint association (jpda.py)."""
    truth, cands, masks = bank2
    f, q, h, r = _cv_system()
    x0s = jnp.asarray(np.stack([X0_A, X0_B]), DTYPE)
    p0 = jnp.diag(jnp.asarray([4.0, 0.25, 4.0, 0.25], DTYPE))
    model, state = jpda.new(x0s, p0, f, None, h, gn.noiseless(q, r),
                            m_max=M_MAX, pd=PD,
                            clutter_density=N_CLUTTER / BOX**2, gate=16.0)

    def run_one(c, m):
        _, est = jpda.run(model, state, c, m)
        return est.states[:, :, ::2]  # [T, 2, 2]

    marginal, pos = _bank_runner(run_one, cands, masks,
                                 lambda o: o[-1, -1, 0, 0])
    rms, loss = _maintained_rms(pos, truth[:, :, :, ::2])
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "jpda_frames_per_sec", "value": frames / marginal,
        "unit": "frames/s", "bank_ms": 1e3 * marginal,
        "scenes": B_SCENES, "frames": T_FRAMES, "m_max": M_MAX,
        "n_targets": 2, "tail_set_rms": rms, "track_loss_rate": loss,
        "gates_pass": bool(rms < 1.0 and loss <= 0.02),
    })


def bench_tracker(bank2):
    """GNN tracker with M/N lifecycle (tracker.py): auto-initiation
    from clutter-contaminated frames, no prior target count."""
    truth, cands, masks = bank2
    f, q, h, r = _cv_system()
    p0_new = jnp.diag(jnp.asarray([1.0, 0.5, 1.0, 0.5], DTYPE))
    model, state = tracker.new(f, None, h, gn.noiseless(q, r),
                               n_slots=M_MAX, p0_new=p0_new, gate=16.0,
                               confirm_hits=3, delete_misses=4)

    def run_one(c, m):
        _, est = tracker.run(model, state, c, m)
        return est.states[:, :, ::2], est.status == 2, est.n_confirmed

    marginal, (pos, conf, ncf) = _bank_runner(
        run_one, cands, masks, lambda o: o[0][-1, -1, 0, 0])
    # Gate pair: (a) each truth is localized by its nearest CONFIRMED
    # track (slots carry no canonical order, and an occasional phantom
    # must not poison the localization read-out); (b) the confirmed
    # count stays in a band around 2 so phantoms can't hide.
    d = jnp.linalg.norm(
        pos[:, :, None, :, :] - truth[:, :, :, None, ::2], axis=-1)
    d = jnp.where(conf[:, :, None, :], d, jnp.inf)  # [B, T, 2, slots]
    nearest = jnp.min(d, axis=-1)  # [B, T, 2]
    tail = nearest[:, -TAIL:]
    rms = float(jnp.sqrt(jnp.mean(
        jnp.where(jnp.isfinite(tail), tail, 0.0) ** 2)))
    covered = float(jnp.mean(jnp.isfinite(tail)))
    ncf_tail = float(jnp.mean(ncf[:, -TAIL:]))
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "gnn_tracker_frames_per_sec",
        "value": frames / marginal, "unit": "frames/s",
        "bank_ms": 1e3 * marginal, "scenes": B_SCENES,
        "frames": T_FRAMES, "m_max": M_MAX, "tail_loc_rms": rms,
        "tail_truth_coverage": covered, "tail_n_confirmed": ncf_tail,
        "gates_pass": bool(rms < 1.0 and covered > 0.95
                           and 1.8 < ncf_tail < 2.4),
    })


def _birth():
    bm = jnp.asarray([[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]],
                     DTYPE)
    bp = jnp.broadcast_to(
        jnp.diag(jnp.asarray([4.0, 0.25, 4.0, 0.25], DTYPE)), (2, 4, 4))
    bw = jnp.asarray([0.03, 0.03], DTYPE)
    return bw, bm, bp


def bench_phd(bank2):
    """GM-PHD (phd.py): intensity filter, no association at all."""
    truth, cands, masks = bank2
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    model, state = phd.new(f, None, h, gn.noiseless(q, r), bw, bm, bp,
                           p_survival=0.99, p_detect=PD,
                           clutter=N_CLUTTER / BOX**2, j_max=24)

    def run_one(c, m):
        _, est = phd.run(model, state, c, m)
        return est.states[:, :4, ::2], est.weights[:, :4], est.cardinality

    marginal, (pos, w, card) = _bank_runner(run_one, cands, masks,
                                            lambda o: o[0][-1, -1, 0, 0])
    ospa, worst = _tail_ospa(pos, w, truth[:, :, :, ::2])
    card_tail = float(jnp.mean(card[:, -TAIL:]))
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "gm_phd_frames_per_sec", "value": frames / marginal,
        "unit": "frames/s", "bank_ms": 1e3 * marginal,
        "scenes": B_SCENES, "frames": T_FRAMES, "m_max": M_MAX,
        "j_max": 24, "tail_ospa": ospa, "worst_scene_ospa": worst,
        "tail_cardinality": card_tail,
        "gates_pass": bool(ospa < 0.5 and 1.6 < card_tail < 2.4),
    })


def bench_cphd(bank2):
    """GM-CPHD (cphd.py): PHD + full cardinality pmf propagation."""
    truth, cands, masks = bank2
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    model, state = cphd.new(f, None, h, gn.noiseless(q, r), bw, bm, bp,
                            p_survival=0.99, p_detect=PD,
                            clutter_rate=float(N_CLUTTER),
                            volume=BOX**2, n_max=12, j_max=24)

    def run_one(c, m):
        _, est = cphd.run(model, state, c, m)
        return (est.states[:, :4, ::2], est.cardinality_map,
                est.cardinality_mean)

    marginal, (pos, cmap, card) = _bank_runner(run_one, cands, masks,
                                               lambda o: o[0][-1, -1, 0, 0])
    # MAP-cardinality-driven extraction (Vo, Vo & Cantoni 2007): take
    # the top-N̂ components where N̂ = argmax ρ.  This is CPHD's selling
    # point — the pmf holds N̂ = 2 straight through missed detections,
    # where weight-thresholded extraction drops the missed target for a
    # frame (measured: OSPA 0.52 thresholded vs 0.30 MAP-driven on the
    # same run bank).
    top_k = jnp.arange(4)[None, None, :] < cmap[:, :, None]
    ospa, worst = _tail_ospa(pos, jnp.where(top_k, 1.0, 0.0),
                             truth[:, :, :, ::2])
    card_tail = float(jnp.mean(card[:, -TAIL:]))
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "gm_cphd_frames_per_sec", "value": frames / marginal,
        "unit": "frames/s", "bank_ms": 1e3 * marginal,
        "scenes": B_SCENES, "frames": T_FRAMES, "m_max": M_MAX,
        "j_max": 24, "n_max": 12, "tail_ospa": ospa,
        "worst_scene_ospa": worst, "tail_cardinality": card_tail,
        "gates_pass": bool(ospa < 0.5 and 1.6 < card_tail < 2.4),
    })


def bench_pmb(bank2):
    """PMB/TOMB-P (pmb.py): Bernoulli tracks + BP association."""
    truth, cands, masks = bank2
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    model, state = pmb.new(f, None, h, gn.noiseless(q, r), bw, bm, bp,
                           p_survival=0.99, p_detect=PD,
                           clutter=N_CLUTTER / BOX**2, j_max=8,
                           t_max=8, bp_iters=10)

    def run_one(c, m):
        _, est = pmb.run(model, state, c, m)
        return est.states[:, :4, ::2], est.existence[:, :4], est.n_targets

    marginal, (pos, ex, nt) = _bank_runner(run_one, cands, masks,
                                           lambda o: o[0][-1, -1, 0, 0])
    # r > 0.5 extraction (the Bernoulli-track standard), OSPA-scored:
    # fixed top-2-by-existence reads DUPLICATE tracks of one target as
    # a "lost" other target (measured: 2-10% phantom scene-loss
    # across pmb/lmb/glmb, while the per-truth nearest-track RMS in
    # those very scenes is 0.14-0.24 — every target is tracked; only
    # the read-out was wrong).
    ospa, worst = _tail_ospa(pos, ex, truth[:, :, :, ::2])
    nt_tail = float(jnp.mean(nt[:, -TAIL:]))
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "pmb_frames_per_sec", "value": frames / marginal,
        "unit": "frames/s", "bank_ms": 1e3 * marginal,
        "scenes": B_SCENES, "frames": T_FRAMES, "m_max": M_MAX,
        "t_max": 8, "bp_iters": 10, "tail_ospa": ospa,
        "worst_scene_ospa": worst, "tail_n_targets": nt_tail,
        "gates_pass": bool(ospa < 0.5 and worst < 1.0
                           and 1.6 < nt_tail < 2.4),
    })


def bench_lmb(bank2):
    """Labeled multi-Bernoulli (lmb.py): labeled-RFS tracking with BP
    association at this scene scale."""
    truth, cands, masks = bank2
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    model, state = lmb.new(f, None, h, gn.noiseless(q, r), bw, bm, bp,
                           m_max=M_MAX, p_survival=0.99, p_detect=PD,
                           clutter=N_CLUTTER / BOX**2, t_max=8,
                           assoc="bp", bp_iters=10)

    def run_one(c, m):
        _, est = lmb.run(model, state, c, m)
        return est.states[:, :4, ::2], est.existence[:, :4], est.n_targets

    marginal, (pos, ex, nt) = _bank_runner(run_one, cands, masks,
                                           lambda o: o[0][-1, -1, 0, 0])
    ospa, worst = _tail_ospa(pos, ex, truth[:, :, :, ::2])  # r > 0.5
    nt_tail = float(jnp.mean(nt[:, -TAIL:]))
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "lmb_frames_per_sec", "value": frames / marginal,
        "unit": "frames/s", "bank_ms": 1e3 * marginal,
        "scenes": B_SCENES, "frames": T_FRAMES, "m_max": M_MAX,
        "t_max": 8, "bp_iters": 10, "tail_ospa": ospa,
        "worst_scene_ospa": worst, "tail_n_targets": nt_tail,
        "gates_pass": bool(ospa < 0.5 and worst < 1.0
                           and 1.6 < nt_tail < 2.4),
    })


def bench_glmb(bank2):
    """delta-GLMB (glmb.py) with the Gibbs association backend at this
    scene scale: hypothesis-carrying labeled RFS — the most expensive
    tracker in the stack (per frame it samples and exactly scores
    h_max x n_samples global hypotheses)."""
    truth, cands, masks = bank2
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    br = jnp.asarray([0.1, 0.1], DTYPE)
    model, state = glmb.new(f, None, h, gn.noiseless(q, r), br, bm, bp,
                            m_max=M_MAX, p_survival=0.99, p_detect=PD,
                            clutter=N_CLUTTER / BOX**2, gate=16.0,
                            t_max=4, h_max=16, assoc="gibbs",
                            n_samples=16, gibbs_sweeps=4)
    key = jax.random.PRNGKey(21)

    def run_one(c, m):
        _, est = glmb.run(model, state, c, m, key=key)
        # the Vo & Vo delta-GLMB estimator: tracks of the best
        # hypothesis at the MAP cardinality (marginal-existence top-k
        # misreads duplicate labels of one target as a lost other)
        return est.map_states[:, :, ::2], est.map_alive, est.n_targets

    marginal, (pos, alive, nt) = _bank_runner(
        run_one, cands, masks, lambda o: o[0][-1, -1, 0, 0])
    ospa, worst = _tail_ospa(pos, jnp.where(alive, 1.0, 0.0),
                             truth[:, :, :, ::2])
    nt_tail = float(jnp.mean(nt[:, -TAIL:]))
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "glmb_frames_per_sec", "value": frames / marginal,
        "unit": "frames/s", "bank_ms": 1e3 * marginal,
        "scenes": B_SCENES, "frames": T_FRAMES, "m_max": M_MAX,
        "t_max": 4, "h_max": 16, "n_samples": 16, "gibbs_sweeps": 4,
        "tail_ospa": ospa, "worst_scene_ospa": worst,
        "tail_n_targets": nt_tail,
        "gates_pass": bool(ospa < 0.5 and worst < 1.0
                           and 1.6 < nt_tail < 2.4),
    })


def bench_phd_lifecycle(bank):
    """GM-PHD on the lifecycle bank: adaptive (measurement-driven)
    birth does ALL the acquisition — the fixed birth prior sits at
    (±5, ±5), the spawn sites at (±30, ±30)."""
    truth, cands, masks, alive = bank
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    model, state = phd.new(f, None, h, gn.noiseless(q, r), bw, bm, bp,
                           p_survival=0.99, p_detect=PD,
                           clutter=N_CLUTTER / BOX**2, j_max=32,
                           adaptive_birth_w=0.02)

    def run_one(c, m):
        _, est = phd.run(model, state, c, m)
        # cardinality read-out = EXTRACTED component count (w > 0.5,
        # the Vo-Ma standard), not the intensity mass: with adaptive
        # birth the mass carries a ~0.3 standing birth-component
        # surplus by construction (measured), while the extraction
        # count reads the staircase cleanly.
        return (est.states[:, :8, ::2], est.weights[:, :8],
                jnp.sum(est.weights > 0.5, axis=1).astype(DTYPE))

    marginal, (pos, w, card) = _bank_runner(run_one, cands, masks,
                                            lambda o: o[0][-1, -1, 0, 0],
                                            chunk=32)
    scores = _lifecycle_scores(pos, w > 0.5, card, truth, alive)
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "gm_phd_lifecycle_frames_per_sec",
        "value": frames / marginal, "unit": "frames/s",
        "bank_ms": 1e3 * marginal, "scenes": B_SCENES,
        "frames": T_FRAMES, "m_max": M_LC, "j_max": 32,
        "adaptive_birth": True, "cardinality_profile": "2-3-4-3-2",
        **scores,
    })


def bench_cphd_lifecycle(bank):
    """GM-CPHD on the lifecycle bank: the cardinality pmf must climb
    the birth staircase and descend the death one."""
    truth, cands, masks, alive = bank
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    model, state = cphd.new(f, None, h, gn.noiseless(q, r), bw, bm, bp,
                            p_survival=0.99, p_detect=PD,
                            clutter_rate=float(N_CLUTTER),
                            volume=BOX**2, n_max=12, j_max=32,
                            adaptive_birth_w=0.02)

    def run_one(c, m):
        _, est = cphd.run(model, state, c, m)
        return (est.states[:, :8, ::2], est.cardinality_map,
                est.cardinality_mean)

    marginal, (pos, cmap, card) = _bank_runner(run_one, cands, masks,
                                               lambda o: o[0][-1, -1, 0, 0],
                                               chunk=32)
    # MAP-cardinality extraction (see bench_cphd)
    top_k = jnp.arange(8)[None, None, :] < cmap[:, :, None]
    scores = _lifecycle_scores(pos, top_k, card, truth, alive)
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "gm_cphd_lifecycle_frames_per_sec",
        "value": frames / marginal, "unit": "frames/s",
        "bank_ms": 1e3 * marginal, "scenes": B_SCENES,
        "frames": T_FRAMES, "m_max": M_LC, "j_max": 32, "n_max": 12,
        "adaptive_birth": True, "cardinality_profile": "2-3-4-3-2",
        **scores,
    })


def bench_lmb_lifecycle(bank):
    """LMB on the lifecycle bank: adaptive-birth Bernoulli tracks must
    be created at births and their existence driven to zero at deaths."""
    truth, cands, masks, alive = bank
    f, q, h, r = _cv_system()
    bw, bm, bp = _birth()
    model, state = lmb.new(f, None, h, gn.noiseless(q, r),
                           jnp.asarray([0.03, 0.03], DTYPE), bm, bp,
                           m_max=M_LC, p_survival=0.99, p_detect=PD,
                           clutter=N_CLUTTER / BOX**2, t_max=12,
                           assoc="bp", bp_iters=10,
                           adaptive_birth_r=0.05)

    def run_one(c, m):
        _, est = lmb.run(model, state, c, m)
        # cardinality read-out = confirmed-track count (r > 0.5, the
        # Bernoulli-track standard): sum-of-existence carries the
        # standing sub-threshold adaptive-birth mass (~+0.4 measured)
        return (est.states[:, :8, ::2], est.existence[:, :8],
                est.n_confirmed.astype(DTYPE))

    marginal, (pos, ex, nt) = _bank_runner(run_one, cands, masks,
                                           lambda o: o[0][-1, -1, 0, 0],
                                           chunk=32)
    scores = _lifecycle_scores(pos, ex > 0.5, nt, truth, alive)
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "lmb_lifecycle_frames_per_sec",
        "value": frames / marginal, "unit": "frames/s",
        "bank_ms": 1e3 * marginal, "scenes": B_SCENES,
        "frames": T_FRAMES, "m_max": M_LC, "t_max": 12,
        "adaptive_birth": True, "cardinality_profile": "2-3-4-3-2",
        **scores,
    })


def bench_tracker_lifecycle(bank):
    """GNN tracker on the lifecycle bank: the M/N lifecycle (3-hit
    confirmation, 4-miss deletion) is the component under test —
    tracks must auto-initiate at each birth and delete after each
    death."""
    truth, cands, masks, alive = bank
    f, q, h, r = _cv_system()
    p0_new = jnp.diag(jnp.asarray([1.0, 0.5, 1.0, 0.5], DTYPE))
    model, state = tracker.new(f, None, h, gn.noiseless(q, r),
                               n_slots=M_LC, p0_new=p0_new, gate=16.0,
                               confirm_hits=3, delete_misses=4)

    def run_one(c, m):
        _, est = tracker.run(model, state, c, m)
        return est.states[:, :, ::2], est.status == 2, est.n_confirmed

    marginal, (pos, conf, ncf) = _bank_runner(
        run_one, cands, masks, lambda o: o[0][-1, -1, 0, 0], chunk=32)
    scores = _lifecycle_scores(pos, conf, ncf.astype(DTYPE), truth, alive)
    frames = B_SCENES * T_FRAMES
    return emit({
        "metric": "gnn_tracker_lifecycle_frames_per_sec",
        "value": frames / marginal, "unit": "frames/s",
        "bank_ms": 1e3 * marginal, "scenes": B_SCENES,
        "frames": T_FRAMES, "m_max": M_LC, "n_slots": M_LC,
        "confirm_hits": 3, "delete_misses": 4,
        "cardinality_profile": "2-3-4-3-2", **scores,
    })


def bench_glmb_dense(bank, b_scenes):
    """delta-GLMB Gibbs at a scale where the exact backend is
    INFEASIBLE (round-4 judge task #4): t_max=12 label slots over
    M_LC=12 candidate slots means the exact ternary outcome table has
    sum_k C(12,k)·P(12,k) ≈ 1.3e10 rows — five orders of magnitude
    past the 500k host-enumeration guard — so Gibbs sampling over
    child hypotheses is the only way to run this scene at all.  Birth
    model: one Bernoulli slot per known spawn region (the standard
    Vo-Vo GLMB design input), means at the schedule's expected
    birth-time positions.  Scored with the same lifecycle gates as the
    adaptive-birth rows."""
    truth, cands, masks, alive = bank
    truth, cands, masks = (truth[:b_scenes], cands[:b_scenes],
                           masks[:b_scenes])
    f, q, h, r = _cv_system()
    births, _ = _lc_schedule()
    fn = np.asarray(f, np.float64)
    qn = np.asarray(q, np.float64)
    bm = np.stack([np.linalg.matrix_power(fn, int(b)) @ LC_X0[i]
                   for i, b in enumerate(births)])
    # Honest birth covariances: push the spawn uncertainty (scene
    # jitter) through the dynamics to each birth frame, accumulating
    # process noise — by frame 80 the integrated velocity noise alone
    # is sigma ~ 13 position units, so a fixed tight prior NEVER
    # gates the late births in most scenes (measured: E[n] peak 3.3/4
    # with sigma = 3; the push-forward prior recovers the staircase).
    jit_p = np.diag([0.25, 0.25 * 0.05**2, 0.25, 0.25 * 0.05**2])
    bp_rows = []
    for b in births:
        pb = jit_p.copy()
        for _ in range(int(b)):
            pb = fn @ pb @ fn.T + qn
        bp_rows.append(pb + np.diag([1.0, 0.01, 1.0, 0.01]))
    bp = jnp.asarray(np.stack(bp_rows), DTYPE)
    br = jnp.full((N_LC,), 0.03, DTYPE)
    model, state = glmb.new(f, None, h, gn.noiseless(q, r), br,
                            jnp.asarray(bm, DTYPE), bp,
                            m_max=M_LC, p_survival=0.99, p_detect=PD,
                            clutter=N_CLUTTER / BOX**2, gate=16.0,
                            t_max=12, h_max=64, assoc="gibbs",
                            n_samples=32, gibbs_sweeps=4)
    key = jax.random.PRNGKey(23)

    def run_one(c, m):
        _, est = glmb.run(model, state, c, m, key=key)
        return est.map_states[:, :, ::2], est.map_alive, est.n_targets

    marginal, (pos, alive_est, nt) = _bank_runner(
        run_one, cands, masks, lambda o: o[0][-1, -1, 0, 0])
    scores = _lifecycle_scores(pos, alive_est, nt, truth, alive)
    frames = b_scenes * T_FRAMES
    return emit({
        "metric": "glmb_dense_frames_per_sec",
        "value": frames / marginal, "unit": "frames/s",
        "bank_ms": 1e3 * marginal, "scenes": b_scenes,
        "frames": T_FRAMES, "m_max": M_LC, "t_max": 12, "h_max": 64,
        "n_samples": 32, "gibbs_sweeps": 4, "assoc": "gibbs",
        "exact_table_rows": "~1.3e10 (infeasible, 500k guard)",
        "cardinality_profile": "2-3-4-3-2", **scores,
    })


def bench_fusion(bank2, key):
    """Track-to-track association + covariance-intersection fusion
    (fusion.associate_and_fuse) over every (scene, frame) as an
    independent fusion problem: two sensors with COMPLEMENTARY-axis
    accuracy (a sharp in x / blurry in y, b the reverse — e.g. two
    crossed range-accurate radars), padded 4-slot track sets.  Gate:
    fused matched-track RMS beats BOTH single-sensor RMS.  The axes
    must be complementary for this gate to be achievable: with ALIGNED
    covariance shapes CI's optimum is ω = 1 (take the tighter track
    verbatim, fused == sensor a exactly — measured; same
    scalar-endpoint argument as the inverse-CI tightness tests), because
    without cross-covariance knowledge CI cannot exploit
    independence."""
    truth, _, _ = bank2
    pos = truth[:, :, :, ::2].reshape(-1, 2, 2)  # [B*T, 2, 2]
    n_prob = pos.shape[0]
    ka, kb = jax.random.split(key)
    sig_a = jnp.asarray([0.2, 0.8], DTYPE)  # sharp x, blurry y
    sig_b = jnp.asarray([0.8, 0.2], DTYPE)  # blurry x, sharp y
    pa = jnp.diag(sig_a**2)
    pb = jnp.diag(sig_b**2)
    xa_v = pos + sig_a * jax.random.normal(ka, pos.shape, DTYPE)
    xb_v = pos + sig_b * jax.random.normal(kb, pos.shape, DTYPE)
    pad = jnp.zeros((n_prob, 2, 2), DTYPE)
    xa = jnp.concatenate([xa_v, pad], axis=1)  # [n_prob, 4, 2]
    xb = jnp.concatenate([xb_v, pad], axis=1)
    mask = jnp.zeros((n_prob, 4), bool).at[:, :2].set(True)
    pas = jnp.broadcast_to(pa, (n_prob, 4, 2, 2))
    pbs = jnp.broadcast_to(pb, (n_prob, 4, 2, 2))

    def fuse_one(x1, p1, m1, x2, p2, m2):
        xs, ps, mk = fusion.associate_and_fuse(x1, p1, m1, x2, p2, m2,
                                               gate=16.0)
        return xs[:2]  # a-side fused tracks

    def make(repeats):
        @jax.jit
        def fn(shift):
            outs = []
            for i in range(repeats):
                x1 = jnp.roll(xa, shift + i, axis=0)
                outs.append(jax.vmap(fuse_one)(x1, pas, mask,
                                               xb, pbs, mask))
            return sum(outs)

        return fn

    marginal, fused = _slope_time(make, lambda o: o[-1, 0, 0])
    rms_f = _set_rms(fused.reshape(B_SCENES, T_FRAMES, 2, 2),
                     truth[:, :, :, ::2])
    rms_a = _set_rms(xa_v.reshape(B_SCENES, T_FRAMES, 2, 2),
                     truth[:, :, :, ::2])
    rms_b = _set_rms(xb_v.reshape(B_SCENES, T_FRAMES, 2, 2),
                     truth[:, :, :, ::2])
    return emit({
        "metric": "t2t_fusion_problems_per_sec",
        "value": n_prob / marginal, "unit": "fusions/s",
        "bank_ms": 1e3 * marginal, "problems": n_prob,
        "fused_rms": rms_f, "sensor_a_rms": rms_a, "sensor_b_rms": rms_b,
        "gates_pass": bool(rms_f < 0.95 * min(rms_a, rms_b)),
    })


def main():
    DEVICE.update(profiling.require_gpu())
    profiling.setup_compile_cache()
    stage("gen bank1")
    bank1 = _gen_bank(jax.random.PRNGKey(11), n_targets=1)
    stage("gen bank2")
    bank2 = _gen_bank(jax.random.PRNGKey(12), n_targets=2)
    stage("gen lifecycle bank")
    bank_lc = _gen_lifecycle_bank(jax.random.PRNGKey(14))
    glmb_dense_scenes = int(os.environ.get("BENCH_GLMB_DENSE_SCENES", 32))
    rows = []
    for name, fn in [
        ("pdaf", lambda: bench_pdaf(bank1)),
        ("jpda", lambda: bench_jpda(bank2)),
        ("tracker", lambda: bench_tracker(bank2)),
        ("phd", lambda: bench_phd(bank2)),
        ("cphd", lambda: bench_cphd(bank2)),
        ("pmb", lambda: bench_pmb(bank2)),
        ("lmb", lambda: bench_lmb(bank2)),
        ("glmb", lambda: bench_glmb(bank2)),
        ("fusion", lambda: bench_fusion(bank2, jax.random.PRNGKey(13))),
        ("phd_lifecycle", lambda: bench_phd_lifecycle(bank_lc)),
        ("cphd_lifecycle", lambda: bench_cphd_lifecycle(bank_lc)),
        ("lmb_lifecycle", lambda: bench_lmb_lifecycle(bank_lc)),
        ("tracker_lifecycle", lambda: bench_tracker_lifecycle(bank_lc)),
        ("glmb_dense",
         lambda: bench_glmb_dense(bank_lc, glmb_dense_scenes)),
    ]:
        stage(f"row {name}")
        rows.append(fn())
    ok = all(r["gates_pass"] for r in rows)
    emit({"metric": "tracking_tier_summary", "rows": len(rows),
          "gates_pass": ok})
    assert ok, "tracking-tier accuracy gates failed"


if __name__ == "__main__":
    main()
