"""Track fusion pins: independent fusion == KF identity update, the
Julier-Uhlmann CI consistency theorem over random joint covariances
(and the independence rule VIOLATING it on the same draws), the
det-minimizing weight vs brute force, no-gain on identical
covariances, T2T association calibration with/without the
cross-covariance, and a two-sensor end-to-end win."""

import jax
import jax.numpy as jnp
import numpy as np

from gokalman_tpu import noise as gn
from gokalman_tpu.filters import fusion, vanilla

from fixtures import random_spd


def _joint_blocks(rng, n, corr_scale=1.0):
    """Random jointly-PSD (Pa, Pb, Pab): draw a 2n x 2n SPD matrix and
    read off the blocks; corr_scale < 1 shrinks the cross block
    (staying PSD by diagonal dominance of the construction)."""
    j = random_spd(rng, 2 * n, 1.0)
    pa, pb = j[:n, :n], j[n:, n:]
    pab = corr_scale * j[:n, n:]
    return pa, pb, pab


def _ci_true_error_cov(pa, pb, pab, p_f, w):
    """The ACTUAL error covariance of the CI combination x_f =
    Wa xa + Wb xb (Wa = w P_f Pa^-1, Wb = (1-w) P_f Pb^-1) under the
    true joint statistics."""
    wa = w * p_f @ np.linalg.inv(pa)
    wb = (1.0 - w) * p_f @ np.linalg.inv(pb)
    return (wa @ pa @ wa.T + wb @ pb @ wb.T
            + wa @ pab @ wb.T + wb @ pab.T @ wa.T)


def test_fuse_independent_equals_identity_kf_update():
    rng = np.random.default_rng(0)
    n = 3
    pa, pb = random_spd(rng, n, 1.0), random_spd(rng, n, 1.0)
    xa, xb = rng.standard_normal(n), rng.standard_normal(n)
    fe = fusion.fuse_independent(xa, pa, xb, pb)
    m, s = vanilla.new(jnp.asarray(xa), jnp.asarray(pa), jnp.eye(n),
                       None, jnp.eye(n),
                       gn.noiseless(jnp.zeros((n, n)), jnp.asarray(pb)))
    # one measurement update with F = I, Q = 0, H = I, R = Pb
    _, e = vanilla.step(m, s, jnp.asarray(xb))
    np.testing.assert_allclose(np.asarray(fe.state), np.asarray(e.state),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(fe.covariance),
                               np.asarray(e.covariance), atol=1e-10)


def test_ci_consistency_theorem_and_independent_rule_violation():
    """CI's reason to exist: P_f upper-bounds the TRUE fused-error
    covariance for every feasible cross-covariance; the product rule
    does not (overconfident on positively correlated tracks)."""
    rng = np.random.default_rng(1)
    n = 3
    ind_violated = 0
    for _ in range(25):
        pa, pb, pab = _joint_blocks(rng, n)
        xa, xb = rng.standard_normal(n), rng.standard_normal(n)
        fe = fusion.covariance_intersection(xa, pa, xb, pb)
        p_f = np.asarray(fe.covariance)
        true_cov = _ci_true_error_cov(pa, pb, pab, p_f,
                                      float(fe.omega))
        assert np.linalg.eigvalsh(p_f - true_cov).min() > -1e-8
        # product rule on the same draw: its claimed covariance vs its
        # actual error covariance under the true correlation
        fi = fusion.fuse_independent(xa, pa, xb, pb)
        p_i = np.asarray(fi.covariance)
        wa = p_i @ np.linalg.inv(pa)
        wb = p_i @ np.linalg.inv(pb)
        true_i = (wa @ pa @ wa.T + wb @ pb @ wb.T
                  + wa @ pab @ wb.T + wb @ pab.T @ wa.T)
        if np.linalg.eigvalsh(p_i - true_i).min() < -1e-8:
            ind_violated += 1
    assert ind_violated > 15, ind_violated


def test_ci_no_gain_on_identical_covariances():
    rng = np.random.default_rng(2)
    p = random_spd(rng, 3, 1.0)
    xa, xb = rng.standard_normal(3), rng.standard_normal(3)
    fe = fusion.covariance_intersection(xa, p, xb, p)
    np.testing.assert_allclose(np.asarray(fe.covariance), p, atol=1e-8)


def test_ci_omega_matches_brute_force():
    rng = np.random.default_rng(3)
    for _ in range(5):
        pa, pb = random_spd(rng, 3, 1.0), random_spd(rng, 3, 1.0)
        xa, xb = rng.standard_normal(3), rng.standard_normal(3)
        fe = fusion.covariance_intersection(xa, pa, xb, pb)
        det_ci = np.linalg.det(np.asarray(fe.covariance))
        ws = np.linspace(0, 1, 10001)
        dets = [np.linalg.det(np.linalg.inv(
            w * np.linalg.inv(pa) + (1 - w) * np.linalg.inv(pb)))
            for w in ws]
        assert det_ci < np.min(dets) * (1 + 1e-4), (det_ci, np.min(dets))


def test_ci_defers_to_the_informative_track():
    rng = np.random.default_rng(4)
    pa = random_spd(rng, 2, 0.5)
    pb = 1e4 * np.eye(2)  # b knows nothing
    xa, xb = np.array([1.0, -1.0]), np.array([50.0, 50.0])
    fe = fusion.covariance_intersection(xa, pa, xb, pb)
    assert float(fe.omega) > 0.95, float(fe.omega)
    np.testing.assert_allclose(np.asarray(fe.state), xa, atol=0.05)
    np.testing.assert_allclose(np.asarray(fe.covariance), pa, rtol=0.05)


def test_t2t_statistic_calibration_and_cross_covariance():
    """Same-target statistic ~ chi2(n): mean n with the right S.
    With positively correlated errors and NO p_cross the statistic is
    deflated (too lenient); supplying Pab restores the mean."""
    rng = np.random.default_rng(5)
    n = 2
    # explicitly POSITIVELY correlated errors: ea = ec + e1,
    # eb = ec + e2 with a shared component ec (the shared-process-noise
    # structure of two trackers on one target): Pab = Pc > 0, so the
    # true S = P1 + P2 is SMALLER than the naive Pa + Pb
    pc = random_spd(rng, n, 1.0)
    p1 = random_spd(rng, n, 0.3)
    p2 = random_spd(rng, n, 0.3)
    pa, pb, pab = pc + p1, pc + p2, pc
    joint = np.block([[pa, pab], [pab.T, pb]])
    l_ = np.linalg.cholesky(joint)
    stats_nocross, stats_cross = [], []
    for _ in range(4000):
        e = l_ @ rng.standard_normal(2 * n)
        ea, eb = e[:n], e[n:]
        stats_nocross.append(float(fusion.t2t_statistic(ea, pa, eb, pb)))
        stats_cross.append(float(fusion.t2t_statistic(
            ea, pa, eb, pb, p_cross=pab)))
    m_no, m_yes = np.mean(stats_nocross), np.mean(stats_cross)
    assert abs(m_yes - n) < 0.15, m_yes
    assert m_no < 0.8 * n, m_no  # deflated without the cross term
    # different targets: statistic far beyond any sensible gate
    far = float(fusion.t2t_statistic(np.zeros(n) + 50.0, pa,
                                     np.zeros(n), pb))
    assert far > 100.0


def _two_tracker_mc(runs, seed):
    """Vectorized shared-truth two-tracker harness: returns final-step
    truth and (xa, Pa, xb, Pb) batches.  vmapped (one compile) — a
    python loop of eager fusion calls accumulates enough tiny XLA:CPU
    executables to hit this box's compile-materialization crash."""
    rng = np.random.default_rng(seed)
    dt = 1.0
    f = np.array([[1.0, dt], [0.0, 1.0]])
    q = 0.05 * np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]])
    h = np.array([[1.0, 0.0]])
    ra, rb = np.array([[0.5]]), np.array([[0.8]])
    lq = np.linalg.cholesky(q)
    xs = np.zeros((runs, 2))
    ya = np.zeros((runs, 60, 1))
    yb = np.zeros((runs, 60, 1))
    for trial in range(runs):
        x = np.array([0.0, 1.0])
        for k in range(60):
            x = f @ x + lq @ rng.standard_normal(2)
            ya[trial, k] = h @ x + np.sqrt(ra[0, 0]) * rng.standard_normal(1)
            yb[trial, k] = h @ x + np.sqrt(rb[0, 0]) * rng.standard_normal(1)
        xs[trial] = x
    ma, sa = vanilla.new(jnp.zeros(2), 10 * jnp.eye(2), jnp.asarray(f),
                         None, jnp.asarray(h),
                         gn.noiseless(jnp.asarray(q), jnp.asarray(ra)))
    mb, sb = vanilla.new(jnp.zeros(2), 10 * jnp.eye(2), jnp.asarray(f),
                         None, jnp.asarray(h),
                         gn.noiseless(jnp.asarray(q), jnp.asarray(rb)))
    ea = jax.vmap(lambda y: vanilla.run(ma, sa, y)[1])(jnp.asarray(ya))
    eb = jax.vmap(lambda y: vanilla.run(mb, sb, y)[1])(jnp.asarray(yb))
    return (xs, np.asarray(ea.state[:, -1]),
            np.asarray(ea.covariance[:, -1]),
            np.asarray(eb.state[:, -1]),
            np.asarray(eb.covariance[:, -1]))


def test_two_sensor_end_to_end_ci_fusion():
    """Two KFs watch the same constant-velocity truth through different
    sensors (correlated through the shared process noise); CI-fusing
    their final estimates beats each individual track's error on
    average AND stays conservative (NEES under the fused covariance
    <= n on average)."""
    xs, xa_b, pa_b, xb_b, pb_b = _two_tracker_mc(150, seed=6)
    fe = jax.vmap(fusion.covariance_intersection)(
        jnp.asarray(xa_b), jnp.asarray(pa_b),
        jnp.asarray(xb_b), jnp.asarray(pb_b))
    xf_b, pf_b = np.asarray(fe.state), np.asarray(fe.covariance)
    err_a = float(np.sum((xa_b - xs) ** 2))
    err_b = float(np.sum((xb_b - xs) ** 2))
    err_f = float(np.sum((xf_b - xs) ** 2))
    d = xf_b - xs
    nees = np.einsum("ri,rij,rj->r", d, np.linalg.inv(pf_b), d)
    # CI guarantees CONSISTENCY, not strict error reduction vs the
    # better track (the tracks share the process noise, so most of
    # their error is common); assert: never worse than the better
    # track beyond MC slack, strictly better than the worse one, and
    # the fused covariance stays honest-or-conservative
    lo, hi = min(err_a, err_b), max(err_a, err_b)
    assert err_f < hi, (err_f, err_a, err_b)
    assert err_f < 1.05 * lo, (err_f, err_a, err_b)
    assert np.mean(nees) < 2.2, np.mean(nees)


def test_bsc_known_cross_is_exact_and_optimal():
    """Bar-Shalom-Campo pins: (a) claimed P_f == TRUE fused-error
    covariance exactly; (b) no other unbiased linear combination
    (Wa + Wb = I grid) does better in trace; (c) Pab = 0 reduces to
    the independent product rule."""
    rng = np.random.default_rng(7)
    n = 2
    for _ in range(10):
        pa, pb, pab = _joint_blocks(rng, n, corr_scale=0.7)
        xa, xb = rng.standard_normal(n), rng.standard_normal(n)
        fe = fusion.fuse_known_cross(xa, pa, xb, pb, pab)
        p_f = np.asarray(fe.covariance)
        w = (pa - pab) @ np.linalg.inv(pa + pb - pab - pab.T)
        wa, wb = np.eye(n) - w, w
        true_cov = (wa @ pa @ wa.T + wb @ pb @ wb.T
                    + wa @ pab @ wb.T + wb @ pab.T @ wa.T)
        np.testing.assert_allclose(p_f, true_cov, atol=1e-10)
        # optimality: random perturbations of the gain never reduce tr
        for _ in range(20):
            dw = 0.05 * rng.standard_normal((n, n))
            wa2, wb2 = wa - dw, wb + dw
            alt = (wa2 @ pa @ wa2.T + wb2 @ pb @ wb2.T
                   + wa2 @ pab @ wb2.T + wb2 @ pab.T @ wa2.T)
            assert np.trace(alt) >= np.trace(true_cov) - 1e-10
    pa, pb = random_spd(rng, n, 1.0), random_spd(rng, n, 1.0)
    xa, xb = rng.standard_normal(n), rng.standard_normal(n)
    fb = fusion.fuse_known_cross(xa, pa, xb, pb, np.zeros((n, n)))
    fi = fusion.fuse_independent(xa, pa, xb, pb)
    np.testing.assert_allclose(np.asarray(fb.state),
                               np.asarray(fi.state), atol=1e-10)
    np.testing.assert_allclose(np.asarray(fb.covariance),
                               np.asarray(fi.covariance), atol=1e-10)


def test_associate_tracks_matches_brute_force_optimum():
    """Exact-enumeration contract: the assignment's total gated cost
    equals the brute-force optimum over all permutations (greedy has
    no such guarantee), on a hand case and random scenes."""
    pa = np.broadcast_to(np.eye(1), (2, 1, 1))
    xa = np.array([[0.0], [1.4]])
    xb = np.array([[0.2], [1.0]])
    a, s = fusion.associate_tracks(xa, pa, np.ones(2, bool), xb, pa,
                                   np.ones(2, bool), gate=16.0)
    assert list(np.asarray(a)) == [0, 1]
    # brute-force oracle over all GATED matchings on random scenes:
    # objective = sum(matched stats) + gate * (#unmatched_a + #unmatched_b)
    rng = np.random.default_rng(0)
    import itertools

    gate = 16.0

    def total_cost(xa_, xb_, pairs, n_a, n_b):
        t_ = 0.0
        used_b = set()
        for i, j in pairs:
            t_ += (xa_[i, 0] - xb_[j, 0]) ** 2 / 2.0
            used_b.add(j)
        t_ += gate * (n_a - len(pairs)) + gate * (n_b - len(used_b))
        return t_

    def brute_force(xa_, xb_, n_a, n_b):
        best = np.inf
        for k in range(min(n_a, n_b) + 1):
            for rows in itertools.combinations(range(n_a), k):
                for cols in itertools.permutations(range(n_b), k):
                    pairs = [(i, j) for i, j in zip(rows, cols)
                             if (xa_[i, 0] - xb_[j, 0]) ** 2 / 2.0
                             <= gate]
                    if len(pairs) < k:
                        continue
                    best = min(best, total_cost(xa_, xb_, pairs,
                                                n_a, n_b))
        return best

    for _ in range(10):
        xa_ = rng.uniform(-3, 3, (3, 1))
        xb_ = rng.uniform(-3, 3, (3, 1))
        pa_ = np.broadcast_to(np.eye(1), (3, 1, 1))
        a_, s_ = fusion.associate_tracks(xa_, pa_, np.ones(3, bool),
                                         xb_, pa_, np.ones(3, bool),
                                         gate=gate)
        got = [(i, int(j)) for i, j in enumerate(np.asarray(a_))
               if j >= 0]
        assert total_cost(xa_, xb_, got, 3, 3) <=             brute_force(xa_, xb_, 3, 3) + 1e-9


def test_associate_tracks_per_side_unmatched_cost():
    """Regression (review find, measured): a single-gate cost for a
    dropped real-real pair let the optimizer unmatch BOTH sides at
    half price — stats [[15, inf], [14, 15.9]] at gate 16 returned
    [-1, 0] (a0 dropped despite an in-gate partner, 3 output tracks
    for 2 targets).  Per-side accounting keeps both matches."""
    # build 1-D tracks realizing those statistics: stat = d^2/2
    pa = np.broadcast_to(np.eye(1), (2, 1, 1))
    xa = np.array([[0.0], [100.0 + np.sqrt(2 * 14.0)]])
    xb = np.array([[np.sqrt(2 * 15.0)], [100.0 + np.sqrt(2 * 14.0)
                                         + np.sqrt(2 * 15.9) * 0]])
    # simpler: place b0 between a0 and a1 so a0-b0=15, a1-b0=14,
    # and b1 near a1 with a1-b1=15.9, a0-b1 far
    d00, d10, d11 = np.sqrt(2 * 15.0), np.sqrt(2 * 14.0), np.sqrt(2 * 15.9)
    xa = np.array([[0.0], [d00 + d10]])
    xb = np.array([[d00], [d00 + d10 + d11]])
    stats = (xa - xb.T) ** 2 / 2.0
    assert abs(stats[0, 0] - 15.0) < 1e-9
    assert abs(stats[1, 0] - 14.0) < 1e-9
    assert abs(stats[1, 1] - 15.9) < 1e-9
    assert stats[0, 1] > 16.0
    a, s = fusion.associate_tracks(xa, pa, np.ones(2, bool), xb, pa,
                                   np.ones(2, bool), gate=16.0)
    assert list(np.asarray(a)) == [0, 1], list(np.asarray(a))


def test_associate_tracks_gating_and_masks():
    pa = np.broadcast_to(np.eye(2), (3, 2, 2))
    xa = np.array([[0.0, 0.0], [5.0, 5.0], [50.0, 50.0]])
    xb = np.array([[0.1, -0.1], [49.0, 49.0], [0.0, 0.0]])
    mask_b = np.array([True, True, False])  # b[2] invalid (dup of a[0])
    a, s = fusion.associate_tracks(xa, pa, np.ones(3, bool), xb, pa,
                                   mask_b, gate=9.21)  # chi2(2) 99%
    a = list(np.asarray(a))
    assert a[0] == 0          # near pair matched
    assert a[1] == -1         # nothing within gate
    assert a[2] == 1          # 50,50 <-> 49,49 within gate (d2/2=1)
    assert np.isinf(np.asarray(s)[1])


def test_associate_and_fuse_improves_ospa():
    """Two noisy views of 3 targets: the fused set is closer to truth
    (OSPA) than either single-sensor set, and unmatched leftovers
    survive (a b-only target stays in the output)."""
    from gokalman_tpu.diagnostics import ospa

    rng = np.random.default_rng(4)
    truth = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0],
                      [10.0, 10.0]])
    pa = np.broadcast_to(0.5 * np.eye(2), (4, 2, 2)).copy()
    pb = np.broadcast_to(0.8 * np.eye(2), (4, 2, 2)).copy()
    o_f, o_a, o_b = [], [], []
    for _ in range(50):
        xa = truth[:3] + np.sqrt(0.5) * rng.standard_normal((3, 2))
        xb = truth + np.sqrt(0.8) * rng.standard_normal((4, 2))
        xa = np.vstack([xa, np.zeros((1, 2))])  # padded slot
        ma = np.array([True, True, True, False])
        mb = np.ones(4, bool)
        xs, ps, mask = fusion.associate_and_fuse(
            xa, pa, ma, xb, pb, mb, gate=25.0)
        assert int(np.asarray(mask).sum()) == 4  # 3 fused + 1 leftover
        o_f.append(float(ospa(xs, mask, truth, np.ones(4, bool), 5.0)))
        o_a.append(float(ospa(xa, ma, truth, np.ones(4, bool), 5.0)))
        o_b.append(float(ospa(xb, mb, truth, np.ones(4, bool), 5.0)))
    assert np.mean(o_f) < np.mean(o_a)
    assert np.mean(o_f) < np.mean(o_b)


def test_ici_tighter_than_ci_unbiased_and_consistent():
    """Inverse-CI pins: (a) unbiased combination (gains sum to I) for any w;
    (b) det(P_ICI) <= det(P_CI) on random pairs; (c) no-gain on
    identical covariances (== P, like CI); (d) honest NEES in the
    shared-process-noise two-tracker scenario (its consistency model)
    while strictly tighter than CI there."""
    rng = np.random.default_rng(8)
    for _ in range(10):
        pa = random_spd(rng, 3, 1.0)
        pb = random_spd(rng, 3, 1.0)
        xa, xb = rng.standard_normal(3), rng.standard_normal(3)
        fi = fusion.inverse_covariance_intersection(xa, pa, xb, pb)
        fc = fusion.covariance_intersection(xa, pa, xb, pb)
        assert (np.linalg.det(np.asarray(fi.covariance))
                <= np.linalg.det(np.asarray(fc.covariance)) * (1 + 1e-9))
        # unbiasedness: fusing xa == xb returns exactly that point
        same = fusion.inverse_covariance_intersection(xa, pa, xa, pb)
        np.testing.assert_allclose(np.asarray(same.state), xa,
                                   atol=1e-8)
    p = random_spd(rng, 3, 1.0)
    fe = fusion.inverse_covariance_intersection(
        rng.standard_normal(3), p, rng.standard_normal(3), p)
    np.testing.assert_allclose(np.asarray(fe.covariance), p, atol=1e-7)
    # shared-process-noise two-tracker MC: honest NEES, never worse
    xs, xa_b, pa_b, xb_b, pb_b = _two_tracker_mc(150, seed=9)
    fi_b = jax.vmap(fusion.inverse_covariance_intersection)(
        jnp.asarray(xa_b), jnp.asarray(pa_b),
        jnp.asarray(xb_b), jnp.asarray(pb_b))
    fc_b = jax.vmap(fusion.covariance_intersection)(
        jnp.asarray(xa_b), jnp.asarray(pa_b),
        jnp.asarray(xb_b), jnp.asarray(pb_b))
    d = np.asarray(fi_b.state) - xs
    nees_ici = np.einsum("ri,rij,rj->r", d,
                         np.linalg.inv(np.asarray(fi_b.covariance)), d)
    det_ratio = (np.linalg.det(np.asarray(fi_b.covariance))
                 / np.linalg.det(np.asarray(fc_b.covariance)))
    assert np.mean(nees_ici) < 2.5, np.mean(nees_ici)  # honest (n=2)
    # here both covariances share the same SHAPE (same H/F/Q), where
    # inverse CI and CI coincide (both optima sit at the scalar endpoint) —
    # never worse is the guarantee:
    assert np.max(det_ratio) < 1.0 + 1e-6, np.max(det_ratio)
    # the strict win needs COMPLEMENTARY information directions:
    pa_c, pb_c = np.diag([0.1, 4.0]), np.diag([4.0, 0.1])
    fi_c = fusion.inverse_covariance_intersection(
        np.zeros(2), pa_c, np.zeros(2), pb_c)
    fc_c = fusion.covariance_intersection(
        np.zeros(2), pa_c, np.zeros(2), pb_c)
    ratio = (np.linalg.det(np.asarray(fi_c.covariance))
             / np.linalg.det(np.asarray(fc_c.covariance)))
    assert ratio < 0.3, ratio  # measured 0.276


def test_ci_n_matches_pairwise_and_beats_sequential():
    """N-CI pins: N=2 == pairwise CI; consistency over random joint
    covariances for N=4; joint weight optimization never looser than
    sequential pairwise CI (and strictly tighter on shaped draws)."""
    rng = np.random.default_rng(10)
    # N = 2 equivalence
    pa, pb = random_spd(rng, 3, 1.0), random_spd(rng, 3, 1.0)
    xa, xb = rng.standard_normal(3), rng.standard_normal(3)
    f2 = fusion.covariance_intersection(xa, pa, xb, pb)
    fn = fusion.covariance_intersection_n(np.stack([xa, xb]),
                                          np.stack([pa, pb]))
    np.testing.assert_allclose(np.asarray(fn.covariance),
                               np.asarray(f2.covariance), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(fn.state),
                               np.asarray(f2.state), atol=1e-5)
    # N = 4: consistency for every feasible joint correlation
    n = 2
    for _ in range(5):
        j = random_spd(rng, 4 * n, 1.0)
        ps = np.stack([j[i * n:(i + 1) * n, i * n:(i + 1) * n]
                       for i in range(4)])
        xs = rng.standard_normal((4, n))
        fe = fusion.covariance_intersection_n(xs, ps)
        w = np.zeros((4, n, n))
        p_f = np.asarray(fe.covariance)
        lam = sum(float(np.nan) for _ in ())  # no-op keepalive
        # gains: W_i = w_i P_f P_i^-1, sum W_i = I
        # true fused-error covariance under the joint j
        ws_ = [np.asarray(fe.omega)]  # w[0]; recover all from identity
        # recompute weights from the returned covariance instead:
        # P_f^-1 = sum w_i P_i^-1 with the found w — check consistency
        # directly via the gain form using the simplex found inside:
        # (use equal gains reconstruction: W_i = w_i P_f P_i^-1 needs
        # all w; re-derive w by least squares on the information sum)
        infos = np.stack([np.linalg.inv(p_) for p_ in ps])
        a_mat = infos.reshape(4, -1).T
        w_all, *_ = np.linalg.lstsq(a_mat,
                                    np.linalg.inv(p_f).reshape(-1),
                                    rcond=None)
        w_all = np.clip(w_all, 0, None)
        w_all = w_all / w_all.sum()
        wg = [w_all[i] * p_f @ infos[i] for i in range(4)]
        true_cov = np.zeros((n, n))
        for i in range(4):
            for k in range(4):
                true_cov += wg[i] @ j[i * n:(i + 1) * n,
                                      k * n:(k + 1) * n] @ wg[k].T
        assert np.linalg.eigvalsh(p_f - true_cov).min() > -1e-7
    # joint optimum never looser than sequential pairwise
    for _ in range(5):
        ps = np.stack([random_spd(rng, 2, 1.0) for _ in range(4)])
        xs = rng.standard_normal((4, 2))
        fj = fusion.covariance_intersection_n(xs, ps)
        x_s, p_s = xs[0], ps[0]
        for i in range(1, 4):
            fs = fusion.covariance_intersection(x_s, p_s, xs[i], ps[i])
            x_s, p_s = np.asarray(fs.state), np.asarray(fs.covariance)
        assert (np.linalg.det(np.asarray(fj.covariance))
                <= np.linalg.det(p_s) * (1 + 1e-6))
