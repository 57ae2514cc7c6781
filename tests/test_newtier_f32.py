"""f32 + vmap-bank smoke tests for the session's new tier.

The device path runs in float32: these pin that each new filter
(a) stays finite and sane in f32 (dtype promotions, eps guards), and
(b) vmaps over scenario banks (the serving shape every module claims).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gokalman_tpu import noise as gn
from gokalman_tpu.dynamics import attitude as att
from gokalman_tpu.filters import (jpda, mekf, pdaf, phd, quadrature,
                                  studentt, tracker, ukf, vanilla)


@pytest.fixture(autouse=True)
def _f32():
    # tests/conftest.py enables x64 globally; run this module in f32
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _cv4():
    f = jnp.asarray(np.kron(np.eye(2), np.array([[1.0, 1.0], [0.0, 1.0]])),
                    jnp.float32)
    qb = np.array([[1 / 3, 1 / 2], [1 / 2, 1.0]]) * 1e-3
    q = jnp.asarray(np.kron(np.eye(2), qb), jnp.float32)
    h = jnp.asarray(np.kron(np.eye(2), np.array([[1.0, 0.0]])), jnp.float32)
    r = jnp.asarray(0.04 * np.eye(2), jnp.float32)
    return f, q, h, r


def test_studentt_f32_and_vmap_bank():
    dt = 0.1
    f = jnp.asarray([[1.0, dt], [0.0, 1.0]], jnp.float32)
    h = jnp.asarray([[1.0, 0.0]], jnp.float32)
    q = jnp.asarray([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]],
                    jnp.float32) * 0.02
    r = jnp.asarray([[0.5]], jnp.float32)
    nz = gn.noiseless(q, r)
    tm, ts = studentt.new(jnp.zeros(2, jnp.float32),
                          jnp.eye(2, dtype=jnp.float32), f, None, h, nz,
                          dof=4.0)
    ys_bank = jax.random.normal(jax.random.PRNGKey(0), (8, 60, 1),
                                jnp.float32)
    _, ests = jax.vmap(lambda y: studentt.run(tm, ts, y))(ys_bank)
    assert ests.state.dtype == jnp.float32
    assert np.isfinite(np.asarray(ests.state)).all()
    assert (np.asarray(ests.scale)[..., 0, 0] > 0).all()


def test_quadrature_f32():
    nz = gn.noiseless(jnp.asarray([[0.01]], jnp.float32),
                      jnp.asarray([[0.3]], jnp.float32))
    qm, qs = quadrature.new(jnp.ones(1, jnp.float32),
                            jnp.eye(1, dtype=jnp.float32), nz, order=5)
    fx = lambda x: 0.9 * x + 0.2 * jnp.sin(x)
    hx = lambda x: x
    ys = jax.random.normal(jax.random.PRNGKey(1), (50, 1), jnp.float32)
    _, est = quadrature.run(qm, qs, ys, fx, hx)
    xs_sm, _ = quadrature.rts_smoother(qm, est.state, est.covariance, fx)
    assert est.state.dtype == jnp.float32
    assert np.isfinite(np.asarray(xs_sm)).all()


def test_mekf_usque_f32():
    refs = np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32)
    model, state = mekf.new(att.quat_identity(jnp.float32),
                            jnp.eye(6, dtype=jnp.float32) * 1e-2,
                            refs, 1e-4, 1e-6, 1e-3, 0.25)
    rng = np.random.default_rng(2)
    T = 60
    omegas = jnp.asarray(0.02 * rng.standard_normal((T, 3)), jnp.float32)
    obs = jnp.asarray(np.tile(refs, (T, 1, 1)), jnp.float32)
    _, em = mekf.run(model, state, omegas, obs)
    _, eu = mekf.usque_run(model, state, omegas, obs)
    for est in (em, eu):
        norms = np.linalg.norm(np.asarray(est.q), axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)
        assert np.isfinite(np.asarray(est.covariance)).all()


def test_jpda_tracker_phd_f32():
    f, q, h, r = _cv4()
    nz = gn.noiseless(q, r)
    rng = np.random.default_rng(3)
    T = 30
    frames = jnp.asarray(rng.uniform(-20, 20, (T, 4, 2)), jnp.float32)
    frames = frames.at[:, 0, :].set(
        jnp.asarray(rng.standard_normal((T, 2)) * 0.2, jnp.float32))
    masks = jnp.ones((T, 4), bool)

    x0s = jnp.zeros((2, 4), jnp.float32).at[1, 0].set(10.0).at[1, 2].set(10.0)
    jm, js = jpda.new(x0s, jnp.eye(4, dtype=jnp.float32), f, None, h, nz,
                      m_max=4)
    _, ej = jpda.run(jm, js, frames, masks)
    assert ej.states.dtype == jnp.float32
    assert np.isfinite(np.asarray(ej.states)).all()
    assert np.isfinite(np.asarray(ej.betas)).all()

    tm, tst = tracker.new(f, None, h, nz, n_slots=6,
                          p0_new=jnp.diag(jnp.asarray(
                              [0.2, 0.25, 0.2, 0.25], jnp.float32)))
    _, et = tracker.run(tm, tst, frames, masks)
    assert np.isfinite(np.asarray(et.states)).all()

    bm = jnp.zeros((1, 4), jnp.float32)
    bp = jnp.eye(4, dtype=jnp.float32)[None] * 4.0
    pm, pst = phd.new(f, None, h, nz, jnp.asarray([0.05], jnp.float32),
                      bm, bp, j_max=12)
    _, ep = phd.run(pm, pst, frames, masks)
    assert np.isfinite(np.asarray(ep.cardinality)).all()
    assert np.isfinite(np.asarray(ep.states)).all()


def test_oosm_fading_correlated_f32():
    f, q, h, r = _cv4()
    nz = gn.noiseless(q, r)
    x0 = jnp.zeros(4, jnp.float32)
    p0 = jnp.eye(4, dtype=jnp.float32)
    vm, vs = vanilla.new(x0, p0, f, None, h, nz)
    ys = jax.random.normal(jax.random.PRNGKey(4), (40, 2), jnp.float32)
    _, ef = vanilla.run_fading(vm, vs, ys, alpha=1.02)
    assert ef.state.dtype == jnp.float32
    assert np.isfinite(np.asarray(ef.state)).all()
    m_ok = 0.3 * jnp.sqrt(jnp.diag(q)[:, None]
                          * jnp.diag(r)[None, :]).astype(jnp.float32)
    _, ec = vanilla.run_correlated(vm, vs, ys, m_ok)
    assert np.isfinite(np.asarray(ec.state)).all()
    sk, ek = vanilla.step(vm, vs, ys[0])
    _, eo = vanilla.oosm_update(vm, sk, ek, ys[1], f, q)
    assert np.isfinite(np.asarray(eo.state)).all()


def test_iplf_augmented_f32():
    nz = gn.noiseless(jnp.eye(2, dtype=jnp.float32) * 0.01,
                      jnp.asarray([[0.09]], jnp.float32))
    um, us = ukf.new(jnp.asarray([1.0, 0.5], jnp.float32),
                     jnp.eye(2, dtype=jnp.float32) * 0.4, nz)
    fx = lambda x: jnp.stack([x[0] + 0.1 * jnp.sin(x[1]), 0.95 * x[1]])
    hx = lambda x: jnp.linalg.norm(x)[None]
    ys = 1.0 + 0.1 * jax.random.normal(jax.random.PRNGKey(5), (30, 1),
                                       jnp.float32)
    _, ei = ukf.run_iplf(um, us, ys, fx, hx, iters=3)
    assert ei.state.dtype == jnp.float32
    assert np.isfinite(np.asarray(ei.covariance)).all()

    fxa = lambda x, w: fx(x) + w
    hxa = lambda x, v: hx(x) + v
    _, ea = ukf.run_augmented(um, us, ys, fxa, hxa)
    assert np.isfinite(np.asarray(ea.state)).all()


def test_cphd_ospa_f32_dense_scene():
    """cphd in f32 on a DENSE, tight-R scene: the scaled-esf form must
    survive where raw elementary symmetric functions overflow float32
    (xi ~ 1e4-1e5 and e_8 ~ xi^8 >> 3.4e38); ospa f32 trace finite."""
    from gokalman_tpu.diagnostics import ospa
    from gokalman_tpu.filters import cphd

    f, q, h, r = _cv4()
    r_tight = jnp.asarray(1e-4 * np.eye(2), jnp.float32)
    nz = gn.noiseless(q, r_tight)
    rng = np.random.default_rng(9)
    # 8 detections clustered near the birth site every frame
    T = 10
    frames = jnp.asarray(rng.normal(0.0, 0.5, (T, 8, 2)), jnp.float32)
    masks = jnp.ones((T, 8), bool)
    bm = jnp.zeros((1, 4), jnp.float32)
    bp = jnp.eye(4, dtype=jnp.float32)[None] * 4.0
    model, state = cphd.new(f, None, h, nz, jnp.asarray([0.2], jnp.float32),
                            bm, bp, p_detect=0.9, clutter_rate=2.0,
                            volume=1e4, n_max=12, j_max=12)
    _, est = cphd.run(model, state, frames, masks)
    assert est.cardinality_pmf.dtype == jnp.float32
    assert np.isfinite(np.asarray(est.cardinality_pmf)).all()
    assert np.isfinite(np.asarray(est.weights)).all()
    o = jax.vmap(lambda e, em: ospa(
        e, em, jnp.zeros((2, 2), jnp.float32), jnp.ones(2, bool), 3.0))(
            est.states[:, :4, ::2], est.weights[:, :4] > 0.5)
    assert np.isfinite(np.asarray(o)).all()


def test_immpdaf_rigidbody_f32():
    from gokalman_tpu.dynamics import attitude as att32
    from gokalman_tpu.filters import imm, vanilla

    dt = 0.5
    f = jnp.asarray([[1.0, dt], [0.0, 1.0]], jnp.float32)
    h = jnp.asarray([[1.0, 0.0]], jnp.float32)
    qb = jnp.asarray([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]],
                     jnp.float32)
    r = jnp.asarray([[0.09]], jnp.float32)

    def mk(qs):
        return vanilla.new(jnp.zeros(2, jnp.float32),
                           jnp.eye(2, dtype=jnp.float32), f, None, h,
                           gn.noiseless(qs * qb, r))[0]

    im, ist = imm.new(jnp.zeros(2, jnp.float32),
                      jnp.eye(2, dtype=jnp.float32),
                      [mk(1e-3), mk(1.0)],
                      jnp.asarray([[0.95, 0.05], [0.05, 0.95]],
                                  jnp.float32))
    rng = np.random.default_rng(4)
    frames = jnp.asarray(rng.uniform(-5, 5, (20, 4, 1)), jnp.float32)
    masks = jnp.ones((20, 4), bool)
    _, est = imm.run_pdaf(im, ist, frames, masks, 0.9, 0.3, 16.0)
    assert est.state.dtype == jnp.float32
    assert np.isfinite(np.asarray(est.state)).all()
    assert np.allclose(np.asarray(est.mode_probs).sum(axis=1), 1.0,
                       atol=1e-5)

    inertia = jnp.diag(jnp.asarray([1.0, 2.0, 3.0], jnp.float32))
    q = att32.quat_identity(jnp.float32)
    w = jnp.asarray([0.02, 0.5, 0.01], jnp.float32)
    for _ in range(20):
        q, w = att32.propagate_rigid_body(q, w, inertia, 0.05, n_sub=2)
    assert q.dtype == jnp.float32
    np.testing.assert_allclose(float(jnp.linalg.norm(q)), 1.0, atol=1e-5)


def test_pmb_fusion_sise_f32():
    from gokalman_tpu.filters import fusion, pmb, sise

    f, q, h, r = _cv4()
    rng = np.random.default_rng(12)
    # PMB: one target + clutter, f32 end to end
    bm = jnp.zeros((1, 4), jnp.float32)
    bp = 4.0 * jnp.eye(4, dtype=jnp.float32)[None]
    m, s = pmb.new(f, None, h, gn.noiseless(q, r),
                   jnp.asarray([0.05], jnp.float32), bm, bp,
                   j_max=8, t_max=6)
    x = np.array([0.5, 0.1, -0.5, 0.1], np.float32)
    frames = np.zeros((30, 4, 2), np.float32)
    fn, hn = np.asarray(f), np.asarray(h)
    for k in range(30):
        x = fn @ x
        frames[k, 0] = hn @ x + 0.2 * rng.standard_normal(2)
        frames[k, 1:] = rng.uniform(-20, 20, (3, 2))
    _, est = pmb.run(m, s, jnp.asarray(frames),
                     jnp.ones((30, 4), bool))
    assert est.existence.dtype == jnp.float32
    assert np.isfinite(np.asarray(est.states)).all()
    assert float(est.existence[-1, 0]) > 0.5
    # fusion: vmapped CI over a bank of track pairs, f32
    pa = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (16, 2, 2))
    pb = 2.0 * pa
    xa = jnp.asarray(rng.standard_normal((16, 2)), jnp.float32)
    xb = xa + 0.1
    fe = jax.vmap(fusion.covariance_intersection)(xa, pa, xb, pb)
    assert fe.covariance.dtype == jnp.float32
    assert np.isfinite(np.asarray(fe.covariance)).all()
    assert ((np.asarray(fe.omega) >= 0) & (np.asarray(fe.omega) <= 1)).all()
    # sise: f32 run stays finite, d-hat tracks a step
    e_in = jnp.asarray([[0.0], [1.0], [0.0], [0.0]], jnp.float32)
    ms_, ss_ = sise.new(jnp.zeros(4, jnp.float32),
                        jnp.eye(4, dtype=jnp.float32), f, None,
                        jnp.eye(4, dtype=jnp.float32), e_in,
                        gn.noiseless(q, 0.1 * jnp.eye(4, dtype=jnp.float32)))
    xs_ = np.zeros(4, np.float32)
    ys_ = []
    for k in range(40):
        d = 0.5 if k >= 20 else 0.0
        xs_ = fn @ xs_ + np.asarray(e_in[:, 0]) * d \
            + 0.01 * rng.standard_normal(4)
        ys_.append(xs_ + 0.3 * rng.standard_normal(4))
    _, es_ = sise.run(ms_, ss_, jnp.asarray(np.stack(ys_), jnp.float32))
    assert es_.state.dtype == jnp.float32
    assert np.isfinite(np.asarray(es_.input)).all()
    assert abs(float(np.asarray(es_.input)[30:, 0].mean()) - 0.5) < 0.2


def test_setmembership_f32():
    from gokalman_tpu.filters import setmembership as smf

    f = jnp.asarray([[1.0, 0.5], [0.0, 1.0]], jnp.float32)
    h = jnp.asarray([[1.0, 0.0]], jnp.float32)
    q = jnp.asarray(np.diag([0.02, 0.08]), jnp.float32)
    r = jnp.asarray([[0.09]], jnp.float32)
    rng = np.random.default_rng(5)
    m, s = smf.new(jnp.zeros(2, jnp.float32),
                   0.5 * jnp.eye(2, dtype=jnp.float32), f, None, h,
                   gn.noiseless(q, r))
    ys = jnp.asarray(0.3 * rng.standard_normal((40, 1)), jnp.float32)
    _, est = smf.run(m, s, ys)
    assert est.shape.dtype == jnp.float32
    assert np.isfinite(np.asarray(est.shape)).all()
    assert (np.asarray(est.trace) > 0).all()
