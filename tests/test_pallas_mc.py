"""Fused Monte-Carlo kernel (ops/pallas_mc.py) tests.

On the CPU the kernel runs through the Pallas interpreter, which runs
the kernel's real counter-based generator, so the kernel is checked
member for member against its jnp replica (identical noise) and against
an independent float64 numpy replay.  Tests marked `gpu` run the
compiled Triton kernel and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gokalman_tpu import noise as gn
from gokalman_tpu.filters import vanilla
from gokalman_tpu.ops import pallas_mc
from gokalman_tpu.ops.ensemble import mc_chi_square

FIELDS = ("nis_means", "nees_means", "mean", "stddev")


def _model6(dtype=jnp.float32):
    i3 = jnp.eye(3, dtype=dtype)
    z3 = jnp.zeros((3, 3), dtype=dtype)
    f = jnp.block([[i3, 0.1 * i3], [z3, i3]]).astype(dtype)
    q = (1e-3 * jnp.eye(6)).astype(dtype)
    h = jnp.concatenate([i3, z3], axis=1).astype(dtype)
    return vanilla.new(
        jnp.zeros(6, dtype), jnp.eye(6, dtype=dtype), f, None, h,
        gn.awgn(q, (0.5 * i3).astype(dtype)),
    )


def _model(n, p, with_g=False, dtype=jnp.float32):
    rng = np.random.default_rng(10 * n + p)
    f = np.eye(n) + 0.05 * np.triu(rng.standard_normal((n, n)), 1)
    h = np.eye(p, n) + 0.1 * rng.standard_normal((p, n))
    g = rng.standard_normal((n, 1)) if with_g else None
    return vanilla.new(
        jnp.zeros(n, dtype), jnp.eye(n, dtype=dtype), jnp.asarray(f, dtype),
        None if g is None else jnp.asarray(g, dtype), jnp.asarray(h, dtype),
        gn.awgn(jnp.asarray(0.01 * np.eye(n), dtype),
                jnp.asarray(0.5 * np.eye(p), dtype)),
    )


def _schedule(n, p, t, rng):
    """Time-varying padded schedule: per-step H, R and row masks."""
    hs = np.eye(p, n)[None] + 0.1 * rng.standard_normal((t, p, n))
    rs = np.stack([np.diag(rng.uniform(0.2, 1.0, p)) for _ in range(t)])
    masks = rng.uniform(size=(t, p)) > 0.3
    return (jnp.asarray(hs, jnp.float32), jnp.asarray(rs, jnp.float32),
            jnp.asarray(masks))


def _assert_results_close(got, want, rtol=1e-5):
    scale = max(float(jnp.max(jnp.abs(want.stddev))), 1.0)
    for name in FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=rtol, atol=rtol * scale, err_msg=name)


def test_kernel_lowers_and_runs_interpreted():
    """The kernel runs through the interpreter with finite outputs of
    the right shapes and consistent NEES/NIS."""
    model, state0 = _model6()
    steps = 6
    out = pallas_mc.mc_chi_square_pallas(
        model, state0, 2048, steps, jnp.int32(0), init_spread=True,
        interpret=True)
    assert out.nees_means.shape == (steps,)
    assert out.mean.shape == (steps, 6)
    assert bool(jnp.all(jnp.isfinite(out.nees_means)))
    assert bool(jnp.all(jnp.isfinite(out.stddev)))
    # 2048 runs: NEES ~ chi2(6)/2048 per step, NIS ~ chi2(3)/2048.
    assert abs(float(jnp.mean(out.nees_means)) - 6.0) < 0.5
    assert abs(float(jnp.mean(out.nis_means)) - 3.0) < 0.3


def test_kernel_shape_guards():
    model, state0 = _model6()
    for tile in (0, 96, 1000):
        with pytest.raises(ValueError, match="power of two"):
            pallas_mc.mc_chi_square_pallas(model, state0, 1000, 4,
                                           jnp.int32(0), tile=tile,
                                           interpret=True)


def test_kernel_generalizes_to_other_shapes():
    """The kernel factory builds for any (n, p), including a sample
    count that is not a multiple of the tile (masked last block)."""
    for n, p in [(2, 2), (4, 1)]:
        model, st = _model(n, p)
        out = pallas_mc.mc_chi_square_pallas(
            model, st, 1000, 5, jnp.int32(0), tile=128, interpret=True)
        ref = pallas_mc.mc_chi_square_reference(model, st, 1000, 5, 0)
        assert out.nees_means.shape == (5,)
        assert out.mean.shape == (5, n)
        _assert_results_close(out, ref)


@pytest.mark.parametrize("tv,ctrl", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("n,p", [(6, 3), (4, 2), (2, 1)])
def test_kernel_matches_jnp_replica(n, p, tv, ctrl):
    """Interpreted kernel == plain-jnp replica with identical counter
    noise, for every (n, p) and the time-varying / control variants."""
    t = 6
    rng = np.random.default_rng(n + 7 * p)
    model, st = _model(n, p, with_g=ctrl)
    kw = {}
    if tv:
        kw["hs"], kw["rs"], kw["meas_masks"] = _schedule(n, p, t, rng)
    if ctrl:
        kw["controls"] = jnp.asarray(rng.standard_normal((t, 1)), jnp.float32)
    out = pallas_mc.mc_chi_square_pallas(model, st, 300, t, jnp.int32(5),
                                         tile=128, interpret=True, **kw)
    ref = pallas_mc.mc_chi_square_reference(model, st, 300, t, 5, **kw)
    _assert_results_close(out, ref)


def test_draws_independent_of_block_size():
    """Noise is keyed by global member index, so the tile changes only
    the summation order."""
    model, st = _model6()
    a = pallas_mc.mc_chi_square_pallas(model, st, 512, 5, 9, tile=64,
                                       interpret=True)
    b = pallas_mc.mc_chi_square_pallas(model, st, 512, 5, 9, tile=256,
                                       interpret=True)
    _assert_results_close(a, b)
    z1 = pallas_mc.sample_normals_pallas(4096, 3, tile=128, interpret=True)
    z2 = pallas_mc.sample_normals_pallas(4096, 3, tile=1024, interpret=True)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))


def test_kernel_tv_controls_matches_numpy_replica():
    """TV + controls algebra against an independent float64 numpy replay
    of a jerkcar-style padded schedule, fed the kernel's own draws."""
    from gokalman_tpu.ops.ensemble import _covariance_path_tv, _masked_schedule
    from gokalman_tpu.workloads import jerkcar as jc

    t, n, p, samples = 6, 4, 2, 256
    model, st = vanilla.new(
        jnp.asarray(jc.X0, jnp.float32), jnp.asarray(jc.P0, jnp.float32),
        jnp.asarray(jc.F, jnp.float32), jnp.asarray(jc.G, jnp.float32),
        jnp.asarray(jc.H1, jnp.float32),
        gn.awgn(jnp.asarray(jc.Q, jnp.float32), jnp.asarray(jc.R, jnp.float32)),
    )
    rng = np.random.default_rng(2)
    _, us, hs, rs, masks = jc.schedule(rng.standard_normal(t),
                                       rng.standard_normal(t),
                                       rng.standard_normal(t + 1))
    us, hs, rs = (jnp.asarray(a, jnp.float32) for a in (us, hs, rs))
    masks = jnp.asarray(masks)
    out = pallas_mc.mc_chi_square_pallas(
        model, st, samples, t, 4, init_spread=False, tile=128,
        controls=us, hs=hs, rs=rs, meas_masks=masks, interpret=True)

    # --- float64 numpy replica over the same per-member draws ---
    hs_m, rs_m, lrs = _masked_schedule(model, hs, rs, masks)
    ks, s_inv, p_inv = _covariance_path_tv(model, st.p, hs_m, rs_m)
    ks, s_inv, p_inv, hs_m, lrs = (np.asarray(a, np.float64)
                                   for a in (ks, s_inv, p_inv, hs_m, lrs))
    f, g = np.asarray(jc.F), np.asarray(jc.G)
    lq = np.asarray(model.noise.sqrt_q, np.float64)
    key = pallas_mc._key(4)
    member = jnp.arange(samples, dtype=jnp.uint32)
    stride = (n + p + 1) // 2
    x_t = np.tile(np.asarray(jc.X0, np.float64)[:, None], (1, samples))
    x_e = x_t.copy()
    for k in range(t):
        wv = np.asarray(pallas_mc._draws(key, member, jnp.int32(k + 1),
                                         n + p, stride), np.float64)
        gu = (g[:, 0] * float(us[k, 0]))[:, None]
        x_t = f @ x_t + gu + lq @ wv[:n]
        x_p = f @ x_e + gu
        innov = hs_m[k] @ (x_t - x_p) + lrs[k] @ wv[n:]
        x_e = x_p + ks[k] @ innov
        err = x_t - x_e
        np.testing.assert_allclose(float(out.nees_means[k]), np.mean(
            np.sum(err * (p_inv[k] @ err), axis=0)), rtol=1e-4)
        np.testing.assert_allclose(float(out.nis_means[k]), np.mean(
            np.sum(innov * (s_inv[k] @ innov), axis=0)), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(out.mean[k]),
                                   x_t.mean(axis=1), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out.stddev[k]),
                                   x_t.std(axis=1, ddof=1), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("cov_path,rtol", [("moment", 1e-6), ("sqrt", 1e-4)])
def test_precomputed_path_matches_inline(cov_path, rtol):
    """A precomputed path (either recurrence) gives the inline result."""
    model, st = _model6()
    path = pallas_mc.precompute_path(model, st, 5, cov_path=cov_path)
    a = pallas_mc.mc_chi_square_pallas(model, st, 256, 5, 1, interpret=True)
    b = pallas_mc.mc_chi_square_pallas(model, st, 256, 5, 1, path=path,
                                       interpret=True)
    _assert_results_close(a, b, rtol=rtol)


def test_compiled_kernel_refuses_cpu():
    """Off the GPU the kernel fails loudly instead of silently running
    in interpret mode."""
    if jax.devices()[0].platform != "cpu":
        pytest.skip("checks the CPU backend")
    model, st = _model6()
    with pytest.raises(Exception, match="interpret"):
        pallas_mc.mc_chi_square_pallas(model, st, 256, 3, 0)


def test_threefry_matches_jax():
    """The in-kernel generator is the Threefry-2x32 block cipher of
    jax.random, bit for bit."""
    from jax._src import prng

    rng = np.random.default_rng(0)
    k0, k1 = (jnp.uint32(v) for v in rng.integers(0, 2**32, 2))
    x0, x1 = (jnp.asarray(rng.integers(0, 2**32, 1000), jnp.uint32)
              for _ in range(2))
    got = pallas_mc.threefry2x32(k0, k1, x0, x1)
    want = prng.threefry2x32_p.bind(k0, k1, x0, x1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_sample_normals_match_jnp_generator():
    """The sampling kernel draws exactly what the jnp generator gives
    for members 0..N-1 at slot 0."""
    count = 3000
    z = pallas_mc.sample_normals_pallas(count, 7, tile=256, interpret=True)
    member = jnp.arange((count + 1) // 2, dtype=jnp.uint32)
    key = pallas_mc._key(7)
    a, b = pallas_mc._draws(key, member, jnp.int32(0), 2, 1)
    want = np.stack([np.asarray(a), np.asarray(b)], axis=1).reshape(-1)
    np.testing.assert_array_equal(np.asarray(z), want[:count])


def _check_normal_statistics(z):
    n = z.size
    assert np.isfinite(z).all()
    se = 1.0 / np.sqrt(n)  # standard error of the mean
    assert abs(z.mean()) < 6 * se, z.mean()
    assert abs(z.std() - 1.0) < 6 * se, z.std()
    # Skewness ~ 0, excess kurtosis ~ 0 (SE ~ sqrt(6/n), sqrt(24/n)).
    zc = z - z.mean()
    skew = (zc**3).mean() / z.std() ** 3
    kurt = (zc**4).mean() / z.std() ** 4 - 3.0
    assert abs(skew) < 6 * np.sqrt(6 / n), skew
    assert abs(kurt) < 6 * np.sqrt(24 / n), kurt
    # Tail mass: P(|z|>1)=.3173, P(|z|>2)=.0455, P(|z|>3)=.0027.
    for thresh, expect in ((1.0, 0.31731), (2.0, 0.04550), (3.0, 0.00270)):
        frac = float((np.abs(z) > thresh).mean())
        tol = 6 * np.sqrt(expect * (1 - expect) / n)
        assert abs(frac - expect) < tol, (thresh, frac, expect)
    # The 24-bit uniforms must not produce duplicate spikes at 0.
    assert float((z == 0.0).mean()) < 1e-4


def test_generator_statistics_interpret():
    """Moments and tail quantiles of the generator over ~half a million
    draws, through the interpreted sampling kernel."""
    z = np.asarray(pallas_mc.sample_normals_pallas(
        524_288, jnp.int32(7), interpret=True), np.float64)
    _check_normal_statistics(z)


@pytest.mark.gpu
def test_generator_statistics_on_gpu():
    """The same statistics from the compiled kernel (libdevice
    log/sin/cos on the card)."""
    z = np.asarray(pallas_mc.sample_normals_pallas(4_194_304, jnp.int32(7)),
                   np.float64)
    _check_normal_statistics(z)


@pytest.mark.gpu
def test_kernel_statistics_on_gpu():
    """Compiled kernel vs the XLA pipeline (different noise streams, so
    within Monte-Carlo error) and vs its jnp replica (identical noise)."""
    model, state0 = _model6()
    samples, steps = 16_384, 12
    out = pallas_mc.mc_chi_square_pallas(model, state0, samples, steps,
                                         jnp.int32(3))
    ref = jax.jit(lambda k: mc_chi_square(
        model, state0, samples, steps, k, init_spread=True,
        lagged_measurements=False))(jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(out.nees_means),
                               np.asarray(ref.nees_means), rtol=0.1)
    np.testing.assert_allclose(np.asarray(out.nis_means),
                               np.asarray(ref.nis_means), rtol=0.1)
    np.testing.assert_allclose(np.asarray(out.stddev[-1]),
                               np.asarray(ref.stddev[-1]), rtol=0.05)
    rep = pallas_mc.mc_chi_square_reference(model, state0, samples, steps, 3)
    _assert_results_close(out, rep, rtol=1e-4)
