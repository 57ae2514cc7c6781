"""Ensemble sharding over a device mesh.

The reference scales only by running more independent sequences in a
Go loop (montecarlo.go:108-117) with channel-based CSV streaming as its
sole concurrency (README.md:11).  The equivalent here is a 1-D
`ensemble` mesh axis: Monte-Carlo runs are sharded across devices with
`jax.sharding`, the per-step ensemble reductions (mean/stddev/NEES/NIS)
lower to all-reduces that XLA hands to the collective library, and the
time axis stays a local lax.scan on every device (the recurrence is
inherently serial — SURVEY.md §5 'long-context' note).

No TP/PP/SP/EP axes exist because the model state is a 6-vector: there
is nothing to shard but the embarrassingly parallel run axis.  This is
the domain's entire communication layer (SURVEY.md §2.9/§5.8).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


ENSEMBLE_AXIS = "ensemble"


def ensemble_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (ENSEMBLE_AXIS,))


def ensemble_sharding(mesh: Mesh, batch_axis: int = -1, ndim: int = 2) -> NamedSharding:
    """NamedSharding placing the ensemble axis across the 1-D mesh.

    Default matches the ops.ensemble [n, S] layout (S = last axis).
    """
    spec = [None] * ndim
    spec[batch_axis] = mesh.axis_names[0]
    return NamedSharding(mesh, P(*spec))


def pool_ensemble_stats(mean_local, std_local, shard_samples: int, axis_name):
    """Pool per-shard ensemble (mean, stddev[ddof=1]) into the global
    (mean, stddev[ddof=1]) over a named mesh axis.

    The pooled variance is recovered from each shard's second moment
    ((m-1)·s² + m·x̄²); taking pmean of per-shard stddevs instead would
    systematically under-estimate the ensemble spread (Jensen: sqrt is
    concave), so multi-device results would not match a single-device run
    on the same total ensemble.
    """
    ndev = jax.lax.psum(1, axis_name)
    m = shard_samples
    mean = jax.lax.pmean(mean_local, axis_name)
    ssq = jax.lax.psum((m - 1) * std_local**2 + m * mean_local**2, axis_name)
    total = m * ndev
    var = (ssq - total * mean**2) / (total - 1)
    return mean, jnp.sqrt(jnp.maximum(var, 0.0))


def sharded_mc_chi_square_pallas(
    model,
    state0,
    samples_per_device: int,
    steps: int,
    seed: int,
    mesh: Optional[Mesh] = None,
    init_spread: bool = True,
    tile: int | None = None,
    interpret: bool = False,
):
    """Multi-device fused-kernel pipeline: device d runs the kernel on
    members [d·m, (d+1)·m) of one counter-keyed ensemble (m =
    samples_per_device), and the per-step statistic sums are combined
    with one psum.  The result is the single-device
    mc_chi_square_pallas(samples = m·devices) up to summation order.
    """
    from ..ops import pallas_mc

    mesh = ensemble_mesh() if mesh is None else mesh
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    tile = pallas_mc.TILE if tile is None else tile

    def local():
        offset = jax.lax.axis_index(axis) * samples_per_device
        sums, shift = pallas_mc._stat_sums(
            model, state0, samples_per_device, steps, seed, offset,
            init_spread, tile, False, False, interpret)
        return pallas_mc._finish(jax.lax.psum(sums, axis), shift,
                                 samples_per_device * ndev)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(), out_specs=P(),
                       check_vma=False)
    return jax.jit(fn)()


def sharded_mc_chi_square(
    model,
    state0,
    samples: int,
    steps: int,
    key,
    mesh: Optional[Mesh] = None,
    controls=None,
    init_spread: bool = False,
    lagged_measurements: bool = True,
    hs=None,
    rs=None,
    meas_masks=None,
):
    """mc_chi_square with the run axis sharded across `mesh`.

    Each device owns samples/n_devices runs; the per-step NEES/NIS/mean
    reductions become psum-style collectives inserted by XLA (GSPMD).
    Requires samples % n_devices == 0.
    """
    from ..ops.ensemble import mc_chi_square

    mesh = ensemble_mesh() if mesh is None else mesh
    ndev = mesh.devices.size
    if samples % ndev:
        raise ValueError(f"samples ({samples}) must divide the mesh size ({ndev})")
    sharding = ensemble_sharding(mesh)

    fn = jax.jit(
        lambda k, u: mc_chi_square(
            model,
            state0,
            samples,
            steps,
            k,
            controls=u,
            ensemble_sharding=sharding,
            init_spread=init_spread,
            lagged_measurements=lagged_measurements,
            hs=hs,
            rs=rs,
            meas_masks=meas_masks,
        )
    )
    return fn(key, controls)


def sharded_enkf_run(noise, x0, p0, n_ens: int, measurements, fx, hx, key,
                     mesh: Mesh, controls=None, inflation: float = 1.0,
                     meas_masks=None, loc_xy=None, loc_yy=None):
    """Stochastic EnKF with the member axis sharded over the mesh.

    The whole filter runs inside one shard_map: members stay resident
    on their device for the entire scan; each analysis step all-reduces
    only the tiny moment blocks (x-mean [n], y-moments [p]/[p,p],
    cross-covariance [n,p], perturbation mean [p], posterior moment
    sums [n,n]) over the mesh.  Noise is keyed per GLOBAL member index
    (filters.enkf._member_normals), so the result equals the unsharded
    filters.enkf.run bit-for-bit (tests/test_shard_enkf.py).

    The deterministic ETKF variant is intentionally NOT sharded: its
    [N, N] ensemble-space transform mixes all members densely, which is
    the wrong tool once the ensemble needs more than one device — use the
    stochastic form (or keep ETKF single-device).
    """
    from functools import partial

    from ..filters import enkf

    axis_names = mesh.axis_names
    if len(axis_names) != 1:
        raise ValueError("sharded_enkf_run expects a 1-D ensemble mesh")
    axis = axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    if n_ens % n_dev:
        raise ValueError(f"n_ens {n_ens} not divisible by {n_dev} devices")
    local_n = n_ens // n_dev

    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    chol0 = jnp.linalg.cholesky(p0)
    t = measurements.shape[0]
    # Key layout mirrors the unsharded path exactly:
    #   k_init, k_run = split(key);  step keys = split(k_run, T)
    # == enkf.new(..., key=k_init) + enkf.run(..., key=k_run).
    init_key, run_key = jax.random.split(key)
    step_keys = jax.random.split(run_key, t)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(axis), P()),
    )
    def run_local(meas, ctrls, masks, skeys):
        # Global member ids for this shard.
        offset = jax.lax.axis_index(axis) * local_n
        z = enkf._member_normals(init_key, local_n, x0.shape[0], x0.dtype,
                                 offset)
        ens = x0[None, :] + z @ chol0.T
        state = enkf.State(ens, jnp.int32(0))

        def body(carry, xs):
            m, u, has, k = xs
            return enkf.step(noise, carry, m, fx, hx, k, u, inflation, has,
                             loc_xy, loc_yy, member_offset=offset,
                             n_total=n_ens, axis_name=axis)

        state, ests = jax.lax.scan(body, state, (meas, ctrls, masks, skeys))
        return state.ensemble, ests

    ensemble, ests = run_local(measurements, controls, meas_masks, step_keys)
    return ensemble, ests


def sharded_particle_run(x0, p0, n_particles: int, measurements, propagate,
                         loglik, key, mesh: Mesh, controls=None,
                         meas_masks=None, resample_threshold: float = 0.5,
                         resampling: str = "gather"):
    """Bootstrap particle filter with the particle axis sharded over the
    mesh.

    Propagation and likelihood evaluation — the expensive parts for
    nontrivial dynamics — stay device-local; normalization, moments,
    and ESS are tiny collectives.  Noise is keyed per GLOBAL particle
    index; the key layout mirrors `new(key=k_init)` + `run(key=k_run)`
    with (k_init, k_run) = split(key).

    `resampling` picks the distributed resampling scheme:

    - "gather" (default): all-gather the (weights, particles) arrays —
      small at filter-state scale — so every device computes the
      identical systematic-ancestor vector and keeps its slice.  The
      result equals the unsharded filters.particle run BIT-FOR-BIT
      (tests/test_shard_particle.py), but each device materializes the
      full N-particle cloud during resampling, capping N at
      single-device memory.
    - "local": RNA / island resampling (Bolic, Djuric & Hong 2005) —
      per-shard systematic resampling with the island weight retained,
      plus a ring half-exchange of particles (weights attached, an
      exactly-unbiased permutation).  Per-shard memory stays
      O(N_local) and nothing N-sized ever moves: the scalable scheme
      for clouds beyond one device's memory.  Statistically — not
      bit — equal to the unsharded filter
      (tests/test_shard_particle_local.py pins evidence, posterior
      moments, and island-weight health).
    """
    from functools import partial

    from ..filters import particle

    if resampling not in ("gather", "local"):
        raise ValueError(f"unknown resampling scheme {resampling!r}")
    axis_names = mesh.axis_names
    if len(axis_names) != 1:
        raise ValueError("sharded_particle_run expects a 1-D ensemble mesh")
    axis = axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    if n_particles % n_dev:
        raise ValueError(
            f"n_particles {n_particles} not divisible by {n_dev} devices"
        )
    local_n = n_particles // n_dev

    x0 = jnp.asarray(x0)
    p0 = jnp.asarray(p0)
    t = measurements.shape[0]
    init_key, run_key = jax.random.split(key)
    step_keys = jax.random.split(run_key, t)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(axis), P()),
    )
    def run_local(meas, ctrls, masks, skeys):
        offset = jax.lax.axis_index(axis) * local_n
        state = particle.new(x0, p0, local_n, init_key,
                             member_offset=offset, n_total=n_particles)
        # The initial weights/counter are computed identically on every
        # device (invariant); mark them device-varying so the scan
        # carry's manual-axes tracking matches the (genuinely varying)
        # outputs.  The particles leaf is already varying (axis_index).
        state = state._replace(
            log_weights=jax.lax.pcast(state.log_weights, (axis,),
                                      to="varying"),
            k=jax.lax.pcast(state.k, (axis,), to="varying"),
        )

        def body(carry, xs):
            m, u, has, k = xs
            return particle.step(
                carry, m, propagate, loglik, k, control=u,
                resample_threshold=resample_threshold, has=has,
                member_offset=offset, n_total=n_particles, axis_name=axis,
                local_resampling=(resampling == "local"), n_shards=n_dev,
            )

        state, ests = jax.lax.scan(body, state, (meas, ctrls, masks, skeys))
        return state.particles, ests

    particles, ests = run_local(measurements, controls, meas_masks, step_keys)
    return particles, ests


def sharded_sensor_fusion_run(x0, p0, f, q, hs, rs, measurements,
                              mesh: Mesh, meas_masks=None, g=None,
                              controls=None):
    """Distributed multi-SENSOR Kalman filtering: the sensor axis
    sharded over the mesh, fused in information form.

    The information-filter identity makes measurement fusion an
    ALL-REDUCE: with independent sensors, the posterior information is

        Lambda_post = Lambda_pred + sum_s H_s' R_s^-1 H_s,
        i_post      = Lambda_pred x_pred + sum_s H_s' R_s^-1 y_s,

    so each device computes only its local sensors' [n, n] + [n]
    contributions and one psum per step fuses them over the mesh — the
    measurement data (S sensor streams) never leaves its device.  The
    result equals the CENTRAL KF on the stacked measurement vector
    digit-for-digit (tests/test_shard_fusion.py), because it IS the
    same algebra; this is the data-parallel shape of decentralized
    estimation (cf. the exporter-of-information architecture the
    information filter exists for, information.go:1).

    `hs` [S, p, n] / `rs` [S, p, p] per-sensor models, `measurements`
    [S, T, p] per-sensor streams (sharded on the sensor axis),
    `meas_masks` [S, T] optional per-sensor dropout (a masked sensor
    contributes nothing that step — sensors dropping out mid-run is
    the operating mode of a real network).  The [n, n] state recursion
    itself is replicated on every device (it is tiny next to the
    per-sensor work at scale).

    Returns (states [T, n], covariances [T, n, n]) — replicated.
    """
    from functools import partial

    from .. import linalg

    axis_names = mesh.axis_names
    if len(axis_names) != 1:
        raise ValueError("sharded_sensor_fusion_run expects a 1-D mesh")
    axis = axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    hs, rs = jnp.asarray(hs), jnp.asarray(rs)
    measurements = jnp.asarray(measurements)
    n_sensors = hs.shape[0]
    if n_sensors % n_dev:
        raise ValueError(
            f"{n_sensors} sensors not divisible by {n_dev} devices")
    x0, p0 = jnp.asarray(x0), jnp.asarray(p0)
    f = jnp.asarray(f)
    q = jnp.asarray(q)
    if meas_masks is None:
        meas_masks = jnp.ones(measurements.shape[:2], bool)
    # vanilla.predict convention: a model G with no controls supplied
    # means the control term is absent (not a fabricated zero vector,
    # whose [T, 1] placeholder shape would crash a multi-column G)
    g_ = None if (g is None or controls is None) else jnp.asarray(g)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
    )
    @linalg.highp
    def run_local(hs_l, rs_l, ys_l, masks_l, ctrls):
        # per-sensor information geometry, computed once (local)
        rinv_h = jax.vmap(lambda r_, h_: linalg.solve_psd(r_, h_))(
            rs_l, hs_l)  # [S_l, p, n] = R^-1 H
        u_l = jnp.einsum("spn,spm->snm", hs_l, rinv_h)  # per-sensor H'R^-1H

        def body(carry, xs):
            x, p = carry
            ys_k, m_k, ctrl_k = xs  # [S_l, p], [S_l], [m]
            x_pred = f @ x
            if g_ is not None:
                x_pred = x_pred + g_ @ ctrl_k
            p_pred = linalg.sym(f @ p @ f.T + q)
            mf = m_k.astype(x.dtype)
            lam_c = jax.lax.psum(
                jnp.einsum("s,snm->nm", mf, u_l), axis)
            i_c = jax.lax.psum(
                jnp.einsum("s,spn,sp->n", mf, rinv_h,
                           jnp.where(m_k[:, None], ys_k, 0.0)), axis)
            lam_pred = linalg.inv_psd(p_pred)
            p_post = linalg.inv_psd(linalg.sym(lam_pred + lam_c))
            x_post = p_post @ (lam_pred @ x_pred + i_c)
            return (x_post, p_post), (x_post, p_post)

        xs_in = (jnp.swapaxes(ys_l, 0, 1), jnp.swapaxes(masks_l, 0, 1),
                 ctrls)
        (_, _), (states, covs) = jax.lax.scan(
            body, (x0, p0), xs_in)
        return states, covs

    ctrls_in = (jnp.zeros((measurements.shape[1], 1), x0.dtype)
                if controls is None else jnp.asarray(controls))
    return run_local(hs, rs, measurements, jnp.asarray(meas_masks, bool),
                     ctrls_in)
