"""Self-consistent OD (truth0 mode): the truth is co-propagated inside
the filter scan and measurements are generated in-scan through the same
batched integrator/station calls — the one-propagator structure of the
reference's own tests (srif_test.go:89-125): a Q=0 filter cannot
absorb any mismatch between a separately compiled truth program and
its own propagator."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gokalman_tpu import noise as gn
from gokalman_tpu import od
from gokalman_tpu.dynamics import elements, propagate, stations
from gokalman_tpu.dynamics.propagate import MeasurementSet


@functools.lru_cache(maxsize=1)
def _scenario():
    r, v = elements.oe_to_rv(7000.0, 0.001, jnp.deg2rad(30.0),
                             jnp.deg2rad(80.0), jnp.deg2rad(40.0), 0.0)
    x0_truth = jnp.concatenate([r, v])
    sts = (
        stations.new_station(-35.398333, 148.981944, 0.0, 10.0),
        stations.new_station(40.427222, -4.250556, 0.0, 10.0),
        stations.new_station(35.247164, -116.795, 0.0, 10.0),
    )
    dt, total = 10.0, 6000
    traj = propagate.propagate(x0_truth, dt, total, degree=2, with_stm=False)
    ms = propagate.generate_measurements(sts, traj)
    has = np.asarray(ms.has_meas)
    first = int(np.argmax(has))
    sl = slice(first, total)
    ms2 = MeasurementSet(ms.obs[sl], ms.htildes[sl], ms.has_meas[sl],
                         ms.station_idx[sl])
    return dict(
        sts=sts, dt=dt, ms=ms2, x0_ref=traj.states[first - 1],
        t0=float(traj.times[first - 1]), truth=np.asarray(traj.states[sl]),
        p0=jnp.diag(jnp.array([50.0, 50.0, 50.0, 1.0, 1.0, 1.0])),
        noise=gn.noiseless(jnp.zeros((3, 3)),
                           jnp.diag(jnp.array([1e-6, 1e-6]))),
    )


def test_cotruth_matches_standalone_truth_on_cpu():
    """On CPU (native f64) the co-propagated truth is bit-identical to
    the standalone propagation, so truth0 changes nothing semantically
    — it only restructures which program computes what."""
    s = _scenario()
    res = od.run_srif_od(s["x0_ref"], s["p0"], s["noise"], s["ms"], s["dt"],
                         stations_list=s["sts"], degree=2, t0=s["t0"],
                         truth0=s["x0_ref"])
    np.testing.assert_array_equal(np.asarray(res.truth), s["truth"])
    # Truth-start + noiseless + self-consistent => exactly zero error.
    assert float(np.abs(np.asarray(res.est_states) - s["truth"]).max()) == 0.0


def test_small_perturbation_converges_to_strict_gates():
    """1.7 m / 1.7 mm/s initial error: both SRIF and hybrid CKF
    converge under the reference-strict gates (srif_test.go:169) on
    the self-consistent arc."""
    s = _scenario()
    x0_small = s["x0_ref"] + jnp.array([1e-3, -1e-3, 1e-3,
                                        1e-6, -1e-6, 1e-6])
    selm = np.asarray(s["ms"].has_meas)
    for runner, kwargs in (
        (od.run_srif_od, {}),
        (od.run_hybrid_od, {}),
    ):
        res = runner(x0_small, s["p0"], s["noise"], s["ms"], s["dt"],
                     stations_list=s["sts"], degree=2, t0=s["t0"],
                     truth0=s["x0_ref"], **kwargs)
        err = np.asarray(res.est_states) - np.asarray(res.truth)
        pos = np.sqrt((err[selm, :3] ** 2).sum(1).mean())
        vel = np.sqrt((err[selm, 3:6] ** 2).sum(1).mean())
        assert pos < 1e-3 and vel < 1e-6, (runner.__name__, pos, vel)


def test_perturbed_ekf_selfconsistent():
    """0.6 km perturbed EKF with in-scan measurements recovers the
    strict-gate class on the converged tail."""
    s = _scenario()
    x0p = s["x0_ref"] + jnp.array([0.5, -0.3, 0.2, 1e-4, -5e-5, 8e-5])
    ekf_mask = jnp.cumsum(s["ms"].has_meas) > 30
    res = od.run_hybrid_od(x0p, s["p0"], s["noise"], s["ms"], s["dt"],
                           stations_list=s["sts"], degree=2, t0=s["t0"],
                           ekf_mask=ekf_mask, truth0=s["x0_ref"])
    err = np.asarray(res.est_states) - np.asarray(res.truth)
    selm = np.asarray(s["ms"].has_meas).copy()
    selm[: len(selm) // 2] = False
    pos = np.sqrt((err[selm, :3] ** 2).sum(1).mean())
    vel = np.sqrt((err[selm, 3:6] ** 2).sum(1).mean())
    assert pos < 1e-3 and vel < 1e-6, (pos, vel)


def test_truth0_incompatible_with_dmc():
    s = _scenario()
    with pytest.raises(ValueError, match="truth0"):
        od.run_hybrid_od(s["x0_ref"], s["p0"], s["noise"], s["ms"], s["dt"],
                         stations_list=s["sts"], degree=2, t0=s["t0"],
                         dmc_tau=3000.0, dmc_sigma=1e-9,
                         truth0=s["x0_ref"])
