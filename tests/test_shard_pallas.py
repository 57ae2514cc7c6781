"""Multi-device fused-kernel pipeline on the 8-device CPU mesh (the
kernel through the Pallas interpreter): device d runs members
[d·m, (d+1)·m) of one counter-keyed ensemble, so the sharded result
equals the single-device kernel on the whole ensemble."""

import jax
import jax.numpy as jnp
import numpy as np

from gokalman_tpu import noise as gn
from gokalman_tpu.filters import vanilla
from gokalman_tpu.ops import pallas_mc
from gokalman_tpu.parallel import mesh as pmesh


def test_sharded_kernel_mechanics_on_cpu_mesh():
    n, p = 4, 2
    f = jnp.eye(n, dtype=jnp.float32) + 0.01 * jnp.triu(jnp.ones((n, n), jnp.float32), 1)
    h = jnp.eye(p, n, dtype=jnp.float32)
    model, st = vanilla.new(
        jnp.zeros(n, jnp.float32), jnp.eye(n, dtype=jnp.float32), f, None, h,
        gn.awgn(1e-3 * jnp.eye(n, dtype=jnp.float32), 0.5 * jnp.eye(p, dtype=jnp.float32)),
    )
    mesh = pmesh.ensemble_mesh()
    assert mesh.devices.size == 8
    out = pmesh.sharded_mc_chi_square_pallas(
        model, st, samples_per_device=128, steps=4, seed=0,
        mesh=mesh, init_spread=True, interpret=True,
    )
    assert out.nees_means.shape == (4,)
    assert out.mean.shape == (4, n)
    assert bool(jnp.all(jnp.isfinite(out.nees_means)))
    assert bool(jnp.all(jnp.isfinite(out.stddev)))
    one = pallas_mc.mc_chi_square_pallas(model, st, 128 * 8, 4, 0,
                                         init_spread=True, interpret=True)
    for name in ("nees_means", "nis_means", "mean", "stddev"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(one, name)),
            rtol=1e-5, atol=1e-6, err_msg=name)


def test_pool_ensemble_stats_matches_global_stddev():
    """pool_ensemble_stats must reproduce the single-chip ddof=1 stddev
    of the concatenated ensemble (pmean of per-shard stddevs is biased
    low and would make multi-chip results disagree with one chip)."""
    import numpy as np
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(5)
    ndev, m, t = 8, 64, 5
    data = rng.standard_normal((ndev * m, t)) * rng.uniform(0.5, 3.0, t)
    mesh = pmesh.ensemble_mesh()

    def local(x):  # x: [m, t] shard
        mean_l = jnp.mean(x, axis=0)
        std_l = jnp.std(x, axis=0, ddof=1)
        return pmesh.pool_ensemble_stats(mean_l, std_l, m, pmesh.ENSEMBLE_AXIS)

    mean, std = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(pmesh.ENSEMBLE_AXIS), out_specs=P(),
        check_vma=False,
    ))(jnp.asarray(data))
    np.testing.assert_allclose(np.asarray(mean), data.mean(axis=0), atol=1e-12)
    np.testing.assert_allclose(np.asarray(std), data.std(axis=0, ddof=1),
                               atol=1e-12)
