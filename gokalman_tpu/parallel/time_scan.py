"""Parallel-in-time filtering/smoothing SHARDED OVER THE TIME AXIS.

Every other sharded pipeline in this package is embarrassingly
parallel (ensemble members, particles, scenes, sensors).  The serial
recurrence x_{k+1} = f(x_k) itself (vanilla.go:139; SURVEY.md §5 names
parallel-in-time the stretch goal) is distributed here: the
associative-scan formulation of the Kalman filter/RTS smoother
(ops/assoc_scan.py, Särkkä & García-Fernández 2021) makes the time
axis a SCAN over an associative monoid, and a scan over a monoid
distributes by the classic three-phase block decomposition:

  1. each device runs a LOCAL `lax.associative_scan` over its
     contiguous block of T/D scan elements (O(T/D log T/D) depth,
     zero communication);
  2. the D block aggregates (one element each — a few n x n matrices)
     are `all_gather`-ed over the mesh axis and prefix-combined; the
     collective moves O(D n^2) bytes TOTAL, independent of T;
  3. each device folds its exclusive block prefix (the combination of
     all earlier blocks) into its local results with one vmapped
     combine.

Total FLOPs ~2x the single-device scan (the standard distributed-scan
overhead); wall-clock scales as T/D for T >> D n^2.  The smoother pass
mirrors the scheme in reverse (block SUFFIXES instead of prefixes).

Both passes are pinned bit-level against the single-device
filter_parallel/smooth_parallel on the virtual 8-CPU mesh
(tests/test_time_scan.py) and certified by dryrun_multichip pipeline
#9 (__graft_entry__.py).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import linalg
from ..filters import vanilla
from ..ops import assoc_scan

TIME_AXIS = "time"


def _dist_scan(comb, elems, identity, axis: str, reverse: bool):
    """Distributed associative scan of the per-device block `elems`
    ([T_local, ...] leaves) living inside a shard_map over `axis`.
    Forward: each result element is combined with the exclusive prefix
    of earlier blocks; reverse: with the exclusive suffix of later
    blocks."""
    local = jax.lax.associative_scan(comb, elems, reverse=reverse)
    # Block aggregate: the element covering the whole local block.
    agg = jax.tree.map(lambda x: x[0] if reverse else x[-1], local)
    aggs = jax.lax.all_gather(agg, axis)  # [D, ...] — O(D n^2) bytes
    scanned = jax.lax.associative_scan(comb, aggs, reverse=reverse)
    idx = jax.lax.axis_index(axis)
    d = jax.tree.leaves(aggs)[0].shape[0]
    if reverse:
        # Suffix for block i = combination of blocks i+1..D-1.
        sel = jnp.minimum(idx + 1, d - 1)
        boundary = idx == d - 1
    else:
        sel = jnp.maximum(idx - 1, 0)
        boundary = idx == 0
    fix = jax.tree.map(
        lambda s, i: jnp.where(boundary, i, s[sel]), scanned, identity
    )
    return jax.vmap(lambda e: comb(fix, e))(local)


@partial(jax.jit, static_argnames=("mesh", "axis", "smooth"))
@linalg.highp
def sharded_filter_smoother(
    model: vanilla.Model,
    state0: vanilla.State,
    measurements: jax.Array,
    mesh: Mesh,
    controls: Optional[jax.Array] = None,
    axis: str = TIME_AXIS,
    smooth: bool = True,
):
    """Filter (and optionally RTS-smooth) a single long sequence with
    the TIME axis block-sharded over `mesh`'s `axis`.

    Returns (means, covs, sm_means, sm_covs) — the same posteriors as
    `assoc_scan.filter_parallel` + `smooth_parallel` on one device
    (sm_* are None when smooth=False).  T must be divisible by the
    mesh axis size.  Element construction is vectorized over T and
    left to GSPMD (it is embarrassingly parallel); only the scans run
    under shard_map with the explicit collective.
    """
    t = measurements.shape[0]
    d = mesh.shape[axis]
    if t % d != 0:
        raise ValueError(f"T={t} must be divisible by mesh axis {d}")
    n = model.f.shape[0]
    dtype = model.f.dtype

    elems = assoc_scan.filter_elements(model, state0, measurements,
                                       controls)
    elems = jax.lax.with_sharding_constraint(
        elems, NamedSharding(mesh, P(axis))
    )

    f_ident = assoc_scan.identity_elem(n, dtype)

    @partial(
        jax.shard_map, mesh=mesh, in_specs=P(axis),
        out_specs=(P(axis), P(axis)),
    )
    def fwd(elems_local):
        out = _dist_scan(assoc_scan._combine, elems_local, f_ident,
                         axis, reverse=False)
        return out.b, out.c

    means, covs = fwd(elems)
    if not smooth:
        return means, covs, None, None

    selems = assoc_scan.smoother_elements(model, means, covs)
    selems = jax.lax.with_sharding_constraint(
        selems, NamedSharding(mesh, P(axis))
    )
    s_ident = assoc_scan.sidentity_elem(n, dtype)

    @partial(
        jax.shard_map, mesh=mesh, in_specs=P(axis),
        out_specs=(P(axis), P(axis)),
    )
    def bwd(selems_local):
        out = _dist_scan(assoc_scan._scomb, selems_local, s_ident,
                         axis, reverse=True)
        return out.g, out.l

    sm_means, sm_covs = bwd(selems)
    return means, covs, sm_means, sm_covs


def time_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices with the 'time' axis."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (TIME_AXIS,))
