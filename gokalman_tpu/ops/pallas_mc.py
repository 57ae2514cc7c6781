"""Fused Monte-Carlo + chi-square pipeline as one GPU kernel.

Pallas on the Triton route.  One kernel launch runs the complete
runs x steps workload of SURVEY.md §3.2, the reference's
NewMonteCarloRuns followed by NewChiSquare (montecarlo.go:92-119,
chisquare.go:16-95):

- each program owns a power-of-two block of ensemble members and keeps
  their (truth, estimate) state pair in registers for the whole T loop,
  so the carries never leave the chip; the lax.scan pipeline of
  ops.ensemble reads and writes them in device memory every step;
- Gaussian noise comes from a counter-based generator written into the
  kernel: Threefry-2x32 keyed by (seed, global member index, step,
  draw), then Box-Muller.  The draws do not depend on the block size,
  and `mc_chi_square_reference` replays the identical noise in plain
  jnp, which is what the kernel is compared with element by element;
- the per-step gains and NEES/NIS weights (run-independent, computed
  once by ops.ensemble's covariance path) are loaded as scalars that
  are uniform across the block;
- each program sums its block's per-step statistics into a
  [grid, stats_rows, T] array that XLA then reduces: deterministic, no
  atomics.

The kernel is built per (n, p, tile, tv, ctrl) by `_build` and cached,
so any state/measurement size works; `ops.ensemble.mc_chi_square`
remains the general path (lagged measurements, sharded layouts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import linalg
from ..filters import vanilla
from .ensemble import (
    ChiSquareResult,
    _covariance_path,
    _covariance_path_sqrt,
    _covariance_path_tv,
    _masked_schedule,
)

# Members per program.  One member per thread (a warp per 32 members)
# measured fastest at 98,304 x 1,000 on an H100 (PERF.md).
TILE = 32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (the block cipher behind
    jax.random's default generator) on uint32 arrays.

    Plain jnp with only add, xor and shifts, so the same function runs
    inside the kernel and outside it."""
    k2 = k0 ^ k1 ^ jnp.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << jnp.uint32(r)) | (x1 >> jnp.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def _normal_pair(bits0, bits1):
    """Two independent standard normals from two uint32 words
    (Box-Muller, both branches).  The top 24 bits of each word make the
    uniforms; u1 is centred in its bin so log(u1) is always finite."""
    u1 = ((bits0 >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32)
          + 0.5) * (2.0**-24)
    u2 = (bits1 >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * (
        2.0**-24)
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    angle = (2.0 * jnp.pi) * u2
    return r * jnp.cos(angle), r * jnp.sin(angle)


def _draws(key, member, slot, count: int, stride: int):
    """`count` standard normals per member for one step slot.

    Counter words: x0 = global member index, x1 = slot * stride + pair.
    Slot 0 is the initial spread, slot t+1 is step t."""
    out = []
    for j in range((count + 1) // 2):
        ctr = (slot * stride + j).astype(jnp.uint32)
        out += _normal_pair(*threefry2x32(key[0], key[1], member, ctr))
    return out[:count]


def _compiler_params(tile):
    """One member per thread: a warp per 32 members (up to 8 warps)."""
    return plt.CompilerParams(num_warps=max(1, min(tile // 32, 8)),
                              num_stages=1)


def _key(seed):
    """uint32 key pair from an integer seed."""
    return jnp.stack([jnp.asarray(seed).astype(jnp.uint32),
                      jnp.uint32(0x5EED)])


class _Layout:
    """Offsets of the packed per-step path row and of the fixed scalars.

    Path row: K [n,p], Pinv [n,n], Sinv [p,p], the noise-free truth c
    [n], then (tv) H [p,n] and chol R [p,p], then (ctrl) G·u [n].
    Fixed: F, Lq, H, Lr, x0, L0 (the initial-spread factor)."""

    def __init__(self, n, p, tv, ctrl):
        self.n, self.p, self.tv, self.ctrl = n, p, tv, ctrl
        self.k = 0
        self.pinv = n * p
        self.sinv = self.pinv + n * n
        self.c = self.sinv + p * p
        end = self.c + n
        self.h_row = self.lr_row = self.gu = 0
        if tv:
            self.h_row = end
            end += p * n
            self.lr_row = end
            end += p * p
        if ctrl:
            self.gu = end
            end += n
        self.row_len = end
        self.f = 0
        self.lq = n * n
        self.h = 2 * n * n
        self.lr = self.h + p * n
        self.x0 = self.lr + p * p
        self.l0 = self.x0 + n
        self.fixed_len = self.l0 + n * n
        self.stride = (n + p + 1) // 2  # Box-Muller pairs per step slot
        # NEES, NIS, Σd [n], Σd² [n] with d = x_t - c: shifting by the
        # noise-free truth keeps the sum-of-squares variance accurate
        # when the ensemble spread is small against its mean.
        self.stats_rows = 2 + 2 * n


def _init(lay, fixed, key, member):
    """Initial (truth, estimate) component lists: x0 + L0 z and x0."""
    n = lay.n
    z0 = _draws(key, member, jnp.int32(0), n, lay.stride)
    x0 = [fixed(lay.x0 + i) for i in range(n)]
    zero = jnp.zeros(member.shape, jnp.float32)
    xt = []
    for i in range(n):
        acc = zero + x0[i]
        for j in range(i + 1):  # L0 lower triangular
            acc = acc + fixed(lay.l0 + i * n + j) * z0[j]
        xt.append(acc)
    return xt, [zero + x0[i] for i in range(n)]


def _step(lay, fixed, row, key, member, t, xt, xe):
    """One consistent-measurement MC step for every member.

    `fixed(off)` / `row(off)` return the scalar at `off` of the fixed
    block / of step t's path row.  Returns the new carries and the
    per-member statistics [NEES, NIS, d..., d²...], d = x_t - c_t."""
    n, p = lay.n, lay.p
    wv = _draws(key, member, t + 1, n + p, lay.stride)
    w, v = wv[:n], wv[n:]
    if lay.tv:
        hm = lambda i, j: row(lay.h_row + i * n + j)
        lrm = lambda i, j: row(lay.lr_row + i * p + j)
    else:
        hm = lambda i, j: fixed(lay.h + i * n + j)
        lrm = lambda i, j: fixed(lay.lr + i * p + j)

    # Truth: x_t' = F x_t (+ G u) + Lq w; replay predict x_e^- = F x_e (+ G u).
    zero = jnp.zeros_like(xt[0])
    xt_new, xp = [], []
    for i in range(n):
        acc = accp = zero
        for j in range(n):
            fij = fixed(lay.f + i * n + j)
            acc = acc + fij * xt[j]
            accp = accp + fij * xe[j]
        for j in range(i + 1):  # Lq lower triangular
            acc = acc + fixed(lay.lq + i * n + j) * w[j]
        if lay.ctrl:
            gu = row(lay.gu + i)
            acc = acc + gu
            accp = accp + gu
        xt_new.append(acc)
        xp.append(accp)

    # Innovation = H (x_t' - x_e^-) + Lr v  (y generated from x_t').
    d = [xt_new[j] - xp[j] for j in range(n)]
    innov = []
    for i in range(p):
        acc = jnp.zeros_like(xt[0])
        for j in range(n):
            acc = acc + hm(i, j) * d[j]
        for j in range(i + 1):  # chol(R) lower triangular
            acc = acc + lrm(i, j) * v[j]
        innov.append(acc)

    # Update x_e' = x_e^- + K innov; err = x_t' - x_e'.
    xe_new, err = [], []
    for i in range(n):
        upd = xp[i]
        for j in range(p):
            upd = upd + row(lay.k + i * p + j) * innov[j]
        xe_new.append(upd)
        err.append(xt_new[i] - upd)

    # NEES / NIS quadratic forms (symmetric: diagonal + 2x upper).
    nees = jnp.zeros_like(xt[0])
    for i in range(n):
        nees = nees + row(lay.pinv + i * n + i) * err[i] * err[i]
        for j in range(i + 1, n):
            nees = nees + 2.0 * row(lay.pinv + i * n + j) * err[i] * err[j]
    nis = jnp.zeros_like(xt[0])
    for i in range(p):
        nis = nis + row(lay.sinv + i * p + i) * innov[i] * innov[i]
        for j in range(i + 1, p):
            nis = nis + 2.0 * row(lay.sinv + i * p + j) * innov[i] * innov[j]
    d = [xt_new[i] - row(lay.c + i) for i in range(n)]
    stats = [nees, nis] + d + [x * x for x in d]
    return xt_new, xe_new, stats


@functools.partial(jax.jit,
                   static_argnames=("steps", "tv", "ctrl", "cov_path"))
@linalg.highp
def _compute_path(model, state0, steps, controls=None, hs=None, rs=None,
                  meas_masks=None, tv=False, ctrl=False, cov_path="moment"):
    if tv:
        hs_m, rs_m, lrs = _masked_schedule(model, hs, rs, meas_masks)
        if cov_path == "sqrt":
            k_path, s_inv_path, p_inv_path = _covariance_path_sqrt(
                model, state0.p, hs=hs_m, rs=rs_m)
        else:
            k_path, s_inv_path, p_inv_path = _covariance_path_tv(
                model, state0.p, hs_m, rs_m)
    else:
        hs_m = lrs = None
        if cov_path == "sqrt":
            k_path, s_inv_path, p_inv_path = _covariance_path_sqrt(
                model, state0.p, steps=steps)
        else:
            k_path, s_inv_path, p_inv_path = _covariance_path(
                model, state0.p, steps)
    gus = controls @ model.g.T if ctrl else None  # [T,m]@[m,n]
    return (k_path, s_inv_path, p_inv_path,
            _noise_free_truth(model.f, state0.x, gus, steps), hs_m, lrs, gus)


def _noise_free_truth(f, x0, gus, steps):
    """c_t = F c_{t-1} (+ G u_t), c_{-1} = x0, for all t in O(log T)
    depth: the prefix composition of the affine maps x -> F x + G u_t
    (a sequential scan would be T tiny dependent launches)."""
    n = f.shape[0]
    a = jnp.broadcast_to(f, (steps, n, n))
    b = jnp.zeros((steps, n), f.dtype) if gus is None else gus

    def compose(earlier, later):
        a1, b1 = earlier
        a2, b2 = later
        return a2 @ a1, jnp.einsum("...ij,...j->...i", a2, b1) + b2

    a_pre, b_pre = jax.lax.associative_scan(compose, (a, b))
    return a_pre @ x0 + b_pre


def _flags(model, controls, hs, rs, meas_masks):
    tv = hs is not None or rs is not None or meas_masks is not None
    ctrl = controls is not None and model.g is not None
    return tv, ctrl


def precompute_path(model, state0, steps, controls=None, hs=None, rs=None,
                    meas_masks=None, cov_path="moment"):
    """Seed-independent per-step path for mc_chi_square_pallas: gains,
    NEES/NIS weight factors, masked schedule, control increments.

    Depends only on (model, state0, schedule), never on the seed, so
    repeated experiments (new seeds, same model) compute it once and
    pass it via `path=`; the kernel launch is then the only
    per-experiment device cost.

    `cov_path="sqrt"` switches the recurrence to the factored chol/QR
    array (ops.ensemble._covariance_path_sqrt) for cond ~1e10-class f32
    models; the kernel consumes the same per-step arrays either way."""
    tv, ctrl = _flags(model, controls, hs, rs, meas_masks)
    return _compute_path(model, state0, steps, controls, hs, rs, meas_masks,
                         tv=tv, ctrl=ctrl, cov_path=cov_path)


def _pack(model, state0, path, lay, init_spread):
    """Flatten the path into [T, row_len] rows and the fixed model
    scalars into one f32 vector."""
    k_path, s_inv_path, p_inv_path, shift, hs_m, lrs, gus = path
    t = k_path.shape[0]
    cols = [k_path.reshape(t, -1), p_inv_path.reshape(t, -1),
            s_inv_path.reshape(t, -1), shift]
    if lay.tv:
        cols += [hs_m.reshape(t, -1), lrs.reshape(t, -1)]
    if lay.ctrl:
        cols.append(gus.reshape(t, -1))
    rows = jnp.concatenate(cols, axis=1).astype(jnp.float32)
    spread_l = (linalg.chol_or_eigh_sqrt(state0.p) if init_spread
                else jnp.zeros_like(state0.p))
    fixed = jnp.concatenate([
        m.reshape(-1) for m in (model.f, model.noise.sqrt_q, model.h,
                                model.noise.sqrt_r, state0.x, spread_l)
    ]).astype(jnp.float32)
    return rows, fixed


@functools.lru_cache(maxsize=16)
def _build(n: int, p: int, tile: int, tv: bool, ctrl: bool, interpret: bool):
    """pallas_call computing per-program sums of the per-step
    statistics for a (n, p, tile, tv, ctrl) shape class."""
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    lay = _Layout(n, p, tv, ctrl)

    def kernel(rows_ref, fixed_ref, ctr_ref, samples_ref, stats_ref):
        pid = pl.program_id(0)
        steps = rows_ref.shape[0]
        local = pid * tile + jnp.arange(tile, dtype=jnp.int32)
        valid = local < samples_ref[0]
        key = (ctr_ref[0], ctr_ref[1])
        member = local.astype(jnp.uint32) + ctr_ref[2]
        fvals = [fixed_ref[i] for i in range(lay.fixed_len)]
        fixed = lambda off: fvals[off]
        xt, xe = _init(lay, fixed, key, member)

        def body(t, carry):
            xt, xe = carry
            row = lambda off: rows_ref[t, off]
            xt, xe, stats = _step(lay, fixed, row, key, member, t, xt, xe)
            for q, s in enumerate(stats):
                stats_ref[pid, q, t] = jnp.sum(jnp.where(valid, s, 0.0))
            return xt, xe

        jax.lax.fori_loop(0, steps, body, (xt, xe))

    def launch(rows, fixed, ctr, samples):
        grid = pl.cdiv(samples, tile)
        return pl.pallas_call(
            kernel,
            grid=(grid,),
            out_shape=jax.ShapeDtypeStruct(
                (grid, lay.stats_rows, rows.shape[0]), jnp.float32),
            backend="triton",
            compiler_params=_compiler_params(tile),
            interpret=interpret,
            name="mc_chi_square_fused",
        )(rows, fixed, ctr, jnp.asarray([samples], jnp.int32))

    return lay, launch


def _finish(sums, shift, samples: int) -> ChiSquareResult:
    """ChiSquareResult from the [2+2n, T] member sums and the [T, n]
    shift they were taken about."""
    n = shift.shape[1]
    mean_d = sums[2:2 + n].T / samples
    # Clamp: the sum-of-squares form can go epsilon-negative when the
    # ensemble is (near-)degenerate.
    var = jnp.maximum(sums[2 + n:].T - samples * mean_d**2, 0.0) / (
        samples - 1)
    return ChiSquareResult(sums[1] / samples, sums[0] / samples,
                           shift + mean_d, jnp.sqrt(var))


@functools.partial(
    jax.jit, static_argnames=("samples", "steps", "init_spread", "tile",
                              "tv", "ctrl", "interpret"))
def _stat_sums(model, state0, samples, steps, seed, member_offset,
               init_spread, tile, tv, ctrl, interpret,
               controls=None, hs=None, rs=None, meas_masks=None, path=None):
    """([2+2n, T] sums over members [offset, offset + samples) of
    (NEES, NIS, d, d²) per step, the [T, n] shift c of d = x_t - c)."""
    n = model.f.shape[0]
    p = model.h.shape[0]
    lay, launch = _build(n, p, tile, tv, ctrl, interpret)
    if path is None:
        path = _compute_path(model, state0, steps, controls, hs, rs,
                             meas_masks, tv=tv, ctrl=ctrl)
    rows, fixed = _pack(model, state0, path, lay, init_spread)
    key = _key(seed)
    ctr = jnp.concatenate(
        [key, jnp.asarray(member_offset).astype(jnp.uint32).reshape(1)])
    per_block = launch(rows, fixed, ctr, samples)
    return jnp.sum(per_block, axis=0), rows[:, lay.c:lay.c + n]


def mc_chi_square_pallas(
    model: vanilla.Model,
    state0: vanilla.State,
    samples: int,
    steps: int,
    seed,
    init_spread: bool = True,
    tile: int = TILE,
    controls=None,
    hs=None,
    rs=None,
    meas_masks=None,
    path=None,
    interpret: bool = False,
) -> ChiSquareResult:
    """Fused-kernel equivalent of ops.ensemble.mc_chi_square
    (lagged_measurements=False semantics) for any (n, p) model,
    including jerkcar-class time-varying padded (hs, rs, meas_masks)
    schedules and a shared control stream; both are read from the
    kernel's per-step path rows.  `seed` is an integer scalar; member i
    draws its noise from the counter stream (seed, i, step, draw).
    `tile` (a power of two) members run in each program; any `samples`
    works (the last block is masked).  `path` takes a
    precompute_path(...) result so repeated experiments skip the
    seed-independent covariance-path computation.  `interpret=True`
    runs the kernel through the Pallas interpreter (CPU tests)."""
    tv, ctrl = _flags(model, controls, hs, rs, meas_masks)
    sums, shift = _stat_sums(
        model, state0, samples, steps, seed, 0, init_spread, tile, tv, ctrl,
        interpret, controls=controls if ctrl else None, hs=hs, rs=rs,
        meas_masks=meas_masks, path=path)
    return _finish(sums, shift, samples)


@functools.partial(jax.jit, static_argnames=("samples", "steps",
                                             "init_spread"))
def mc_chi_square_reference(model, state0, samples, steps, seed,
                            init_spread=True, controls=None, hs=None,
                            rs=None, meas_masks=None, path=None):
    """The kernel's pipeline in plain jnp (a lax.scan over [S] member
    arrays) with the identical counter noise, so the kernel can be
    checked against it member for member, not only statistically."""
    tv, ctrl = _flags(model, controls, hs, rs, meas_masks)
    lay = _Layout(model.f.shape[0], model.h.shape[0], tv, ctrl)
    if path is None:
        path = _compute_path(model, state0, steps, controls, hs, rs,
                             meas_masks, tv=tv, ctrl=ctrl)
    rows, fixed_v = _pack(model, state0, path, lay, init_spread)
    fixed = lambda off: fixed_v[off]
    key = _key(seed)
    member = jnp.arange(samples, dtype=jnp.uint32)
    carry = _init(lay, fixed, key, member)

    def body(carry, xs):
        t, row_v = xs
        xt, xe, stats = _step(lay, fixed, lambda off: row_v[off], key,
                              member, t, *carry)
        return (xt, xe), jnp.stack([jnp.sum(s) for s in stats])

    _, sums = jax.lax.scan(body, carry,
                           (jnp.arange(steps, dtype=jnp.int32), rows))
    return _finish(sums.T, rows[:, lay.c:lay.c + lay.n], samples)


def sample_normals_pallas(count: int, seed, tile: int = 1024,
                          interpret: bool = False) -> jax.Array:
    """The first `count` standard normals of the kernel's generator:
    member i's initial-spread pair (slot 0) gives draws 2i and 2i+1.

    Exists so the generator's statistics are testable on their own; the
    fused pipeline's NEES/NIS gates would mask a subtly broken generator
    behind filter averaging."""
    blocks = pl.cdiv(count, 2 * tile)

    def kernel(key_ref, z0_ref, z1_ref):
        member = (pl.program_id(0) * tile
                  + jnp.arange(tile, dtype=jnp.int32)).astype(jnp.uint32)
        z0_ref[...], z1_ref[...] = _normal_pair(*threefry2x32(
            key_ref[0], key_ref[1], member, jnp.uint32(0)))

    spec = pl.BlockSpec((tile,), lambda i: (i,))
    z0, z1 = pl.pallas_call(
        kernel,
        grid=(blocks,),
        in_specs=[pl.no_block_spec],
        out_specs=[spec, spec],
        out_shape=[jax.ShapeDtypeStruct((blocks * tile,), jnp.float32)] * 2,
        backend="triton",
        compiler_params=_compiler_params(tile),
        interpret=interpret,
        name="sample_normals",
    )(_key(seed))
    return jnp.stack([z0, z1], axis=1).reshape(-1)[:count]
