"""Quaternion attitude kinematics — the dynamics substrate for the
MEKF tier (filters/mekf.py).

A second application domain beside orbit determination (dynamics/
gravity.py): spacecraft attitude from gyros + vector observations
(star tracker / sun sensor / magnetometer).  The reference framework
has no attitude support; this follows the standard treatment (Markley &
Crassidis, *Fundamentals of Spacecraft Attitude Determination and
Control*, ch. 3 & 6).

Conventions (Markley's, the aerospace standard):
- scalar-LAST quaternions q = [q1 q2 q3, q4], unit norm;
- q represents the rotation FROM the inertial frame TO the body frame:
  b = A(q) r  with A(q) the attitude matrix (direction cosine matrix);
- composition q_total = q2 ⊗ q1 applies q1 first (⊗ is Hamilton-free
  "natural order" composition: A(q2 ⊗ q1) = A(q2) A(q1)).

Everything is pure jnp, jittable, vmappable; the discrete gyro
propagation uses the EXACT rotation-vector exponential (power-series
safe near zero via the sinc form), not an Euler step, so coarse gyro
rates don't leak norm error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import linalg


def quat_identity(dtype=None):
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_normalize(q):
    return q / jnp.linalg.norm(q)


def quat_conj(q):
    """Inverse rotation for unit quaternions."""
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], q.dtype)


def quat_compose(q2, q1):
    """Natural-order composition: A(quat_compose(q2, q1)) = A(q2) A(q1)
    (Markley eq. 2.82b — "q2 ⊗ q1", rotation q1 applied first)."""
    v2, s2 = q2[:3], q2[3]
    v1, s1 = q1[:3], q1[3]
    # Natural order flips the sign of the cross term vs Hamilton's.
    v = s2 * v1 + s1 * v2 - jnp.cross(v2, v1)
    s = s2 * s1 - v2 @ v1
    return jnp.concatenate([v, s[None]])


def cross_matrix(v):
    """[v×] such that cross_matrix(v) @ w == cross(v, w)."""
    z = jnp.zeros((), v.dtype)
    return jnp.array([
        [z, -v[2], v[1]],
        [v[2], z, -v[0]],
        [-v[1], v[0], z],
    ])


def attitude_matrix(q):
    """A(q): inertial -> body DCM (Markley eq. 2.125)."""
    v, s = q[:3], q[3]
    vx = cross_matrix(v)
    eye = jnp.eye(3, dtype=q.dtype)
    return (s**2 - v @ v) * eye + 2.0 * jnp.outer(v, v) - 2.0 * s * vx


def quat_from_rotvec(phi):
    """Exact exponential map: rotation vector (rad) -> unit quaternion.
    Series-safe at ||phi|| -> 0 via jnp.sinc (no 0/0 under jit/grad)."""
    angle = jnp.linalg.norm(phi)
    half = 0.5 * angle
    # sin(half)/angle = 0.5 * sinc(half/pi); exact at angle = 0.
    k = 0.5 * jnp.sinc(half / jnp.pi)
    return jnp.concatenate([k * phi, jnp.cos(half)[None]])


def rotvec_from_quat(q):
    """Log map: unit quaternion -> rotation vector in (-pi, pi]."""
    q = jnp.where(q[3] < 0, -q, q)  # shortest arc
    vnorm = jnp.linalg.norm(q[:3])
    angle = 2.0 * jnp.arctan2(vnorm, q[3])
    # angle/vnorm -> 2/q4 as vnorm -> 0; guard the division.
    scale = jnp.where(vnorm > 1e-12, angle / jnp.maximum(vnorm, 1e-30), 2.0 / q[3])
    return scale * q[:3]


def propagate_quat(q, omega, dt):
    """Discrete gyro propagation: body rate omega (rad/s, body frame)
    held constant over dt.  q_{k+1} = q_k ⊗ dq(omega dt) in natural
    order — the incremental body rotation composes on the BODY side:
    A(q_{k+1}) = A(dq) A(q_k), i.e. quat_compose(dq, q)."""
    dq = quat_from_rotvec(omega * dt)
    return quat_normalize(quat_compose(dq, q))


def gyro_error_phi_q(omega, dt, sigma_v, sigma_u, dtype=None):
    """Discrete error-state transition Φ and process noise Q for the
    standard 6-state attitude error model x = [δθ; δβ] driven by a
    rate-integrating gyro (Farrenkopf; Markley & Crassidis eqs.
    6.83-6.93):

        δθ̇ = -[ω×] δθ - δβ - η_v,   δβ̇ = η_u

    with angle random walk σ_v (rad/√s) and rate random walk σ_u
    (rad/s^1.5).  Φ uses the exact closed form (6.84); Q the standard
    trapezoidal discretization (6.93).
    """
    dtype = dtype or omega.dtype
    angle = jnp.linalg.norm(omega) * dt
    wx = cross_matrix(omega)
    eye = jnp.eye(3, dtype=dtype)
    w2 = jnp.maximum(omega @ omega, 1e-30)
    # Exact Φ11 = exp(-[ω×] dt): Rodrigues with sinc-safe coefficients.
    s = jnp.sinc(angle / jnp.pi) * dt  # sin(angle)/|ω|, exact at 0
    c = 0.5 * dt**2 * jnp.sinc(angle / (2 * jnp.pi)) ** 2  # (1-cos)/ω²
    phi11 = eye - wx * s + (wx @ wx) * c
    # Φ12 (Markley 6.84): -(I dt - [ω×] c + [ω×]² (dt - s)/ω²)
    phi12 = -(eye * dt - wx * c + (wx @ wx) * (dt - s) / w2)
    phi = jnp.block([[phi11, phi12], [jnp.zeros((3, 3), dtype), eye]])
    sv2, su2 = sigma_v**2, sigma_u**2
    q11 = (sv2 * dt + su2 * dt**3 / 3.0) * eye
    q12 = -(su2 * dt**2 / 2.0) * eye
    q22 = (su2 * dt) * eye
    q = jnp.block([[q11, q12], [q12, q22]])
    return phi, q


def vector_measurement(q, ref_dir):
    """Predicted body-frame observation of a known inertial unit vector
    (star/sun/field direction): b̂ = A(q) r."""
    return attitude_matrix(q) @ ref_dir


def vector_measurement_jacobian(q, ref_dir):
    """H = [ [A(q) r ×] , 0_{3x3} ] w.r.t. the error state [δθ; δβ]
    (Markley & Crassidis eq. 6.61: δb = [b̂×] δθ to first order)."""
    b = vector_measurement(q, ref_dir)
    return jnp.concatenate([cross_matrix(b), jnp.zeros((3, 3), q.dtype)],
                           axis=1)


def apply_error(q, dtheta):
    """Multiplicative error injection: q ← δq(δθ) ⊗ q (body-side, same
    side as propagate_quat's increment), renormalized."""
    return quat_normalize(quat_compose(quat_from_rotvec(dtheta), q))


def attitude_error_angle(q_est, q_true):
    """Total rotation angle (rad) between two attitudes."""
    dq = quat_compose(q_est, quat_conj(q_true))
    return jnp.linalg.norm(rotvec_from_quat(dq))


def euler_rates(inertia, omega, torque=None):
    """Euler's rigid-body equations: ω̇ = I⁻¹(τ − ω × I ω) in the body
    frame (Markley & Crassidis eq. 3.81).  `inertia` [3,3] SPD body
    inertia matrix; `torque` [3] body torque (None = torque-free).
    Cholesky solve (the inertia matrix is SPD)."""
    h = inertia @ omega
    rhs = -jnp.cross(omega, h)
    if torque is not None:
        rhs = rhs + torque
    return linalg.solve_psd(inertia, rhs)


@linalg.highp
def propagate_rigid_body(q, omega, inertia, dt, torque=None, n_sub: int = 1):
    """One rigid-body step: RK4 on the coupled (quaternion, body-rate)
    state — ω through Euler's equations, q through the exact rotation
    exponential at the RK4-averaged rate.  `n_sub` substeps refine the
    rate coupling for large dt·ω.  Torque-free motion conserves the
    INERTIAL angular momentum A(q)ᵀ I ω and the rotational kinetic
    energy ½ωᵀIω (pinned in tests) — under linalg.highp, since at a
    reduced-precision matmul default (TF32 on the GPU) those invariants
    cannot hold."""
    h = dt / n_sub

    def substep(carry, _):
        q_c, w_c = carry
        k1 = euler_rates(inertia, w_c, torque)
        k2 = euler_rates(inertia, w_c + 0.5 * h * k1, torque)
        k3 = euler_rates(inertia, w_c + 0.5 * h * k2, torque)
        k4 = euler_rates(inertia, w_c + h * k3, torque)
        w_new = w_c + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        # rotation over the substep at the trapezoidal mean rate
        q_new = propagate_quat(q_c, 0.5 * (w_c + w_new), h)
        return (q_new, w_new), None

    (q_out, w_out), _ = jax.lax.scan(substep, (q, omega), None,
                                     length=n_sub)
    return q_out, w_out
