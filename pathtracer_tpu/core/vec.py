"""float3 math on (..., 3) arrays — the JAX Vector (reference: Vector.h).

Everything operates on trailing-dimension-3 float arrays so that rays, normals
and colors batch over arbitrary leading wavefront dimensions and XLA fuses the
arithmetic into the surrounding kernels.
"""

from __future__ import annotations

import jax.numpy as jnp


def any_true(x, axis=None):
    """jnp.any as an int32 max.  XLA's GPU compiler routes boolean (pred)
    reductions to its Triton block-level emitter, where one over the
    wavefront compiled for more than 7 minutes on an H100; an integer
    reduction compiles at once."""
    return jnp.max(x.astype(jnp.int32), axis=axis, initial=0) > 0


def dot(a, b):
    """Batched 3-vector dot product -> (...,) (reference: Vector.h dot)."""
    return jnp.sum(a * b, axis=-1)


def dot3(a, b):
    """Dot product keeping the trailing dim: (..., 1)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    """Batched cross product (reference: Vector.h:561-564)."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def norm2(a):
    return jnp.sum(a * a, axis=-1)


def norm(a):
    return jnp.sqrt(norm2(a))


def normalize(a, eps=1e-20):
    """Safe normalize; zero vectors stay finite (never NaN under grad).

    Uses exact sqrt+divide, NOT lax.rsqrt: XLA lowers rsqrt to a low-precision
    vectorized approximation on some backends/batch shapes, and the ~1e-4
    direction error amplifies through the sphere quadric into visible
    visibility-branch flips vs the exact CPU reference.
    """
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    return a / jnp.sqrt(jnp.maximum(n2, eps))


def reflect(d, n):
    """Reflect incoming direction d about normal n (reference: Vector.h reflect):
    r = d - 2*dot(d, n)*n, for d pointing toward the surface."""
    return d - 2.0 * dot3(d, n) * n


def get_tangent(n):
    """Branch-free version of the reference's axis-aligned tangent pick
    (reference: Vector.h:566-579): zero the smallest-|component| axis and swap
    the other two with one negation, then normalize."""
    an = jnp.abs(n)
    ax, ay, az = an[..., 0], an[..., 1], an[..., 2]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    # case x smallest: (0, -z, y); elif y smallest: (-z, 0, x); else (-y, x, 0)
    x_min = (ax <= ay) & (ax <= az)
    y_min = (~x_min) & (ay <= ax) & (ay <= az)
    tx = jnp.where(x_min, 0.0, jnp.where(y_min, -nz, -ny))
    ty = jnp.where(x_min, -nz, jnp.where(y_min, 0.0, nx))
    tz = jnp.where(x_min, ny, jnp.where(y_min, nx, 0.0))
    return normalize(jnp.stack([tx, ty, tz], axis=-1))


def onb(n):
    """Orthonormal basis (t1, t2) around n matching the reference frame
    convention used by random_cos (reference: Vector.h:586-588):
    t1 = get_tangent(n), t2 = cross(t1, n)."""
    t1 = get_tangent(n)
    t2 = cross(t1, n)
    return t1, t2
