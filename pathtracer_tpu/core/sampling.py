"""Directional sampling — pure functions of explicit uniforms.

JAX counterparts of the reference's sampling free functions
(reference: Vector.h:582-655, BRDF.h:41-61).  Unlike the reference, none of
these draw randomness themselves: uniforms always arrive as arguments so the
caller controls the per-lane PCG stream and the functions stay pure/traceable
and trivially differentiable (directions are typically stop-gradient'd by the
integrator — detached sampling).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import vec

TWO_PI = 6.283185307179586


def random_cos(n, r1, r2):
    """Cosine-weighted hemisphere direction around n (reference: Vector.h:582-589).

    local = (cos(2πr1)·sqrt(1-r2), sin(2πr1)·sqrt(1-r2), sqrt(r2)) in the
    (t1, t2, n) frame with t1 = get_tangent(n), t2 = cross(t1, n).
    """
    sr2 = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    lx = jnp.cos(TWO_PI * r1) * sr2
    ly = jnp.sin(TWO_PI * r1) * sr2
    lz = jnp.sqrt(jnp.maximum(r2, 0.0))
    t1, t2 = vec.onb(n)
    return lz[..., None] * n + lx[..., None] * t1 + ly[..., None] * t2


def random_uniform_sphere(r1, r2):
    """Uniform direction on the unit sphere (reference: Vector.h:604-615)."""
    s = jnp.sqrt(jnp.maximum(r2 * (1.0 - r2), 0.0))
    return jnp.stack(
        [
            2.0 * jnp.cos(TWO_PI * r1) * s,
            2.0 * jnp.sin(TWO_PI * r1) * s,
            1.0 - 2.0 * r2,
        ],
        axis=-1,
    )


def random_uniform_hemisphere(n, r1, r2):
    """Uniform hemisphere around n (reference: Vector.h:617-630)."""
    s = jnp.sqrt(jnp.maximum(1.0 - r2 * r2, 0.0))
    lx = jnp.cos(TWO_PI * r1) * s
    ly = jnp.sin(TWO_PI * r1) * s
    lz = r2
    t1, t2 = vec.onb(n)
    return lz[..., None] * n + lx[..., None] * t1 + ly[..., None] * t2


def box_muller(r1, r2):
    """2D Gaussian + radius in third lane (reference: Vector.h:646-655)."""
    s1 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(r1, 1e-38)))
    s2 = TWO_PI * r2
    return jnp.stack([s1 * jnp.cos(s2), s1 * jnp.sin(s2), s1], axis=-1)


def random_phong(r_dir, phong_exponent, r1, r2):
    """Phong-lobe direction around the mirror direction r_dir
    (reference: BRDF.h:41-61).

    local z = r2^(1/(e+1)), radius = sqrt(1 - r2^(2/(e+1))), frame built the
    same axis-aligned-tangent way as random_cos but around R.
    """
    e = phong_exponent
    z = jnp.power(jnp.maximum(r2, 1e-38), 1.0 / (e + 1.0))
    fac = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    lx = jnp.cos(TWO_PI * r1) * fac
    ly = jnp.sin(TWO_PI * r1) * fac
    t1, t2 = vec.onb(r_dir)
    return z[..., None] * r_dir + lx[..., None] * t1 + ly[..., None] * t2
