"""BRDF evaluation/sampling as pure vectorized functions.

JAX counterpart of the reference BRDF hierarchy (reference:
BRDF.h:22-113).  Virtual dispatch becomes lane masking: every lane computes
the (cheap) Phong model; Lambert is Phong with Ks=0.  Measured BRDFs
(MERL/Titopo) are separate gather-based modules.

All functions take explicit uniforms (detached-sampling friendly) and are
differentiable in the material parameters (kd, ks, ne).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import vec, sampling

M_PI = np.float32(np.pi)
M_TWO_PI = np.float32(2.0 * np.pi)


def phong_eval(kd, ks, ne, wi, wo, n):
    """Phong BRDF value (reference: BRDF.h:88-96).

    reflechi = reflect(-wo, n); d = dot(reflechi, wi);
    d < 0  ->  kd/pi;  else kd/pi + ks * d^ne * (ne+2)/(2*pi)  (per channel).

    Differentiable in (kd, ks, ne): the pow base is masked to 1 on the
    d<=0 branch BEFORE the power — otherwise the cotangent of pow(0, ne)
    is NaN and poisons the whole gradient through the where (the classic
    JAX where-grad trap).
    """
    refl = vec.reflect(-wo, n)
    d = vec.dot(refl, wi)
    front = d > 0.0
    d_safe = jnp.where(front, d, 1.0)
    lobe = jnp.power(d_safe[..., None], ne) * (ne + 2.0) / M_TWO_PI
    diffuse = kd / M_PI
    return jnp.where(front[..., None], diffuse + lobe * ks, diffuse)


def phong_sample(kd, ks, ne, wo, n, u_choice, r1, r2):
    """MIS Kd-vs-Ks Phong sampling (reference: BRDF.h:63-86).

    p = 1 - mean(ks); with prob p sample cosine around n, else Phong lobe
    around the mirror direction; the returned pdf is the mixture pdf.

    Args:
      u_choice: uniform for the diffuse-vs-specular choice (engine draw in the
        reference, BRDF.h:73).
      r1, r2: the 2D sample (lattice/CP or engine).
    Returns:
      (direction (N,3), pdf (N,), sampled_diffuse (N,) bool)
    """
    avg_ne = jnp.mean(ne, axis=-1)
    p = 1.0 - jnp.mean(ks, axis=-1)
    r_mirror = vec.reflect(-wo, n)
    diffuse_dir = sampling.random_cos(n, r1, r2)
    phong_dir = sampling.random_phong(r_mirror, avg_ne, r1, r2)
    sampled_diffuse = u_choice < p
    d = jnp.where(sampled_diffuse[..., None], diffuse_dir, phong_dir)

    proba_phong = ((avg_ne + 1.0) / M_TWO_PI
                   * jnp.power(jnp.maximum(vec.dot(r_mirror, d), 0.0), avg_ne))
    pdf = p * vec.dot(n, d) / M_PI + (1.0 - p) * proba_phong
    return d, pdf, sampled_diffuse


def lambert_eval(kd):
    """Lambert BRDF value kd/pi (reference: BRDF.h:109-111)."""
    return kd / M_PI


def lambert_sample(n, r1, r2):
    """Cosine sampling with pdf = cos/pi (reference: BRDF.h:103-108)."""
    d = sampling.random_cos(n, r1, r2)
    pdf = vec.dot(n, d) / M_PI
    return d, pdf
