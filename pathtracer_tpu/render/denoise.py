"""Denoiser hook: auxiliary-guided a-trous wavelet filtering.

The reference post-filters offline renders with Intel Open Image Denoise
fed by color+albedo+normal buffers (reference: Raytracer.cpp:1721-1746; the
aux buffers accumulate UNSPLATTED, :1631-1645, because OIDN cannot handle
splatting).  This slot keeps the same interface — denoise(color,
albedo, normal) — with an edge-avoiding a-trous wavelet filter (Dammertz et
al. 2010 family) implemented as pure stencil convolutions: ideal VPU work,
and the hook is swappable for a learned model later.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# 5-tap B3-spline kernel
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _shift2d(img, di, dj):
    """Shift with edge clamping (replicate borders)."""
    h, w = img.shape[0], img.shape[1]
    i = jnp.clip(jnp.arange(h) + di, 0, h - 1)
    j = jnp.clip(jnp.arange(w) + dj, 0, w - 1)
    return img[i][:, j]


def atrous_denoise(color, albedo, normal, iterations: int = 4,
                   sigma_color: float = 1.0, sigma_normal: float = 0.25,
                   sigma_albedo: float = 0.1):
    """Edge-avoiding a-trous filtering of an HDR color buffer.

    Args:
      color: (H,W,3) HDR radiance (divided by sample count).
      albedo, normal: (H,W,3) primary-hit auxiliaries.
      iterations: a-trous levels (stride doubles per level).
    Returns:
      (H,W,3) filtered color.
    """
    color = jnp.asarray(color, jnp.float32)
    albedo = jnp.asarray(albedo, jnp.float32)
    normal = jnp.asarray(normal, jnp.float32)
    # luminance scale adapts the color sigma to HDR magnitudes
    lum_scale = jnp.maximum(jnp.mean(jnp.abs(color)), 1e-6)

    out = color
    for level in range(iterations):
        stride = 1 << level
        acc = jnp.zeros_like(out)
        wacc = jnp.zeros_like(out[..., :1])
        for ki in range(-2, 3):
            for kj in range(-2, 3):
                k = _B3[ki + 2] * _B3[kj + 2]
                di, dj = ki * stride, kj * stride
                c = _shift2d(out, di, dj)
                a = _shift2d(albedo, di, dj)
                nn = _shift2d(normal, di, dj)
                dw_c = jnp.sum((c - out) ** 2, -1, keepdims=True) / (
                    (sigma_color * lum_scale) ** 2 + 1e-12)
                dw_a = jnp.sum((a - albedo) ** 2, -1, keepdims=True) / (
                    sigma_albedo ** 2 + 1e-12)
                dw_n = jnp.sum((nn - normal) ** 2, -1, keepdims=True) / (
                    sigma_normal ** 2 + 1e-12)
                w = k * jnp.exp(-(dw_c + dw_a + dw_n))
                acc = acc + w * c
                wacc = wacc + w
        out = acc / jnp.maximum(wacc, 1e-12)
    return out


denoise = jax.jit(atrous_denoise, static_argnames=('iterations',))
