"""Learned kernel-predicting denoiser — the OIDN-slot model.

The reference post-filters with Intel Open Image Denoise fed by
color+albedo+normal buffers (reference: Raytracer.cpp:1721-1746).  The
equivalent here is a small kernel-predicting CNN (KPCN family,
Bako et al. 2017, scaled down): a conv stack reads tonemapped radiance
plus the primary-hit auxiliaries and predicts a per-pixel 5x5 filter
kernel (softmax-normalized, so output radiance is a convex combination
of neighborhood radiance — energy-bounded and HDR-safe by
construction).  Trained on procedurally generated scenes rendered by
THIS renderer at low vs high spp (scripts/train_denoiser.py); weights
ship in the repo and load at import.  Falls back to the a-trous filter
(render/denoise.py) when weights are absent.

Kernel prediction instead of direct regression keeps the tiny model
honest: it cannot invent energy, only reweight samples — the same
reason the reference feeds OIDN unsplatted buffers (Raytracer.cpp:
1631-1645 comment).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

KSIZE = 5                     # predicted kernel width
_R = KSIZE // 2
WEIGHTS_PATH = os.path.join(os.path.dirname(__file__),
                            'denoiser_weights.npz')


FEATURES = 48
DEPTH = 5                     # hidden 3x3 conv layers (+1 output layer)
IN_CHANNELS = 10


def kpcn_lite(params, x):
    """Conv stack -> per-pixel KSIZE*KSIZE kernel logits.

    params: {'Conv_i': {'kernel': (3,3,Cin,Cout), 'bias': (Cout,)}} for
    i = 0..DEPTH, SAME padding, ReLU between layers.  (H,W,C) -> (H,W,25).
    Products at full float32 precision: TF32 on a GPU would move the
    predicted kernels visibly."""
    n = len(params)
    x = x[None]
    for i in range(n):
        p = params[f'Conv_{i}']
        x = lax.conv_general_dilated(
            x, p['kernel'], (1, 1), 'SAME',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
            precision=lax.Precision.HIGHEST) + p['bias']
        if i < n - 1:
            x = jax.nn.relu(x)
    return x[0]


def _tonemap(c):
    """HDR -> [0,1)-ish network input (log1p keeps highlight ordering)."""
    return jnp.log1p(jnp.maximum(c, 0.0))


def features_from_buffers(color, albedo, normal):
    """(H,W,10) network input: tonemapped radiance, albedo, normal,
    luminance."""
    c = _tonemap(color)
    lum = jnp.mean(c, axis=-1, keepdims=True)
    return jnp.concatenate([c, albedo, normal, lum], axis=-1)


def apply_kernels(color, logits):
    """Apply per-pixel softmax kernels to the radiance neighborhood."""
    w = jax.nn.softmax(logits, axis=-1)               # (H,W,K*K)
    h, wd = color.shape[0], color.shape[1]
    out = jnp.zeros_like(color)
    idx = 0
    for di in range(-_R, _R + 1):
        i = jnp.clip(jnp.arange(h) + di, 0, h - 1)
        ci = color[i]
        for dj in range(-_R, _R + 1):
            j = jnp.clip(jnp.arange(wd) + dj, 0, wd - 1)
            out = out + w[..., idx:idx + 1] * ci[:, j]
            idx += 1
    return out


def denoise_apply(params, color, albedo, normal):
    """Denoise an HDR buffer with trained params."""
    x = features_from_buffers(color, albedo, normal)
    logits = kpcn_lite(params, x)
    return apply_kernels(color, logits)


def init_params(rng_key):
    """Random weights (LeCun-normal kernels, zero biases)."""
    init = jax.nn.initializers.lecun_normal()
    chans = [IN_CHANNELS] + [FEATURES] * DEPTH + [KSIZE * KSIZE]
    keys = jax.random.split(rng_key, len(chans) - 1)
    return {f'Conv_{i}': {
        'kernel': init(keys[i], (3, 3, chans[i], chans[i + 1]), jnp.float32),
        'bias': jnp.zeros((chans[i + 1],), jnp.float32)}
        for i in range(len(chans) - 1)}


def save_weights(params, path: str = WEIGHTS_PATH):
    flat = {}
    for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat['/'.join(str(getattr(k, 'key', k)) for k in kp)] = \
            np.asarray(v)
    np.savez_compressed(path, **flat)


def _set_in(tree, keys, val):
    k = keys[0]
    if len(keys) == 1:
        tree[k] = val
        return
    tree.setdefault(k, {})
    _set_in(tree[k], keys[1:], val)


def load_weights(path: str = WEIGHTS_PATH) -> Optional[dict]:
    """Load shipped weights; None when absent (callers fall back to
    a-trous)."""
    if not os.path.exists(path):
        return None
    data = np.load(path)
    tree: dict = {}
    for k in data.files:
        _set_in(tree, k.split('/'), jnp.asarray(data[k]))
    return tree


_params_cache = 'unset'


def denoise_learned(color, albedo, normal):
    """OIDN-slot entry: learned model when weights ship, a-trous
    otherwise (same signature as denoise.atrous_denoise)."""
    global _params_cache
    if _params_cache == 'unset':
        _params_cache = load_weights()
    if _params_cache is None:
        from . import denoise as dn
        return dn.atrous_denoise(color, albedo, normal)
    return denoise_apply(_params_cache, jnp.asarray(color, jnp.float32),
                         jnp.asarray(albedo, jnp.float32),
                         jnp.asarray(normal, jnp.float32))
