"""Texture channels: load, sample, and per-group device storage.

Counterpart of the reference Texture class (reference:
BRDF.h:252-426): one class serves all 8 map channels (albedo, specular,
normal, alpha, roughness, transparency-mask, refraction-index, subsurface);
color maps are /255 then gamma-2.2-linearized at load (BRDF.h:393-404),
normal maps decode (v-128)/norm (BRDF.h:406-419), sampling is point
lookup with fractional wrap (BRDF.h:270-275, 293-307), and a constant
color is an image-less channel with a multiplier (BRDF.h:254, 306-307).

Device layout: per-(mesh, group, channel) images are separate (H,W,3)
arrays (static pytree structure — group counts are small); texel gathers
are (N,)-indexed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp
from ..utils import struct


def load_color_image(path: str) -> np.ndarray:
    """Color map load: /255 then ^2.2 (reference: BRDF.h:393-404)."""
    from ..io.image import load_image
    img = load_image(path)
    return np.power(img / 255.0, 2.2).astype(np.float32)


def load_normal_image(path: str) -> np.ndarray:
    """Normal map decode: (v - 128)/|v - 128| (reference: BRDF.h:406-419).

    Note the reference subtracts 128 from raw u8 (not /255), then
    normalizes — reproduced exactly.
    """
    from ..io.image import load_image
    img = load_image(path) - 128.0
    n = np.linalg.norm(img, axis=-1, keepdims=True)
    return (img / np.maximum(n, 1e-12)).astype(np.float32)


def load_raw_image(path: str) -> np.ndarray:
    """Raw /255-then-gamma load for scalar channels (alpha/roughness/... use
    the same loadColors path in the reference)."""
    return load_color_image(path)


@struct.dataclass
class GroupTextures:
    """Optional per-group images; constant channels stay None (multiplier
    lives in MeshArrays.g_* / the analytic material table)."""

    kd: Optional[jnp.ndarray] = None        # (H,W,3) linearized
    ks: Optional[jnp.ndarray] = None
    normal: Optional[jnp.ndarray] = None    # (H,W,3) decoded tangent-space
    alpha: Optional[jnp.ndarray] = None     # (H,W,3); red channel used
    roughness: Optional[jnp.ndarray] = None
    transp: Optional[jnp.ndarray] = None
    refr: Optional[jnp.ndarray] = None
    ksub: Optional[jnp.ndarray] = None

    @property
    def any_image(self):
        return any(x is not None for x in
                   (self.kd, self.ks, self.normal, self.alpha, self.roughness,
                    self.transp, self.refr, self.ksub))


_LOADERS = {
    'kd': load_color_image, 'ks': load_color_image, 'ksub': load_color_image,
    'alpha': load_color_image, 'roughness': load_raw_image,
    'transp': load_raw_image, 'refr': load_raw_image,
    'normal': load_normal_image,
}


def make_group_textures(spec) -> 'GroupTextures':
    """Build GroupTextures from a {channel: path-or-array} dict.

    Channels: kd, ks, normal, alpha, roughness, transp, refr, ksub —
    the reference's 8 per-object texture slots (Geometry.h:399-445).
    Paths go through the channel's loader (color maps gamma-linearize,
    normal maps decode); arrays are taken as already-decoded float data.
    """
    spec = spec or {}
    kw = {}
    for ch, val in spec.items():
        if ch not in _LOADERS:
            raise ValueError(f'unknown texture channel {ch!r}')
        if val is None:
            continue
        if isinstance(val, str):
            arr = _LOADERS[ch](val)
        else:
            arr = np.asarray(val, np.float32)
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        kw[ch] = jnp.asarray(arr)
    return GroupTextures(**kw)


def wrap(u):
    """Fractional repeat wrap (reference: BRDF.h:270-275)."""
    u = u - jnp.floor(u)
    return u


def sample_point(img: jnp.ndarray, u, v):
    """Point sample at wrapped (u,v) (reference getVec, BRDF.h:293-299):
    x = u*(W-1), y = v*(H-1), truncated."""
    h, w = img.shape[0], img.shape[1]
    u = wrap(u)
    v = wrap(v)
    x = jnp.clip((u * (w - 1)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * (h - 1)).astype(jnp.int32), 0, h - 1)
    return img[y, x]


def sample_red(img: jnp.ndarray, u, v):
    """Red-channel scalar sample (reference getValRed, BRDF.h:381-392)."""
    return sample_point(img, u, v)[..., 0]


def sample_bilinear(img: jnp.ndarray, u, v):
    """Bilinear sample at wrapped (u,v) — an OPTION the reference lacks
    (its Texture is point-sampled, BRDF.h:293-307); coordinates use the
    same x = u*(W-1) mapping so bilinear==point at texel centers."""
    h, w = img.shape[0], img.shape[1]
    xf = wrap(u) * (w - 1)
    yf = wrap(v) * (h - 1)
    x0 = jnp.clip(jnp.floor(xf).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(yf).astype(jnp.int32), 0, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = (xf - x0.astype(xf.dtype))[..., None]
    fy = (yf - y0.astype(yf.dtype))[..., None]
    c00 = img[y0, x0]
    c10 = img[y0, x1]
    c01 = img[y1, x0]
    c11 = img[y1, x1]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


CHANNELS = ('kd', 'ks', 'normal', 'alpha', 'roughness', 'transp', 'refr',
            'ksub')


@struct.dataclass
class ChannelAtlas:
    """One channel's per-group images packed into a single array.

    The per-group select-chain in scene._merge_mesh_hit is the right
    call for a handful of groups (a few vectorized selects instead of a
    gather), but a mesh with dozens of textured
    groups would pay G full-image samples per channel.  The atlas stacks
    every group's image vertically into one (Ht, Wmax, 3) array plus
    per-group row-offset/size tables, so ONE gather serves all groups
    regardless of G (replaces the reference's per-group Texture vector,
    Geometry.h:666-713, at wavefront width)."""

    img: jnp.ndarray        # (Ht, Wmax, 3)
    y0: jnp.ndarray         # (G,) int32 first row of group g's image
    h: jnp.ndarray          # (G,) int32 (1 for imageless groups)
    w: jnp.ndarray          # (G,) int32
    has: jnp.ndarray        # (G,) bool — group has an image here


def build_atlas(images) -> Optional[ChannelAtlas]:
    """Pack a per-group list of Optional[(H,W,3)] into a ChannelAtlas
    (None when no group has an image)."""
    if not any(im is not None for im in images):
        return None
    y0s, hs, ws, rows = [], [], [], []
    wmax = max(int(im.shape[1]) for im in images if im is not None)
    y = 0
    for im in images:
        if im is None:
            y0s.append(0)
            hs.append(1)
            ws.append(1)
            continue
        im = np.asarray(im, np.float32)
        hh, ww = im.shape[0], im.shape[1]
        if ww < wmax:
            im = np.pad(im, ((0, 0), (0, wmax - ww), (0, 0)))
        rows.append(im)
        y0s.append(y)
        hs.append(hh)
        ws.append(ww)
        y += hh
    return ChannelAtlas(
        img=jnp.asarray(np.concatenate(rows, axis=0)),
        y0=jnp.asarray(y0s, jnp.int32), h=jnp.asarray(hs, jnp.int32),
        w=jnp.asarray(ws, jnp.int32), has=jnp.asarray(
            [im is not None for im in images]))


def sample_atlas(at: ChannelAtlas, grp, u, v, bilinear: bool = False):
    """Per-lane atlas sample: (vals (N,3), has (N,) bool).

    Point mode reproduces sample_point exactly (x = u*(w-1) truncated);
    bilinear clamps the 2x2 footprint inside the group's own rows so no
    lane ever blends across group boundaries."""
    hg = at.h[grp]
    wg = at.w[grp]
    y0g = at.y0[grp]
    xf = wrap(u) * (wg - 1).astype(jnp.float32)
    yf = wrap(v) * (hg - 1).astype(jnp.float32)
    x0 = jnp.clip(xf.astype(jnp.int32), 0, wg - 1)
    y0 = jnp.clip(yf.astype(jnp.int32), 0, hg - 1)
    if not bilinear:
        return at.img[y0g + y0, x0], at.has[grp]
    x1 = jnp.minimum(x0 + 1, wg - 1)
    y1 = jnp.minimum(y0 + 1, hg - 1)
    fx = (xf - x0.astype(xf.dtype))[..., None]
    fy = (yf - y0.astype(yf.dtype))[..., None]
    c00 = at.img[y0g + y0, x0]
    c10 = at.img[y0g + y0, x1]
    c01 = at.img[y0g + y1, x0]
    c11 = at.img[y0g + y1, x1]
    val = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
           + (c01 * (1 - fx) + c11 * fx) * fy)
    return val, at.has[grp]
