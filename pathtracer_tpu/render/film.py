"""Film: Gaussian splat accumulation + SAT border normalization + tonemap.

JAX counterpart of the reference's splatting loops
(reference: Raytracer.cpp:1486-1497 splat, :1276-1291 + 1354-1374 summed-area
filter-integral tables, :1540-1547 gamma/u8 encode).  Per-sample nested splat
loops become (2F+1)^2 vectorized scatter-adds over the whole wavefront, which
XLA lowers to fast sorted scatters.

The radiance scale constant 196964.7 is the reference's display divisor
(Raytracer.cpp:1543); gamma default 2.2 (Raytracer.h gamma field).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

RADIANCE_SCALE = np.float32(196964.7)


class FilmSpec(NamedTuple):
    """Static film configuration + precomputed border-normalization table."""

    width: int
    height: int
    sigma: float
    filter_size: int             # F = ceil(2*sigma) (Raytracer.cpp:1356)
    ratio: jnp.ndarray           # (H,W) 1/sum(filter integral over in-bounds window)


def make_film(width: int, height: int, sigma: float = 0.5) -> FilmSpec:
    """Build film spec with per-pixel border ratio (Raytracer.cpp:1477-1482).

    ratio(i,j) = 1 / sum of the discrete filter taps whose window survives
    border clamping.  The Gaussian taps separate as f(i)*f(j), so the
    reference's 2D SAT lookup (Raytracer.cpp:1276-1291) collapses to an
    outer product of 1D clamped-window sums — O(H+W) host work.
    """
    fsize = int(math.ceil(sigma * 2.0))
    offs = np.arange(-fsize, fsize + 1, dtype=np.float64)
    f1d = np.exp(-offs ** 2 / (2.0 * sigma * sigma)) / (
        math.sqrt(2.0 * math.pi) * sigma)

    def axis_sums(n):
        idx = np.arange(n)
        lo = np.maximum(0, idx - fsize) - idx + fsize      # first tap kept
        hi = np.minimum(idx + fsize, n - 1) - idx + fsize  # last tap kept
        csum = np.concatenate([[0.0], np.cumsum(f1d)])
        return csum[hi + 1] - csum[lo]

    fi = axis_sums(height)
    fj = axis_sums(width)
    ratio = (1.0 / np.outer(fi, fj)).astype(np.float32)
    return FilmSpec(width=width, height=height, sigma=float(sigma),
                    filter_size=fsize, ratio=jnp.asarray(ratio))


def make_film_spec_static(width: int, height: int, sigma: float) -> FilmSpec:
    """make_film usable inside a traced context (constants fold into jit)."""
    return make_film(width, height, sigma)


def alloc(film: FilmSpec):
    """Fresh padded accumulators: (H+2F, W+2F, 3) image + (H+2F, W+2F) count.

    The F-pixel halo absorbs splat contributions that fall outside the image
    (the reference clamps its window instead, Raytracer.cpp:1477-1480; the
    ratio table already normalizes border pixels identically)."""
    f = film.filter_size
    h, w = film.height + 2 * f, film.width + 2 * f
    return (jnp.zeros((h, w, 3), jnp.float32), jnp.zeros((h, w), jnp.float32))


def crop(film: FilmSpec, padded):
    f = film.filter_size
    return padded[f:f + film.height, f:f + film.width]


def splat(film: FilmSpec, image, sample_count, colors, dx, dy, row0=0,
          block_rows=None):
    """Splat a row-contiguous block of grid samples into the film — STENCIL.

    reference: Raytracer.cpp:1486-1497 — each sample contributes to the
    (2F+1)^2 window around its pixel with weight
    w = exp(-((i2-i-dy)^2 + (j2-j-dx)^2) / (2 sigma^2)) * ratio / (2 pi sigma^2),
    the same w accumulating into sample_count; image rows are flipped
    (row 0 = top = sensor row H-1), matching the reference's (H-i-1).

    Samples arrive one-per-pixel in grid order, so the splat is a
    gather stencil, not a scatter: for each of the (2F+1)^2 offsets the whole
    weighted color plane shifts by (oi,oj) and adds elementwise into the
    padded film.  This replaced an .at[].add scatter that cost 1.26 s/wave
    at 1080p (~100x).

    Args:
      image, sample_count: padded accumulators from alloc().
      colors: (Nb, 3), Nb == block_rows*W, sensor rows [row0, row0+block_rows)
        in row-major order.  dx/dy: (Nb,) jitter.
      row0: first sensor row of the block (static int or traced scalar —
        traced when called inside shard_map with axis_index).
      block_rows: rows in this block (static); default full height.
    Returns:
      (image, sample_count) updated.
    """
    h, w, fs = film.height, film.width, film.filter_size
    hs = block_rows if block_rows is not None else h
    sigma = film.sigma
    denom2 = np.float32(1.0 / (2.0 * sigma * sigma))
    base = np.float32(1.0 / (sigma * sigma * 2.0 * np.pi))

    # flip to image space: sensor row i -> image row h-1-i; the block maps to
    # image rows [h-row0-hs, h-row0), i.e. padded rows starting at
    # h-row0-hs (+fs pad) - fs stencil reach = h-row0-hs.
    cg = colors.reshape(hs, w, 3)[::-1]
    dxg = dx.reshape(hs, w)[::-1]
    dyg = dy.reshape(hs, w)[::-1]
    if isinstance(row0, int) and row0 == 0 and hs == h:
        ratio_f = film.ratio[::-1] * base
    else:
        ratio_f = jax.lax.dynamic_slice(
            film.ratio[::-1], (h - row0 - hs, 0), (hs, w)) * base

    part_img = jnp.zeros((hs + 2 * fs, w + 2 * fs, 3), jnp.float32)
    part_cnt = jnp.zeros((hs + 2 * fs, w + 2 * fs), jnp.float32)
    for oi in range(-fs, fs + 1):
        for oj in range(-fs, fs + 1):
            wgt = jnp.exp(-((oi - dyg) ** 2 + (oj - dxg) ** 2) * denom2) * ratio_f
            # flipped-space target = (src - oi, src + oj); partial is padded
            # by fs so indices stay in range for all offsets
            r0 = fs - oi
            c0 = fs + oj
            part_img = part_img.at[r0:r0 + hs, c0:c0 + w].add(
                cg * wgt[..., None])
            part_cnt = part_cnt.at[r0:r0 + hs, c0:c0 + w].add(wgt)

    start = h - row0 - hs  # padded-film row of the partial's first row
    if isinstance(row0, int):
        image = image.at[start:start + hs + 2 * fs].add(part_img)
        sample_count = sample_count.at[start:start + hs + 2 * fs].add(part_cnt)
    else:
        blk = jax.lax.dynamic_slice(
            image, (start, 0, 0), (hs + 2 * fs, w + 2 * fs, 3))
        image = jax.lax.dynamic_update_slice(image, blk + part_img,
                                             (start, 0, 0))
        blk_c = jax.lax.dynamic_slice(sample_count, (start, 0),
                                      (hs + 2 * fs, w + 2 * fs))
        sample_count = jax.lax.dynamic_update_slice(
            sample_count, blk_c + part_cnt, (start, 0))
    return image, sample_count


def to_display(image, sample_count, gamma=2.2, progressive=True):
    """HDR accumulator -> [0,1] display floats (reference: Raytracer.cpp:1540-1547).

    progressive=True divides by max(sample_count,1) (interactive path);
    the offline path divides by sample_count after full accumulation
    (Raytracer.cpp:1687-1694) — same thing once all samples are in.
    """
    denom = jnp.maximum(sample_count, 1.0) if progressive else sample_count
    lin = image / RADIANCE_SCALE / denom[..., None]
    return jnp.clip(jnp.power(jnp.maximum(lin, 0.0), 1.0 / gamma), 0.0, 1.0)


def to_u8(display):
    return np.asarray(np.clip(np.asarray(display) * 255.0, 0.0, 255.0)
                      ).astype(np.uint8)
