"""Measured BRDFs: MERL isotropic (.binary) and Titopo tabulated formats.

JAX counterpart of IsoMERLBRDF / TitopoBRDF (reference:
BRDF.h:116-248, MERLBRDFRead.cpp:28-235).  Both are pure gather tables —
a good fit for a wavefront: the half/difference-angle reparameterization is
vectorized trigonometry and the lookups are (N,)-indexed gathers.

Sampling for both is cosine-hemisphere with pdf = cos/pi
(reference: BRDF.h:126-131, :198-203).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils import struct

from ..core import vec

# MERL table resolution + channel scales (reference: MERLBRDFRead.h:3-8)
RES_TH = 90
RES_TD = 90
RES_PD = 360
RED_SCALE = 1.0 / 1500.0
GREEN_SCALE = 1.15 / 1500.0
BLUE_SCALE = 1.66 / 1500.0

MERL = 0
TITOPO = 1


@struct.dataclass
class MeasuredBRDF:
    """One loaded measured-BRDF table bound to scene objects."""

    data: jnp.ndarray                # MERL: (3, TH*TD*PD/2) f32
                                     # Titopo: (Ti*To*Pd, 3) f32
    kind: int = struct.field(pytree_node=False)
    dims: tuple = struct.field(pytree_node=False, default=())
    # source file (scene save/round-trip; not used at render time)
    path: str = struct.field(pytree_node=False, default='')


def load_merl(path: str) -> MeasuredBRDF:
    """Read a MERL .binary file (reference: read_brdf, MERLBRDFRead.cpp:212-235)."""
    with open(path, 'rb') as f:
        dims = np.fromfile(f, np.int32, 3)
        n = int(dims[0] * dims[1] * dims[2])
        if n != RES_TH * RES_TD * RES_PD // 2:
            raise ValueError(f'MERL dims mismatch: {dims}')
        raw = np.fromfile(f, np.float64, 3 * n)
    table = raw.reshape(3, n).astype(np.float32)
    return MeasuredBRDF(data=jnp.asarray(table), kind=MERL, path=path)


def load_titopo(path: str, n_thetai: int, n_thetao: int, n_phid: int
                ) -> MeasuredBRDF:
    """Read a raw-float Titopo file (reference: BRDF.h:118-124).  Grid sizes
    are chosen by extension in the reference GUI: .titopoh -> 45^3,
    .titopo -> 90x90x360 (mainApp.cpp:2418-2428)."""
    raw = np.fromfile(path, np.float32, n_thetai * n_thetao * n_phid * 3)
    return MeasuredBRDF(data=jnp.asarray(raw.reshape(-1, 3)), kind=TITOPO,
                        dims=(n_thetai, n_thetao, n_phid), path=path)


def load_measured(path: str) -> MeasuredBRDF:
    """Extension dispatch exactly like the reference's BRDF drop handler
    (mainApp.cpp:2418-2434): `.titopoh` -> Titopo 45x45x180, `.titopo`
    -> Titopo 90x90x360, anything else (`.binary`) -> MERL.  This is the
    loader the scene paths (io/scene_json, io/scn_import) call, so
    `.titopo` assets bind to TitopoBRDF instead of being misparsed as
    MERL binaries."""
    low = path.lower()
    if low.endswith('.titopoh'):
        return load_titopo(path, 45, 45, 180)
    if low.endswith('.titopo'):
        return load_titopo(path, 90, 90, 360)
    return load_merl(path)


def _local_frame(n, wi, wo):
    """Project wi/wo into the reference's tangent frame (BRDF.h:140-154)."""
    t1, t2 = vec.onb(n)
    wi_l = jnp.stack([vec.dot(wi, t1), vec.dot(wi, t2), vec.dot(wi, n)], -1)
    wo_l = jnp.stack([vec.dot(wo, t1), vec.dot(wo, t2), vec.dot(wo, n)], -1)
    return wi_l, wo_l


def _rotate_z(v, angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack([c * v[..., 0] - s * v[..., 1],
                      s * v[..., 0] + c * v[..., 1],
                      v[..., 2]], -1)


def _rotate_y(v, angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack([c * v[..., 0] + s * v[..., 2],
                      v[..., 1],
                      -s * v[..., 0] + c * v[..., 2]], -1)


def merl_eval(table: MeasuredBRDF, wi, wo, n):
    """Vectorized lookup_brdf_val (reference: MERLBRDFRead.cpp:76-207).

    Half-angle nonlinear theta_h index (sqrt mapping), phi_d folded by
    reciprocity into [0, pi), nearest-neighbor lookup, per-channel scales.
    Zero below the horizon (BRDF.h:229-232).
    """
    wi_l, wo_l = _local_frame(n, wi, wo)
    above = (wi_l[..., 2] > 0.0) & (wo_l[..., 2] > 0.0)

    half = vec.normalize((wi_l + wo_l) * 0.5)
    theta_half = jnp.arccos(jnp.clip(half[..., 2], -1.0, 1.0))
    fi_half = jnp.arctan2(half[..., 1], half[..., 0])
    tmp = _rotate_z(wi_l, -fi_half)
    diff = _rotate_y(tmp, -theta_half)
    theta_diff = jnp.arccos(jnp.clip(diff[..., 2], -1.0, 1.0))
    fi_diff = jnp.arctan2(diff[..., 1], diff[..., 0])

    # indices (MERLBRDFRead.cpp:130-177)
    th_deg = theta_half / (np.pi / 2.0) * RES_TH
    ith = jnp.sqrt(jnp.maximum(th_deg * RES_TH, 0.0)).astype(jnp.int32)
    ith = jnp.clip(jnp.where(theta_half <= 0.0, 0, ith), 0, RES_TH - 1)
    itd = jnp.clip((theta_diff / (np.pi * 0.5) * RES_TD).astype(jnp.int32),
                   0, RES_TD - 1)
    fi_d = jnp.where(fi_diff < 0.0, fi_diff + np.pi, fi_diff)
    ipd = jnp.clip((fi_d / np.pi * (RES_PD // 2)).astype(jnp.int32),
                   0, RES_PD // 2 - 1)

    idx = ipd + itd * (RES_PD // 2) + ith * (RES_PD // 2) * RES_TD
    r = table.data[0, idx] * RED_SCALE
    g = table.data[1, idx] * GREEN_SCALE
    b = table.data[2, idx] * BLUE_SCALE
    out = jnp.stack([r, g, b], -1)
    return jnp.where(above[..., None], jnp.maximum(out, 0.0), 0.0)


def titopo_eval(table: MeasuredBRDF, wi, wo, n):
    """Vectorized TitopoBRDF::eval (reference: BRDF.h:132-185): trilinear
    interpolation over the (theta_i, theta_o, phi_d) grid."""
    nti, nto, npd = table.dims
    wi_l, wo_l = _local_frame(n, wi, wo)
    above = (wi_l[..., 2] > 0.0) & (wo_l[..., 2] > 0.0)

    thetai = jnp.arccos(jnp.clip(wi_l[..., 2], -1.0, 1.0))
    thetao = jnp.arccos(jnp.clip(wo_l[..., 2], -1.0, 1.0))
    phid = (jnp.arctan2(wo_l[..., 1], wo_l[..., 0])
            - jnp.arctan2(wi_l[..., 1], wi_l[..., 0]))
    phid = jnp.mod(phid, 2.0 * np.pi)

    fi = thetai / (np.pi / 2.0) * nti
    fo = thetao / (np.pi / 2.0) * nto
    fp = phid / (2.0 * np.pi) * npd
    i0 = jnp.clip(fi.astype(jnp.int32), 0, nti - 1)
    o0 = jnp.clip(fo.astype(jnp.int32), 0, nto - 1)
    p0 = jnp.clip(fp.astype(jnp.int32), 0, npd - 1)
    i1 = jnp.minimum(i0 + 1, nti - 1)
    o1 = jnp.minimum(o0 + 1, nto - 1)
    p1 = jnp.minimum(p0 + 1, npd - 1)
    wi_f = fi - i0
    wo_f = fo - o0
    wp_f = fp - p0

    def at(i, o, p_):
        return table.data[(i * nto + o) * npd + p_]

    v = ((at(i0, o0, p0) * (1 - wp_f)[..., None]
          + at(i0, o0, p1) * wp_f[..., None]) * (1 - wo_f)[..., None]
         + (at(i0, o1, p0) * (1 - wp_f)[..., None]
            + at(i0, o1, p1) * wp_f[..., None]) * wo_f[..., None]
         ) * (1 - wi_f)[..., None] + (
        (at(i1, o0, p0) * (1 - wp_f)[..., None]
         + at(i1, o0, p1) * wp_f[..., None]) * (1 - wo_f)[..., None]
        + (at(i1, o1, p0) * (1 - wp_f)[..., None]
           + at(i1, o1, p1) * wp_f[..., None]) * wo_f[..., None]
    ) * wi_f[..., None]
    return jnp.where(above[..., None], v, 0.0)


def measured_eval(table: MeasuredBRDF, wi, wo, n):
    if table.kind == MERL:
        return merl_eval(table, wi, wo, n)
    return titopo_eval(table, wi, wo, n)
