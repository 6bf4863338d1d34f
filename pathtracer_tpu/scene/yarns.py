"""Yarns: polylines rendered as finite-cylinder tubes.

JAX counterpart of Yarns (reference: TriangleMesh.h:265-309 — .yarn
polylines scaled x50, one Cylinder(r=0.1) per segment, own BVH) and the
finite-cylinder intersection (reference: Geometry.h:731-846).

Segments sweep as chunked dense quadratic tests (VPU work), like triangles
and disks.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils import struct

BIG_T = np.float32(1e30)

YARN_SCALE = 50.0      # TriangleMesh.h:281
YARN_RADIUS = 0.1


def load_yarn(path: str):
    """Parse a .yarn file (reference: TriangleMesh.h:268-290):
    nbyarns, then per yarn: nbsegments and that many xyz points.
    Returns (a (S,3), b (S,3)) segment endpoints, scaled x50."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    nb = int(next(it))
    seg_a, seg_b = [], []
    for _ in range(nb):
        npts = int(next(it))
        prev = None
        for _ in range(npts):
            p = np.array([float(next(it)), float(next(it)),
                          float(next(it))]) * YARN_SCALE
            if prev is not None:
                seg_a.append(prev)
                seg_b.append(p)
            prev = p
    return (np.asarray(seg_a, np.float32).reshape(-1, 3),
            np.asarray(seg_b, np.float32).reshape(-1, 3))


@struct.dataclass
class YarnArrays:
    ax: jnp.ndarray; ay: jnp.ndarray; az: jnp.ndarray    # segment start (S,)
    ux: jnp.ndarray; uy: jnp.ndarray; uz: jnp.ndarray    # unit axis
    length: jnp.ndarray                                  # (S,)
    radius: jnp.ndarray                                  # (S,)
    obj_row: int = struct.field(pytree_node=False)

    @property
    def num_segments(self):
        return self.ax.shape[0]


def upload_yarns(seg_a, seg_b, obj_row, radius=YARN_RADIUS) -> YarnArrays:
    d = seg_b - seg_a
    ln = np.linalg.norm(d, axis=1)
    u = d / np.maximum(ln[:, None], 1e-12)
    return YarnArrays(
        ax=jnp.asarray(seg_a[:, 0]), ay=jnp.asarray(seg_a[:, 1]),
        az=jnp.asarray(seg_a[:, 2]),
        ux=jnp.asarray(u[:, 0]), uy=jnp.asarray(u[:, 1]),
        uz=jnp.asarray(u[:, 2]),
        length=jnp.asarray(ln.astype(np.float32)),
        radius=jnp.full((len(seg_a),), radius, jnp.float32),
        obj_row=int(obj_row),
    )


def cylinder_sweep(ya: YarnArrays, org, dirn, t_max, chunk: int = 2048):
    """Closest finite-cylinder hit over all segments: (t, seg index, axial s).

    Quadratic in the plane perpendicular to the axis (reference:
    Cylinder::intersection, Geometry.h:731-846), nearest positive root
    whose axial coordinate lies within [0, length].
    """
    n = org.shape[0]
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]
    best_t = t_max
    best_i = jnp.full((n,), -1, jnp.int32)
    best_s = jnp.zeros((n,))
    total = ya.num_segments
    for start in range(0, total, chunk):
        sl = slice(start, min(start + chunk, total))
        axp, ayp, azp = ya.ax[sl], ya.ay[sl], ya.az[sl]
        uxp, uyp, uzp = ya.ux[sl], ya.uy[sl], ya.uz[sl]
        ln = ya.length[sl]
        r = ya.radius[sl]
        # oc = o - A
        ocx, ocy, ocz = ox - axp, oy - ayp, oz - azp
        du = dx * uxp + dy * uyp + dz * uzp          # dot(d, u)
        ocu = ocx * uxp + ocy * uyp + ocz * uzp      # dot(oc, u)
        # perpendicular components
        dpx, dpy, dpz = dx - du * uxp, dy - du * uyp, dz - du * uzp
        opx, opy, opz = ocx - ocu * uxp, ocy - ocu * uyp, ocz - ocu * uzp
        a = dpx * dpx + dpy * dpy + dpz * dpz
        b = dpx * opx + dpy * opy + dpz * opz
        c = opx * opx + opy * opy + opz * opz - r * r
        delta = b * b - a * c
        safe_a = jnp.maximum(a, 1e-20)
        sq = jnp.sqrt(jnp.maximum(delta, 0.0))
        t1 = (-b - sq) / safe_a
        t2 = (-b + sq) / safe_a
        s1 = ocu + t1 * du
        s2 = ocu + t2 * du
        ok1 = (delta >= 0) & (t1 > 0) & (s1 >= 0) & (s1 <= ln)
        ok2 = (delta >= 0) & (t2 > 0) & (s2 >= 0) & (s2 <= ln)
        t = jnp.where(ok1, t1, jnp.where(ok2, t2, BIG_T))
        s_ax = jnp.where(ok1, s1, s2)
        j = jnp.argmin(t, axis=-1)
        jj = j[:, None]
        tj = jnp.take_along_axis(t, jj, -1)[:, 0]
        win = tj < best_t
        best_i = jnp.where(win, j.astype(jnp.int32) + start, best_i)
        best_s = jnp.where(win, jnp.take_along_axis(s_ax, jj, -1)[:, 0],
                           best_s)
        best_t = jnp.where(win, tj, best_t)
    return best_t, best_i, best_s
