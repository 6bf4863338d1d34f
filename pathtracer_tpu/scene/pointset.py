"""Point sets: XYZ import, kNN normal/radius estimation, disk splats.

Counterpart of PointSet (reference: PointSet.h:38-239,
PointSet.cpp:124-244): points render as normal-oriented disks; normals are
estimated by 10-NN PCA when absent (nanoflann + CImg symmetric_eigen in
the reference -> scipy cKDTree + numpy eigh here); splat radius is
0.21*2*d6 (distance to the 6th neighbor, PointSet.h:176).

Disk intersection runs as a chunked dense sweep over points (N rays x
P-point blocks) — the disk test is 10 flops, pure VPU work.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from ..core import vec
from ..utils import struct

BIG_T = np.float32(1e30)

# column codes (reference: PointSet.h:53 comment)
COL_IGNORE, COL_X, COL_Y, COL_Z = -1, 0, 1, 2
COL_NX, COL_NY, COL_NZ = 3, 4, 5
COL_R, COL_G, COL_B = 6, 7, 8


def load_xyz(path: str, cols, centered: bool = True):
    """Parse an XYZ file with user column mapping (reference:
    PointSet.h:52-99 + format dialog mainApp.cpp:2379-2400).

    Returns (points (P,3), normals (P,3) or zeros, colors (P,3)).
    Colors default to (1,1,1)/255 exactly like the reference (quirk: a
    colorless point set is nearly black, PointSet.h:61+96).
    """
    data = np.loadtxt(path, ndmin=2).astype(np.float32)
    ncols = data.shape[1]
    assert len(cols) <= ncols, f"mapping has {len(cols)} cols, file {ncols}"
    p = np.zeros((len(data), 3), np.float32)
    n = np.zeros((len(data), 3), np.float32)
    c = np.full((len(data), 3), 1.0, np.float32)
    for i, code in enumerate(cols):
        if code == COL_IGNORE:
            continue
        if code <= COL_Z:
            p[:, code] = data[:, i]
        elif code <= COL_NZ:
            n[:, code - 3] = data[:, i]
        else:
            c[:, code - 6] = data[:, i]
    c = c / 255.0
    if centered and len(p):
        lo, hi = p.min(0), p.max(0)
        s = float(max(hi - lo))
        p = (p - (lo + hi) * 0.5) / s
    return p, n, c


def estimate_normals(points: np.ndarray, k: int = 10):
    """10-NN PCA normals + 0.42*d6 radii (reference: PointSet.h:125-179)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    dist, idx = tree.query(points, k=k)
    neigh = points[idx]                        # (P,k,3)
    center = neigh.mean(axis=1, keepdims=True)
    d = neigh - center
    cov = np.einsum('pki,pkj->pij', d, d)
    _w, v = np.linalg.eigh(cov)                # ascending eigenvalues
    normals = v[:, :, 0].astype(np.float32)    # smallest -> surface normal
    radii = (0.21 * 2.0 * np.maximum(1e-8, dist[:, 5])).astype(np.float32)
    return normals, radii


@struct.dataclass
class PointSetArrays:
    """Device-side point set bound to an object-table row."""

    px: jnp.ndarray; py: jnp.ndarray; pz: jnp.ndarray       # (P,)
    nx: jnp.ndarray; ny: jnp.ndarray; nz: jnp.ndarray       # unit normals
    radius: jnp.ndarray                                     # (P,)
    colors: jnp.ndarray                                     # (P,3)
    # particle-cluster acceleration (wavefront form of the reference's uniform
    # accel grid, fluid.cpp:36-62): Morton-sorted particles grouped into
    # CLUSTER_P-sized clusters with radius-inflated AABBs; None = brute
    c_lox: jnp.ndarray = None; c_loy: jnp.ndarray = None
    c_loz: jnp.ndarray = None; c_hix: jnp.ndarray = None
    c_hiy: jnp.ndarray = None; c_hiz: jnp.ndarray = None
    obj_row: int = struct.field(pytree_node=False, default=0)
    n_clusters: int = struct.field(pytree_node=False, default=0)
    display_edges: bool = struct.field(pytree_node=False, default=False)
    # True: points are SPHERES (fluid particle rendering, fluid.cpp:175-262)
    # False: normal-oriented disks (PointSet splats)
    as_spheres: bool = struct.field(pytree_node=False, default=False)
    # transparent fluid: union-exit semantics for interior rays
    transparent: bool = struct.field(pytree_node=False, default=False)

    @property
    def num_points(self):
        return self.px.shape[0]


def upload_pointset(points, normals, colors, radii, obj_row,
                    display_edges=False) -> PointSetArrays:
    n = normals / np.maximum(
        np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    return PointSetArrays(
        px=jnp.asarray(points[:, 0]), py=jnp.asarray(points[:, 1]),
        pz=jnp.asarray(points[:, 2]),
        nx=jnp.asarray(n[:, 0]), ny=jnp.asarray(n[:, 1]),
        nz=jnp.asarray(n[:, 2]),
        radius=jnp.asarray(radii), colors=jnp.asarray(colors),
        obj_row=int(obj_row), display_edges=bool(display_edges),
    )


def make_pointset(path_or_points, cols=None, obj_row=0, normals=None,
                  colors=None, centered=True,
                  display_edges=False) -> PointSetArrays:
    """Load + estimate + upload in one step (PointSet::init)."""
    if isinstance(path_or_points, str):
        pts, nrm, col = load_xyz(path_or_points, cols or [0, 1, 2], centered)
    else:
        pts = np.asarray(path_or_points, np.float32)
        nrm = np.zeros_like(pts) if normals is None else np.asarray(normals)
        col = (np.full((len(pts), 3), 1 / 255, np.float32) if colors is None
               else np.asarray(colors, np.float32))
    if not nrm.any():
        nrm, radii = estimate_normals(pts)
    else:
        _, radii = estimate_normals(pts)   # radii still from kNN spacing
    return upload_pointset(pts, nrm, col, radii, obj_row, display_edges)


# ---------------------------------------------------------------------------
# Particle-cluster acceleration (fluid tier)
# ---------------------------------------------------------------------------
#
# The reference accelerates fluid-particle intersection with a per-frame
# uniform grid + per-ray DDA walk over voxel particle lists (fluid.cpp:
# 36-62 build, 65-171 transparent walk, 264-336 opaque).  The wavefront
# form here is a two-phase cluster decomposition in plain XLA:
# Morton-sorted particles grouped into CLUSTER_P-sized clusters with
# radius-inflated AABBs; phase 1 = a dense slab cull (_dense_cull) emitting
# near-first sorted slots per BLOCK-ray packet; phase 2 = a while_loop over
# only the emitted slots, each one (BLOCK, CLUSTER_P) vectorized sphere
# rectangle sliced from the sorted arrays, with a sound early break on the
# sorted entry keys.  Overflowed packets (count > MAXC_P) reroute their
# unproven lanes to the brute sweep — no hit is ever dropped.

BLOCK = 512          # rays per packet
CLUSTER_P = 256      # particles per cluster (dynamic_slice granule)
MAXC_P = 64          # culled cluster slots per packet
CLUSTERED_MIN = 8192   # below this the brute sweep wins


def _spread_bits(x):
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def morton_order(points: np.ndarray) -> np.ndarray:
    """Spatial sort order by 30-bit Morton code (locality for clustering)."""
    p = np.asarray(points, np.float64)
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint32)
    code = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))
    return np.argsort(code, kind='stable')


def _cluster_particles(p, radii, normals, colors):
    """Sort by Morton, pad to a CLUSTER_P multiple (dummies far away),
    return (p, radii, normals, colors, bounds(C,6))."""
    order = morton_order(p)
    p, radii = p[order], radii[order]
    normals, colors = normals[order], colors[order]
    n = len(p)
    pad = (-n) % CLUSTER_P
    if pad:
        p = np.concatenate([p, np.full((pad, 3), 1e9, np.float32)])
        radii = np.concatenate([radii, np.zeros(pad, np.float32)])
        normals = np.concatenate([normals,
                                  np.tile([[0, 1, 0]], (pad, 1))
                                  .astype(np.float32)])
        colors = np.concatenate([colors, np.zeros((pad, 3), np.float32)])
    c = len(p) // CLUSTER_P
    pc = p.reshape(c, CLUSTER_P, 3)
    rc = radii.reshape(c, CLUSTER_P, 1)
    lo = (pc - rc).min(1)
    hi = (pc + rc).max(1)
    # dummy-only padding keeps its 1e9 box: rays never enter it
    return p, radii, normals, colors, lo.astype(np.float32), \
        hi.astype(np.float32)


def _pad_rays(org, dirn, tmax, target_n):
    """Extend ray arrays with dead rays (tmax=-1 -> culled everywhere)."""
    pad = target_n - org.shape[0]
    org = jnp.concatenate([org, jnp.full((pad, 3), 1e6, org.dtype)])
    dirn = jnp.concatenate([dirn, jnp.broadcast_to(
        jnp.asarray([1.0, 0.0, 0.0], dirn.dtype), (pad, 3))])
    tmax = jnp.concatenate([tmax, jnp.full((pad,), -1.0, tmax.dtype)])
    return org, dirn, tmax


def _emit_from_keys(keys_c, live_c, maxc):
    """Near-first top-k emission from per-(packet, cluster) keys: the
    maxc smallest keys per packet row with their cluster ids (-1 pads),
    plus the live-cluster count per packet."""
    count = jnp.sum(live_c, axis=1, dtype=jnp.int32)[:, None]
    c = keys_c.shape[1]
    k = min(maxc, c)
    iota = jnp.broadcast_to(jnp.arange(c, dtype=jnp.int32), keys_c.shape)
    keys_s, idx_s = jax.lax.sort((keys_c, iota), dimension=-1, num_keys=1)
    keys_sel, idx = keys_s[:, :k], idx_s[:, :k]
    ids = jnp.where(keys_sel < BIG_T, idx, -1)
    if k < maxc:
        nb_ = ids.shape[0]
        ids = jnp.concatenate(
            [ids, jnp.full((nb_, maxc - k), -1, jnp.int32)], axis=1)
        keys_sel = jnp.concatenate(
            [keys_sel, jnp.full((nb_, maxc - k), BIG_T)], axis=1)
    return ids, count, keys_sel


def _dense_cull(cb, org, dirn, tmax, maxc: int):
    """Every packet x every cluster slab rectangle: per packet, the
    near-first list of clusters some lane's ray enters before its tmax."""
    lox, loy, loz, hix, hiy, hiz = cb
    n = org.shape[0]
    nb = n // BLOCK

    def per_packet(xs):
        o, d, tm = xs                   # (BLOCK,3) (BLOCK,3) (BLOCK,)
        ivx = 1.0 / d[:, 0:1]
        ivy = 1.0 / d[:, 1:2]
        ivz = 1.0 / d[:, 2:3]
        t1 = (lox[None, :] - o[:, 0:1]) * ivx
        t2 = (hix[None, :] - o[:, 0:1]) * ivx
        tmin = jnp.minimum(t1, t2)
        tmx = jnp.maximum(t1, t2)
        t1 = (loy[None, :] - o[:, 1:2]) * ivy
        t2 = (hiy[None, :] - o[:, 1:2]) * ivy
        tmin = jnp.maximum(tmin, jnp.minimum(t1, t2))
        tmx = jnp.minimum(tmx, jnp.maximum(t1, t2))
        t1 = (loz[None, :] - o[:, 2:3]) * ivz
        t2 = (hiz[None, :] - o[:, 2:3]) * ivz
        tmin = jnp.maximum(tmin, jnp.minimum(t1, t2))
        tmx = jnp.minimum(tmx, jnp.maximum(t1, t2))
        entry = jnp.maximum(tmin, 0.0)
        live = (tmx >= entry) & (tmin < tm[:, None])       # (BLOCK, C)
        key = jnp.min(jnp.where(live, entry, BIG_T), axis=0)
        return key, vec.any_true(live, axis=0)

    keys_c, live_c = jax.lax.map(
        per_packet, (org.reshape(nb, BLOCK, 3), dirn.reshape(nb, BLOCK, 3),
                     tmax.reshape(nb, BLOCK)))             # (nb, C)
    return _emit_from_keys(jnp.where(live_c, keys_c, BIG_T), live_c, maxc)


def _cull_spheres(ps: PointSetArrays, org, dirn, tmax):
    """Shared dense cull over particle-cluster AABBs (pads rays to the
    packet size internally).  Returns (ids, count, keys, padded rays)."""
    n = org.shape[0]
    pad = (-n) % BLOCK
    if pad:
        org, dirn, tmax = _pad_rays(org, dirn, tmax, n + pad)
    ids, count, keys = _dense_cull(
        (ps.c_lox, ps.c_loy, ps.c_loz, ps.c_hix, ps.c_hiy, ps.c_hiz),
        org, dirn, tmax, maxc=MAXC_P)
    return ids, count, keys, org, dirn, tmax


@jax.jit
def _clustered_entry_exec(px, py, pz, pr, ids, keys, org, dirn, tmax):
    """Per-packet closest sphere-entry sweep over culled slots."""
    nb = org.shape[0] // BLOCK

    def per_packet(xs):
        sid, key, o, d, tm = xs
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        a = dx * dx + dy * dy + dz * dz

        def cond(c):
            s, bt, _ = c
            ks = key[jnp.minimum(s, MAXC_P - 1)]
            return (s < MAXC_P) & (ks < jnp.max(bt))

        def body(c):
            s, bt, bi = c
            cid = sid[s]
            base = jnp.maximum(cid, 0) * CLUSTER_P
            sx = jax.lax.dynamic_slice(px, (base,), (CLUSTER_P,))
            sy = jax.lax.dynamic_slice(py, (base,), (CLUSTER_P,))
            sz = jax.lax.dynamic_slice(pz, (base,), (CLUSTER_P,))
            sr = jax.lax.dynamic_slice(pr, (base,), (CLUSTER_P,))
            ocx = ox - sx[None, :]
            ocy = oy - sy[None, :]
            ocz = oz - sz[None, :]
            b = dx * ocx + dy * ocy + dz * ocz
            c2 = ocx * ocx + ocy * ocy + ocz * ocz - sr[None, :] ** 2
            delta = b * b - a * c2
            sq = jnp.sqrt(jnp.maximum(delta, 0.0))
            t1 = (-b - sq) / a
            t2 = (-b + sq) / a
            t = jnp.where(t1 > 0, t1, t2)
            ok = (delta >= 0) & (t2 >= 0) & (t > 0) & (cid >= 0)
            t = jnp.where(ok, t, BIG_T)
            j = jnp.argmin(t, axis=-1)
            tj = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
            win = tj < bt
            bi = jnp.where(win, base + j.astype(jnp.int32), bi)
            bt = jnp.where(win, tj, bt)
            return s + 1, bt, bi

        _, bt, bi = jax.lax.while_loop(
            cond, body, (0, tm, jnp.full((BLOCK,), -1, jnp.int32)))
        return bt, bi

    B = BLOCK
    bt, bi = jax.lax.map(per_packet, (ids, keys, org.reshape(nb, B, 3),
                                      dirn.reshape(nb, B, 3),
                                      tmax.reshape(nb, B)))
    return bt.reshape(-1), bi.reshape(-1)


def clustered_sphere_sweep(ps: PointSetArrays, org, dirn, t_max):
    """Accelerated closest sphere hit (opaque fluid, fluid.cpp:264-336):
    cull + slot sweep, with a brute reroute for overflow-residual lanes."""
    n = org.shape[0]
    ids, count, keys, porg, pdirn, ptmax = _cull_spheres(ps, org, dirn,
                                                         t_max)
    bt, bi = _clustered_entry_exec(ps.px, ps.py, ps.pz, ps.radius,
                                   ids, keys, porg, pdirn, ptmax)
    # overflow soundness: a dropped cluster's packet-entry key >= kept
    # keys[-1]; a lane is exact iff its best t <= that bound
    res = ((count[:, 0] > MAXC_P)[:, None]
           & (bt.reshape(-1, porg.shape[0] // count.shape[0])
              > keys[:, -1][:, None])).reshape(-1)[:n]
    bt, bi = bt[:n], bi[:n]

    def fallback(args):
        bt, bi = args
        fb_t, fb_i = sphere_sweep(ps, org, dirn, jnp.where(res, bt, 0.0))
        win = res & (fb_t < bt)
        return jnp.where(win, fb_t, bt), jnp.where(win, fb_i, bi)

    return jax.lax.cond(vec.any_true(res), fallback, lambda a: a, (bt, bi))


@jax.jit
def _clustered_union_exec(px, py, pz, pr, ids, keys, org, dirn):
    """Fixed-point union-exit over culled slots (see sphere_union_exit)."""
    nb = org.shape[0] // BLOCK
    eps = 1e-4

    def per_packet(xs):
        sid, key, o, d = xs
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        a = dx * dx + dy * dy + dz * dz

        def slot_pass(exit_t, idx, inside):
            def cond(c):
                s, ex, _, _ = c
                ks = key[jnp.minimum(s, MAXC_P - 1)]
                return (s < MAXC_P) & (ks <= jnp.max(ex) + eps)

            def body(c):
                s, ex, ix, ins = c
                cid = sid[s]
                base = jnp.maximum(cid, 0) * CLUSTER_P
                sx = jax.lax.dynamic_slice(px, (base,), (CLUSTER_P,))
                sy = jax.lax.dynamic_slice(py, (base,), (CLUSTER_P,))
                sz = jax.lax.dynamic_slice(pz, (base,), (CLUSTER_P,))
                sr = jax.lax.dynamic_slice(pr, (base,), (CLUSTER_P,))
                ocx = ox - sx[None, :]
                ocy = oy - sy[None, :]
                ocz = oz - sz[None, :]
                b = dx * ocx + dy * ocy + dz * ocz
                c2 = ocx * ocx + ocy * ocy + ocz * ocz - sr[None, :] ** 2
                delta = b * b - a * c2
                sq = jnp.sqrt(jnp.maximum(delta, 0.0))
                t1 = (-b - sq) / a
                t2 = (-b + sq) / a
                ok = (delta >= 0) & (t2 > 0) & (cid >= 0)
                ins = ins | vec.any_true(ok & (t1 < 0), axis=-1)
                straddle = ok & (t1 <= ex[:, None] + eps) \
                    & (t2 > ex[:, None])
                t2m = jnp.where(straddle, t2, -1.0)
                j = jnp.argmax(t2m, axis=-1)
                tj = jnp.take_along_axis(t2m, j[:, None], -1)[:, 0]
                win = tj > ex
                ix = jnp.where(win, base + j.astype(jnp.int32), ix)
                ex = jnp.where(win, tj, ex)
                return s + 1, ex, ix, ins

            _, ex, ix, ins = jax.lax.while_loop(
                cond, body, (0, exit_t, idx, inside))
            return ex, ix, ins

        def outer_cond(c):
            it, changed, *_ = c
            # run to the fixed point: union chains can thread back through
            # earlier slots, needing one pass per link in the worst case
            # (the cap only guards pathological eps-cycles)
            return changed & (it < 64)

        def outer_body(c):
            it, _, ex, ix, ins = c
            ex2, ix2, ins2 = slot_pass(ex, ix, ins)
            return it + 1, vec.any_true(ex2 > ex), ex2, ix2, ins2

        _, _, ex, ix, ins = jax.lax.while_loop(
            outer_cond, outer_body,
            (0, jnp.bool_(True), jnp.zeros((BLOCK,)),
             jnp.full((BLOCK,), -1, jnp.int32), jnp.zeros((BLOCK,), bool)))
        return ex, ix, ins

    B = BLOCK
    ex, ix, ins = jax.lax.map(per_packet, (ids, keys,
                                           org.reshape(nb, B, 3),
                                           dirn.reshape(nb, B, 3)))
    return ex.reshape(-1), ix.reshape(-1), ins.reshape(-1)


def clustered_union_exit(ps: PointSetArrays, org, dirn):
    """Accelerated union-of-spheres exit (transparent fluid walk,
    fluid.cpp:65-171) with brute reroute for overflow-residual lanes."""
    n = org.shape[0]
    big = jnp.full((n,), BIG_T)
    ids, count, keys, porg, pdirn, _ = _cull_spheres(ps, org, dirn, big)
    ex, ix, ins = _clustered_union_exec(ps.px, ps.py, ps.pz, ps.radius,
                                        ids, keys, porg, pdirn)
    blk = porg.shape[0] // count.shape[0]
    res = ((count[:, 0] > MAXC_P)[:, None]
           & (ex.reshape(-1, blk) + 1e-4 >= keys[:, -1][:, None])
           ).reshape(-1)[:n]
    ex, ix, ins = ex[:n], ix[:n], ins[:n]

    def fallback(args):
        ex, ix, ins = args
        f_ex, f_ix, f_ins = sphere_union_exit(ps, org, dirn)
        return (jnp.where(res, f_ex, ex), jnp.where(res, f_ix, ix),
                jnp.where(res, f_ins, ins))

    return jax.lax.cond(vec.any_true(res), fallback, lambda a: a, (ex, ix, ins))


def sphere_sweep(ps: PointSetArrays, org, dirn, t_max, chunk: int = 4096):
    """Closest sphere hit over all points (fluid opaque mode: nearest
    particle sphere, reference fluid.cpp:175-262). Returns (t, index)."""
    n = org.shape[0]
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]
    a = (dx * dx + dy * dy + dz * dz)
    best_t = t_max
    best_i = jnp.full((n,), -1, jnp.int32)
    total = ps.num_points
    for start in range(0, total, chunk):
        sl = slice(start, min(start + chunk, total))
        ocx = ox - ps.px[sl]
        ocy = oy - ps.py[sl]
        ocz = oz - ps.pz[sl]
        b = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - ps.radius[sl] ** 2
        delta = b * b - a * c
        sq = jnp.sqrt(jnp.maximum(delta, 0.0))
        t1 = (-b - sq) / a
        t2 = (-b + sq) / a
        t = jnp.where(t1 > 0, t1, t2)
        ok = (delta >= 0) & (t2 >= 0) & (t > 0)
        t = jnp.where(ok, t, BIG_T)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
        win = tj < best_t
        best_i = jnp.where(win, j.astype(jnp.int32) + start, best_i)
        best_t = jnp.where(win, tj, best_t)
    return best_t, best_i


def sphere_union_exit(ps: PointSetArrays, org, dirn, chunk: int = 4096,
                      iters: int = 12):
    """Exit point of the union of spheres containing the ray origin.

    Wavefront form of the reference's transparent-fluid interval walk
    (fluid.cpp:65-171: collect per-sphere (t1,t2), sort, walk merged
    intervals): instead of a per-lane sort, iterate a monotone fixed point —
    extend the current exit t by any sphere whose interval straddles it.
    Converges to the union-component exit in a few sweeps.

    Returns (t_exit (N,), idx (N,) of the sphere providing the exit,
    inside (N,) bool).
    """
    n = org.shape[0]
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]
    a = dx * dx + dy * dy + dz * dz
    total = ps.num_points

    t_exit = jnp.zeros((n,))
    idx = jnp.full((n,), -1, jnp.int32)
    inside = jnp.zeros((n,), bool)
    eps = 1e-4
    for it in range(iters):
        changed_exit = t_exit
        changed_idx = idx
        for start in range(0, total, chunk):
            sl = slice(start, min(start + chunk, total))
            ocx = ox - ps.px[sl]
            ocy = oy - ps.py[sl]
            ocz = oz - ps.pz[sl]
            b = dx * ocx + dy * ocy + dz * ocz
            c = ocx * ocx + ocy * ocy + ocz * ocz - ps.radius[sl] ** 2
            delta = b * b - a * c
            sq = jnp.sqrt(jnp.maximum(delta, 0.0))
            t1 = (-b - sq) / a
            t2 = (-b + sq) / a
            ok = (delta >= 0) & (t2 > 0)
            if it == 0:
                inside = inside | vec.any_true(ok & (t1 < 0), axis=-1)
            # spheres whose interval straddles the current exit extend it
            straddle = ok & (t1 <= (changed_exit[:, None] + eps)) \
                & (t2 > changed_exit[:, None])
            t2m = jnp.where(straddle, t2, -1.0)
            j = jnp.argmax(t2m, axis=-1)
            tj = jnp.take_along_axis(t2m, j[:, None], -1)[:, 0]
            win = tj > changed_exit
            changed_idx = jnp.where(win, j.astype(jnp.int32) + start,
                                    changed_idx)
            changed_exit = jnp.where(win, tj, changed_exit)
        t_exit = changed_exit
        idx = changed_idx
    return t_exit, idx, inside


def fluid_pointset(particles, obj_row=0, radius=0.5,
                   color=(0.4, 0.6, 0.9), clustered=None) -> PointSetArrays:
    """Fluid-frame particles as a renderable sphere set (the reference
    displays Fluid via its particle spheres, fluid.cpp:628-635).

    Beyond CLUSTERED_MIN particles the Morton particle-cluster tier is
    built (the accel-grid counterpart, fluid.cpp:36-62); pass
    `clustered=True/False` to force either path."""
    p = np.asarray(particles, np.float32)
    n = len(p)
    col = np.broadcast_to(np.asarray(color, np.float32), (n, 3)).copy()
    radii = np.full((n,), radius, np.float32)
    normals = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    if clustered is None:
        clustered = n >= CLUSTERED_MIN
    extra = {}
    if clustered and n:
        p, radii, normals, col, lo, hi = _cluster_particles(
            p, radii, normals, col)
        extra = dict(
            c_lox=jnp.asarray(lo[:, 0]), c_loy=jnp.asarray(lo[:, 1]),
            c_loz=jnp.asarray(lo[:, 2]), c_hix=jnp.asarray(hi[:, 0]),
            c_hiy=jnp.asarray(hi[:, 1]), c_hiz=jnp.asarray(hi[:, 2]),
            n_clusters=len(lo))
    m = len(p)
    return PointSetArrays(
        px=jnp.asarray(p[:, 0]), py=jnp.asarray(p[:, 1]),
        pz=jnp.asarray(p[:, 2]),
        nx=jnp.asarray(normals[:, 0]), ny=jnp.asarray(normals[:, 1]),
        nz=jnp.asarray(normals[:, 2]),
        radius=jnp.asarray(radii),
        colors=jnp.asarray(col), obj_row=int(obj_row), as_spheres=True,
        **extra)


def disk_sweep(ps: PointSetArrays, org, dirn, t_max, chunk: int = 4096):
    """Closest disk hit: (t, point index, rim flag). Dense chunked sweep.

    Disk test (reference Disk::intersection, Geometry.h:1106-1122): plane
    hit then |P-c|^2 <= r^2; rim when > (0.95 r)^2 (PointSet.cpp:211-215).
    """
    n = org.shape[0]
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]
    best_t = t_max
    best_i = jnp.full((n,), -1, jnp.int32)
    total = ps.num_points
    for start in range(0, total, chunk):
        sl = slice(start, min(start + chunk, total))
        cx, cy, cz = ps.px[sl], ps.py[sl], ps.pz[sl]
        nx, ny, nz = ps.nx[sl], ps.ny[sl], ps.nz[sl]
        dn = dx * nx + dy * ny + dz * nz
        t = ((cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz) / dn
        hx = ox + t * dx - cx
        hy = oy + t * dy - cy
        hz = oz + t * dz - cz
        r2 = hx * hx + hy * hy + hz * hz
        ok = (t > 0.0) & (r2 <= ps.radius[sl] ** 2) & ~jnp.isnan(t)
        t = jnp.where(ok, t, BIG_T)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
        win = tj < best_t
        best_i = jnp.where(win, j.astype(jnp.int32) + start, best_i)
        best_t = jnp.where(win, tj, best_t)
    return best_t, best_i
