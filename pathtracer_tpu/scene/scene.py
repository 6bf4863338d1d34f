"""Scene as a pytree of SoA arrays + dense vectorized intersection.

JAX counterpart of the reference Scene/Object layer (reference:
Geometry.h:240-728 Object, :849-1103 Sphere, :1127-1217 Plane,
:1238-1400 + Geometry.cpp:589-744 Scene intersection dispatch).

Design: instead of a virtual-dispatch loop over heterogeneous objects, all
analytic objects live in one fixed-size SoA table; a ray intersects *every*
object in one fused vectorized sweep ((N rays) x (O objects) candidate-t
matrix, masked argmin).  O is small (analytic objects); triangle meshes are
handled separately by the BVH kernels (ops/).

Layout: the wavefront dimension N stays the leading axis and no rank-3
(N, small, small) temporaries are materialized; transform math is written
per-coordinate on (N,) / (N,O) planes.

Object slots follow the reference convention (Raytracer.cpp:1238-1274):
row 0 = spherical light, row 1 = environment dome (flipped-normal giant
sphere), row 2+ = user objects.

Transforms: every object carries 3x4 trans/inv_trans and 3x3 rot matrices
(reference: Geometry.h:322-396) built host-side per frame from keyframes;
rays are intersected in object space and hits mapped back, identically to
Scene::intersection (Geometry.cpp:589-688).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from ..core import vec

# object type tags
SPHERE = 0
PLANE = 1
MESH = 2       # row is transform/flags holder; geometry in SceneArrays.meshes
POINTSET = 3   # row is transform/flags holder; geometry in .pointsets

BIG_T = np.float32(1e30)   # numpy: no backend init at import


@struct.dataclass
class SceneArrays:
    """Device-side scene: SoA over O analytic objects + global light/env.

    A struct dataclass (utils/struct.py): array fields are traced leaves,
    `identity_transform` is static metadata (it selects the cheap transform
    path at trace time).  Use `.replace(...)` for functional updates.
    """

    obj_type: jnp.ndarray      # (O,) int32
    center: jnp.ndarray        # (O,3) sphere center / plane point A
    radius: jnp.ndarray        # (O,) sphere radius
    normal: jnp.ndarray        # (O,3) plane normal (unit)
    flip_normals: jnp.ndarray  # (O,) bool
    # constant material channels (reference defaults Geometry.h:399-445)
    kd: jnp.ndarray            # (O,3)
    ks: jnp.ndarray            # (O,3)
    ne: jnp.ndarray            # (O,3) phong exponent per channel
    ksub: jnp.ndarray          # (O,3)
    transp: jnp.ndarray        # (O,) bool
    refr_index: jnp.ndarray    # (O,)
    miroir: jnp.ndarray        # (O,) bool
    ghost: jnp.ndarray         # (O,) bool
    # transforms (reference: Geometry.h:322-396); flattened row-major 12/9
    trans: jnp.ndarray         # (O,12)
    inv_trans: jnp.ndarray     # (O,12)
    rot: jnp.ndarray           # (O,9)
    # static: all transforms identity rotation/scale (translation only)?
    identity_transform: bool = struct.field(pytree_node=False)
    # light / environment
    light_intensity: jnp.ndarray   # scalar: s.intensite_lumiere
    light_scale: jnp.ndarray       # scalar: light keyframe scale
    envmap_intensity: jnp.ndarray  # scalar
    envmap: Optional[jnp.ndarray]  # (He,We,3) f32 dome radiance texture or None
    # cached light constants (prepare_render, Raytracer.cpp:1377-1380)
    center_light: jnp.ndarray      # (3,)
    radius_light: jnp.ndarray      # scalar
    # fog (reference: Geometry.h:1371-1377 scene params, Raytracer.cpp:44-192)
    fog_density: jnp.ndarray = None        # scalar
    fog_absorption: jnp.ndarray = None
    fog_density_decay: jnp.ndarray = None
    fog_absorption_decay: jnp.ndarray = None
    phase_aniso: jnp.ndarray = None        # Schlick k
    ground_level: jnp.ndarray = None       # objects[2] translation y
    fog_enabled: bool = struct.field(pytree_node=False, default=False)
    fog_type: int = struct.field(pytree_node=False, default=0)
    fog_phase_type: int = struct.field(pytree_node=False, default=0)
    # subsurface scattering compiled in? (any object with Ksub > 0)
    ss_enabled: bool = struct.field(pytree_node=False, default=False)
    # per-object: is the subsurface reservoir probe supported on this row?
    # False only for mesh/pointset/yarn rows without a reservoir path —
    # the integrator masks the SS entry RR there so the estimator stays
    # unbiased (None = all rows supported)
    ss_obj_ok: jnp.ndarray = None          # (O,) bool
    # ghost compositing objects present?
    ghost_enabled: bool = struct.field(pytree_node=False, default=False)
    # measured BRDFs: per-object selector (0 = Phong, k+1 = table k) + tables
    brdf_type: jnp.ndarray = None          # (O,) int32
    measured_brdfs: tuple = ()
    # background photo for compositing, already gamma-linearized and scaled
    # by 196964.699 (reference: Geometry.h:1355-1362); None when unset
    background: Optional[jnp.ndarray] = None   # (Hb,Wb,3)
    # triangle meshes, each bound to an object row (empty tuple if none)
    meshes: tuple = ()
    # point sets (disk splats), each bound to an object row
    pointsets: tuple = ()
    # yarn cylinder sets, each bound to an object row
    yarns: tuple = ()
    # per-analytic-object texture channels (GroupTextures or None per row);
    # spheres sample spherical UV (Geometry.h:979-984), planes 0.1*(x,z)
    # (Geometry.h:1152-1154)
    obj_textures: tuple = ()

    @property
    def num_objects(self):
        return self.obj_type.shape[0]

    @property
    def light_power(self):
        """lightPower = intensite_lumiere / scale^2 (Raytracer.cpp:1380)."""
        return self.light_intensity / (self.light_scale * self.light_scale)


class Hit(NamedTuple):
    """Per-ray hit record (the reference's (P, sphere_id, t, mat) out-params)."""

    hit: jnp.ndarray        # (N,) bool
    t: jnp.ndarray          # (N,)
    p: jnp.ndarray          # (N,3) world-space point
    n: jnp.ndarray          # (N,3) unit shading normal
    obj_id: jnp.ndarray     # (N,) int32
    kd: jnp.ndarray         # (N,3)
    ks: jnp.ndarray         # (N,3)
    ne: jnp.ndarray         # (N,3)
    ke: jnp.ndarray         # (N,3)
    ksub: jnp.ndarray       # (N,3)
    transp: jnp.ndarray     # (N,) bool
    refr_index: jnp.ndarray  # (N,)
    miroir: jnp.ndarray     # (N,) bool
    ghost: jnp.ndarray      # (N,) bool
    brdf_type: jnp.ndarray  # (N,) int32: 0=Phong, k+1=measured table k
    # surface-locality key for the wavefront's secondary-ray sort: mesh
    # hits carry a triangle-range bucket (BVH order, at most 8192 buckets
    # per mesh), analytic hits their object row.  Sorting bounce rays by
    # (direction octant, lkey) keeps neighbouring lanes on one surface
    # patch.
    lkey: jnp.ndarray = None   # (N,) int32 in [0, 8191]


def _local_ray(sc: SceneArrays, origins, dirs):
    """Map rays into every object's space (Geometry.cpp:606-608).

    Returns per-coordinate (N,O) planes (ox, oy, oz), (dx, dy, dz).
    With identity transforms this is a cheap broadcast subtract.
    """
    ox, oy, oz = origins[:, 0:1], origins[:, 1:2], origins[:, 2:3]  # (N,1)
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    m = sc.inv_trans  # (O,12) rows: [r00 r01 r02 t0 r10 r11 r12 t1 ...]
    if sc.identity_transform:
        lox = ox + m[:, 3]
        loy = oy + m[:, 7]
        loz = oz + m[:, 11]
        return (lox, loy, loz), (dx + 0.0 * m[:, 0], dy + 0.0 * m[:, 0],
                                 dz + 0.0 * m[:, 0])
    lox = m[:, 0] * ox + m[:, 1] * oy + m[:, 2] * oz + m[:, 3]
    loy = m[:, 4] * ox + m[:, 5] * oy + m[:, 6] * oz + m[:, 7]
    loz = m[:, 8] * ox + m[:, 9] * oy + m[:, 10] * oz + m[:, 11]
    ldx = m[:, 0] * dx + m[:, 1] * dy + m[:, 2] * dz
    ldy = m[:, 4] * dx + m[:, 5] * dy + m[:, 6] * dz
    ldz = m[:, 8] * dx + m[:, 9] * dy + m[:, 10] * dz
    return (lox, loy, loz), (ldx, ldy, ldz)


def _candidate_ts(sc: SceneArrays, origins, dirs, avoid_ghosts=False):
    """All candidate hit distances: (N, O) with BIG_T for misses.

    Sphere quadric per (ray, object) (reference: Geometry.h:918-992 —
    smallest positive root, far root if inside, direction may be non-unit
    under object scaling) and plane hit (Geometry.h:1142-1157), selected by
    obj_type, all on per-coordinate (N,O) planes.
    """
    (lox, loy, loz), (ldx, ldy, ldz) = _local_ray(sc, origins, dirs)

    # sphere: oc = org - center
    ocx = lox - sc.center[:, 0]
    ocy = loy - sc.center[:, 1]
    ocz = loz - sc.center[:, 2]
    b = ldx * ocx + ldy * ocy + ldz * ocz
    a = ldx * ldx + ldy * ldy + ldz * ldz
    c = ocx * ocx + ocy * ocy + ocz * ocz - sc.radius * sc.radius
    delta = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    inva = 1.0 / a
    t2 = (-b + sq) * inva
    t1 = (-b - sq) * inva
    t_sph = jnp.where(t1 > 0.0, t1, t2)
    ok_sph = (delta >= 0.0) & (t2 >= 0.0) & (t_sph > 0.0)

    # plane
    nx, ny, nz = sc.normal[:, 0], sc.normal[:, 1], sc.normal[:, 2]
    ddot = ldx * nx + ldy * ny + ldz * nz
    safe = jnp.abs(ddot) >= 1e-9
    tnum = ((sc.center[:, 0] - lox) * nx + (sc.center[:, 1] - loy) * ny
            + (sc.center[:, 2] - loz) * nz)
    t_pl = tnum / jnp.where(safe, ddot, 1.0)
    ok_pl = safe & (t_pl > 0.0)

    is_sphere = sc.obj_type == SPHERE
    is_plane = sc.obj_type == PLANE
    t = jnp.where(is_sphere & ok_sph, t_sph,
                  jnp.where(is_plane & ok_pl, t_pl, BIG_T))
    if avoid_ghosts:
        t = jnp.where(sc.ghost, BIG_T, t)
    return t, (lox, loy, loz), (ldx, ldy, ldz)


def _envmap_ke(sc: SceneArrays, nx, ny, nz):
    """Dome radiance lookup (reference: Geometry.h:963-977).

    theta = 1 - acos(N.y)/pi; phi = (atan2(-N.z, N.x) + pi) / 2pi;
    Ke = tex[theta*(H-1), phi*(W-1)] * 100000/255.  n must be unit.
    """
    if sc.envmap is None:
        return None
    eh, ew = sc.envmap.shape[0], sc.envmap.shape[1]
    theta = 1.0 - jnp.arccos(jnp.clip(ny, -1.0, 1.0)) / np.pi
    phi = (jnp.arctan2(-nz, nx) + np.pi) / (2.0 * np.pi)
    ti = jnp.clip((theta * (eh - 1)).astype(jnp.int32), 0, eh - 1)
    pi_ = jnp.clip((phi * (ew - 1)).astype(jnp.int32), 0, ew - 1)
    return sc.envmap[ti, pi_] * jnp.float32(100000.0 / 255.0)


def _sel_table(table, obj_id, num_objects):
    """Row lookup by per-lane object id as a SELECT CHAIN, not a gather.

    O is tiny (analytic objects), so O-1 vectorized selects stand in for
    a per-lane gather."""
    out = jnp.broadcast_to(table[0], obj_id.shape + table.shape[1:]
                           if table.ndim > 1 else obj_id.shape)
    for o in range(1, num_objects):
        mask = obj_id == o
        if table.ndim > 1:
            mask = mask[:, None]
        out = jnp.where(mask, table[o], out)
    return out


def _sel_cols(planes, obj_id, num_objects):
    """Select per-lane column of an (N,O) plane by object id (select chain)."""
    out = planes[:, 0]
    for o in range(1, num_objects):
        out = jnp.where(obj_id == o, planes[:, o], out)
    return out


def intersect(sc: SceneArrays, origins, dirs, avoid_ghosts=False) -> Hit:
    """Closest-hit over all analytic objects (Geometry.cpp:589-688).

    origins/dirs: (N,3).  Fully vectorized: one (N,O) candidate matrix,
    masked argmin, then select-chain extraction — no per-object control
    flow, no rank-3 temporaries, no gathers (module docstring).
    """
    t_all, (lox, loy, loz), (ldx, ldy, ldz) = _candidate_ts(
        sc, origins, dirs, avoid_ghosts)
    no = sc.num_objects
    obj_id = jnp.argmin(t_all, axis=-1).astype(jnp.int32)     # (N,)
    t = jnp.min(t_all, axis=-1)
    hit = t < BIG_T

    def take(m):  # winning object's plane value -> (N,)
        return _sel_cols(m, obj_id, no)

    def row(tbl):  # winning object's table row
        return _sel_table(tbl, obj_id, no)

    # object-space hit point
    px = take(lox) + t * take(ldx)
    py = take(loy) + t * take(ldy)
    pz = take(loz) + t * take(ldz)

    is_sphere = row(sc.obj_type) == SPHERE
    cen = row(sc.center)
    nrm_o = row(sc.normal)
    nlx = jnp.where(is_sphere, px - cen[:, 0], nrm_o[:, 0])
    nly = jnp.where(is_sphere, py - cen[:, 1], nrm_o[:, 1])
    nlz = jnp.where(is_sphere, pz - cen[:, 2], nrm_o[:, 2])
    sgn = jnp.where(row(sc.flip_normals), -1.0, 1.0)
    nlx, nly, nlz = sgn * nlx, sgn * nly, sgn * nlz

    # back to world space (Geometry.cpp:677-684)
    if sc.identity_transform:
        tr3 = row(sc.trans)
        p = jnp.stack([px + tr3[:, 3], py + tr3[:, 7], pz + tr3[:, 11]],
                      axis=-1)
        n = jnp.stack([nlx, nly, nlz], axis=-1)
    else:
        tm = row(sc.trans)
        p = jnp.stack([
            tm[:, 0] * px + tm[:, 1] * py + tm[:, 2] * pz + tm[:, 3],
            tm[:, 4] * px + tm[:, 5] * py + tm[:, 6] * pz + tm[:, 7],
            tm[:, 8] * px + tm[:, 9] * py + tm[:, 10] * pz + tm[:, 11],
        ], axis=-1)
        rm = row(sc.rot)
        n = jnp.stack([
            rm[:, 0] * nlx + rm[:, 1] * nly + rm[:, 2] * nlz,
            rm[:, 3] * nlx + rm[:, 4] * nly + rm[:, 5] * nlz,
            rm[:, 6] * nlx + rm[:, 7] * nly + rm[:, 8] * nlz,
        ], axis=-1)
    n = vec.normalize(n)

    # dome radiance: only object 1 carries the envmap (Raytracer.cpp:1258)
    if sc.envmap is not None:
        inv_len = 1.0 / jnp.sqrt(jnp.maximum(
            nlx * nlx + nly * nly + nlz * nlz, 1e-20))
        # the lookup uses the OUTWARD geometric normal N = P - O *before*
        # the flip (Geometry.h:965-971); nl carries sgn, so undo it
        ke_env = _envmap_ke(sc, sgn * nlx * inv_len, sgn * nly * inv_len,
                            sgn * nlz * inv_len)
        ke = jnp.where((obj_id == 1)[:, None], ke_env, 0.0)
    else:
        ke = jnp.zeros_like(p)

    out = Hit(
        hit=hit, t=t, p=p, n=n, obj_id=obj_id,
        kd=row(sc.kd), ks=row(sc.ks), ne=row(sc.ne), ke=ke,
        ksub=row(sc.ksub), transp=row(sc.transp) & hit,
        refr_index=row(sc.refr_index),
        miroir=row(sc.miroir) & hit, ghost=row(sc.ghost) & hit,
        brdf_type=row(sc.brdf_type),
        lkey=obj_id,
    )

    # analytic-object texture channels: constant material x image, sphere
    # spherical UV / plane 0.1*(x,z) (queryMaterial, Geometry.h:399-445;
    # UVs Geometry.h:979-984, 1152-1154).  Static loop over the few
    # textured rows; local-frame P and the pre-flip outward normal are
    # still in scope here.
    for o, gt in enumerate(sc.obj_textures):
        if gt is None or not gt.any_image:
            continue
        from ..models import texture as tex_mod
        m = (obj_id == o) & hit
        # sphere UV uses the outward geometric normal BEFORE flip_normals
        inv_len = 1.0 / jnp.sqrt(jnp.maximum(
            nlx * nlx + nly * nly + nlz * nlz, 1e-20))
        nx_o, ny_o, nz_o = (sgn * nlx * inv_len, sgn * nly * inv_len,
                            sgn * nlz * inv_len)
        u_sph = 1.0 - jnp.arccos(jnp.clip(ny_o, -1.0, 1.0)) / np.pi
        v_sph = (jnp.arctan2(-nz_o, nx_o) + np.pi) / (2.0 * np.pi)
        u = jnp.where(is_sphere, u_sph, px * 0.1)
        v = jnp.where(is_sphere, v_sph, pz * 0.1)
        def _ov(field, img, mult):
            val = tex_mod.sample_point(img, u, v) * mult
            return jnp.where(m[:, None], val, field)
        if gt.kd is not None:
            out = out._replace(kd=_ov(out.kd, gt.kd, sc.kd[o]))
        if gt.ks is not None:
            out = out._replace(ks=_ov(out.ks, gt.ks, sc.ks[o]))
        if gt.roughness is not None:
            out = out._replace(ne=_ov(out.ne, gt.roughness, sc.ne[o]))
        if gt.ksub is not None:
            out = out._replace(ksub=_ov(out.ksub, gt.ksub, sc.ksub[o]))
        if gt.transp is not None:
            # getBool: red * multiplier < 0.5 is transparent; the constant
            # multiplier encodes the flag as 0 (transp) / 1 (opaque)
            tmult = jnp.where(sc.transp[o], 0.0, 1.0)
            tval = tex_mod.sample_red(gt.transp, u, v) * tmult < 0.5
            out = out._replace(transp=jnp.where(m, tval, out.transp))
        if gt.refr is not None:
            rval = tex_mod.sample_red(gt.refr, u, v) * sc.refr_index[o]
            out = out._replace(
                refr_index=jnp.where(m, rval, out.refr_index))

    for mesh in sc.meshes:
        out = _merge_mesh_hit(sc, mesh, origins, dirs, out, avoid_ghosts)
    for ps in sc.pointsets:
        out = _merge_pointset_hit(sc, ps, origins, dirs, out, avoid_ghosts)
    for ya in sc.yarns:
        out = _merge_yarn_hit(sc, ya, origins, dirs, out, avoid_ghosts)
    return out


def _merge_yarn_hit(sc: SceneArrays, ya, origins, dirs, cur: Hit,
                    avoid_ghosts: bool) -> Hit:
    """Yarn cylinder closest hit (reference: Yarns::intersection via
    Cylinder, TriangleMesh.h:292-299, Geometry.h:731-846)."""
    from . import yarns as yarn_mod

    row = ya.obj_row
    org_l, dir_l = _local_ray_row(sc, row, origins, dirs)
    t_y, idx, s_ax = yarn_mod.cylinder_sweep(ya, org_l, dir_l, cur.t)
    win = t_y < cur.t
    if avoid_ghosts:
        win = win & ~sc.ghost[row]
    i = jnp.maximum(idx, 0)
    a = jnp.stack([ya.ax[i], ya.ay[i], ya.az[i]], axis=-1)
    u = jnp.stack([ya.ux[i], ya.uy[i], ya.uz[i]], axis=-1)
    p_l = org_l + t_y[:, None] * dir_l
    n_l = vec.normalize(p_l - a - s_ax[:, None] * u)
    n_l = jnp.where(sc.flip_normals[row], -n_l, n_l)

    if sc.identity_transform:
        tr3 = sc.trans[row]
        p_w = p_l + jnp.stack([tr3[3], tr3[7], tr3[11]])
        n_w = n_l
    else:
        tr = sc.trans[row].reshape(3, 4)
        p_w = _mm(p_l, tr[:, :3].T) + tr[:, 3]
        n_w = vec.normalize(_mm(n_l, sc.rot[row].reshape(3, 3).T))

    def sel(new, old):
        m = win[..., None] if new.ndim > win.ndim else win
        return jnp.where(m, new, old)

    kd3 = jnp.broadcast_to(sc.kd[row], p_w.shape)
    return cur._replace(
        hit=cur.hit | win,
        t=jnp.where(win, t_y, cur.t),
        p=sel(p_w, cur.p),
        n=sel(n_w, cur.n),
        obj_id=jnp.where(win, jnp.int32(row), cur.obj_id),
        kd=sel(kd3, cur.kd),
        ks=sel(jnp.broadcast_to(sc.ks[row], p_w.shape), cur.ks),
        ne=sel(jnp.broadcast_to(sc.ne[row], p_w.shape), cur.ne),
        ksub=sel(jnp.broadcast_to(sc.ksub[row], p_w.shape), cur.ksub),
        transp=jnp.where(win, sc.transp[row], cur.transp),
        refr_index=jnp.where(win, sc.refr_index[row], cur.refr_index),
        miroir=jnp.where(win, sc.miroir[row], cur.miroir),
        ghost=jnp.where(win, sc.ghost[row], cur.ghost),
        brdf_type=jnp.where(win, sc.brdf_type[row], cur.brdf_type),
        lkey=jnp.where(win, jnp.int32(row), cur.lkey),
    )


def _merge_pointset_hit(sc: SceneArrays, ps, origins, dirs, cur: Hit,
                        avoid_ghosts: bool) -> Hit:
    """Disk-splat closest hit folded into the running hit (reference:
    PointSet::intersection, PointSet.cpp:124-244): two-sided disk normal
    flipped toward the ray, per-point color as Kd, rim darkening when
    display_edges."""
    from . import pointset as ps_mod

    row = ps.obj_row
    org_l, dir_l = _local_ray_row(sc, row, origins, dirs)
    if ps.as_spheres:
        if ps.n_clusters:
            t_ps, idx = ps_mod.clustered_sphere_sweep(ps, org_l, dir_l,
                                                      cur.t)
        else:
            t_ps, idx = ps_mod.sphere_sweep(ps, org_l, dir_l, cur.t)
        # transparent fluid: rays starting inside the particle union exit
        # at the union boundary (the reference's interval-union walk,
        # fluid.cpp:65-171) so refraction happens at entry and exit only
        if ps.transparent:
            if ps.n_clusters:
                t_u, idx_u, inside = ps_mod.clustered_union_exit(
                    ps, org_l, dir_l)
            else:
                t_u, idx_u, inside = ps_mod.sphere_union_exit(ps, org_l,
                                                              dir_l)
            use_u = inside & (t_u < cur.t) & (t_u > 0)
            t_ps = jnp.where(use_u, t_u, t_ps)
            idx = jnp.where(use_u, idx_u, idx)
    else:
        t_ps, idx = ps_mod.disk_sweep(ps, org_l, dir_l, cur.t)
    win = t_ps < cur.t
    if avoid_ghosts:
        win = win & ~sc.ghost[row]
    i = jnp.maximum(idx, 0)

    p_l = org_l + t_ps[:, None] * dir_l
    if ps.as_spheres:
        cen = jnp.stack([ps.px[i], ps.py[i], ps.pz[i]], axis=-1)
        n_l = vec.normalize(p_l - cen)
    else:
        n_l = jnp.stack([ps.nx[i], ps.ny[i], ps.nz[i]], axis=-1)
        # two-sided shading (PointSet.cpp:205) + flip_normals
        facing = jnp.sum(n_l * dir_l, axis=-1) > 0.0
        n_l = jnp.where(facing[:, None], -n_l, n_l)
    n_l = jnp.where(sc.flip_normals[row], -n_l, n_l)
    kd = ps.colors[i]
    if ps.display_edges:
        cen = jnp.stack([ps.px[i], ps.py[i], ps.pz[i]], axis=-1)
        r2 = jnp.sum((p_l - cen) ** 2, axis=-1)
        rim = r2 > (ps.radius[i] * 0.95) ** 2
        kd = jnp.where(rim[:, None], 0.0, kd)

    if sc.identity_transform:
        tr3 = sc.trans[row]
        p_w = p_l + jnp.stack([tr3[3], tr3[7], tr3[11]])
        n_w = n_l
    else:
        tr = sc.trans[row].reshape(3, 4)
        p_w = _mm(p_l, tr[:, :3].T) + tr[:, 3]
        n_w = vec.normalize(_mm(n_l, sc.rot[row].reshape(3, 3).T))

    def sel(new, old):
        m = win[..., None] if new.ndim > win.ndim else win
        return jnp.where(m, new, old)

    return cur._replace(
        hit=cur.hit | win,
        t=jnp.where(win, t_ps, cur.t),
        p=sel(p_w, cur.p),
        n=sel(n_w, cur.n),
        obj_id=jnp.where(win, jnp.int32(row), cur.obj_id),
        kd=sel(kd, cur.kd),
        ks=sel(jnp.broadcast_to(sc.ks[row], kd.shape), cur.ks),
        ne=sel(jnp.broadcast_to(sc.ne[row], kd.shape), cur.ne),
        ksub=sel(jnp.broadcast_to(sc.ksub[row], kd.shape), cur.ksub),
        transp=jnp.where(win, sc.transp[row], cur.transp),
        refr_index=jnp.where(win, sc.refr_index[row], cur.refr_index),
        miroir=jnp.where(win, sc.miroir[row], cur.miroir),
        ghost=jnp.where(win, sc.ghost[row], cur.ghost),
        brdf_type=jnp.where(win, sc.brdf_type[row], cur.brdf_type),
        lkey=jnp.where(win, jnp.int32(row), cur.lkey),
    )


def _mm(x, m):
    """(N,3) x (3,3) transform product at full float32 precision (a GPU
    would otherwise run it in TF32 and move hit points enough to flip
    visibility against the CPU reference)."""
    return jnp.matmul(x, m, precision=jax.lax.Precision.HIGHEST)


def _local_ray_row(sc: SceneArrays, row: int, origins, dirs):
    """Map rays into one object row's space (static row)."""
    m = sc.inv_trans[row]                     # (12,)
    if sc.identity_transform:
        org_l = origins + jnp.stack([m[3], m[7], m[11]])
        return org_l, dirs
    rotm = m.reshape(3, 4)
    org_l = _mm(origins, rotm[:, :3].T) + rotm[:, 3]
    dir_l = _mm(dirs, rotm[:, :3].T)
    return org_l, dir_l


def _shade_fetch(mesh, tri):
    """Per-triangle shading attributes as ONE packed row gather (one
    (T, C) row per lane instead of one gather per attribute table).
    Returns {} when the mesh has no pack."""
    if getattr(mesh, 'shade_pack', None) is None:
        return {}
    rows = mesh.shade_pack[tri]
    return {name: rows[:, s:s + w] for name, s, w in mesh.shade_cols}


def _kernel_bary(mesh, org_l, dir_l, t, tri):
    """Winner barycentrics from the kernel tier's triangle rows (the
    kernel returns (t, tri) only): one ktris row gather and the
    edge-matrix formula of traverse._tri_test_block."""
    bb = mesh.ktris[jnp.maximum(tri, 0)]   # TriSoup field order
    p_b = org_l + t[:, None] * dir_l
    pxv = p_b - bb[:, 0:3]
    b11 = jnp.sum(pxv * bb[:, 3:6], axis=-1)
    b21 = jnp.sum(pxv * bb[:, 6:9], axis=-1)
    be = (b11 * bb[:, 14] - b21 * bb[:, 13]) * bb[:, 15]
    ga = (b21 * bb[:, 12] - b11 * bb[:, 13]) * bb[:, 15]
    hitl = tri >= 0
    be = jnp.where(hitl, be, 0.0)
    ga = jnp.where(hitl, ga, 0.0)
    return 1.0 - be - ga, be, ga


def _mesh_uv(mesh, tri, al, be, ga, sf=None):
    """Interpolated texture coordinates (TriangleMesh.cpp:930-931)."""
    if sf is not None and 'uv0' in sf:
        uv = (sf['uv0'] * al[:, None] + sf['uv1'] * be[:, None]
              + sf['uv2'] * ga[:, None])
    else:
        uv = (mesh.uv0[tri] * al[:, None] + mesh.uv1[tri] * be[:, None]
              + mesh.uv2[tri] * ga[:, None])
    return uv[:, 0], uv[:, 1]


def _shade_grp(mesh, tri, sf):
    """Winning triangle's material group (0 when the mesh has one group)."""
    if 'grp' in sf:
        return sf['grp'][:, 0].view(jnp.int32)
    if getattr(mesh, 'shade_pack', None) is not None:
        return jnp.zeros(tri.shape, jnp.int32)   # single-group mesh
    return mesh.group[tri]


def _mesh_alpha(mesh, mh):
    """Per-lane alpha-map red value; 1.0 where no map (TriangleMesh.cpp:1199-1205)."""
    from ..models import texture as tex_mod

    tri = jnp.maximum(mh.tri, 0)
    al, be, ga = mh.alpha, mh.beta, mh.gamma
    sf = _shade_fetch(mesh, tri)
    u, v = _mesh_uv(mesh, tri, al, be, ga, sf)
    grp = _shade_grp(mesh, tri, sf)
    aval = jnp.ones_like(mh.t)
    atl = dict(zip(tex_mod.CHANNELS, mesh.atlases)) if mesh.atlases else {}
    if atl.get('alpha') is not None:
        val, has = tex_mod.sample_atlas(atl['alpha'], grp, u, v,
                                        mesh.bilinear)
        return jnp.where(has, val[:, 0], aval)
    samp = (tex_mod.sample_bilinear if mesh.bilinear
            else tex_mod.sample_point)
    for g, gt in enumerate(mesh.textures):
        if gt.alpha is not None:
            aval = jnp.where(grp == g, samp(gt.alpha, u, v)[..., 0],
                             aval)
    return aval


def _mesh_closest_hit(mesh, org_l, dir_l, t_max, cutout_rounds=None,
                      t_min=None):
    """Closest hit honoring alpha cutouts: re-intersect past texels with
    alpha < 0.5, up to cutout_rounds skips (the reference skips them inside
    the leaf loop, TriangleMesh.cpp:1199-1205; the wavefront equivalent is
    iterative re-intersection with a rising t floor).

    t_min: optional per-lane strict lower bound (the reservoir march's
    rising floor).

    cutout_rounds defaults to the mesh's own cutout_rounds (upload_mesh
    option; the reference's in-leaf skip is unbounded — raise it for
    scenes stacking >4 cutout texels along one ray)."""
    from ..ops import traverse

    if cutout_rounds is None:
        cutout_rounds = getattr(mesh, 'cutout_rounds', 4)
    has_alpha = any(gt.alpha is not None for gt in mesh.textures)

    def one_hit(t_min):
        if mesh.tier == 'kernel':
            from ..ops import bvh_kernel
            t, tri = bvh_kernel.kernel_hit(
                mesh.kroot, mesh.knodes, mesh.ktris, org_l, dir_l, t_max,
                t_min, max_leaf=mesh.max_leaf, depth=mesh.bvh_depth,
                interpret=mesh.kernel_interpret)
            al, be, ga = _kernel_bary(mesh, org_l, dir_l, t, tri)
            return traverse.MeshHit(t=t, tri=tri, alpha=al, beta=be,
                                    gamma=ga)
        if mesh.tier == 'brute':
            return traverse.brute_force_hit(mesh.soup, org_l, dir_l,
                                            t_max=t_max, t_min=t_min)
        return traverse.bvh_hit(mesh.bvh, mesh.soup, org_l, dir_l,
                                max_leaf=mesh.max_leaf, t_init=t_max,
                                t_min=t_min)

    if not has_alpha:
        return one_hit(t_min)

    n = org_l.shape[0]
    acc = traverse.MeshHit(t=jnp.full((n,), traverse.BIG_T),
                           tri=jnp.full((n,), -1, jnp.int32),
                           alpha=jnp.ones((n,)), beta=jnp.zeros((n,)),
                           gamma=jnp.zeros((n,)))
    done = jnp.zeros((n,), bool)
    t_floor = (jnp.full((n,), -1.0) if t_min is None
               else jnp.broadcast_to(t_min, (n,)))
    for _ in range(cutout_rounds):
        mh = one_hit(t_floor)
        found = mh.t < t_max
        aval = _mesh_alpha(mesh, mh)
        cutout = found & (aval < 0.5) & ~done
        accept = ~done & ~cutout
        acc = traverse.MeshHit(*[jnp.where(accept, new, old)
                                 for new, old in zip(mh, acc)])
        done = done | accept
        t_floor = jnp.where(cutout, mh.t, t_floor)
    return acc


def _merge_mesh_hit(sc: SceneArrays, mesh, origins, dirs, cur: Hit,
                    avoid_ghosts: bool) -> Hit:
    """Intersect one mesh and fold the result into the running closest hit.

    The reference does this via Embree instancing of each TriMesh with its
    3x4 transform (Geometry.cpp:627-674) then getMaterial for the winning
    triangle (TriangleMesh.cpp:919-1026); here the mesh hit prunes against
    the current best t and the material interpolation is vectorized.
    """
    from ..models import texture as tex_mod

    row = mesh.obj_row
    if mesh.world_space:
        # merged multi-mesh: triangles baked to world space (one BVH for
        # several source objects); per-lane object state recovers by
        # group -> source-row gather below
        org_l, dir_l = origins, dirs
    else:
        org_l, dir_l = _local_ray_row(sc, row, origins, dirs)
    mh = _mesh_closest_hit(mesh, org_l, dir_l, cur.t)

    tri = jnp.maximum(mh.tri, 0)
    sf = _shade_fetch(mesh, tri)
    grp = _shade_grp(mesh, tri, sf)
    if mesh.group_rows is not None:
        row_lane = mesh.group_rows[grp]
    else:
        row_lane = jnp.full(tri.shape, jnp.int32(row))

    def _obj(tbl):
        # per-lane object-table value; constant row -> broadcast, no gather
        if mesh.group_rows is None:
            return jnp.broadcast_to(tbl[row], tri.shape + tbl.shape[1:])
        return tbl[row_lane]

    win = mh.t < cur.t
    if avoid_ghosts:
        win = win & ~_obj(sc.ghost)
    al, be, ga = traverse_bary_cleanup(mh)

    # shading normal (TriangleMesh.cpp:940-948)
    if mesh.interp_normals:
        if 'n0' in sf:
            n_l = (sf['n0'] * al[:, None] + sf['n1'] * be[:, None]
                   + sf['n2'] * ga[:, None])
        else:
            n_l = (mesh.n0[tri] * al[:, None] + mesh.n1[tri] * be[:, None]
                   + mesh.n2[tri] * ga[:, None])
    elif 'fn' in sf:
        n_l = sf['fn']
    else:
        soup = mesh.tri_soup()
        n_l = jnp.stack([soup.nx[tri], soup.ny[tri], soup.nz[tri]], axis=-1)
    n_l = vec.normalize(n_l)

    u, v = _mesh_uv(mesh, tri, al, be, ga, sf)

    # tangent-space normal mapping (TriangleMesh.cpp:952-970)
    atl = dict(zip(tex_mod.CHANNELS, mesh.atlases)) if mesh.atlases else {}
    samp = (tex_mod.sample_bilinear if mesh.bilinear
            else tex_mod.sample_point)
    if any(gt.normal is not None for gt in mesh.textures):
        if 't0' in sf:
            tangent = vec.normalize(
                sf['t0'] * al[:, None] + sf['t1'] * be[:, None]
                + sf['t2'] * ga[:, None])
        else:
            tangent = vec.normalize(
                mesh.t0[tri] * al[:, None] + mesh.t1[tri] * be[:, None]
                + mesh.t2[tri] * ga[:, None])
        bitangent = vec.cross(n_l, tangent)
        if atl.get('normal') is not None:
            ns_loc, has_nm = tex_mod.sample_atlas(atl['normal'], grp, u, v,
                                                  mesh.bilinear)
            ns = (ns_loc[:, 0:1] * tangent + ns_loc[:, 1:2] * bitangent
                  + ns_loc[:, 2:3] * n_l)
            degenerate = vec.norm2(ns) < 1e-20
            ns = jnp.where(degenerate[:, None], n_l, vec.normalize(ns))
            n_l = jnp.where(has_nm[:, None], ns, n_l)
        else:
            for g, gt in enumerate(mesh.textures):
                if gt.normal is not None:
                    ns_loc = samp(gt.normal, u, v)
                    ns = (ns_loc[:, 0:1] * tangent
                          + ns_loc[:, 1:2] * bitangent
                          + ns_loc[:, 2:3] * n_l)
                    degenerate = vec.norm2(ns) < 1e-20
                    ns = jnp.where(degenerate[:, None], n_l,
                                   vec.normalize(ns))
                    n_l = jnp.where((grp == g)[:, None], ns, n_l)

    n_l = jnp.where(_obj(sc.flip_normals)[:, None], -n_l, n_l)

    # world-space point and normal through the object transform
    p_l = org_l + mh.t[:, None] * dir_l
    if mesh.world_space:
        p_w = p_l
        n_w = n_l
    elif sc.identity_transform:
        tr = sc.trans[row]
        p_w = p_l + jnp.stack([tr[3], tr[7], tr[11]])
        n_w = n_l
    else:
        tr = sc.trans[row].reshape(3, 4)
        p_w = _mm(p_l, tr[:, :3].T) + tr[:, 3]
        n_w = vec.normalize(_mm(n_l, sc.rot[row].reshape(3, 3).T))

    # material: group constants x optional texture images (queryMaterial,
    # Geometry.h:399-445 — image value multiplied by the channel multiplier)
    if mesh.g_kd.shape[0] == 1:
        # single-group mesh: constants broadcast, no per-lane table gather
        def _g1(tbl):
            return jnp.broadcast_to(tbl[0], tri.shape + tbl.shape[1:])
        kd, ks, ne, ksub = (_g1(mesh.g_kd), _g1(mesh.g_ks),
                            _g1(mesh.g_ne), _g1(mesh.g_ksub))
        transp, refr = _g1(mesh.g_transp), _g1(mesh.g_refr)
    else:
        kd = mesh.g_kd[grp]
        ks = mesh.g_ks[grp]
        ne = mesh.g_ne[grp]
        ksub = mesh.g_ksub[grp]
        transp = mesh.g_transp[grp]
        refr = mesh.g_refr[grp]
    if atl:
        # atlas path: one gather per imaged channel, any group count
        def _atlas_mul(name, cur, gconst):
            a = atl.get(name)
            if a is None:
                return cur
            val, has = tex_mod.sample_atlas(a, grp, u, v, mesh.bilinear)
            return jnp.where(has[:, None], val * gconst[grp], cur)

        kd = _atlas_mul('kd', kd, mesh.g_kd)
        ks = _atlas_mul('ks', ks, mesh.g_ks)
        ne = _atlas_mul('roughness', ne, mesh.g_ne)
        ksub = _atlas_mul('ksub', ksub, mesh.g_ksub)
        if atl.get('transp') is not None:
            # getBool semantics: red * multiplier < 0.5 -> transparent
            # (Geometry.h:432-436, BRDF.h:334-345)
            val, has = tex_mod.sample_atlas(atl['transp'], grp, u, v,
                                            mesh.bilinear)
            tmult = jnp.where(mesh.g_transp[grp], 0.0, 1.0)
            transp = jnp.where(has, val[:, 0] * tmult < 0.5, transp)
        if atl.get('refr') is not None:
            # getValRed: red * multiplier (Geometry.h:437-441)
            val, has = tex_mod.sample_atlas(atl['refr'], grp, u, v,
                                            mesh.bilinear)
            refr = jnp.where(has, val[:, 0] * mesh.g_refr[grp], refr)
    else:
        for g, gt in enumerate(mesh.textures):
            sel_g = (grp == g)[:, None]
            if gt.kd is not None:
                kd = jnp.where(sel_g, samp(gt.kd, u, v)
                               * mesh.g_kd[g], kd)
            if gt.ks is not None:
                ks = jnp.where(sel_g, samp(gt.ks, u, v)
                               * mesh.g_ks[g], ks)
            if gt.roughness is not None:
                ne = jnp.where(sel_g, samp(gt.roughness, u, v)
                               * mesh.g_ne[g], ne)
            if gt.ksub is not None:
                ksub = jnp.where(sel_g, samp(gt.ksub, u, v)
                                 * mesh.g_ksub[g], ksub)
            if gt.transp is not None:
                # getBool semantics: red * multiplier < 0.5 -> transparent;
                # the group flag encodes the constant multiplier 0/1
                # (Geometry.h:432-436, BRDF.h:334-345)
                tmult = jnp.where(mesh.g_transp[g], 0.0, 1.0)
                tval = samp(gt.transp, u, v)[..., 0] * tmult < 0.5
                transp = jnp.where(grp == g, tval, transp)
            if gt.refr is not None:
                # getValRed: red * multiplier (Geometry.h:437-441)
                rval = samp(gt.refr, u, v)[..., 0] * mesh.g_refr[g]
                refr = jnp.where(grp == g, rval, refr)
    if 'vc0' in sf or mesh.vc0 is not None:
        # vertex-color override (TriangleMesh.cpp:975-977)
        vc0 = sf['vc0'] if 'vc0' in sf else mesh.vc0[tri]
        vc1 = sf['vc1'] if 'vc1' in sf else mesh.vc1[tri]
        vc2 = sf['vc2'] if 'vc2' in sf else mesh.vc2[tri]
        kd = (vc0 * al[:, None] + vc1 * be[:, None] + vc2 * ga[:, None])
    if 'fc' in sf or mesh.facecolors is not None:
        # .seg/.lab overlay replaces Kd outright (TriangleMesh.cpp:988-990)
        kd = sf['fc'] if 'fc' in sf else mesh.facecolors[tri]
    if mesh.display_edges and 'ec' in sf:
        # per-edge CSV colors (TriangleMesh.cpp:991-1014): ANY bary <
        # 0.05 crossing takes the crossed edge's mapped color, black if
        # unmapped; the LAST matching branch wins like the reference's
        # sequential ifs (alpha, then beta, then gamma)
        ec = sf['ec'].reshape(-1, 3, 3)
        em = sf['em'] != 0.0
        sel_c = jnp.zeros_like(kd)
        on_edge = jnp.zeros_like(al, bool)
        for cond, slot in (((al < 0.05), 1), ((be < 0.05), 2),
                           ((ga < 0.05), 0)):
            col = jnp.where(em[:, slot, None], ec[:, slot], 0.0)
            sel_c = jnp.where(cond[:, None], col, sel_c)
            on_edge = on_edge | cond
        kd = jnp.where(on_edge[:, None], sel_c, kd)
    elif mesh.display_edges and ('se' in sf or mesh.show_edges is not None):
        # wireframe: blacken near real polygon borders — bary < 0.05
        # against the opposite-corner edge flag (TriangleMesh.cpp:1015-1021;
        # alpha->showEdges[1], beta->showEdges[2], gamma->showEdges[0])
        se = (sf['se'] != 0.0) if 'se' in sf else mesh.show_edges[tri]
        edge = ((al < 0.05) & se[:, 1]) | ((be < 0.05) & se[:, 2]) \
            | ((ga < 0.05) & se[:, 0])
        kd = jnp.where(edge[:, None], 0.0, kd)

    def sel(new, old):
        m = win[..., None] if new.ndim > win.ndim else win
        return jnp.where(m, new, old)

    return Hit(
        hit=cur.hit | win,
        t=jnp.where(win, mh.t, cur.t),
        p=sel(p_w, cur.p),
        n=sel(n_w, cur.n),
        obj_id=jnp.where(win, row_lane, cur.obj_id),
        kd=sel(kd, cur.kd),
        ks=sel(ks, cur.ks),
        ne=sel(ne, cur.ne),
        ke=sel(jnp.zeros_like(cur.ke), cur.ke),
        ksub=sel(ksub, cur.ksub),
        transp=jnp.where(win, transp, cur.transp),
        refr_index=jnp.where(win, refr, cur.refr_index),
        miroir=jnp.where(win, _obj(sc.miroir), cur.miroir),
        ghost=jnp.where(win, _obj(sc.ghost), cur.ghost),
        brdf_type=jnp.where(win, _obj(sc.brdf_type), cur.brdf_type),
        # surface-locality sort key: the winner's position in BVH order,
        # bucketed to the 13-bit key budget (nearby triangles share a
        # bucket, so sorted bounce rays start on nearby subtrees)
        lkey=jnp.where(
            win,
            jnp.minimum(tri // max(1, -(-mesh.num_triangles // 8192)),
                        8191).astype(jnp.int32),
            cur.lkey),
    )


def traverse_bary_cleanup(mh):
    from ..ops import traverse
    return traverse.bary_cleanup(mh.alpha, mh.beta, mh.gamma)


class ProbeHit(NamedTuple):
    """Result of the restricted reservoir probe (subsurface exit point)."""

    found: jnp.ndarray    # (N,) bool
    t: jnp.ndarray        # (N,)
    p: jnp.ndarray        # (N,3) world
    n: jnp.ndarray        # (N,3) unit shading normal (world)
    ksub: jnp.ndarray     # (N,3) material at the exit point
    # lanes whose crossing march exhausted RESERVOIR_MAX_CROSSINGS slots
    # (reported found=False — a biased miss if ever common; surfaced as
    # the ss_reservoir_overflow stat through the integrator)
    overflow: jnp.ndarray = None   # (N,) bool


MESH_RESERVOIR_MAX_TRIS = 65536   # dense two-pass reservoir cost cap
RESERVOIR_MAX_CROSSINGS = 16      # crossing-march slot budget (big meshes)


def _mesh_reservoir_supported(mesh) -> bool:
    """Every mesh tier now has a reservoir path: the dense count-then-pick
    sweep up to MESH_RESERVOIR_MAX_TRIS, the crossing march beyond it
    (reference counterpart: TriangleMesh.cpp:1321-1428)."""
    return True


def _mesh_reservoir_march(mesh, org_m, dir_m, tmax, u,
                          max_cross=RESERVOIR_MAX_CROSSINGS):
    """Uniform random intersection with a BIG mesh along [0, tmax).

    Instead of sweeping all T triangles (the dense two-pass, unaffordable
    for big meshes), march the closest-hit traversal with a rising
    strict t floor, recording every crossing into max_cross slots — a
    closed surface crosses a short subsurface probe segment only a few
    times, and each step is one traversal of the mesh's own tier.  Then count-then-pick with the single uniform like
    the dense path (same distribution as the reference's sequential
    reservoir, TriangleMesh.cpp:1321-1428).

    Lanes exceeding max_cross crossings report found=False (the probe
    behaves as a miss there — the integrator already weights probe
    failure; 16+ crossings within a probe segment is pathological).
    Returns (found, t, tri, alpha, beta, gamma).
    """
    n = org_m.shape[0]
    K = max_cross
    big = jnp.broadcast_to(tmax, (n,))

    def cond(c):
        i, _, active, *_ = c
        return vec.any_true(active) & (i < K)

    def body(c):
        i, t_floor, active, ts, tris, als, bes = c
        # the march counts crossings in both directions (subsurface
        # probes travel inside the surface)
        mh = _mesh_closest_hit(mesh, org_m, dir_m, big, t_min=t_floor)
        found = active & (mh.t < big)
        row = lambda a, v: jax.lax.dynamic_update_slice(
            a, v[None, :], (i, 0))
        ts = row(ts, jnp.where(found, mh.t, BIG_T))
        tris = row(tris, jnp.where(found, mh.tri, -1))
        als = row(als, mh.alpha)
        bes = row(bes, mh.beta)
        return (i + 1, jnp.where(found, mh.t, t_floor), found,
                ts, tris, als, bes)

    init = (jnp.int32(0), jnp.full((n,), -1.0), jnp.ones((n,), bool),
            jnp.full((K, n), BIG_T), jnp.full((K, n), -1, jnp.int32),
            jnp.zeros((K, n)), jnp.zeros((K, n)))
    i_end, _, still, ts, tris, als, bes = jax.lax.while_loop(
        cond, body, init)

    valid = ts < big[None, :]
    count = jnp.sum(valid.astype(jnp.int32), axis=0)
    # slot budget exhausted with crossings still coming -> probe miss
    overflow = still & (i_end >= K)
    found = (count > 0) & ~overflow
    target = jnp.clip(
        jnp.floor(u * count.astype(jnp.float32)).astype(jnp.int32),
        0, jnp.maximum(count - 1, 0))
    t_sel = ts[0]
    tri_sel = tris[0]
    al_sel = als[0]
    be_sel = bes[0]
    for k in range(1, K):
        m = target == k
        t_sel = jnp.where(m, ts[k], t_sel)
        tri_sel = jnp.where(m, tris[k], tri_sel)
        al_sel = jnp.where(m, als[k], al_sel)
        be_sel = jnp.where(m, bes[k], be_sel)
    ga_sel = 1.0 - al_sel - be_sel
    return (found, t_sel, jnp.maximum(tri_sel, 0), al_sel, be_sel, ga_sel,
            overflow)


def reservoir_same_object(sc: SceneArrays, origins, dirs, tmax, obj_id, u):
    """Uniformly-random intersection with the SAME object along [0, tmax].

    JAX counterpart of Scene::get_random_intersection restricted to
    one object (reference: Geometry.cpp:339-472 with sphere_id != -1;
    per-object reservoir variants Geometry.h:994-1094, :1159-1183,
    TriangleMesh.cpp:1321-1428).  The reference's sequential reservoir
    (one engine draw per candidate) is replaced by count-then-pick with a
    single uniform — identical distribution, vectorizable draw count.

    Analytic objects contribute their (<=2) quadric roots; brute-force
    meshes contribute all triangle hits in range (two chunked passes).
    """
    from ..ops import traverse

    n = origins.shape[0]
    t_all, (lox, loy, loz), (ldx, ldy, ldz) = _candidate_ts(sc, origins, dirs)
    del t_all  # we need both roots, recompute below

    # both sphere roots per (N,O)
    ocx = lox - sc.center[:, 0]
    ocy = loy - sc.center[:, 1]
    ocz = loz - sc.center[:, 2]
    b = ldx * ocx + ldy * ocy + ldz * ocz
    a = ldx * ldx + ldy * ldy + ldz * ldz
    c = ocx * ocx + ocy * ocy + ocz * ocz - sc.radius * sc.radius
    delta = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    inva = 1.0 / a
    s_t1 = (-b - sq) * inva
    s_t2 = (-b + sq) * inva
    ok_sph = delta >= 0.0

    nx, ny, nz = sc.normal[:, 0], sc.normal[:, 1], sc.normal[:, 2]
    ddot = ldx * nx + ldy * ny + ldz * nz
    safe = jnp.abs(ddot) >= 1e-9
    p_t = (((sc.center[:, 0] - lox) * nx + (sc.center[:, 1] - loy) * ny
            + (sc.center[:, 2] - loz) * nz) / jnp.where(safe, ddot, 1.0))

    is_sphere = sc.obj_type == SPHERE
    is_plane = sc.obj_type == PLANE
    row_sel = jnp.arange(sc.num_objects)[None, :] == obj_id[:, None]

    # candidates restricted to the hit object, gathered per lane
    def gather(m):
        return jnp.sum(jnp.where(row_sel, m, 0.0), axis=1)

    def gatherb(m):
        return vec.any_true(row_sel & m, axis=1)

    tmax_ = tmax
    c1_t = gather(jnp.where(is_sphere, s_t1, p_t))
    c2_t = gather(jnp.where(is_sphere, s_t2, 0.0))
    c1_ok = gatherb((is_sphere & ok_sph) | (is_plane & safe))
    c2_ok = gatherb(is_sphere & ok_sph)
    c1_ok = c1_ok & (c1_t >= 0.0) & (c1_t < tmax_)
    c2_ok = c2_ok & (c2_t >= 0.0) & (c2_t < tmax_)

    count = c1_ok.astype(jnp.int32) + c2_ok.astype(jnp.int32)
    pick2 = (jnp.floor(u * count.astype(jnp.float32)).astype(jnp.int32)
             >= c1_ok.astype(jnp.int32))
    take2 = c2_ok & (pick2 | ~c1_ok)
    t_sel = jnp.where(take2, c2_t, c1_t)
    found = count > 0

    # local hit point + normal of the selected analytic candidate
    lo = jnp.stack([gather(lox), gather(loy), gather(loz)], axis=-1)
    ld = jnp.stack([gather(ldx), gather(ldy), gather(ldz)], axis=-1)
    p_l = lo + t_sel[:, None] * ld
    cen = sc.center[obj_id]
    n_sphere = p_l - cen
    n_l = jnp.where((sc.obj_type[obj_id] == SPHERE)[:, None], n_sphere,
                    sc.normal[obj_id])
    n_l = jnp.where(sc.flip_normals[obj_id, None], -n_l, n_l)

    # meshes: uniform pick among triangle hits in range.  The dense
    # two-pass sweep covers every mesh up to MESH_RESERVOIR_MAX_TRIS,
    # whatever its tier; bigger meshes use the crossing march.
    overflow = jnp.zeros((n,), bool)
    for mesh in sc.meshes:
        if mesh.num_triangles > MESH_RESERVOIR_MAX_TRIS:
            row = mesh.obj_row
            org_m, dir_m = _local_ray_row(sc, row, origins, dirs)
            lane_on_mesh = obj_id == row
            found_m, mt, mtri, a3, b3, g3, ov_m = _mesh_reservoir_march(
                mesh, org_m, dir_m, tmax_, u)
            overflow = overflow | (lane_on_mesh & ov_m)
            sfm = _shade_fetch(mesh, jnp.maximum(mtri, 0))
            if 'n0' in sfm:
                n_m = (sfm['n0'] * a3[:, None] + sfm['n1'] * b3[:, None]
                       + sfm['n2'] * g3[:, None])
            elif 'fn' in sfm:
                n_m = sfm['fn']        # face-normal mesh
            else:
                n_m = (mesh.n0[mtri] * a3[:, None]
                       + mesh.n1[mtri] * b3[:, None]
                       + mesh.n2[mtri] * g3[:, None])
            m_found = lane_on_mesh & found_m
            found = jnp.where(lane_on_mesh, m_found, found)
            t_sel = jnp.where(m_found, mt, t_sel)
            p_l = jnp.where(m_found[:, None],
                            org_m + mt[:, None] * dir_m, p_l)
            n_l = jnp.where(m_found[:, None], n_m, n_l)
            continue
        row = mesh.obj_row
        org_m, dir_m = _local_ray_row(sc, row, origins, dirs)
        mcount = jnp.zeros((n,), jnp.int32)
        chunk = 2048
        soup = mesh.tri_soup()
        t_total = mesh.num_triangles
        for start in range(0, t_total, chunk):
            sl = slice(start, min(start + chunk, t_total))
            tt, _, _, _ = traverse._tri_test_block(soup, sl, org_m, dir_m)
            mcount = mcount + jnp.sum(
                (tt >= 0.0) & (tt < tmax_[:, None]), axis=-1).astype(jnp.int32)
        lane_on_mesh = obj_id == row
        target = jnp.floor(u * mcount.astype(jnp.float32)).astype(jnp.int32)
        # second pass: select the target-th valid hit
        runner = jnp.zeros((n,), jnp.int32)
        mt = jnp.zeros((n,), jnp.float32)
        mtri = jnp.zeros((n,), jnp.int32)
        for start in range(0, t_total, chunk):
            sl = slice(start, min(start + chunk, t_total))
            tt, _, _, _ = traverse._tri_test_block(soup, sl, org_m, dir_m)
            valid = (tt >= 0.0) & (tt < tmax_[:, None])
            idx_in = jnp.cumsum(valid.astype(jnp.int32), axis=-1) - 1 + runner[:, None]
            want = valid & (idx_in == target[:, None])
            anyw = vec.any_true(want, axis=-1)
            j = jnp.argmax(want.astype(jnp.int32), axis=-1)
            mt = jnp.where(anyw, jnp.take_along_axis(tt, j[:, None], -1)[:, 0],
                           mt)
            mtri = jnp.where(anyw, j.astype(jnp.int32) + start, mtri)
            runner = runner + jnp.sum(valid.astype(jnp.int32), axis=-1)
        m_found = lane_on_mesh & (mcount > 0)
        # interpolated normal at the mesh exit
        t3, a3, b3, g3 = traverse._tri_test_lane(soup, mtri, org_m, dir_m)
        del t3
        n_m = (mesh.n0[mtri] * a3[:, None] + mesh.n1[mtri] * b3[:, None]
               + mesh.n2[mtri] * g3[:, None])
        found = jnp.where(lane_on_mesh, m_found, found)
        t_sel = jnp.where(m_found, mt, t_sel)
        p_l = jnp.where(m_found[:, None], org_m + mt[:, None] * dir_m, p_l)
        n_l = jnp.where(m_found[:, None], n_m, n_l)

    # back to world
    if sc.identity_transform:
        tr3 = sc.trans[obj_id]
        p_w = p_l + jnp.stack([tr3[:, 3], tr3[:, 7], tr3[:, 11]], axis=-1)
        n_w = vec.normalize(n_l)
    else:
        tm = sc.trans[obj_id]
        p_w = jnp.stack([
            tm[:, 0] * p_l[:, 0] + tm[:, 1] * p_l[:, 1] + tm[:, 2] * p_l[:, 2] + tm[:, 3],
            tm[:, 4] * p_l[:, 0] + tm[:, 5] * p_l[:, 1] + tm[:, 6] * p_l[:, 2] + tm[:, 7],
            tm[:, 8] * p_l[:, 0] + tm[:, 9] * p_l[:, 1] + tm[:, 10] * p_l[:, 2] + tm[:, 11],
        ], axis=-1)
        rm = sc.rot[obj_id]
        n_w = vec.normalize(jnp.stack([
            rm[:, 0] * n_l[:, 0] + rm[:, 1] * n_l[:, 1] + rm[:, 2] * n_l[:, 2],
            rm[:, 3] * n_l[:, 0] + rm[:, 4] * n_l[:, 1] + rm[:, 5] * n_l[:, 2],
            rm[:, 6] * n_l[:, 0] + rm[:, 7] * n_l[:, 1] + rm[:, 8] * n_l[:, 2],
        ], axis=-1))

    return ProbeHit(found=found, t=t_sel, p=p_w, n=n_w,
                    ksub=sc.ksub[obj_id], overflow=overflow)


def intersect_shadow(sc: SceneArrays, origins, dirs, dist_light,
                     avoid_ghosts=True):
    """Any-hit within 0.999*dist_light (Geometry.cpp:691-744). Returns bool (N,)."""
    from ..ops import traverse

    t_all, _, _ = _candidate_ts(sc, origins, dirs, avoid_ghosts)
    blocked = vec.any_true(t_all < (dist_light[:, None] * 0.999), axis=-1)
    limit = dist_light * 0.999
    for mesh in sc.meshes:
        if mesh.world_space:
            org_l, dir_l = origins, dirs
        else:
            org_l, dir_l = _local_ray_row(sc, mesh.obj_row, origins, dirs)
        has_alpha = any(gt.alpha is not None for gt in mesh.textures)
        if mesh.tier == 'kernel' and not has_alpha:
            # any-hit traversal: a lane retires at its first hit below the
            # light distance.  Alpha meshes take the closest-hit path
            # below — cutout texels must not occlude
            # (TriangleMesh.cpp:1299-1305).
            from ..ops import bvh_kernel
            _, tri = bvh_kernel.kernel_hit(
                mesh.kroot, mesh.knodes, mesh.ktris, org_l, dir_l, limit,
                max_leaf=mesh.max_leaf, depth=mesh.bvh_depth, any_hit=True,
                interpret=mesh.kernel_interpret)
            mb = tri >= 0
        elif has_alpha:
            # t_max bounded at the light distance (hits beyond it never
            # occlude); t is transform-invariant because _local_ray_row
            # keeps dir_l unnormalized.  Occlusion only needs t.
            mh = _mesh_closest_hit(mesh, org_l, dir_l, limit)
            mb = mh.t < limit
        elif mesh.tier == 'brute':
            mb = traverse.brute_force_any(mesh.soup, org_l, dir_l, limit)
        else:
            mh = traverse.bvh_hit(mesh.bvh, mesh.soup, org_l, dir_l,
                                  max_leaf=mesh.max_leaf,
                                  any_hit_limit=limit)
            mb = mh.t < limit
        if avoid_ghosts:
            mb = mb & ~sc.ghost[mesh.obj_row]
        blocked = blocked | mb
    for ps in sc.pointsets:
        from . import pointset as ps_mod
        org_l, dir_l = _local_ray_row(sc, ps.obj_row, origins, dirs)
        if ps.as_spheres:
            sweep = (ps_mod.clustered_sphere_sweep if ps.n_clusters
                     else ps_mod.sphere_sweep)
        else:
            sweep = ps_mod.disk_sweep
        t_ps, _ = sweep(ps, org_l, dir_l,
                        jnp.broadcast_to(BIG_T, limit.shape))
        pb = t_ps < limit
        if avoid_ghosts:
            pb = pb & ~sc.ghost[ps.obj_row]
        blocked = blocked | pb
    for ya in sc.yarns:
        from . import yarns as yarn_mod
        org_l, dir_l = _local_ray_row(sc, ya.obj_row, origins, dirs)
        t_y, _, _ = yarn_mod.cylinder_sweep(
            ya, org_l, dir_l, jnp.broadcast_to(BIG_T, limit.shape))
        yb = t_y < limit
        if avoid_ghosts:
            yb = yb & ~sc.ghost[ya.obj_row]
        blocked = blocked | yb
    return blocked


# ---------------------------------------------------------------------------
# Host-side scene building
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ObjectSpec:
    """Host-side description of one analytic object (builder input)."""

    obj_type: int
    center: Any = (0.0, 0.0, 0.0)   # sphere center or plane point
    radius: float = 1.0
    normal: Any = (0.0, 1.0, 0.0)
    flip_normals: bool = False
    kd: Any = (1.0, 1.0, 1.0)       # queryMaterial defaults (Geometry.h:404-441)
    ks: Any = (0.0, 0.0, 0.0)
    ne: Any = (1.0, 1.0, 1.0)
    ksub: Any = (0.0, 0.0, 0.0)
    transp: bool = False
    refr_index: float = 1.3
    miroir: bool = False
    ghost: bool = False
    translation: Any = (0.0, 0.0, 0.0)
    rotation: Any = None            # 3x3 or None
    scale: float = 1.0
    rotation_center: Any = None     # defaults to sphere center / (0,0,0)
    mesh_data: Any = None           # host MeshData for obj_type == MESH
    interp_normals: bool = True
    measured_brdf: Any = None       # models.merl.MeasuredBRDF or None
    # texture channel images: {channel: path-or-array} (see
    # models.texture.make_group_textures); for meshes a list gives
    # per-group overrides.  Analytic objects sample them with sphere
    # spherical UV (Geometry.h:979-984) / plane 0.1*(x,z) UV
    # (Geometry.h:1152-1154)
    textures: Any = None
    # wireframe edge display (TriangleMesh.cpp:978-1023) and .seg/.lab
    # face overlay source (path or (T,3) colors, mainApp.cpp:2311-2377)
    display_edges: bool = False
    seg_path: Any = None
    # per-edge color CSV (TriMesh colors_csv_filename,
    # TriangleMesh.cpp:132-210); shown when display_edges
    edge_csv: Any = None
    # texture filtering/packing options (mesh objects): bilinear is an
    # option the reference lacks (its Texture is point-sampled); atlas
    # packing activates automatically past ATLAS_MIN_GROUPS textured
    # groups, or force with use_atlas
    bilinear: bool = False
    use_atlas: Any = None
    # alpha-cutout re-intersection rounds (>=4 stacked cutout texels
    # along one ray need a higher value; each round costs one traversal)
    cutout_rounds: int = 4
    # keyframe animation: {frame: {'translation','rotation','scale'}}
    # (reference: Object keyframe maps, Geometry.h:258-320)
    keyframes: Any = None


def sphere(center, radius, **kw) -> ObjectSpec:
    spec = ObjectSpec(obj_type=SPHERE, center=center, radius=radius, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = center
    return spec


def plane(point, normal, **kw) -> ObjectSpec:
    spec = ObjectSpec(obj_type=PLANE, center=point, normal=normal, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = (0.0, 0.0, 0.0)
    return spec


YARNS = 4      # object type tag for yarn rows


def yarn_object(yarn_data, **kw) -> ObjectSpec:
    """A yarn set (segments) occupying one object-table row.  `yarn_data`
    is (seg_a (S,3), seg_b (S,3)) or a .yarn file path."""
    spec = ObjectSpec(obj_type=YARNS, mesh_data=yarn_data, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = (0.0, 0.0, 0.0)
    return spec


def pointset_object(point_data, **kw) -> ObjectSpec:
    """A point set occupying one object-table row.  `point_data` is either
    a host dict {'points','normals','colors','radii'} or the value returned
    by pointset.make_pointset-compatible loaders."""
    spec = ObjectSpec(obj_type=POINTSET, mesh_data=point_data, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = (0.0, 0.0, 0.0)
    return spec


def mesh_object(mesh_data, **kw) -> ObjectSpec:
    """A triangle mesh occupying one object-table row (transform/flags),
    like the reference TriMesh : Object (TriangleMesh.h:115)."""
    spec = ObjectSpec(obj_type=MESH, mesh_data=mesh_data, **kw)
    if spec.rotation_center is None:
        v = mesh_data.vertices
        spec.rotation_center = ((v.min(0) + v.max(0)) * 0.5).tolist()
    return spec


def _build_matrices(spec: ObjectSpec):
    """Compose 3x4 trans/inv and 3x3 rot (reference: Geometry.h:322-360)."""
    m = np.eye(3) if spec.rotation is None else np.asarray(spec.rotation, np.float64)
    s = float(spec.scale)
    tr = np.asarray(spec.translation, np.float64)
    rc = np.asarray(spec.rotation_center, np.float64)
    trans = np.zeros((3, 4))
    inv = np.zeros((3, 4))
    trans[:, :3] = m * s
    inv[:, :3] = m.T / s
    trans[:, 3] = m @ (-rc) * s + rc + tr
    inv[:, 3] = m.T @ (-rc - tr) / s + rc
    return trans.astype(np.float32), inv.astype(np.float32), m.astype(np.float32)


def _ss_obj_ok(objects, meshes) -> np.ndarray:
    """Per-row subsurface-probe support (see SceneArrays.ss_obj_ok).

    A ksub material whose probe categorically cannot find an exit point
    would double-count the surface estimator (~2x brightening) because the
    failed-probe branch continues as a surface path with weight 1/p — so
    those rows opt out of the SS entry RR entirely (subsProba = 0, the
    reference's !is_subsurface case, Raytracer.cpp:318)."""
    ok = np.ones(len(objects), bool)
    mesh_by_row = {m.obj_row: m for m in meshes}
    for i, o in enumerate(objects):
        if o.obj_type == MESH:
            m = mesh_by_row.get(i)
            if m is not None:
                ok[i] = _mesh_reservoir_supported(m)
            # rows folded into a merged mesh have no per-row entry; they
            # are ksub=0 by merge eligibility, so SS never fires on them
        elif o.obj_type in (POINTSET, YARNS):
            ok[i] = False   # no reservoir path for splats/cylinders yet
    return ok


def load_background(path: str, gamma: float = 2.2) -> np.ndarray:
    """(u8/255)^gamma * 196964.699 (reference: Scene::load_background,
    Geometry.h:1355-1362)."""
    from ..io.image import load_image
    img = load_image(path) / 255.0
    return (np.power(img, gamma) * 196964.699).astype(np.float32)


def build_scene(objects, light_intensity, envmap_intensity=1.0, envmap=None,
                light_scale=1.0, fog=None, background=None,
                frame=None, merge_meshes=None) -> SceneArrays:
    """Assemble SceneArrays from ObjectSpecs. objects[0]=light, [1]=dome.

    `frame`: evaluate per-object keyframes at this frame (the reference's
    build_matrix(frame) per render, Geometry.h:322-360 via prepare_render).

    `merge_meshes`: bake eligible mesh objects into ONE world-space BVH
    (the Embree instance-BVH analogue, Geometry.cpp:627-674) so a
    multi-object scene pays one traversal per bounce instead of one per
    mesh.  None (default) = auto when >=2 eligible meshes; False keeps
    the per-mesh loop (mesh_mod.mergeable_spec lists the exclusions).
    """
    n = len(objects)
    assert n >= 2, "scene needs at least light (0) and dome (1) objects"

    if frame is not None:
        from ..core import transform as tf
        objects = [dataclasses.replace(o) for o in objects]
        for o in objects:
            if o.keyframes:
                tr, rot, s = tf.interpolate_keyframes(o.keyframes, frame)
                o.translation = tuple(tr)
                o.rotation = rot
                o.scale = float(s)

    def stack(field, dim3=False):
        vals = [getattr(o, field) for o in objects]
        if dim3:
            return np.asarray([np.broadcast_to(np.asarray(v, np.float32), (3,))
                               for v in vals], np.float32)
        return np.asarray(vals, np.float32)

    mats = [_build_matrices(o) for o in objects]
    trans = np.stack([m[0] for m in mats])
    inv_trans = np.stack([m[1] for m in mats])
    rot = np.stack([m[2] for m in mats])
    identity = all(o.rotation is None and o.scale == 1.0 for o in objects)

    light = objects[0]
    light_tr = trans[0]
    center_light = (light_tr[:, :3] @ np.asarray(light.center, np.float32)
                    + light_tr[:, 3])

    from . import mesh as mesh_mod

    def _edge_colors(o):
        if not o.edge_csv:
            return None
        from ..io import obj as obj_io
        if isinstance(o.edge_csv, str):
            return obj_io.load_edge_csv(o.edge_csv, o.mesh_data)
        return o.edge_csv     # preloaded (colors, mask) pair

    def _facecolors(o):
        if o.seg_path is None:
            return None
        if isinstance(o.seg_path, str):
            from ..io import obj as obj_io
            t = o.mesh_data.num_triangles
            if o.seg_path.lower().endswith('.lab'):
                return obj_io.load_lab(o.seg_path, t)
            return obj_io.load_seg(o.seg_path, t)
        return np.asarray(o.seg_path, np.float32)

    mesh_items = [(i, o) for i, o in enumerate(objects)
                  if o.obj_type == MESH]
    merged_rows = set()
    if merge_meshes is None or merge_meshes:
        eligible = [i for i, o in mesh_items if mesh_mod.mergeable_spec(o)]
        if len(eligible) >= 2:
            merged_rows = set(eligible)

    meshes = tuple(
        mesh_mod.upload_mesh(o.mesh_data, obj_row=i,
                             interp_normals=o.interp_normals,
                             default_ksub=np.broadcast_to(
                                 np.asarray(o.ksub, np.float32), (3,)),
                             default_transp=bool(o.transp),
                             default_refr=float(o.refr_index),
                             display_edges=bool(o.display_edges),
                             edge_colors=_edge_colors(o),
                             facecolors=_facecolors(o),
                             texture_overrides=o.textures,
                             use_atlas=o.use_atlas,
                             bilinear=bool(o.bilinear),
                             cutout_rounds=int(o.cutout_rounds))
        for i, o in mesh_items if i not in merged_rows)

    if merged_rows:
        entries = [(o, i, trans[i], rot[i])
                   for i, o in mesh_items if i in merged_rows]
        md_m, grow, gdef, tex_ov = mesh_mod.merge_mesh_entries(entries)
        meshes += (mesh_mod.upload_mesh(
            md_m, obj_row=entries[0][1], interp_normals=True,
            world_space=True, group_rows=grow,
            group_transp=gdef['transp'], group_refr=gdef['refr'],
            group_ksub=gdef['ksub'], texture_overrides=tex_ov,
            bilinear=any(o.bilinear for _, o in mesh_items),
            cutout_rounds=max(int(o.cutout_rounds)
                              for _, o in mesh_items)),)

    # analytic-object texture channels (sphere/plane UV sampling)
    from ..models import texture as tex_mod
    obj_textures = tuple(
        (tex_mod.make_group_textures(o.textures)
         if (o.textures and o.obj_type in (SPHERE, PLANE)) else None)
        for o in objects)

    from . import pointset as ps_mod
    pointsets = []
    for i, o in enumerate(objects):
        if o.obj_type != POINTSET:
            continue
        pd = o.mesh_data
        if isinstance(pd, ps_mod.PointSetArrays):
            pointsets.append(pd.replace(obj_row=i,
                                        transparent=bool(o.transp)))
        else:
            pts = np.asarray(pd['points'], np.float32)
            nrm = pd.get('normals')
            col = pd.get('colors')
            radii = pd.get('radii')
            if nrm is None or radii is None:
                est_n, est_r = ps_mod.estimate_normals(pts)
                nrm = est_n if nrm is None else np.asarray(nrm, np.float32)
                radii = est_r if radii is None else np.asarray(radii,
                                                               np.float32)
            if col is None:
                col = np.full((len(pts), 3), 1.0 / 255, np.float32)
            pointsets.append(ps_mod.upload_pointset(pts, nrm, col, radii, i))

    from . import yarns as yarn_mod
    yarns_list = []
    for i, o in enumerate(objects):
        if o.obj_type != YARNS:
            continue
        yd = o.mesh_data
        if isinstance(yd, str):
            seg_a, seg_b = yarn_mod.load_yarn(yd)
        else:
            seg_a, seg_b = (np.asarray(yd[0], np.float32),
                            np.asarray(yd[1], np.float32))
        yarns_list.append(yarn_mod.upload_yarns(seg_a, seg_b, i))

    # measured-BRDF assignment: dedupe tables by identity
    measured_tables = []
    brdf_type_arr = []
    for o in objects:
        if o.measured_brdf is None:
            brdf_type_arr.append(0)
        else:
            try:
                k = next(i for i, t in enumerate(measured_tables)
                         if t is o.measured_brdf)
            except StopIteration:
                k = len(measured_tables)
                measured_tables.append(o.measured_brdf)
            brdf_type_arr.append(k + 1)

    # fog block (reference .scn fog params, Raytracer.cpp:1134-1139)
    fog = fog or {}
    fog_density = float(fog.get('density', 0.0))
    # ground level: objects[2]'s translation y (Raytracer.cpp:56)
    ground_y = (float(np.asarray(objects[2].translation).reshape(-1)[1])
                if n > 2 else 0.0)

    return SceneArrays(
        meshes=meshes,
        pointsets=tuple(pointsets),
        yarns=tuple(yarns_list),
        obj_textures=obj_textures,
        fog_density=jnp.float32(fog_density),
        fog_absorption=jnp.float32(fog.get('absorption', 0.0)),
        fog_density_decay=jnp.float32(fog.get('density_decay', 0.0)),
        fog_absorption_decay=jnp.float32(fog.get('absorption_decay', 0.0)),
        phase_aniso=jnp.float32(fog.get('phase_aniso', 0.8)),
        ground_level=jnp.float32(ground_y),
        fog_enabled=fog_density > 1e-8,
        fog_type=int(fog.get('type', 0)),
        fog_phase_type=int(fog.get('phase_type', 0)),
        ss_enabled=any(
            float(np.sum(np.square(np.broadcast_to(
                np.asarray(o.ksub, np.float32), (3,))))) > 1e-8
            for o in objects),
        ss_obj_ok=jnp.asarray(_ss_obj_ok(objects, meshes), bool),
        ghost_enabled=any(o.ghost for o in objects),
        brdf_type=jnp.asarray(brdf_type_arr, jnp.int32),
        measured_brdfs=tuple(measured_tables),
        background=(None if background is None
                    else jnp.asarray(background, jnp.float32)),
        obj_type=jnp.asarray([o.obj_type for o in objects], jnp.int32),
        center=jnp.asarray(stack('center', dim3=True)),
        radius=jnp.asarray([float(o.radius) for o in objects], jnp.float32),
        normal=jnp.asarray(stack('normal', dim3=True)),
        flip_normals=jnp.asarray([o.flip_normals for o in objects], bool),
        kd=jnp.asarray(stack('kd', dim3=True)),
        ks=jnp.asarray(stack('ks', dim3=True)),
        ne=jnp.asarray(stack('ne', dim3=True)),
        ksub=jnp.asarray(stack('ksub', dim3=True)),
        transp=jnp.asarray([o.transp for o in objects], bool),
        refr_index=jnp.asarray([float(o.refr_index) for o in objects], jnp.float32),
        miroir=jnp.asarray([o.miroir for o in objects], bool),
        ghost=jnp.asarray([o.ghost for o in objects], bool),
        trans=jnp.asarray(trans.reshape(n, 12)),
        inv_trans=jnp.asarray(inv_trans.reshape(n, 12)),
        rot=jnp.asarray(rot.reshape(n, 9)),
        identity_transform=identity,
        light_intensity=jnp.float32(light_intensity),
        light_scale=jnp.float32(light_scale * objects[0].scale),
        envmap_intensity=jnp.float32(envmap_intensity),
        envmap=None if envmap is None else jnp.asarray(envmap, jnp.float32),
        center_light=jnp.asarray(center_light, jnp.float32),
        radius_light=jnp.float32(light.radius * light_scale * objects[0].scale),
    )


def default_objects():
    """The reference default scene's object slate (Raytracer.cpp:1238-1274):
    light sphere at (10,23,15) r=10, flipped env dome r=1e6, ground plane
    translated to y=-27.3.  Append user objects after these three."""
    return [
        sphere((10.0, 23.0, 15.0), 10.0),
        sphere((0.0, 0.0, 0.0), 1e6, flip_normals=True),
        plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), translation=(0.0, -27.3, 0.0)),
    ]


def default_light_intensity(r_lum=10.0):
    """intensite_lumiere = 1e9*4pi/(4pi*R^2*pi) (Raytracer.cpp:1270)."""
    return 1e9 / (r_lum * r_lum * np.pi)
