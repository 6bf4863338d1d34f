"""Device-side triangle meshes: soup + BVH + per-group materials.

Counterpart of TriMesh (reference: TriangleMesh.h:115-260) as a pytree
dataclass: flat SoA triangle/BVH arrays (built host-side by io/obj.py and
ops/bvh.py), per-group constant material channels (MTL multipliers —
texture images arrive with models/texture.py), interpolated shading normals
(reference getMaterial, TriangleMesh.cpp:940-948).

Each mesh is bound to a row of the analytic object table (its transform,
miroir/ghost flags and keyframes live there, like the reference's
Object base-class state).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp
from ..utils import struct

from ..io import obj as obj_io
from ..ops import bvh as bvh_mod
from ..ops import traverse


@struct.dataclass
class MeshArrays:
    # triangle data: the 'brute' and 'bvh' tiers read the SoA soup, the
    # 'bvh' tier also the SoA BVH; the 'kernel' tier keeps neither (its
    # ktris rows hold the same 16 fields, see tri_soup())
    soup: Optional[traverse.TriSoup]
    bvh: Optional[traverse.BVHArrays]
    # shading attributes, in BVH triangle order
    n0: jnp.ndarray          # (T,3) per-corner shading normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray         # (T,2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    t0: jnp.ndarray          # (T,3) per-corner tangents (normal mapping)
    t1: jnp.ndarray
    t2: jnp.ndarray
    group: jnp.ndarray       # (T,) int32
    vc0: Optional[jnp.ndarray]   # (T,3) vertex colors or None
    vc1: Optional[jnp.ndarray]
    vc2: Optional[jnp.ndarray]
    # wireframe edge flags (T,3) bool, BVH order — real polygon borders
    # only (fan-triangulation interior edges stay hidden); kept on device
    # only when display_edges (TriangleMesh.cpp:978-1023)
    show_edges: Optional[jnp.ndarray]
    # per-face overlay colors (T,3) from .seg/.lab files, or None
    # (mainApp.cpp:2311-2377; overrides Kd like reference facecolors)
    facecolors: Optional[jnp.ndarray]
    # per-group constant materials (differentiable leaves)
    g_kd: jnp.ndarray        # (G,3)
    g_ks: jnp.ndarray        # (G,3)
    g_ne: jnp.ndarray        # (G,3)
    g_ksub: jnp.ndarray      # (G,3)
    g_transp: jnp.ndarray    # (G,) bool
    g_refr: jnp.ndarray      # (G,)
    # per-group texture images (static structure; None entries = constant)
    textures: tuple          # tuple of models.texture.GroupTextures, len G
    # statics
    obj_row: int = struct.field(pytree_node=False)
    max_leaf: int = struct.field(pytree_node=False)
    interp_normals: bool = struct.field(pytree_node=False)
    # intersection tier, chosen once by upload_mesh (see TIERS)
    tier: str = struct.field(pytree_node=False, default='bvh')
    # BVH depth (sizes the per-ray stack of the kernel tier)
    bvh_depth: int = struct.field(pytree_node=False, default=0)
    # kernel tier: packed node rows, root box and triangle rows
    # (ops/bvh_kernel.pack_nodes / root_box / pack_tris), else None
    knodes: Optional[jnp.ndarray] = None     # (M, 16) f32
    kroot: Optional[jnp.ndarray] = None      # (8,) f32
    ktris: Optional[jnp.ndarray] = None      # (T, 16) f32
    # run the kernel tier's kernel in interpret mode (CPU tests only;
    # set explicitly through upload_mesh, never derived from the backend)
    kernel_interpret: bool = struct.field(pytree_node=False, default=False)
    display_edges: bool = struct.field(pytree_node=False, default=False)
    # per-channel texture atlases (models.texture.CHANNELS order; each a
    # ChannelAtlas or None) — built for many-group meshes so material
    # fetch does ONE gather per channel instead of a G-long select chain
    atlases: tuple = ()
    # bilinear texture filtering option (reference is point-sampled)
    bilinear: bool = struct.field(pytree_node=False, default=False)
    # alpha-cutout re-intersection rounds (reference's in-leaf skip is
    # unbounded, TriangleMesh.cpp:1199-1205; each round is one traversal)
    cutout_rounds: int = struct.field(pytree_node=False, default=4)
    # MERGED multi-mesh support (the Embree top-level instance-BVH
    # analogue, Geometry.cpp:627-674): a merged mesh holds several
    # source objects' triangles baked to world space under ONE BVH, so a
    # scene with many meshes pays one traversal per bounce instead of
    # one per mesh.  group_rows maps each material group to its source
    # object row (per-lane flags/transforms resolve by gather).
    group_rows: Optional[jnp.ndarray] = None     # (G,) int32 or None
    world_space: bool = struct.field(pytree_node=False, default=False)
    # packed per-triangle shading attributes: the material fetch does ONE
    # (T, C) row gather instead of ~7 separate per-lane gathers.
    # shade_cols maps name -> (start, width) into the packed row; int32
    # columns (group) are bitcast to f32 (gathers move bits, no math).
    shade_pack: Optional[jnp.ndarray] = None     # (T, C) f32
    shade_cols: tuple = struct.field(pytree_node=False, default=())

    @property
    def num_triangles(self):
        return (self.ktris if self.soup is None else self.soup.ax).shape[0]

    def tri_soup(self) -> traverse.TriSoup:
        """The triangle fields as a TriSoup on every tier (the kernel
        tier's are column views of its ktris rows)."""
        if self.soup is not None:
            return self.soup
        return traverse.TriSoup(*[self.ktris[:, j] for j in range(16)])

    @property
    def use_brute(self):
        return self.tier == 'brute'


# intersection tiers: 'kernel' = the per-ray GPU traversal kernel
# (ops/bvh_kernel.py), 'bvh' = XLA lockstep traversal (traverse.bvh_hit),
# 'brute' = dense all-pairs sweep (traverse.brute_force_hit)
TIERS = ('kernel', 'bvh', 'brute')
BRUTE_FORCE_MAX_TRIS = 8192   # CPU: below this the dense sweep is used
ATLAS_MIN_GROUPS = 5          # textured groups before the atlas pays off


def default_tier(n_tris: int, platform: Optional[str] = None) -> str:
    """The intersection tier for a mesh on this platform: the GPU gets
    the traversal kernel at every size; the CPU gets XLA code (dense
    sweep for small meshes, lockstep BVH above BRUTE_FORCE_MAX_TRIS)."""
    if platform is None:
        import jax
        platform = jax.devices()[0].platform
    if platform == 'gpu':
        return 'kernel'
    if platform == 'cpu':
        return 'brute' if n_tris <= BRUTE_FORCE_MAX_TRIS else 'bvh'
    raise ValueError(f'no mesh intersection tier for platform {platform!r}')


def upload_mesh(md: obj_io.MeshData, obj_row: int,
                interp_normals: bool = True,
                tier: Optional[str] = None,
                kernel_interpret: bool = False,
                load_textures: bool = True,
                default_ksub=(0.0, 0.0, 0.0),
                default_transp: bool = False,
                default_refr: float = 1.3,
                display_edges: bool = False,
                facecolors=None,
                texture_overrides=None,
                use_atlas: Optional[bool] = None,
                bilinear: bool = False,
                cutout_rounds: int = 4,
                group_rows=None,
                world_space: bool = False,
                group_transp=None,
                group_refr=None,
                group_ksub=None,
                edge_colors=None) -> MeshArrays:
    """Build BVH + device arrays from host MeshData (TriMesh::init tail,
    TriangleMesh.cpp:784-841).

    tier: one of TIERS, or None for default_tier(T) on this platform.
    kernel_interpret: run the kernel tier in Pallas interpret mode (lets
    the CPU tests drive the GPU kernel; never set for a real render)."""
    from ..models import texture as tex_mod
    import os
    tri_verts = md.vertices[md.vtx_idx]                     # (T,3,3)
    fb = bvh_mod.build_bvh(tri_verts)
    order = fb.order
    host_soup = traverse.make_soup(tri_verts[order], device=False)

    n_idx = md.n_idx[order]
    normals = md.normals if len(md.normals) else np.zeros((1, 3), np.float32)
    n0 = normals[np.clip(n_idx[:, 0], 0, len(normals) - 1)]
    n1 = normals[np.clip(n_idx[:, 1], 0, len(normals) - 1)]
    n2 = normals[np.clip(n_idx[:, 2], 0, len(normals) - 1)]

    uv_idx = md.uv_idx[order]
    has_uv = len(md.uvs) > 0
    uvs = md.uvs if has_uv else np.zeros((1, 2), np.float32)
    uvc = np.clip(uv_idx, 0, len(uvs) - 1)
    uv0, uv1, uv2 = uvs[uvc[:, 0]], uvs[uvc[:, 1]], uvs[uvc[:, 2]]

    if md.vertex_colors is not None:
        vidx = md.vtx_idx[order]
        vc = md.vertex_colors
        vc0, vc1, vc2 = (jnp.asarray(vc[vidx[:, 0]]),
                         jnp.asarray(vc[vidx[:, 1]]),
                         jnp.asarray(vc[vidx[:, 2]]))
    else:
        vc0 = vc1 = vc2 = None

    g = len(md.materials)
    g_kd = np.stack([m.kd for m in md.materials])
    g_ks = np.stack([m.ks for m in md.materials])
    g_ne = np.stack([m.ns for m in md.materials])

    # per-corner tangents for normal mapping (tangentSoup,
    # TriangleMesh.cpp:699-709)
    if md.tangents is not None:
        vidx = md.vtx_idx[order]
        t0 = md.tangents[vidx[:, 0]]
        t1 = md.tangents[vidx[:, 1]]
        t2 = md.tangents[vidx[:, 2]]
    else:
        t0 = t1 = t2 = np.zeros_like(n0)

    # texture images (MTL map_* refs resolved relative to the OBJ dir,
    # TriangleMesh.cpp:504-535)
    textures = []
    for m in md.materials:
        gt = tex_mod.GroupTextures()
        if load_textures:
            def resolve(name):
                if not name:
                    return None
                p = os.path.join(md.obj_dir, name.replace('\\', '/'))
                return p if os.path.exists(p) else None
            kd_p = resolve(m.map_kd)
            ks_p = resolve(m.map_ks)
            nm_p = resolve(m.map_bump)
            al_p = resolve(m.map_d)
            gt = tex_mod.GroupTextures(
                kd=None if kd_p is None else jnp.asarray(
                    tex_mod.load_color_image(kd_p)),
                ks=None if ks_p is None else jnp.asarray(
                    tex_mod.load_color_image(ks_p)),
                normal=None if nm_p is None else jnp.asarray(
                    tex_mod.load_normal_image(nm_p)),
                alpha=None if al_p is None else jnp.asarray(
                    tex_mod.load_color_image(al_p)),
            )
        textures.append(gt)

    # explicit per-group channel overrides (scene-JSON `textures` — the
    # reference's GUI texture slots incl. transp/refr/subsurface maps,
    # Geometry.h:399-445); dict applies to group 0, list is per group
    if texture_overrides:
        ov_list = ([texture_overrides] if isinstance(texture_overrides, dict)
                   else list(texture_overrides))
        for gi, ov in enumerate(ov_list[:g]):
            if not ov:
                continue
            new = tex_mod.make_group_textures(ov)
            merged = {ch: getattr(new, ch) if getattr(new, ch) is not None
                      else getattr(textures[gi], ch)
                      for ch in ('kd', 'ks', 'normal', 'alpha', 'roughness',
                                 'transp', 'refr', 'ksub')}
            textures[gi] = tex_mod.GroupTextures(**merged)

    # many-group meshes: pack each channel's images into one atlas so the
    # material fetch is one gather per channel, not a G-long select chain
    # (select chains win for small G — CLAUDE.md rule — so the atlas only
    # activates past ATLAS_MIN_GROUPS unless forced)
    if use_atlas is None:
        use_atlas = sum(gt.any_image for gt in textures) >= ATLAS_MIN_GROUPS
    if use_atlas and any(gt.any_image for gt in textures):
        atlases = tuple(
            tex_mod.build_atlas([getattr(gt, ch) for gt in textures])
            for ch in tex_mod.CHANNELS)
    else:
        atlases = ()

    if tier is None:
        tier = default_tier(len(order))
    if tier not in TIERS:
        raise ValueError(f'unknown mesh tier {tier!r}')
    if tier == 'kernel':
        from ..ops import bvh_kernel
        knodes = jnp.asarray(bvh_kernel.pack_nodes(fb))
        kroot = jnp.asarray(bvh_kernel.root_box(fb))
        ktris = jnp.asarray(bvh_kernel.pack_tris(host_soup))
    else:
        knodes = kroot = ktris = None

    se = (jnp.asarray(md.show_edges[order]) if display_edges else None)
    if facecolors is not None:
        fc = np.asarray(facecolors, np.float32)
        assert fc.shape == (len(order), 3), 'facecolors must be (T,3)'
        fc = jnp.asarray(fc[order])
    else:
        fc = None

    # ---- packed per-triangle shading fetch (scene._shade_fetch) ----
    # Only the columns this mesh's feature set actually reads are packed;
    # the fetch is one (T, C) row gather instead of one gather per table.
    need_nm = (any(gt.normal is not None for gt in textures)
               or (atlases and atlases[tex_mod.CHANNELS.index('normal')]
                   is not None))
    textured = bool(atlases) or any(gt.any_image for gt in textures)
    parts, shade_cols, off = [], [], 0

    def _add(name, arr):
        nonlocal off
        a = np.asarray(arr, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        parts.append(a)
        shade_cols.append((name, off, a.shape[1]))
        off += a.shape[1]

    if interp_normals:
        _add('n0', n0), _add('n1', n1), _add('n2', n2)
    else:
        _add('fn', np.stack([host_soup.nx, host_soup.ny,
                             host_soup.nz], axis=-1))
    if g > 1 or group_rows is not None:
        _add('grp', np.asarray(md.group[order], np.int32)
             .view(np.float32))
    if textured:
        _add('uv0', uv0), _add('uv1', uv1), _add('uv2', uv2)
    if need_nm:
        _add('t0', t0), _add('t1', t1), _add('t2', t2)
    if vc0 is not None:
        _add('vc0', np.asarray(vc0)), _add('vc1', np.asarray(vc1))
        _add('vc2', np.asarray(vc2))
    if fc is not None:
        _add('fc', np.asarray(fc))
    if se is not None:
        _add('se', np.asarray(se, np.float32))
    if edge_colors is not None and display_edges:
        # per-edge CSV colors (TriMesh::load_edge_colors consumption,
        # TriangleMesh.cpp:991-1014): 9 color floats + 3 mask floats per
        # triangle, slot layout matching the bary crossing test
        ec_arr, em_arr = edge_colors
        _add('ec', np.asarray(ec_arr, np.float32)[order].reshape(-1, 9))
        _add('em', np.asarray(em_arr, np.float32)[order])
    shade_pack = (jnp.asarray(np.concatenate(parts, axis=1))
                  if parts else None)

    # upload only what the tier reads
    soup = (None if tier == 'kernel'
            else traverse.TriSoup(*[jnp.asarray(x) for x in host_soup]))
    bvh = traverse.upload_bvh(fb) if tier == 'bvh' else None

    return MeshArrays(
        soup=soup, bvh=bvh, tier=tier, bvh_depth=int(fb.depth),
        knodes=knodes, kroot=kroot, ktris=ktris,
        kernel_interpret=bool(kernel_interpret),
        atlases=atlases, bilinear=bool(bilinear),
        cutout_rounds=int(cutout_rounds),
        show_edges=se, facecolors=fc, display_edges=bool(display_edges),
        n0=jnp.asarray(n0), n1=jnp.asarray(n1), n2=jnp.asarray(n2),
        uv0=jnp.asarray(uv0), uv1=jnp.asarray(uv1), uv2=jnp.asarray(uv2),
        t0=jnp.asarray(t0), t1=jnp.asarray(t1), t2=jnp.asarray(t2),
        textures=tuple(textures),
        group=jnp.asarray(md.group[order], jnp.int32),
        vc0=vc0, vc1=vc1, vc2=vc2,
        g_kd=jnp.asarray(g_kd), g_ks=jnp.asarray(g_ks),
        g_ne=jnp.asarray(g_ne),
        g_ksub=(jnp.asarray(group_ksub, jnp.float32)
                if group_ksub is not None else jnp.broadcast_to(
                    jnp.asarray(default_ksub, jnp.float32), (g, 3))),
        # object-level transp/refr seed every group (the reference's
        # per-Object fields, Geometry.h:418-433 defaults; MTL/texture
        # channels can override per group later); merged meshes pass
        # per-group arrays gathered from their source objects
        g_transp=(jnp.asarray(group_transp, bool) if group_transp
                  is not None else jnp.full((g,), bool(default_transp))),
        g_refr=(jnp.asarray(group_refr, jnp.float32) if group_refr
                is not None else jnp.full((g,), float(default_refr),
                                          jnp.float32)),
        group_rows=(None if group_rows is None
                    else jnp.asarray(group_rows, jnp.int32)),
        world_space=bool(world_space),
        shade_pack=shade_pack, shade_cols=tuple(shade_cols),
        obj_row=int(obj_row), max_leaf=int(fb.max_leaf),
        interp_normals=bool(interp_normals),
    )


def mergeable_spec(spec) -> bool:
    """Eligibility for the merged multi-mesh tier: features that need
    per-source-object state the merged path does not carry yet stay on
    the per-mesh path (vertex colors, seg overlays, wireframe,
    subsurface reservoirs)."""
    md = spec.mesh_data
    return (md is not None
            and md.vertex_colors is None
            and spec.seg_path is None
            and not spec.display_edges
            # a ghost inside a merged BVH would occlude behind-surfaces
            # on avoid_ghosts sweeps (closest hit returns the ghost and
            # the surface behind it is lost); per-mesh ghosts skip their
            # whole traversal instead, which is the correct semantics
            and not spec.ghost
            and spec.edge_csv is None
            and not np.any(np.broadcast_to(
                np.asarray(spec.ksub, np.float32), (3,)) != 0.0))


def merge_mesh_entries(entries):
    """Bake several mesh objects into ONE world-space MeshData.

    entries: list of (spec, row, trans (3,4) np, rot (3,3) np).
    Returns (MeshData, group_rows (G,) int32, per-group default dict,
    texture_overrides list) ready for upload_mesh(world_space=True).

    The reference reaches the same end through Embree instancing — each
    TriMesh is a sub-scene instanced with its 3x4 transform into one top
    scene (Geometry.cpp:255-277, 627-674).  An instance hierarchy would
    put a per-lane transform gather inside the traversal inner loop, so the transforms are baked into the soup instead and the
    per-object state (flags, rows) is recovered per GROUP at shading.
    Keyframed objects re-bake on every build_scene(frame=...) exactly
    like the reference's per-frame build_matrix."""
    verts, normals, uvs, tangents = [], [], [], []
    vtx_idx, n_idx, uv_idx, groups, show_edges = [], [], [], [], []
    materials, group_rows = [], []
    g_transp, g_refr, g_ksub, tex_ov = [], [], [], []
    v_base = n_base = uv_base = g_base = 0
    import dataclasses as dc
    import os

    for spec, row, trans, rot in entries:
        md = spec.mesh_data
        m3 = np.asarray(trans, np.float64)[:, :3]
        t3 = np.asarray(trans, np.float64)[:, 3]
        r3 = np.asarray(rot, np.float64)
        V = (md.vertices.astype(np.float64) @ m3.T + t3).astype(np.float32)
        t = md.vtx_idx.shape[0]
        verts.append(V)
        vtx_idx.append(md.vtx_idx + v_base)

        if spec.interp_normals and len(md.normals):
            N = (md.normals.astype(np.float64) @ r3.T).astype(np.float32)
            normals.append(N)
            n_idx.append(np.clip(md.n_idx, 0, len(md.normals) - 1)
                         + n_base)
            n_base += len(N)
        else:
            # face normals expanded per corner (flat shading baked in)
            fv = V[md.vtx_idx]
            fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
            ln = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = (fn / np.maximum(ln, 1e-20)).astype(np.float32)
            normals.append(fn)
            n_idx.append(np.repeat(np.arange(t, dtype=np.int32)[:, None],
                                   3, axis=1) + n_base)
            n_base += t

        if len(md.uvs):
            uvs.append(md.uvs)
            uv_idx.append(np.clip(md.uv_idx, 0, len(md.uvs) - 1)
                          + uv_base)
            uv_base += len(md.uvs)
        else:
            uvs.append(np.zeros((1, 2), np.float32))
            uv_idx.append(np.full((t, 3), uv_base, np.int32))
            uv_base += 1

        if md.tangents is not None:
            tangents.append((md.tangents.astype(np.float64)
                             @ r3.T).astype(np.float32))
        else:
            tangents.append(np.zeros_like(V))

        groups.append(md.group + g_base)
        show_edges.append(md.show_edges if md.show_edges is not None
                          else np.zeros((t, 3), bool))
        ng = len(md.materials)
        for m in md.materials:
            def absify(p):
                if not p:
                    return p
                q = p.replace('\\', '/')
                return q if os.path.isabs(q) else os.path.join(
                    md.obj_dir, q)
            materials.append(dc.replace(
                m, map_kd=absify(m.map_kd), map_ks=absify(m.map_ks),
                map_bump=absify(m.map_bump), map_d=absify(m.map_d)))
        group_rows.extend([row] * ng)
        g_transp.extend([bool(spec.transp)] * ng)
        g_refr.extend([float(spec.refr_index)] * ng)
        ks3 = np.broadcast_to(np.asarray(spec.ksub, np.float32), (3,))
        g_ksub.extend([ks3] * ng)
        ov = spec.textures
        ov_list = ([ov] if isinstance(ov, dict) else list(ov or []))
        ov_list = (ov_list + [None] * ng)[:ng]
        tex_ov.extend(ov_list)
        v_base += len(V)
        g_base += ng

    md_merged = obj_io.MeshData(
        vertices=np.concatenate(verts).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        uvs=np.concatenate(uvs).astype(np.float32),
        vtx_idx=np.concatenate(vtx_idx).astype(np.int32),
        uv_idx=np.concatenate(uv_idx).astype(np.int32),
        n_idx=np.concatenate(n_idx).astype(np.int32),
        group=np.concatenate(groups).astype(np.int32),
        show_edges=np.concatenate(show_edges),
        vertex_colors=None,
        materials=materials,
        group_names={},
        tangents=np.concatenate(tangents).astype(np.float32),
        obj_dir='',
    )
    gdef = {'transp': np.asarray(g_transp, bool),
            'refr': np.asarray(g_refr, np.float32),
            'ksub': np.stack(g_ksub).astype(np.float32)}
    return (md_merged, np.asarray(group_rows, np.int32), gdef, tex_ov)
