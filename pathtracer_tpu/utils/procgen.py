"""Procedural benchmark meshes (config-2/3/5 stand-ins).

The reference's showcase scenes (lion 1.8k tris, bot 2.5M, antiqueOffice
23.7M — reference README.md:40-82) ship as OBJ blobs that are not in this
environment, so the bench ladder uses procedurally generated meshes of the
same scale: a displaced UV sphere (closed surface — the shape class of the
scanned models) and a sine terrain (open worst case for the cluster
early-break).  Generators return io.obj.MeshData so they flow through the
exact same upload/BVH/material path as loaded OBJs.
"""

from __future__ import annotations

import numpy as np

from ..io.obj import GroupMaterial, MeshData


def _meshdata(verts: np.ndarray, tris: np.ndarray, normals: np.ndarray,
              uvs: np.ndarray, kd=(0.6, 0.55, 0.5)) -> MeshData:
    t = tris.shape[0]
    mat = GroupMaterial(kd=np.asarray(kd, np.float32))
    return MeshData(
        vertices=verts.astype(np.float32),
        normals=normals.astype(np.float32),
        uvs=uvs.astype(np.float32),
        vtx_idx=tris.astype(np.int32),
        uv_idx=tris.astype(np.int32),
        n_idx=tris.astype(np.int32),
        group=np.zeros(t, np.int32),
        show_edges=np.ones((t, 3), bool),
        vertex_colors=None,
        materials=[mat],
        group_names={'default': 0},
        tangents=None,
        obj_dir='',
    )


def sphere_mesh(n_lat: int, n_lon: int, radius: float = 1.0,
                displace_amp: float = 0.0, seed: int = 0,
                kd=(0.6, 0.55, 0.5)) -> MeshData:
    """Closed UV sphere with ~2*n_lat*n_lon triangles, optional smooth
    radial displacement (band-limited sines) so the BVH sees organic
    local structure instead of a perfect quadric."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)[:-1]
    LAT, LON = np.meshgrid(lat, lon, indexing='ij')   # (n_lat+1, n_lon)
    x = np.sin(LAT) * np.cos(LON)
    y = np.cos(LAT)
    z = np.sin(LAT) * np.sin(LON)
    # snap the pole rows exactly (sin(pi) is ~1.2e-16, which would leave
    # every bottom-pole vertex at a slightly DIFFERENT position — real
    # cracks that fail the watertightness gate)
    x[0, :] = 0.0; z[0, :] = 0.0; y[0, :] = 1.0
    x[-1, :] = 0.0; z[-1, :] = 0.0; y[-1, :] = -1.0
    r = np.full_like(x, radius)
    if displace_amp > 0.0:
        rng = np.random.default_rng(seed)
        # sin(LAT) envelope: the displacement vanishes at the poles so
        # every pole-ring vertex lands on the SAME point — the sphere is
        # genuinely watertight (a pole ring whose radius varied with LON
        # left real cracks there)
        env = np.sin(LAT)
        env[0, :] = 0.0; env[-1, :] = 0.0   # exact zero at the poles
        for _ in range(6):
            f = rng.uniform(2.0, 9.0, 3)
            ph = rng.uniform(0, 2 * np.pi, 3)
            r = r + env * displace_amp * radius / 6.0 * (
                np.sin(f[0] * LAT + ph[0]) * np.cos(f[1] * LON + ph[1])
                + 0.5 * np.sin(f[2] * (LAT + LON) + ph[2]))
    verts = np.stack([x * r, y * r, z * r], -1).reshape(-1, 3)
    normals = np.stack([x, y, z], -1).reshape(-1, 3)   # radial (approx)
    uvs = np.stack([LON / (2 * np.pi), 1.0 - LAT / np.pi],
                   -1).reshape(-1, 2)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    ii, jj = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing='ij')
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    v00 = vid(ii, jj)
    v10 = vid(ii + 1, jj)
    v01 = vid(ii, jj + 1)
    v11 = vid(ii + 1, jj + 1)
    tris = np.concatenate([np.stack([v00, v10, v11], -1),
                           np.stack([v00, v11, v01], -1)], 0)
    # drop degenerate polar slivers: pole-ring "vertices" have distinct
    # indices but collinear positions (identical when displace_amp == 0),
    # so filter by actual area, not index equality — degenerate triangles
    # hit NaN/inf edge cases differently per backend and break parity
    tv = verts[tris]
    area2 = np.linalg.norm(np.cross(tv[:, 1] - tv[:, 0],
                                    tv[:, 2] - tv[:, 0]), axis=1)
    diag2 = float(np.sum((verts.max(0) - verts.min(0)) ** 2))
    tris = tris[area2 > 1e-10 * diag2]
    return _meshdata(verts, tris, normals, uvs, kd=kd)


def terrain_mesh(g: int, extent: float = 20.0, amp: float = 3.0,
                 kd=(0.45, 0.5, 0.35)) -> MeshData:
    """Open sine terrain with 2*g*g triangles — the cluster kernel's
    worst case (grazing rays, no early break for sky-miss lanes)."""
    xs = np.linspace(-extent, extent, g + 1, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing='ij')
    Y = (amp * np.sin(X * 0.6) * np.cos(Z * 0.5)
         + 0.4 * amp * np.sin(X * 1.7 + 2.0))
    verts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    # analytic-ish normals from central differences
    gy_x = np.gradient(Y, xs, axis=0)
    gy_z = np.gradient(Y, xs, axis=1)
    n = np.stack([-gy_x, np.ones_like(Y), -gy_z], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normals = n.reshape(-1, 3)
    uvs = np.stack([(X + extent) / (2 * extent),
                    (Z + extent) / (2 * extent)], -1).reshape(-1, 2)

    def vid(i, j):
        return i * (g + 1) + j

    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing='ij')
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    v00 = vid(ii, jj)
    v10 = vid(ii + 1, jj)
    v01 = vid(ii, jj + 1)
    v11 = vid(ii + 1, jj + 1)
    tris = np.concatenate([np.stack([v00, v10, v11], -1),
                           np.stack([v00, v11, v01], -1)], 0)
    return _meshdata(verts, tris, normals, uvs, kd=kd)
