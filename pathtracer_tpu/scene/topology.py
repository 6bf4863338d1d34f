"""Mesh topology diagnostics + coloring utilities.

Counterpart of the reference's mesh-sanity tooling (reference:
TriMesh::getNbConnected TriangleMesh.cpp:1459-1513, findQuads :1432-1457,
colorAnisotropy/randomColors TriangleMesh.h:168-204, the ShowMeshInfo
dialog mainApp.cpp:1397-1431, BVH stats surfaced mainApp.cpp:974).
All host-side numpy/scipy — diagnostics, not render path.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshInfo:
    """The ShowMeshInfo numbers (mainApp.cpp:1397-1431)."""

    n_triangles: int
    n_polygons: int          # recovered quads/n-gons (findQuads)
    n_real_edges: int        # edges excluding fan diagonals
    n_edges: int
    n_components: int
    n_non_manifold: int
    n_boundary_edges: int
    euler: int
    genus: float


def _edge_key(a, b):
    return (a, b) if a < b else (b, a)


def _edges_to_faces(vtx_idx):
    out = {}
    for f, (a, b, c) in enumerate(vtx_idx):
        for e in (_edge_key(a, b), _edge_key(b, c), _edge_key(a, c)):
            out.setdefault(e, []).append(f)
    return out


def connected_components(vtx_idx: np.ndarray):
    """Face-adjacency component count + edge stats (TriangleMesh.cpp:1459-1513)."""
    e2f = _edges_to_faces(vtx_idx)
    n_edges = len(e2f)
    non_manifold = sum(1 for fs in e2f.values() if len(fs) > 2)
    boundary = sum(1 for fs in e2f.values() if len(fs) == 1)

    # union-find over faces sharing an edge
    parent = np.arange(len(vtx_idx))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for fs in e2f.values():
        for f in fs[1:]:
            ra, rb = find(fs[0]), find(f)
            if ra != rb:
                parent[rb] = ra
    comps = len({find(f) for f in range(len(vtx_idx))})
    return comps, n_edges, non_manifold, boundary


def find_quads(vtx_idx: np.ndarray, show_edges: np.ndarray):
    """Recover polygon counts from fan-diagonal flags (TriangleMesh.cpp:1432-1457).

    show_edges[f] = (e_ij, e_jk, e_ik) visibility in the reference's edge
    order (showEdges[0]=ij, [1]=jk, [2]=ik).
    """
    edge_visible = {}
    n_triangles = 0
    for f, (a, b, c) in enumerate(vtx_idx):
        se = show_edges[f]
        edge_visible[_edge_key(a, b)] = bool(se[0])
        edge_visible[_edge_key(b, c)] = bool(se[1])
        edge_visible[_edge_key(a, c)] = bool(se[2])
        if se[0] and se[1] and se[2]:
            n_triangles += 1
    n_hidden = sum(1 for v in edge_visible.values() if not v)
    n_real_edges = len(edge_visible) - n_hidden
    n_facets = len(vtx_idx) - n_hidden
    return n_triangles, n_facets - n_triangles, n_real_edges


def mesh_info(md) -> MeshInfo:
    """Full diagnostics for a host MeshData (io/obj.py)."""
    comps, n_edges, non_manifold, boundary = connected_components(md.vtx_idx)
    # the reference maps its loader's showEdges (first,True,last) with
    # edge order [0]=prev-edge marker; ours stores (first, True, last) per
    # fan tri — translate to the reference edge semantic
    ntri, npoly, nreal = find_quads(md.vtx_idx, md.show_edges)
    n_vertices = len(md.vertices)
    euler = n_vertices - n_edges + len(md.vtx_idx)
    genus = (2 * comps - euler) / 2.0
    return MeshInfo(
        n_triangles=ntri, n_polygons=npoly, n_real_edges=nreal,
        n_edges=n_edges, n_components=comps, n_non_manifold=non_manifold,
        n_boundary_edges=boundary, euler=euler, genus=genus)


def color_anisotropy(vertices: np.ndarray, vtx_idx: np.ndarray):
    """Per-face anisotropy color (TriangleMesh.h:168-190): the max |cos| of
    the triangle's corner angles, mapped through a hue ramp."""
    a = vertices[vtx_idx[:, 0]]
    b = vertices[vtx_idx[:, 1]]
    c = vertices[vtx_idx[:, 2]]

    def cosang(u, v):
        nu = np.linalg.norm(u, axis=1)
        nv = np.linalg.norm(v, axis=1)
        return np.abs(np.sum(u * v, axis=1)) / np.maximum(nu * nv, 1e-20)

    m = np.maximum(cosang(b - a, c - a),
                   np.maximum(cosang(a - b, c - b), cosang(a - c, b - c)))
    aniso = np.degrees(np.arccos(np.clip(m, -1, 1)))
    hue = np.clip(aniso / 60.0 * 240.0, 0.0, 240.0)
    return transform_hue(np.array([1.0, 0.0, 0.0]), hue)


def transform_hue(rgb: np.ndarray, hue_deg):
    """Hue rotation of a color (the reference's TransformH)."""
    hue = np.radians(np.atleast_1d(hue_deg))
    cos_a = np.cos(hue)
    sin_a = np.sin(hue)
    one3 = 1.0 / 3.0
    sq3 = np.sqrt(1.0 / 3.0)
    m = np.empty((len(hue), 3, 3))
    m[:, 0, 0] = cos_a + (1 - cos_a) * one3
    m[:, 0, 1] = one3 * (1 - cos_a) - sq3 * sin_a
    m[:, 0, 2] = one3 * (1 - cos_a) + sq3 * sin_a
    m[:, 1, 0] = one3 * (1 - cos_a) + sq3 * sin_a
    m[:, 1, 1] = cos_a + one3 * (1 - cos_a)
    m[:, 1, 2] = one3 * (1 - cos_a) - sq3 * sin_a
    m[:, 2, 0] = one3 * (1 - cos_a) - sq3 * sin_a
    m[:, 2, 1] = one3 * (1 - cos_a) + sq3 * sin_a
    m[:, 2, 2] = cos_a + one3 * (1 - cos_a)
    out = np.einsum('fij,j->fi', m, rgb)
    return np.clip(out, 0.0, 1.0)


def random_colors(facecolors: np.ndarray, seed: int = 0):
    """Hash-recolor of face colors (TriangleMesh.h:192-204)."""
    rng = np.random.default_rng(seed)
    r1, r2, r3 = (int(rng.integers(1, 10001)) for _ in range(3))
    c = (facecolors * 1024).astype(np.int64)

    def h(x, r, k1, k2):
        return ((x * r + x * x * (r + k1) + x * k2 + r + 3) % 1024) / 1024.0

    return np.stack([h(c[:, 0], r1, 1, 15), h(c[:, 1], r2, 9, 7),
                     h(c[:, 2], r3, 3, 18)], axis=-1)


def save_anisotropy_legend(path: str):
    """The 30x240 hue-strip legend PNG colorAnisotropy writes alongside
    its face colors (reference: TriangleMesh.h:181-190): row i =
    TransformH(red, i degrees), gamma-2.2 encoded like the reference's
    albedo convention."""
    img = np.zeros((240, 30, 3), np.float32)
    for i in range(240):
        img[i, :] = transform_hue(np.asarray([1.0, 0.0, 0.0]), float(i))[0]
    u8 = (np.clip(img, 0.0, 1.0) ** (1.0 / 2.2) * 255.0).astype(np.uint8)
    from ..io import image as image_io
    image_io.save_image(path, u8)
    return u8
