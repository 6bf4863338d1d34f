"""Host-side BVH build -> flat device arrays.

JAX counterpart of TriMesh::build_bvh_recur (reference:
TriangleMesh.cpp:1029-1130): binary BVH, split axis = largest
centroid-extent, 16 candidate split planes scored by area*count (SAH-lite),
in-place partition of the triangle order (the permutation is returned so
face attributes can be reordered to match, like the reference's
permuted_triangle_index), leaves of <=4 triangles or failed splits.

The recursive node records of the reference flatten into SoA arrays ready
for the vectorized/Pallas traversal:
  node_lo/node_hi : (M,3) child bboxes
  node_a, node_b  : (M,)  internal: left/right child ids;
                          leaf: triangle range [a, b)
  node_leaf       : (M,)  bool

Build is vectorized numpy per node (the 16-way split scoring sweeps all
triangles in the range at once); a C++ builder can replace this for the
multi-million-triangle configs without changing the array contract.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import NamedTuple, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native')
_native_lib = None
_native_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the C++ builder via ctypes; None on failure.

    The native builder replaces this module's numpy build for large meshes —
    same algorithm, C++ speed (the reference's builder is C++ too,
    TriangleMesh.cpp:1029-1130).
    """
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    _native_tried = True
    src = os.path.join(_NATIVE_DIR, 'bvh_builder.cpp')
    lib = os.path.join(_NATIVE_DIR, 'libptbvh.so')
    try:
        if (not os.path.exists(lib)
                or os.path.getmtime(lib) < os.path.getmtime(src)):
            subprocess.run(
                ['g++', '-O3', '-shared', '-fPIC', src, '-o', lib],
                check=True, capture_output=True, timeout=120)
        dll = ctypes.CDLL(lib)
        dll.pt_build_bvh.restype = ctypes.c_int
        _native_lib = dll
    except Exception:
        _native_lib = None
    return _native_lib


NATIVE_BUILD_MIN_TRIS = 20000   # below this numpy is fast enough


class FlatBVH(NamedTuple):
    node_lo: np.ndarray      # (M,3) f32
    node_hi: np.ndarray      # (M,3) f32
    node_a: np.ndarray       # (M,) int32
    node_b: np.ndarray       # (M,) int32
    node_leaf: np.ndarray    # (M,) bool
    order: np.ndarray        # (T,) int32: new position -> original tri index
    max_leaf: int
    depth: int
    n_nodes: int


def build_bvh(tri_verts: np.ndarray, max_leaf_size: int = 4,
              n_split_tests: int = 16) -> FlatBVH:
    """Build from (T,3,3) triangle vertices (3 corners x xyz)."""
    v = tri_verts.astype(np.float32)
    return build_bvh_from_bounds(v.min(axis=1), v.max(axis=1),
                                 v.mean(axis=1),  # (A+B+C)/3, ref :1074
                                 max_leaf_size, n_split_tests)


def build_bvh_native(lo_tri, hi_tri, centers, max_leaf_size=4,
                     n_split_tests=16) -> Optional[FlatBVH]:
    """C++ builder path (native/bvh_builder.cpp); None if unavailable."""
    dll = _load_native()
    if dll is None:
        return None
    n = lo_tri.shape[0]
    lo = np.ascontiguousarray(lo_tri, np.float32)
    hi = np.ascontiguousarray(hi_tri, np.float32)
    cen = np.ascontiguousarray(centers, np.float32)
    cap = 2 * n
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_a = np.empty(cap, np.int32)
    node_b = np.empty(cap, np.int32)
    node_leaf = np.empty(cap, np.uint8)
    order = np.empty(n, np.int32)
    stats = np.zeros(3, np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = dll.pt_build_bvh(p(lo), p(hi), p(cen), n, max_leaf_size,
                          n_split_tests, p(node_lo), p(node_hi), p(node_a),
                          p(node_b), p(node_leaf), p(order), p(stats))
    if rc != 0:
        return None
    m = int(stats[0])
    return FlatBVH(node_lo=node_lo[:m], node_hi=node_hi[:m],
                   node_a=node_a[:m], node_b=node_b[:m],
                   node_leaf=node_leaf[:m].astype(bool), order=order,
                   max_leaf=int(stats[2]), depth=int(stats[1]), n_nodes=m)


def build_bvh_from_bounds(lo_tri: np.ndarray, hi_tri: np.ndarray,
                          centers: np.ndarray, max_leaf_size: int = 4,
                          n_split_tests: int = 16,
                          prefer_native: Optional[bool] = None) -> FlatBVH:
    """Build from per-primitive bounds+centers — shared by triangles, point
    disks (PointSet.cpp:34-121) and yarn cylinders (TriangleMesh.cpp:1550+).

    Large inputs route to the C++ builder automatically."""
    t = lo_tri.shape[0]
    assert t > 0
    if prefer_native is None:
        prefer_native = t >= NATIVE_BUILD_MIN_TRIS
    if prefer_native:
        fb = build_bvh_native(lo_tri, hi_tri, centers, max_leaf_size,
                              n_split_tests)
        if fb is not None:
            return fb

    order = np.arange(t, dtype=np.int32)

    node_lo, node_hi, node_a, node_b, node_leaf = [], [], [], [], []
    stats = {'max_leaf': 0, 'depth': 0, 'n_nodes': 0}

    def new_node(i0, i1):
        idx = len(node_lo)
        sel = order[i0:i1]
        node_lo.append(lo_tri[sel].min(axis=0))
        node_hi.append(hi_tri[sel].max(axis=0))
        node_a.append(i0)
        node_b.append(i1)
        node_leaf.append(True)
        return idx

    # iterative DFS matching the reference's recursion order (left first)
    root = new_node(0, t)
    stack = [(root, 0, t, 0)]
    while stack:
        node, i0, i1, depth = stack.pop()
        stats['depth'] = max(stats['depth'], depth)
        stats['n_nodes'] += 1
        sel = order[i0:i1]
        cen = centers[sel]
        clo, chi = cen.min(axis=0), cen.max(axis=0)
        diag = chi - clo
        # split axis: largest centroid extent with the reference's tie rule
        # (x wins ties over y over z, TriangleMesh.cpp:1047-1055)
        if diag[0] >= diag[1] and diag[0] >= diag[2]:
            axis = 0
        elif diag[1] >= diag[0] and diag[1] >= diag[2]:
            axis = 1
        else:
            axis = 2
        c_ax = cen[:, axis]

        # score n_split_tests planes by area*count (TriangleMesh.cpp:1066-1099)
        fracs = (np.arange(1, n_split_tests + 1, dtype=np.float32)
                 / (n_split_tests + 1))
        split_vals = clo[axis] + diag[axis] * fracs           # (S,)
        left = c_ax[None, :] <= split_vals[:, None]           # (S,Tn)
        tl = lo_tri[sel]
        th = hi_tri[sel]

        def side_area(mask):
            # bbox area of the masked set per split, vectorized over S
            big = np.float32(1e10)
            mlo = np.where(mask[..., None], tl[None], big).min(axis=1)
            mhi = np.where(mask[..., None], th[None], -big).max(axis=1)
            d = np.maximum(mhi - mlo, 0.0)
            return 2.0 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2]
                          + d[:, 1] * d[:, 2])

        nl = left.sum(axis=1)
        nr = (i1 - i0) - nl
        score = side_area(left) * nl + side_area(~left) * nr
        best = int(np.argmin(score))
        split_val = split_vals[best]

        # stable partition keeping the reference's in-place order semantics
        go_left = c_ax <= split_val
        perm = np.concatenate([np.where(go_left)[0], np.where(~go_left)[0]])
        order[i0:i1] = sel[perm]
        pivot = i0 + int(go_left.sum()) - 1

        if pivot < i0 or pivot >= i1 - 1 or i1 <= i0 + max_leaf_size:
            stats['max_leaf'] = max(stats['max_leaf'], i1 - i0)
            continue                      # stays leaf [i0, i1)

        node_leaf[node] = False
        fg = new_node(i0, pivot + 1)
        fd = new_node(pivot + 1, i1)
        node_a[node] = fg
        node_b[node] = fd
        # push right first so left pops first (reference recursion order)
        stack.append((fd, pivot + 1, i1, depth + 1))
        stack.append((fg, i0, pivot + 1, depth + 1))

    return FlatBVH(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_a=np.asarray(node_a, np.int32),
        node_b=np.asarray(node_b, np.int32),
        node_leaf=np.asarray(node_leaf, bool),
        order=order,
        max_leaf=stats['max_leaf'] if stats['max_leaf'] else max_leaf_size,
        depth=stats['depth'],
        n_nodes=len(node_lo),
    )
