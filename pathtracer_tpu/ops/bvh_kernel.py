"""Per-ray BVH traversal kernel for the GPU (Pallas, Triton route).

The mesh tier for NVIDIA cards.  Each lane walks the SAH BVH of
ops/bvh.py on its own with a short stack and retires independently —
the classic GPU stack traversal (reference: TriMesh::intersection,
TriangleMesh.cpp:1133-1235, near-first child order and current-best-t
pruning).  XLA's lockstep `traverse.bvh_hit` runs the same walk for the
whole wavefront at once, so every iteration costs all N lanes until the
slowest lane is done; here a block of BLOCK rays (one warp)
loops only until its own slowest lane is done.  On an H100 (400 W limit)
one warp per 32-ray block measured fastest of 32/64/128-ray blocks.

Layouts (one gather per fetch):

* node row, (M, 16) float32, 64 bytes: the boxes of BOTH children
  (lo_a, hi_a, lo_b, hi_b — the child boxes are tested at the parent, so
  a visit reads one row), then the child ids a, b, then a leaf flag, then
  padding.  Leaf rows hold their triangle range [a, b) instead.  Ints
  ride the row bitcast to float32.
* triangle row, (T, 16) float32: the 16 `traverse.TriSoup` fields in
  their declared order.
* per-lane stack: node id and entry distance, in an extra output buffer
  of shape (N, STACK) that each block indexes with its own lanes (the
  buffer is scratch; its contents are discarded).

Two modes: closest hit with a per-lane t_max bound and strict t_min
floor (alpha cutouts, reservoir march), and any hit (shadow rays) that
retires a lane at its first hit below t_max.  Returns (t, tri); the
scene recomputes barycentrics per ray (scene._kernel_bary).

`interpret=True` runs the same kernel on the CPU for the tests; the
renderer never sets it (scene/mesh.upload_mesh chooses the tier).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .traverse import BIG_T

BLOCK = 32          # rays per program: one warp, one ray per thread
NUM_WARPS = 1
NODE_W = 16         # floats per node row
TRI_W = 16          # floats per triangle row


def stack_size(depth: int) -> int:
    """Stack columns for a BVH of this depth: a DFS that pushes both
    children holds at most depth + 1 entries; one more column takes the
    writes of lanes that push nothing; rounded up to a power of two."""
    need = int(depth) + 2
    return 1 << max(need - 1, 1).bit_length()


def pack_nodes(fb) -> np.ndarray:
    """(M, 16) float32 node rows from a host FlatBVH (ops/bvh.py)."""
    m = fb.n_nodes
    rows = np.zeros((m, NODE_W), np.float32)
    leaf = np.asarray(fb.node_leaf, bool)
    a = np.asarray(fb.node_a, np.int32)
    b = np.asarray(fb.node_b, np.int32)
    inner = ~leaf
    ca, cb = a[inner], b[inner]
    rows[inner, 0:3] = fb.node_lo[ca]
    rows[inner, 3:6] = fb.node_hi[ca]
    rows[inner, 6:9] = fb.node_lo[cb]
    rows[inner, 9:12] = fb.node_hi[cb]
    rows[:, 12] = a.view(np.float32)
    rows[:, 13] = b.view(np.float32)
    rows[:, 14] = leaf.astype(np.int32).view(np.float32)
    return rows


def root_box(fb) -> np.ndarray:
    """(8,) float32: the root's box (lo, hi) padded — tested once per ray."""
    out = np.zeros((8,), np.float32)
    out[0:3] = fb.node_lo[0]
    out[3:6] = fb.node_hi[0]
    return out


def pack_tris(soup) -> np.ndarray:
    """(T, 16) float32 triangle rows from a (host or device) TriSoup."""
    return np.stack([np.asarray(x, np.float32) for x in soup], axis=1)


def _slab(lo, hi, ox, oy, oz, ix, iy, iz):
    """Ray/box slab test (traverse._slab): (hit, entry t clamped at 0)."""
    t1x = (lo[0] - ox) * ix
    t2x = (hi[0] - ox) * ix
    t1y = (lo[1] - oy) * iy
    t2y = (hi[1] - oy) * iy
    t1z = (lo[2] - oz) * iz
    t2z = (hi[2] - oz) * iz
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                   jnp.minimum(t1y, t2y)),
                       jnp.minimum(t1z, t2z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                   jnp.maximum(t1y, t2y)),
                       jnp.maximum(t1z, t2z))
    tn = jnp.maximum(tmin, 0.0)
    return tmax >= tn, tn


def _kernel(root_ref, nodes_ref, tris_ref, rays_ref, t_ref, tri_ref,
            stk_ref, tstk_ref, *, block, n_tris, max_leaf, any_hit,
            use_tmin, stack_cols):
    lane = jax.lax.iota(jnp.int32, block)
    ox, oy, oz = rays_ref[:, 0], rays_ref[:, 1], rays_ref[:, 2]
    dx, dy, dz = rays_ref[:, 3], rays_ref[:, 4], rays_ref[:, 5]
    t_max = rays_ref[:, 6]
    t_min = rays_ref[:, 7]
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    zero = jnp.zeros((block,), jnp.int32)
    dummy = jnp.full((block,), stack_cols - 1, jnp.int32)

    lo = [root_ref[k] for k in range(3)]
    hi = [root_ref[3 + k] for k in range(3)]
    hit0, tn0 = _slab(lo, hi, ox, oy, oz, ix, iy, iz)
    stk_ref[lane, zero] = zero
    tstk_ref[lane, zero] = tn0
    sp = jnp.where(hit0 & (tn0 < t_max), 1, 0)

    def nodef(node, k):
        return nodes_ref[node, k]

    def nodei(node, k):
        return jax.lax.bitcast_convert_type(nodes_ref[node, k], jnp.int32)

    def cond(c):
        return jnp.max(c[0]) > 0

    def body(c):
        sp, best_t, best_tri = c
        active = sp > 0
        sp1 = jnp.maximum(sp - 1, 0)
        node = stk_ref[lane, sp1]
        tnear = tstk_ref[lane, sp1]
        sp = jnp.where(active, sp1, sp)
        process = active & (tnear <= best_t)
        a = nodei(node, 12)
        b = nodei(node, 13)
        is_leaf = nodei(node, 14) != 0

        # internal node: both child boxes from this row, push far then near
        do_int = process & ~is_leaf
        hit_a, t_a = _slab([nodef(node, k) for k in range(0, 3)],
                           [nodef(node, k) for k in range(3, 6)],
                           ox, oy, oz, ix, iy, iz)
        hit_b, t_b = _slab([nodef(node, k) for k in range(6, 9)],
                           [nodef(node, k) for k in range(9, 12)],
                           ox, oy, oz, ix, iy, iz)
        go_a = do_int & hit_a & (t_a < best_t)
        go_b = do_int & hit_b & (t_b < best_t)
        a_near = t_a < t_b
        far = jnp.where(a_near, b, a)
        far_t = jnp.where(a_near, t_b, t_a)
        far_go = jnp.where(a_near, go_b, go_a)
        near = jnp.where(a_near, a, b)
        near_t = jnp.where(a_near, t_a, t_b)
        near_go = jnp.where(a_near, go_a, go_b)
        for val, tval, go in ((far, far_t, far_go), (near, near_t, near_go)):
            col = jnp.where(go, jnp.minimum(sp, stack_cols - 2), dummy)
            stk_ref[lane, col] = val
            tstk_ref[lane, col] = tval
            sp = jnp.where(go, jnp.minimum(sp + 1, stack_cols - 1), sp)

        # leaf: test its triangles (traverse._tri_test_lane arithmetic)
        do_leaf = process & is_leaf
        for k in range(max_leaf):
            tri = jnp.clip(a + k, 0, n_tris - 1)
            valid = do_leaf & (a + k < b)
            f = [tris_ref[tri, j] for j in range(TRI_W)]
            (ax_, ay_, az_, ux, uy, uz, vx, vy, vz, nx, ny, nz,
             m11, m12, m22, inv) = f
            dn = dx * nx + dy * ny + dz * nz
            t = ((ax_ - ox) * nx + (ay_ - oy) * ny + (az_ - oz) * nz) / dn
            px = ox + t * dx - ax_
            py = oy + t * dy - ay_
            pz = oz + t * dz - az_
            b11 = px * ux + py * uy + pz * uz
            b21 = px * vx + py * vy + pz * vz
            beta = (b11 * m22 - b21 * m12) * inv
            gamma = (b21 * m11 - b11 * m12) * inv
            alpha = 1.0 - beta - gamma
            ok = ((t >= 0.0) & (beta >= 0.0) & (gamma >= 0.0)
                  & (alpha >= 0.0) & (t == t))
            win = valid & ok & (t < best_t)
            if use_tmin:
                win = win & (t > t_min)
            best_t = jnp.where(win, t, best_t)
            best_tri = jnp.where(win, tri, best_tri)
        if any_hit:
            sp = jnp.where(best_tri >= 0, 0, sp)
        return sp, best_t, best_tri

    _, best_t, best_tri = jax.lax.while_loop(
        cond, body, (sp, t_max, jnp.full((block,), -1, jnp.int32)))
    t_ref[...] = jnp.where(best_tri >= 0, best_t, BIG_T)
    tri_ref[...] = best_tri


@functools.partial(jax.jit, static_argnames=(
    'max_leaf', 'depth', 'any_hit', 'use_tmin', 'block', 'num_warps',
    'interpret'))
def _call(root, nodes, tris, rays, *, max_leaf, depth, any_hit, use_tmin,
          block, num_warps, interpret):
    n = rays.shape[0]
    cols = stack_size(depth)
    kern = functools.partial(
        _kernel, block=block, n_tris=tris.shape[0], max_leaf=max_leaf,
        any_hit=any_hit, use_tmin=use_tmin, stack_cols=cols)
    row = pl.BlockSpec((block,), lambda i: (i,))
    t, tri, _, _ = pl.pallas_call(
        kern,
        grid=(n // block,),
        in_specs=[pl.no_block_spec, pl.no_block_spec, pl.no_block_spec,
                  pl.BlockSpec((block, 8), lambda i: (i, 0))],
        out_specs=[row, row,
                   pl.BlockSpec((block, cols), lambda i: (i, 0)),
                   pl.BlockSpec((block, cols), lambda i: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.int32),
                   jax.ShapeDtypeStruct((n, cols), jnp.int32),
                   jax.ShapeDtypeStruct((n, cols), jnp.float32)],
        backend='triton',
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name='bvh_traverse_any' if any_hit else 'bvh_traverse_closest',
    )(root, nodes, tris, rays)
    return t, tri


def pack_rays(org, dirn, t_max, t_min=None, block: int = BLOCK):
    """(N_pad, 8) ray rows (o, d, t_max, t_min), padded to the block with
    dead rays (t_max = -1 never enters the root)."""
    n = org.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    t_min = (jnp.full((n,), -1.0, jnp.float32) if t_min is None
             else jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,)))
    rays = jnp.concatenate([org.astype(jnp.float32),
                            dirn.astype(jnp.float32),
                            t_max[:, None], t_min[:, None]], axis=1)
    pad = (-n) % block
    if pad:
        dead = jnp.zeros((pad, 8), jnp.float32)
        dead = dead.at[:, 3].set(1.0).at[:, 6].set(-1.0)
        rays = jnp.concatenate([rays, dead])
    return rays


def kernel_hit(root, nodes, tris, org, dirn, t_max=None, t_min=None, *,
               max_leaf: int, depth: int, any_hit: bool = False,
               block: int = BLOCK, num_warps: int = NUM_WARPS,
               interpret: bool = False):
    """Closest (or any) hit of N rays against a packed BVH.

    root (8,), nodes (M, 16), tris (T, 16) from root_box / pack_nodes /
    pack_tris.  t_max (N,) or None: hits must have t < t_max (any-hit:
    the occlusion distance).  t_min (N,) or None: hits must have
    t > t_min.  Returns (t, tri): BIG_T / -1 on a miss."""
    n = org.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), BIG_T, jnp.float32)
    rays = pack_rays(org, dirn, t_max, t_min, block)
    t, tri = _call(root, nodes, tris, rays, max_leaf=int(max_leaf),
                   depth=int(depth), any_hit=bool(any_hit),
                   use_tmin=t_min is not None, block=int(block),
                   num_warps=int(num_warps), interpret=bool(interpret))
    return t[:n], tri[:n]
