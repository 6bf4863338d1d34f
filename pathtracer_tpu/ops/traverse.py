"""Triangle-mesh intersection kernels: brute-force sweep + BVH traversal.

JAX counterpart of Triangle::intersection + TriMesh::intersection
(reference: TriangleMesh.h:67-111 precomputed edge-matrix barycentric test;
TriangleMesh.cpp:1133-1319 stack traversal with near-first ordering and
current-best-t pruning).

Two strategies, same contract:

* brute_force_hit — every ray tests every triangle, chunked over the
  triangle soup: dense elementwise work with zero gathers, ~30 flops/test
  x T x N.  The CPU tier for small meshes.

* bvh_hit — lockstep wavefront traversal of the flat BVH (ops/bvh.py) with
  a per-lane short stack.  Correct for any size; the CPU tier for big
  meshes and the XLA oracle of the GPU kernel (ops/bvh_kernel.py).

Both return the winning triangle's (t, tri_id, alpha, beta, gamma) with the
reference's semantics: strict t comparison, barycentric NaN/Inf clamps
(TriangleMesh.cpp:1220-1226) applied by the caller via bary_cleanup.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

BIG_T = np.float32(1e30)   # numpy: no backend init at import


class TriSoup(NamedTuple):
    """Precomputed triangle data (reference triangleSoup, TriangleMesh.h:67-78).

    Kept as separate (T,) component arrays (ops/bvh_kernel.pack_tris packs
    them into (T, 16) rows for the GPU kernel).
    """

    ax: jnp.ndarray; ay: jnp.ndarray; az: jnp.ndarray      # vertex A
    ux: jnp.ndarray; uy: jnp.ndarray; uz: jnp.ndarray      # B - A
    vx: jnp.ndarray; vy: jnp.ndarray; vz: jnp.ndarray      # C - A
    nx: jnp.ndarray; ny: jnp.ndarray; nz: jnp.ndarray      # cross(u, v)
    m11: jnp.ndarray; m12: jnp.ndarray; m22: jnp.ndarray
    invdetm: jnp.ndarray


def make_soup(tri_verts: np.ndarray, device: bool = True) -> TriSoup:
    """From (T,3,3) corner positions (in BVH order).

    device=False keeps the fields as host numpy (upload_mesh packs the
    kernel's triangle rows and face normals from them host-side)."""
    a = tri_verts[:, 0].astype(np.float64)
    u = tri_verts[:, 1].astype(np.float64) - a
    v = tri_verts[:, 2].astype(np.float64) - a
    n = np.cross(u, v)
    m11 = (u * u).sum(-1)
    m22 = (v * v).sum(-1)
    m12 = (u * v).sum(-1)
    det = m11 * m22 - m12 * m12
    invdetm = 1.0 / np.where(det != 0, det, 1.0)

    if device:
        def f(x):
            return jnp.asarray(x.astype(np.float32))
    else:
        def f(x):
            return x.astype(np.float32)

    return TriSoup(
        ax=f(a[:, 0]), ay=f(a[:, 1]), az=f(a[:, 2]),
        ux=f(u[:, 0]), uy=f(u[:, 1]), uz=f(u[:, 2]),
        vx=f(v[:, 0]), vy=f(v[:, 1]), vz=f(v[:, 2]),
        nx=f(n[:, 0]), ny=f(n[:, 1]), nz=f(n[:, 2]),
        m11=f(m11), m12=f(m12), m22=f(m22), invdetm=f(invdetm),
    )


class MeshHit(NamedTuple):
    t: jnp.ndarray        # (N,) BIG_T if miss
    tri: jnp.ndarray      # (N,) int32 index into soup order, -1 if miss
    alpha: jnp.ndarray    # (N,)
    beta: jnp.ndarray
    gamma: jnp.ndarray


def bary_cleanup(alpha, beta, gamma):
    """NaN/Inf clamps of the winning barycentrics (TriangleMesh.cpp:1220-1226)."""
    all_nan = jnp.isnan(alpha) & jnp.isnan(beta) & jnp.isnan(gamma)
    alpha = jnp.where(all_nan, 1.0, jnp.where(jnp.isnan(alpha), 0.0, alpha))
    beta = jnp.where(all_nan, 0.0, jnp.where(jnp.isnan(beta), 0.0, beta))
    gamma = jnp.where(all_nan, 0.0, jnp.where(jnp.isnan(gamma), 0.0, gamma))
    alpha = jnp.where(jnp.isinf(alpha), 1.0, alpha)
    beta = jnp.where(jnp.isinf(beta), 1.0, beta)
    gamma = jnp.where(jnp.isinf(gamma), 1.0, gamma)
    return alpha, beta, gamma


def _tri_test_block(soup: TriSoup, sl, org, dirn):
    """Test a (B,) triangle block against (N,) rays -> (N,B) t + baries.

    The Möller-style precomputed-edge-matrix test (TriangleMesh.h:82-103):
    t = dot(A-O, N)/dot(D, N); w = P-A; beta/gamma via 2x2 inverse; accept
    alpha,beta,gamma >= 0 and t > 0 (t<0 or NaN rejected).
    """
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]      # (N,1)
    dx, dy, dz = dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]
    ax, ay, az = soup.ax[sl], soup.ay[sl], soup.az[sl]      # (B,)
    nx, ny, nz = soup.nx[sl], soup.ny[sl], soup.nz[sl]

    dn = dx * nx + dy * ny + dz * nz                        # (N,B)
    t = ((ax - ox) * nx + (ay - oy) * ny + (az - oz) * nz) / dn
    px = ox + t * dx - ax
    py = oy + t * dy - ay
    pz = oz + t * dz - az
    b11 = px * soup.ux[sl] + py * soup.uy[sl] + pz * soup.uz[sl]
    b21 = px * soup.vx[sl] + py * soup.vy[sl] + pz * soup.vz[sl]
    beta = (b11 * soup.m22[sl] - b21 * soup.m12[sl]) * soup.invdetm[sl]
    gamma = (b21 * soup.m11[sl] - b11 * soup.m12[sl]) * soup.invdetm[sl]
    alpha = 1.0 - beta - gamma
    ok = ((t >= 0.0) & (beta >= 0.0) & (gamma >= 0.0) & (alpha >= 0.0)
          & ~jnp.isnan(t))
    return jnp.where(ok, t, BIG_T), alpha, beta, gamma


def _soup_chunks(soup: TriSoup, chunk: int):
    """Soup fields reshaped to (K, C): K = ceil(T / chunk) chunks of equal
    width C <= chunk, padded with at most K - 1 zero triangles (zero
    normal -> NaN t -> never accepted)."""
    t_total = soup.ax.shape[0]
    k = -(-t_total // chunk)
    width = -(-t_total // k)
    pad = k * width - t_total
    return TriSoup(*[jnp.pad(x, (0, pad)).reshape(k, width) for x in soup])


def brute_force_hit(soup: TriSoup, org, dirn, t_max=None, t_min=None,
                    chunk: int = 2048) -> MeshHit:
    """Dense all-pairs sweep, chunked over triangles under a lax.scan
    (closest hit; ties go to the lowest triangle index).

    t_min (N,): reject hits at or below it (alpha-cutout re-intersection)."""
    n = org.shape[0]
    chunks = _soup_chunks(soup, chunk)
    width = chunks.ax.shape[1]
    starts = jnp.arange(chunks.ax.shape[0], dtype=jnp.int32) * width

    def fold(carry, xs):
        best_t, best_tri, best_ab = carry
        blk, start = TriSoup(*xs[0]), xs[1]
        t, al, be, ga = _tri_test_block(blk, slice(None), org, dirn)
        if t_min is not None:
            t = jnp.where(t > t_min[:, None], t, BIG_T)
        j = jnp.argmin(t, axis=-1)                          # (N,)
        jj = j[:, None]
        tj = jnp.take_along_axis(t, jj, axis=-1)[:, 0]
        win = tj < best_t
        best_tri = jnp.where(win, j.astype(jnp.int32) + start, best_tri)
        best_ab = tuple(
            jnp.where(win, jnp.take_along_axis(x, jj, axis=-1)[:, 0], old)
            for x, old in zip((al, be, ga), best_ab))
        best_t = jnp.where(win, tj, best_t)
        return (best_t, best_tri, best_ab), None

    carry = (jnp.full((n,), BIG_T) if t_max is None else t_max,
             jnp.full((n,), -1, jnp.int32),
             (jnp.ones((n,)), jnp.zeros((n,)), jnp.zeros((n,))))
    (best_t, best_tri, (al, be, ga)), _ = jax.lax.scan(
        fold, carry, (tuple(chunks), starts))
    return MeshHit(t=best_t, tri=best_tri, alpha=al, beta=be, gamma=ga)


def brute_force_any(soup: TriSoup, org, dirn, t_limit, chunk: int = 2048):
    """Any-hit with t < t_limit (shadow rays). Returns bool (N,)."""
    def fold(blocked, xs):
        t, _, _, _ = _tri_test_block(TriSoup(*xs), slice(None), org, dirn)
        # min(t) < limit == any(t < limit); a float reduction (see
        # core/vec.any_true)
        return blocked | (jnp.min(t, axis=-1) < t_limit), None

    blocked, _ = jax.lax.scan(fold, jnp.zeros((org.shape[0],), bool),
                              tuple(_soup_chunks(soup, chunk)))
    return blocked


# ---------------------------------------------------------------------------
# BVH traversal (lockstep wavefront, per-lane short stack)
# ---------------------------------------------------------------------------

class BVHArrays(NamedTuple):
    """Flat BVH on device as (M,) component arrays."""

    lo_x: jnp.ndarray; lo_y: jnp.ndarray; lo_z: jnp.ndarray
    hi_x: jnp.ndarray; hi_y: jnp.ndarray; hi_z: jnp.ndarray
    a: jnp.ndarray       # internal: left child; leaf: tri range start
    b: jnp.ndarray       # internal: right child; leaf: tri range end
    leaf: jnp.ndarray    # bool


def upload_bvh(fb) -> BVHArrays:
    return BVHArrays(
        lo_x=jnp.asarray(fb.node_lo[:, 0]), lo_y=jnp.asarray(fb.node_lo[:, 1]),
        lo_z=jnp.asarray(fb.node_lo[:, 2]),
        hi_x=jnp.asarray(fb.node_hi[:, 0]), hi_y=jnp.asarray(fb.node_hi[:, 1]),
        hi_z=jnp.asarray(fb.node_hi[:, 2]),
        a=jnp.asarray(fb.node_a), b=jnp.asarray(fb.node_b),
        leaf=jnp.asarray(fb.node_leaf),
    )


def _slab(bvh: BVHArrays, node, ox, oy, oz, ix, iy, iz):
    """Slab test for gathered nodes (reference BBox::intersection_invd,
    Geometry.h:45-238). Returns (hit, t_near)."""
    lox, loy, loz = bvh.lo_x[node], bvh.lo_y[node], bvh.lo_z[node]
    hix, hiy, hiz = bvh.hi_x[node], bvh.hi_y[node], bvh.hi_z[node]
    t1x = (lox - ox) * ix
    t2x = (hix - ox) * ix
    t1y = (loy - oy) * iy
    t2y = (hiy - oy) * iy
    t1z = (loz - oz) * iz
    t2z = (hiz - oz) * iz
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                   jnp.minimum(t1y, t2y)),
                       jnp.minimum(t1z, t2z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                   jnp.maximum(t1y, t2y)),
                       jnp.maximum(t1z, t2z))
    return (tmax >= jnp.maximum(tmin, 0.0)), jnp.maximum(tmin, 0.0)


def bvh_hit(bvh: BVHArrays, soup: TriSoup, org, dirn, max_leaf: int,
            stack_depth: int = 48, t_init=None, any_hit_limit=None,
            t_min=None) -> MeshHit:
    """Lockstep BVH traversal (reference TriMesh::intersection,
    TriangleMesh.cpp:1133-1235): near-first child ordering, prune by
    current best t, leaves test <= max_leaf triangles.

    If any_hit_limit (N,) is given, acts as the shadow variant: lanes stop
    once blocked below the limit (the early-exit of :1309).
    """
    n = org.shape[0]
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    ix = 1.0 / dirn[:, 0]
    iy = 1.0 / dirn[:, 1]
    iz = 1.0 / dirn[:, 2]

    stack = jnp.zeros((stack_depth, n), jnp.int32)
    tstack = jnp.full((stack_depth, n), BIG_T)
    lanes = jnp.arange(n)

    root_hit, root_t = _slab(bvh, jnp.zeros((n,), jnp.int32),
                             ox, oy, oz, ix, iy, iz)
    sp = jnp.where(root_hit, 1, 0)
    tstack = tstack.at[0].set(jnp.where(root_hit, root_t, BIG_T))

    best_t = jnp.full((n,), BIG_T) if t_init is None else t_init
    state = (stack, tstack, sp, best_t,
             jnp.full((n,), -1, jnp.int32),
             jnp.ones((n,)), jnp.zeros((n,)), jnp.zeros((n,)))

    def cond(s):
        return jnp.max(s[2]) > 0      # sp >= 0; no bool reduction

    def body(s):
        stack, tstack, sp, best_t, best_tri, al, be, ga = s
        active = sp > 0
        sp1 = jnp.maximum(sp - 1, 0)
        node = stack[sp1, lanes]
        tnear = tstack[sp1, lanes]
        # pop; lanes whose node can't beat best just discard it
        sp_new = jnp.where(active, sp1, sp)
        process = active & (tnear <= best_t)

        is_leaf = bvh.leaf[node] | ~process
        a = bvh.a[node]
        b = bvh.b[node]

        # --- internal: test children, push near-first ---
        do_int = process & ~bvh.leaf[node]
        hit_l, t_l = _slab(bvh, a, ox, oy, oz, ix, iy, iz)
        hit_r, t_r = _slab(bvh, b, ox, oy, oz, ix, iy, iz)
        go_l = do_int & hit_l & (t_l < best_t)
        go_r = do_int & hit_r & (t_r < best_t)
        # far child first so near pops first
        l_nearer = t_l < t_r
        first = jnp.where(l_nearer, b, a)       # pushed first (far)
        first_t = jnp.where(l_nearer, t_r, t_l)
        first_go = jnp.where(l_nearer, go_r, go_l)
        second = jnp.where(l_nearer, a, b)      # pushed second (near)
        second_t = jnp.where(l_nearer, t_l, t_r)
        second_go = jnp.where(l_nearer, go_l, go_r)

        def push(stack, tstack, sp, val, tval, mask):
            spc = jnp.minimum(sp, stack_depth - 1)
            stack = stack.at[spc, lanes].set(
                jnp.where(mask, val, stack[spc, lanes]))
            tstack = tstack.at[spc, lanes].set(
                jnp.where(mask, tval, tstack[spc, lanes]))
            return stack, tstack, jnp.where(mask, sp + 1, sp)

        stack, tstack, sp_new = push(stack, tstack, sp_new, first, first_t,
                                     first_go)
        stack, tstack, sp_new = push(stack, tstack, sp_new, second, second_t,
                                     second_go)

        # --- leaf: test up to max_leaf triangles ---
        do_leaf = process & bvh.leaf[node]
        for k in range(max_leaf):
            tri = jnp.minimum(a + k, soup.ax.shape[0] - 1)
            valid = do_leaf & (a + k < b)
            t_k, al_k, be_k, ga_k = _tri_test_lane(soup, tri, org, dirn)
            win = valid & (t_k < best_t)
            if t_min is not None:
                win = win & (t_k > t_min)
            best_t = jnp.where(win, t_k, best_t)
            best_tri = jnp.where(win, tri, best_tri)
            al = jnp.where(win, al_k, al)
            be = jnp.where(win, be_k, be)
            ga = jnp.where(win, ga_k, ga)

        if any_hit_limit is not None:
            # blocked lanes terminate (shadow early-exit)
            blocked = best_t < any_hit_limit
            sp_new = jnp.where(blocked, 0, sp_new)

        return (stack, tstack, sp_new, best_t, best_tri, al, be, ga)

    state = jax.lax.while_loop(cond, body, state)
    _, _, _, best_t, best_tri, al, be, ga = state
    return MeshHit(t=best_t, tri=best_tri, alpha=al, beta=be, gamma=ga)


def _tri_test_lane(soup: TriSoup, tri, org, dirn):
    """Per-lane single-triangle test with gathered triangle data."""
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    dx, dy, dz = dirn[:, 0], dirn[:, 1], dirn[:, 2]
    ax, ay, az = soup.ax[tri], soup.ay[tri], soup.az[tri]
    nx, ny, nz = soup.nx[tri], soup.ny[tri], soup.nz[tri]
    dn = dx * nx + dy * ny + dz * nz
    t = ((ax - ox) * nx + (ay - oy) * ny + (az - oz) * nz) / dn
    px = ox + t * dx - ax
    py = oy + t * dy - ay
    pz = oz + t * dz - az
    b11 = px * soup.ux[tri] + py * soup.uy[tri] + pz * soup.uz[tri]
    b21 = px * soup.vx[tri] + py * soup.vy[tri] + pz * soup.vz[tri]
    beta = (b11 * soup.m22[tri] - b21 * soup.m12[tri]) * soup.invdetm[tri]
    gamma = (b21 * soup.m11[tri] - b11 * soup.m12[tri]) * soup.invdetm[tri]
    alpha = 1.0 - beta - gamma
    ok = ((t >= 0.0) & (beta >= 0.0) & (gamma >= 0.0) & (alpha >= 0.0)
          & ~jnp.isnan(t))
    return jnp.where(ok, t, BIG_T), alpha, beta, gamma
