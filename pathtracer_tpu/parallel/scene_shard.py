"""Scene-sharded intersection: the BVH partitioned across devices.

For scenes whose BVH outgrows one device's memory (SURVEY §7 'sharded
BVH'), partition the triangle set spatially (contiguous ranges of the BVH build order are
spatially coherent), give each chip one partition + its sub-BVH, and
combine per-ray closest hits across the 'scene' mesh axis.

This module implements the broadcast-combine form — every chip intersects
the full ray wavefront against its partition, and an all-gather + argmin
picks the winner.  It is exact and simple; the refinement (ray-sorted
all-to-all routing rays only to partitions whose AABB they enter,
SURVEY §2.7) reuses the same partition layout.

These are standalone hit functions (tested on the virtual CPU mesh); the
renderer does not use them yet — it replicates the scene on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import bvh as bvh_mod
from ..ops import traverse

BIG_T = np.float32(1e30)


class ShardedMesh(NamedTuple):
    """(D, Tpad) per-partition triangle soup components + validity mask."""

    soup: traverse.TriSoup     # each leaf (D, Tpad)
    valid: jnp.ndarray         # (D, Tpad) bool
    tri_base: jnp.ndarray      # (D,) int32 — partition offset in BVH order
    order: np.ndarray          # (T,) global BVH order (host)


def partition_mesh(tri_verts: np.ndarray, n_shards: int) -> ShardedMesh:
    """Partition triangles into spatially-coherent equal chunks.

    A global BVH build provides the spatial ordering; contiguous ranges of
    that order become the per-chip partitions.
    """
    t = tri_verts.shape[0]
    fb = bvh_mod.build_bvh(tri_verts)
    ordered = tri_verts[fb.order]
    tpad = -(-t // n_shards)
    pad = n_shards * tpad - t
    if pad:
        ordered = np.concatenate(
            [ordered, np.zeros((pad, 3, 3), np.float32)], axis=0)
    soup_flat = traverse.make_soup(ordered)
    soup = traverse.TriSoup(*[jnp.asarray(np.asarray(x).reshape(
        n_shards, tpad)) for x in soup_flat])
    valid = (np.arange(n_shards * tpad) < t).reshape(n_shards, tpad)
    base = (np.arange(n_shards) * tpad).astype(np.int32)
    return ShardedMesh(soup=soup, valid=jnp.asarray(valid),
                       tri_base=jnp.asarray(base), order=fb.order)


class ShardedBVH(NamedTuple):
    """v2 layout: per-partition sub-BVH + soup, node arrays padded to a
    common length; partition AABBs drive the ray routing."""

    soup: traverse.TriSoup     # each leaf (D, Tpad), LOCAL BVH order
    valid: jnp.ndarray         # (D, Tpad)
    tri_base: jnp.ndarray      # (D,)
    bvh: traverse.BVHArrays    # each leaf (D, Mpad)
    part_lo: jnp.ndarray       # (D, 3) partition AABB
    part_hi: jnp.ndarray       # (D, 3)
    max_leaf: int              # max over partitions (static)
    order: np.ndarray          # (T,) global spatial order (host)


def partition_mesh_bvh(tri_verts: np.ndarray, n_shards: int) -> ShardedBVH:
    """Spatially-coherent partitions, each with its own sub-BVH.

    The global BVH build supplies the spatial order (like partition_mesh);
    every contiguous chunk then gets a LOCAL BVH so each chip traverses
    log(T/D) instead of brute-forcing its soup (the v1 form)."""
    t = tri_verts.shape[0]
    fb = bvh_mod.build_bvh(tri_verts)
    ordered = tri_verts[fb.order]
    tpad = -(-t // n_shards)
    pad = n_shards * tpad - t

    soups, valids, bvhs, n_nodes, max_leafs = [], [], [], [], []
    lo_all, hi_all = [], []
    for d in range(n_shards):
        nv = max(0, min(tpad, t - d * tpad))
        chunk = ordered[d * tpad:d * tpad + nv]
        if nv == 0:
            chunk = np.zeros((1, 3, 3), np.float32)
        lfb = bvh_mod.build_bvh(chunk)
        local = chunk[lfb.order]
        if len(local) < tpad:
            local = np.concatenate(
                [local, np.zeros((tpad - len(local), 3, 3), np.float32)])
        soups.append(traverse.make_soup(local))
        valids.append(np.arange(tpad) < nv)
        bvhs.append(lfb)
        n_nodes.append(len(lfb.node_a))
        max_leafs.append(lfb.max_leaf)
        if nv:
            lo_all.append(local[:nv].reshape(-1, 3).min(0))
            hi_all.append(local[:nv].reshape(-1, 3).max(0))
            # remap this partition's global order slice to its local order
            fb.order[d * tpad:d * tpad + nv] = \
                fb.order[d * tpad:d * tpad + nv][lfb.order]
        else:
            # inverted box: routes no rays
            lo_all.append(np.full(3, BIG_T, np.float32))
            hi_all.append(np.full(3, -BIG_T, np.float32))

    mpad = max(n_nodes)

    def pad_nodes(fbs, get, fill):
        out = np.stack([
            np.concatenate([get(f), np.full((mpad - n,) + get(f).shape[1:],
                                            fill, get(f).dtype)])
            for f, n in zip(fbs, n_nodes)])
        return jnp.asarray(out)

    bvh = traverse.BVHArrays(
        lo_x=pad_nodes(bvhs, lambda f: f.node_lo[:, 0].astype(np.float32),
                       np.float32(BIG_T)),
        lo_y=pad_nodes(bvhs, lambda f: f.node_lo[:, 1].astype(np.float32),
                       np.float32(BIG_T)),
        lo_z=pad_nodes(bvhs, lambda f: f.node_lo[:, 2].astype(np.float32),
                       np.float32(BIG_T)),
        hi_x=pad_nodes(bvhs, lambda f: f.node_hi[:, 0].astype(np.float32),
                       np.float32(-BIG_T)),
        hi_y=pad_nodes(bvhs, lambda f: f.node_hi[:, 1].astype(np.float32),
                       np.float32(-BIG_T)),
        hi_z=pad_nodes(bvhs, lambda f: f.node_hi[:, 2].astype(np.float32),
                       np.float32(-BIG_T)),
        a=pad_nodes(bvhs, lambda f: f.node_a.astype(np.int32), 0),
        b=pad_nodes(bvhs, lambda f: f.node_b.astype(np.int32), 0),
        leaf=pad_nodes(bvhs, lambda f: f.node_leaf.astype(bool), True),
    )
    soup = traverse.TriSoup(*[jnp.asarray(np.stack(
        [np.asarray(s[i]) for s in soups])) for i in range(16)])
    base = (np.arange(n_shards) * tpad).astype(np.int32)
    return ShardedBVH(
        soup=soup, valid=jnp.asarray(np.stack(valids)),
        tri_base=jnp.asarray(base), bvh=bvh,
        part_lo=jnp.asarray(np.stack(lo_all)),
        part_hi=jnp.asarray(np.stack(hi_all)),
        max_leaf=int(max(max_leafs)), order=fb.order)


def make_routed_hit(mesh: Mesh, max_leaf: int, axis: str = 'scene',
                    block: int = 4096):
    """v2: each chip traverses ONLY rays entering its partition AABB.

    Routing: rays stay replicated (they are tiny next to the sharded
    geometry — the collective is one result all_gather,
    Geometry.h:1392-1394 coherence hints become the sort), but each
    chip sorts rays by (enters-my-partition, direction octant) and sweeps
    just ceil(live/block) blocks of the coherent live prefix through its
    LOCAL sub-BVH — per-chip work scales with the rays that actually
    touch its geometry, not the wavefront size."""

    def body(soup, valid, base, bvharr, plo, phi, org, dirn):
        soup_l = traverse.TriSoup(*[x[0] for x in soup])
        bvh_l = traverse.BVHArrays(*[x[0] for x in bvharr])
        n = org.shape[0]

        # --- route: does the ray enter this partition's AABB? ---
        inv = 1.0 / dirn
        zero = dirn == 0.0
        lo = plo[0][None, :]
        hi = phi[0][None, :]
        t1 = (lo - org) * inv
        t2 = (hi - org) * inv
        inside = (org >= lo) & (org <= hi)
        lo_t = jnp.where(zero, jnp.where(inside, -BIG_T, BIG_T),
                         jnp.minimum(t1, t2))
        hi_t = jnp.where(zero, jnp.where(inside, BIG_T, -BIG_T),
                         jnp.maximum(t1, t2))
        enters = (jnp.min(hi_t, -1) >= jnp.maximum(jnp.max(lo_t, -1), 0.0))

        # --- compact + octant-sort the live prefix ---
        octant = ((dirn[:, 0] < 0).astype(jnp.int32)
                  + 2 * (dirn[:, 1] < 0).astype(jnp.int32)
                  + 4 * (dirn[:, 2] < 0).astype(jnp.int32))
        key = jnp.where(enters, octant, 8)
        idx = jnp.argsort(key)          # jnp.argsort is stable
        live = jnp.sum(enters.astype(jnp.int32))
        npad = -(-n // block) * block
        org_c = jnp.zeros((npad, 3)).at[:n].set(org[idx])
        dir_c = jnp.ones((npad, 3)).at[:n].set(dirn[idx])

        t_c = jnp.full((npad,), BIG_T)
        tri_c = jnp.full((npad,), -1, jnp.int32)

        def blk_cond(c):
            return c[0] * block < live

        def blk_body(c):
            k, t_c, tri_c = c
            o = jax.lax.dynamic_slice(org_c, (k * block, 0), (block, 3))
            d = jax.lax.dynamic_slice(dir_c, (k * block, 0), (block, 3))
            mh = traverse.bvh_hit(bvh_l, soup_l, o, d, max_leaf=max_leaf)
            t_c = jax.lax.dynamic_update_slice(t_c, mh.t, (k * block,))
            tri_c = jax.lax.dynamic_update_slice(tri_c, mh.tri,
                                                 (k * block,))
            return k + 1, t_c, tri_c

        _, t_c, tri_c = jax.lax.while_loop(
            blk_cond, blk_body, (jnp.int32(0), t_c, tri_c))

        # scatter back to wavefront order
        invp = jnp.argsort(idx)
        t = t_c[:n][invp]
        tri = tri_c[:n][invp]
        tri_ok = (tri >= 0) & jnp.take(valid[0], jnp.maximum(tri, 0))
        t = jnp.where(tri_ok, t, BIG_T)
        gtri = jnp.where(tri_ok, tri + base[0], -1)

        # combine across scene shards (one all-gather)
        t_all = jax.lax.all_gather(t, axis)
        g_all = jax.lax.all_gather(gtri, axis)
        j = jnp.argmin(t_all, axis=0)
        lane = jnp.arange(n)
        return t_all[j, lane], g_all[j, lane]

    f = shard_map(
        body, mesh=mesh,
        in_specs=(traverse.TriSoup(*([P(axis)] * 16)), P(axis), P(axis),
                  traverse.BVHArrays(*([P(axis)] * 9)), P(axis), P(axis),
                  P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    def run(sm: ShardedBVH, org, dirn):
        return f(sm.soup, sm.valid, sm.tri_base, sm.bvh, sm.part_lo,
                 sm.part_hi, org, dirn)

    return jax.jit(run)


def make_ring_hit(mesh: Mesh, max_leaf: int, axis: str = 'scene'):
    """Ring-pipelined scene traversal: rays AND geometry sharded 1/D.

    The pipeline-parallel analogue for a path tracer (SURVEY §2.7 'bounce
    pipelining'): instead of replicating the wavefront on every chip (the
    broadcast/routed forms above), each chip holds 1/D of the rays and 1/D
    of the triangles.  Ray blocks circulate around the device ring via
    `ppermute`, carrying their running best (t, tri); each of the D steps a
    chip intersects the visiting block against its LOCAL sub-BVH, pruned by
    the carried best t (so later ring stages skip subtrees already beaten —
    the pipelining win compounds with the pruning win).  After D shifts
    every block is back home with its global closest hit.

    Per-chip wavefront memory is N/D (the broadcast forms are N), and the
    only communication is point-to-point neighbor shifts that XLA overlaps
    with the traversal compute — the ring-attention schedule applied to
    ray/scene intersection.  The reference's analogue is its contribution
    queue + OpenMP pipeline (Raytracer.h:114-115); the mechanism here is
    mesh-axis-native instead of thread-native.
    """
    ndev = mesh.shape[axis]
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]

    def body(soup, valid, base, bvharr, plo, phi, org, dirn):
        soup_l = traverse.TriSoup(*[x[0] for x in soup])
        bvh_l = traverse.BVHArrays(*[x[0] for x in bvharr])
        n = org.shape[0]
        lo = plo[0][None, :]
        hi = phi[0][None, :]

        t = jnp.full((n,), BIG_T)
        gtri = jnp.full((n,), -1, jnp.int32)

        for _ in range(ndev):
            # does the visiting block enter my partition AABB closer than
            # its carried best?
            inv = 1.0 / dirn
            zero = dirn == 0.0
            t1 = (lo - org) * inv
            t2 = (hi - org) * inv
            inside = (org >= lo) & (org <= hi)
            lo_t = jnp.where(zero, jnp.where(inside, -BIG_T, BIG_T),
                             jnp.minimum(t1, t2))
            hi_t = jnp.where(zero, jnp.where(inside, BIG_T, -BIG_T),
                             jnp.maximum(t1, t2))
            t_enter = jnp.maximum(jnp.max(lo_t, -1), 0.0)
            enters = (jnp.min(hi_t, -1) >= t_enter) & (t_enter < t)

            # dead lanes traverse with best=0 -> immediate prune-out
            mh = traverse.bvh_hit(bvh_l, soup_l, org, dirn,
                                  max_leaf=max_leaf,
                                  t_init=jnp.where(enters, t, 0.0))
            tri_ok = (mh.tri >= 0) & jnp.take(valid[0],
                                              jnp.maximum(mh.tri, 0))
            win = enters & tri_ok & (mh.t < t)
            t = jnp.where(win, mh.t, t)
            gtri = jnp.where(win, mh.tri + base[0], gtri)

            # shift the block (rays + carried best) to the next stage
            org = jax.lax.ppermute(org, axis, perm)
            dirn = jax.lax.ppermute(dirn, axis, perm)
            t = jax.lax.ppermute(t, axis, perm)
            gtri = jax.lax.ppermute(gtri, axis, perm)
        # ndev shifts of +1 = identity: every block is home
        return t, gtri

    f = shard_map(
        body, mesh=mesh,
        in_specs=(traverse.TriSoup(*([P(axis)] * 16)), P(axis), P(axis),
                  traverse.BVHArrays(*([P(axis)] * 9)), P(axis), P(axis),
                  P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )

    def run(sm: ShardedBVH, org, dirn):
        n = org.shape[0]
        npad = -(-n // ndev) * ndev
        if npad != n:
            org = jnp.concatenate(
                [org, jnp.zeros((npad - n, 3), org.dtype)])
            dirn = jnp.concatenate(
                [dirn, jnp.ones((npad - n, 3), dirn.dtype)])
        t, gtri = f(sm.soup, sm.valid, sm.tri_base, sm.bvh, sm.part_lo,
                    sm.part_hi, org, dirn)
        return t[:n], gtri[:n]

    return jax.jit(run)


def make_sharded_hit(mesh: Mesh, axis: str = 'scene'):
    """Jitted (sharded_mesh, org, dirn) -> (t, global_tri) closest hit.

    Rays replicated; triangles sharded over `axis`; the winner is chosen by
    an all-gather + argmin over the axis (D is small).
    """

    def body(soup, valid, base, org, dirn):
        soup_local = traverse.TriSoup(*[x[0] for x in soup])
        mh = traverse.brute_force_hit(soup_local, org, dirn)
        # mask padded triangles
        tri_ok = (mh.tri >= 0) & jnp.take(
            valid[0], jnp.maximum(mh.tri, 0))
        t = jnp.where(tri_ok, mh.t, BIG_T)
        gtri = jnp.where(tri_ok, mh.tri + base[0], -1)
        # combine across scene shards
        t_all = jax.lax.all_gather(t, axis)          # (D, N)
        g_all = jax.lax.all_gather(gtri, axis)
        j = jnp.argmin(t_all, axis=0)
        lane = jnp.arange(t.shape[0])
        return t_all[j, lane], g_all[j, lane]

    f = shard_map(
        body, mesh=mesh,
        in_specs=(traverse.TriSoup(*([P(axis)] * 16)), P(axis), P(axis),
                  P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(f)


def scene_axis_comm_model(n_rays: int, d: int, n_bounces: int,
                          shade_width: int):
    """Per-WAVE communication account of a scene-sharded render path.

    A scene axis replicates rays and shards the geometry: each device
    intersects its own partition for EVERY lane, then the per-bounce
    combines move (this has to stay small next to the 1/D compute share):

      * closest hit:  all_gather of (t f32, tri i32) over the axis —
        each device RECEIVES (d-1)*N*8 bytes;
      * shadow any:   psum of an i32 occlusion mask — ring cost
        2*(d-1)/d*N*4 bytes;
      * shading row:  psum of the winner's packed shade row (owner
        gather) — 2*(d-1)/d*N*shade_width*4.

    Returns a dict with per-collective and total bytes per device per
    wave, plus comm bytes per ray-bounce: compute per device shrinks ~1/d
    while comm per device GROWS ~(d-1)/d * const."""
    n = n_rays
    ag_closest = (d - 1) * n * 8 * n_bounces
    ps_shadow = int(2 * (d - 1) / d * n * 4) * n_bounces
    ps_shade = int(2 * (d - 1) / d * n * shade_width * 4) * n_bounces
    total = ag_closest + ps_shadow + ps_shade
    return {
        'n_rays': n, 'devices': d, 'bounces': n_bounces,
        'shade_width': shade_width,
        'allgather_closest_bytes': ag_closest,
        'psum_shadow_bytes': ps_shadow,
        'psum_shade_bytes': ps_shade,
        'total_bytes_per_device_per_wave': total,
        'comm_bytes_per_ray_bounce': total / max(n * n_bounces, 1),
    }
