"""The GPU BVH traversal kernel (ops/bvh_kernel.py) in Pallas interpret
mode against the dense brute-force oracles of ops/traverse.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer_tpu.ops import bvh as bvh_mod
from pathtracer_tpu.ops import bvh_kernel
from pathtracer_tpu.ops import traverse
from pathtracer_tpu.utils import procgen

BIG = float(traverse.BIG_T)


def _random_mesh(t, seed=0, spread=4.0, size=0.8):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 1, 3))
    return (base + rng.uniform(-size, size, (t, 3, 3))).astype(np.float32)


def _random_rays(n, seed=1, extent=6.0):
    """Origins in a box, aimed at random points of the mesh's volume."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = (rng.uniform(-3.5, 3.5, (n, 3)) - org).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


class Packed:
    """A mesh packed for both the kernel and the XLA oracles."""

    def __init__(self, tri, max_leaf_size=4):
        fb = bvh_mod.build_bvh(tri, max_leaf_size=max_leaf_size)
        self.fb = fb
        self.soup = traverse.make_soup(tri[fb.order])
        self.nodes = jnp.asarray(bvh_kernel.pack_nodes(fb))
        self.root = jnp.asarray(bvh_kernel.root_box(fb))
        self.tris = jnp.asarray(bvh_kernel.pack_tris(self.soup))

    def hit(self, org, d, t_max=None, t_min=None, any_hit=False, **kw):
        return bvh_kernel.kernel_hit(
            self.root, self.nodes, self.tris, org, d, t_max, t_min,
            max_leaf=self.fb.max_leaf, depth=self.fb.depth, any_hit=any_hit,
            interpret=True, **kw)


def _assert_same_hits(t_k, tri_k, ref, min_hits=1, atol=0.0):
    t_k, tri_k = np.asarray(t_k), np.asarray(tri_k)
    t_r, tri_r = np.asarray(ref.t), np.asarray(ref.tri)
    hit_r = tri_r >= 0
    assert hit_r.sum() >= min_hits
    np.testing.assert_array_equal(tri_k >= 0, hit_r)
    # same winner except exact ties on shared edges
    if hit_r.any():
        assert np.mean(tri_k[hit_r] == tri_r[hit_r]) > 0.99
    np.testing.assert_allclose(t_k[hit_r], t_r[hit_r], rtol=1e-5, atol=atol)
    assert np.all(t_k[~hit_r] == BIG)


@pytest.mark.parametrize('seed,n_tris,n_rays,block,warps', [
    (0, 300, 100, 32, 1),
    (1, 1000, 257, 32, 1),
    (2, 64, 33, 32, 1),
    (3, 500, 64, 64, 2),
    (4, 200, 129, 128, 4),
    (5, 1, 40, 32, 1),
    (6, 2048, 300, 32, 1),
    (7, 17, 5, 32, 1),
])
def test_closest_matches_brute(seed, n_tris, n_rays, block, warps):
    """Seeds x sizes x block shapes; ray counts that are not a multiple
    of the block exercise the dead-ray padding."""
    mesh = Packed(_random_mesh(n_tris, seed=seed))
    org, d = _random_rays(n_rays, seed=seed + 100)
    t, tri = mesh.hit(org, d, block=block, num_warps=warps)
    assert t.shape == (n_rays,) and tri.shape == (n_rays,)
    _assert_same_hits(t, tri, traverse.brute_force_hit(mesh.soup, org, d),
                      min_hits=0 if n_tris < 20 else 3)


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4, 5])
def test_any_hit_matches_brute_any(seed):
    mesh = Packed(_random_mesh(400, seed=seed))
    org, d = _random_rays(150, seed=seed + 7)
    limit = jnp.asarray(np.random.default_rng(seed).uniform(0.5, 12.0, 150),
                        jnp.float32)
    _, tri = mesh.hit(org, d, limit, any_hit=True)
    ref = np.asarray(traverse.brute_force_any(mesh.soup, org, d, limit))
    assert ref.sum() > 5
    np.testing.assert_array_equal(np.asarray(tri) >= 0, ref)


@pytest.mark.parametrize('seed', [0, 1])
def test_any_hit_agrees_with_closest(seed):
    """Occluded below the limit iff the closest hit is below it."""
    mesh = Packed(_random_mesh(600, seed=seed + 20))
    org, d = _random_rays(200, seed=seed + 30)
    limit = jnp.full((200,), 5.0, jnp.float32)
    t_c, _ = mesh.hit(org, d)
    _, tri_a = mesh.hit(org, d, limit, any_hit=True)
    np.testing.assert_array_equal(np.asarray(tri_a) >= 0,
                                  np.asarray(t_c) < 5.0)


@pytest.mark.parametrize('leaf', [1, 2, 8, 16])
def test_leaf_sizes(leaf):
    tri = _random_mesh(700, seed=leaf)
    mesh = Packed(tri, max_leaf_size=leaf)
    assert mesh.fb.max_leaf <= max(leaf, mesh.fb.max_leaf)
    org, d = _random_rays(120, seed=leaf + 3)
    t, trid = mesh.hit(org, d)
    _assert_same_hits(t, trid, traverse.brute_force_hit(mesh.soup, org, d),
                      min_hits=5)


@pytest.mark.parametrize('seed', [0, 1])
def test_t_max_bound(seed):
    mesh = Packed(_random_mesh(500, seed=seed + 40))
    org, d = _random_rays(160, seed=seed + 41)
    t_max = jnp.asarray(np.random.default_rng(seed).uniform(0.5, 10, 160),
                        jnp.float32)
    t, tri = mesh.hit(org, d, t_max)
    ref = traverse.brute_force_hit(mesh.soup, org, d, t_max=t_max)
    ref = ref._replace(tri=ref.tri, t=jnp.where(ref.tri >= 0, ref.t, BIG))
    _assert_same_hits(t, tri, ref, min_hits=5)
    assert np.all(np.asarray(t)[np.asarray(tri) >= 0]
                  < np.asarray(t_max)[np.asarray(tri) >= 0])


@pytest.mark.parametrize('seed', [0, 1])
def test_t_min_floor(seed):
    """Strict lower bound: the alpha-cutout / reservoir-march floor."""
    mesh = Packed(_random_mesh(500, seed=seed + 50))
    org, d = _random_rays(160, seed=seed + 51)
    t0 = traverse.brute_force_hit(mesh.soup, org, d).t
    t_min = jnp.where(t0 < BIG, t0 + 1e-3, -1.0)   # past the first surface
    t, tri = mesh.hit(org, d, t_min=t_min)
    ref = traverse.brute_force_hit(mesh.soup, org, d, t_min=t_min)
    _assert_same_hits(t, tri, ref, min_hits=3)
    hit = np.asarray(tri) >= 0
    assert np.all(np.asarray(t)[hit] > np.asarray(t_min)[hit])


@pytest.mark.parametrize('axis,sign', [(0, 1.0), (0, -1.0), (1, 1.0),
                                       (1, -1.0), (2, 1.0), (2, -1.0)])
def test_axis_aligned_rays(axis, sign):
    """Zero direction components: the slab test divides by zero."""
    mesh = Packed(_random_mesh(400, seed=axis + 60))
    rng = np.random.default_rng(axis)
    org = rng.uniform(-4, 4, (90, 3)).astype(np.float32)
    org[:, axis] = -8.0 * sign
    d = np.zeros((90, 3), np.float32)
    d[:, axis] = sign
    org, d = jnp.asarray(org), jnp.asarray(d)
    t, tri = mesh.hit(org, d)
    _assert_same_hits(t, tri, traverse.brute_force_hit(mesh.soup, org, d),
                      min_hits=3)


def _degenerate_mesh():
    tri = _random_mesh(200, seed=70)
    tri[::7, 2] = tri[::7, 1]          # zero-area (collinear) triangles
    tri[::11] = tri[::11, :1]          # point triangles
    return tri


@pytest.mark.parametrize('case', ['degenerate_tris', 'origins_near_surface',
                                  'parallel_rays'])
def test_degenerate_inputs(case):
    tri = _degenerate_mesh() if case == 'degenerate_tris' else \
        _random_mesh(200, seed=71)
    mesh = Packed(tri)
    org, d = _random_rays(100, seed=72)
    if case == 'origins_near_surface':
        # the renderer's bounce origins: 1e-3 off a surface point
        s = np.asarray(tri[mesh.fb.order][:100], np.float64)
        n = np.cross(s[:, 1] - s[:, 0], s[:, 2] - s[:, 0])
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        org = jnp.asarray(s.mean(axis=1) + 1e-3 * n, jnp.float32)
    elif case == 'parallel_rays':
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.6, 0.8], jnp.float32),
                             (100, 3))
    t, trid = mesh.hit(org, d)
    assert np.all(np.isfinite(np.asarray(t)))
    # t of a surface 1e-3 away carries the absolute rounding of the
    # coordinates (~1e-7 here), not a relative one
    _assert_same_hits(t, trid, traverse.brute_force_hit(mesh.soup, org, d),
                      min_hits=0, atol=1e-6)


@pytest.mark.parametrize('kind', ['closest', 'any'])
def test_golden_100k(kind):
    """A ~100k-triangle closed mesh at full BVH depth; few rays keep the
    brute oracle cheap."""
    md = procgen.sphere_mesh(224, 224, radius=10.0, displace_amp=0.3,
                             seed=3)
    tri = md.vertices[md.vtx_idx]
    assert tri.shape[0] > 99_000
    mesh = Packed(tri)
    rng = np.random.default_rng(9)
    org = jnp.asarray(rng.uniform(-14, 14, (48, 3)), jnp.float32)
    d = rng.normal(size=(48, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    if kind == 'closest':
        t, trid = mesh.hit(org, d)
        _assert_same_hits(t, trid, traverse.brute_force_hit(
            mesh.soup, org, d, chunk=8192), min_hits=10)
    else:
        limit = jnp.full((48,), 6.0, jnp.float32)
        _, trid = mesh.hit(org, d, limit, any_hit=True)
        ref = traverse.brute_force_any(mesh.soup, org, d, limit, chunk=8192)
        np.testing.assert_array_equal(np.asarray(trid) >= 0,
                                      np.asarray(ref))


@pytest.mark.parametrize('seed', [0, 1])
def test_incoherent_rays_inside_closed_mesh(seed):
    """Origins inside a closed displaced sphere, every direction: each
    ray must hit the shell."""
    md = procgen.sphere_mesh(20, 20, radius=5.0, displace_amp=0.3,
                             seed=seed)
    mesh = Packed(md.vertices[md.vtx_idx])
    rng = np.random.default_rng(seed + 80)
    org = jnp.asarray(rng.uniform(-2, 2, (200, 3)), jnp.float32)
    d = rng.normal(size=(200, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    t, trid = mesh.hit(org, d)
    assert np.all(np.asarray(trid) >= 0)
    _assert_same_hits(t, trid, traverse.brute_force_hit(mesh.soup, org, d),
                      min_hits=200)


def test_deep_bvh_needs_no_more_stack_than_its_depth():
    """Triangles spaced geometrically along a line give an unbalanced,
    deep BVH; the stack sized from its depth is enough."""
    k = np.arange(120)
    x = np.cumsum(1.15 ** (k % 60)).astype(np.float32)
    x = x / x.max() * 100.0
    w = 0.2 * np.diff(x).min()        # no two triangles overlap in x
    tri = np.zeros((120, 3, 3), np.float32)
    tri[:, :, 0] = x[:, None] + np.asarray([-w, w, 0.0], np.float32)
    tri[:, 2, 1] = 1.0
    mesh = Packed(tri, max_leaf_size=1)
    assert mesh.fb.depth >= 10
    org = jnp.asarray(np.stack([x, np.full(120, 0.2),
                                np.full(120, -5.0)], 1), jnp.float32)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                         (120, 3))
    t, trid = mesh.hit(org, d)
    _assert_same_hits(t, trid, traverse.brute_force_hit(mesh.soup, org, d),
                      min_hits=60)


@pytest.mark.parametrize('depth,cols', [(0, 2), (1, 4), (2, 4), (6, 8),
                                        (14, 16), (33, 64), (62, 64)])
def test_stack_size(depth, cols):
    """depth + 1 live entries plus one discard column, as a power of 2."""
    assert bvh_kernel.stack_size(depth) == cols
    assert cols >= depth + 2


def test_pack_nodes_layout():
    tri = _random_mesh(50, seed=90)
    fb = bvh_mod.build_bvh(tri)
    rows = bvh_kernel.pack_nodes(fb)
    assert rows.shape == (fb.n_nodes, 16) and rows.dtype == np.float32
    ints = rows.view(np.int32)
    np.testing.assert_array_equal(ints[:, 12], fb.node_a)
    np.testing.assert_array_equal(ints[:, 13], fb.node_b)
    np.testing.assert_array_equal(ints[:, 14], fb.node_leaf.astype(np.int32))
    inner = np.where(~fb.node_leaf)[0]
    for i in inner[:5]:
        a, b = fb.node_a[i], fb.node_b[i]
        np.testing.assert_array_equal(rows[i, 0:3], fb.node_lo[a])
        np.testing.assert_array_equal(rows[i, 9:12], fb.node_hi[b])
    np.testing.assert_array_equal(bvh_kernel.root_box(fb)[:3], fb.node_lo[0])


@pytest.mark.parametrize('n,block', [(1, 32), (32, 32), (33, 32),
                                     (100, 64)])
def test_pack_rays_pads_with_dead_rays(n, block):
    org, d = _random_rays(n)
    rays = np.asarray(bvh_kernel.pack_rays(org, d, 5.0, None, block))
    assert rays.shape == (-(-n // block) * block, 8)
    np.testing.assert_array_equal(rays[:n, 0:3], np.asarray(org))
    assert np.all(rays[:n, 6] == 5.0) and np.all(rays[:n, 7] == -1.0)
    assert np.all(rays[n:, 6] == -1.0)          # never enter the root
