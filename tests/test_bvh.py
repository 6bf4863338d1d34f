"""BVH build + traversal vs brute-force on random meshes (SURVEY §4)."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracer_tpu.ops import bvh as bvh_mod
from pathtracer_tpu.ops import traverse


def _random_mesh(t, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 1, 3))
    tri = base + rng.uniform(-0.4, 0.4, (t, 3, 3))
    return tri.astype(np.float32)


def _random_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def test_build_covers_all_triangles():
    tri = _random_mesh(501)
    fb = bvh_mod.build_bvh(tri)
    assert sorted(fb.order.tolist()) == list(range(501))
    # every leaf range within bounds; leaves partition [0, T)
    leaves = [(a, b) for a, b, lf in zip(fb.node_a, fb.node_b, fb.node_leaf)
              if lf]
    covered = sorted(i for a, b in leaves for i in range(a, b))
    assert covered == list(range(501))
    assert fb.max_leaf <= max(4, fb.max_leaf)  # stat recorded


def test_bvh_hit_matches_brute_force():
    tri = _random_mesh(400, seed=2)
    fb = bvh_mod.build_bvh(tri)
    soup = traverse.make_soup(tri[fb.order])
    bvh = traverse.upload_bvh(fb)
    org, d = _random_rays(512)

    brute = traverse.brute_force_hit(soup, org, d)
    trav = traverse.bvh_hit(bvh, soup, org, d, max_leaf=fb.max_leaf)

    np.testing.assert_allclose(np.asarray(trav.t), np.asarray(brute.t),
                               rtol=1e-5)
    hit = np.asarray(brute.t) < 1e29
    assert hit.sum() > 20, "test mesh should be hit by many rays"
    # same winning triangle except exact-tie cases
    same_tri = np.asarray(trav.tri)[hit] == np.asarray(brute.tri)[hit]
    assert same_tri.mean() > 0.99
    np.testing.assert_allclose(np.asarray(trav.alpha)[hit][same_tri],
                               np.asarray(brute.alpha)[hit][same_tri],
                               rtol=1e-3, atol=1e-4)


def test_bvh_any_hit_matches_brute():
    tri = _random_mesh(300, seed=3)
    fb = bvh_mod.build_bvh(tri)
    soup = traverse.make_soup(tri[fb.order])
    bvh = traverse.upload_bvh(fb)
    org, d = _random_rays(256, seed=4)
    limit = jnp.full((256,), 5.0)

    brute_blocked = traverse.brute_force_any(soup, org, d, limit)
    trav = traverse.bvh_hit(bvh, soup, org, d, max_leaf=fb.max_leaf,
                            any_hit_limit=limit)
    trav_blocked = trav.t < limit
    np.testing.assert_array_equal(np.asarray(trav_blocked),
                                  np.asarray(brute_blocked))


def test_degenerate_and_axis_aligned_rays():
    """Axis-aligned rays produce inf inverse directions; slab test must not
    NaN out (the reference relies on IEEE inf semantics, Geometry.h:45-238)."""
    tri = _random_mesh(64, seed=5)
    fb = bvh_mod.build_bvh(tri)
    soup = traverse.make_soup(tri[fb.order])
    bvh = traverse.upload_bvh(fb)
    org = jnp.asarray([[0.0, 0.0, -10.0], [0.0, -10.0, 0.0], [-10.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    brute = traverse.brute_force_hit(soup, org, d)
    trav = traverse.bvh_hit(bvh, soup, org, d, max_leaf=fb.max_leaf)
    np.testing.assert_allclose(np.asarray(trav.t), np.asarray(brute.t),
                               rtol=1e-5)


@pytest.mark.parametrize('t,chunk,k,width', [
    (1, 2048, 1, 1), (300, 2048, 1, 300), (2048, 2048, 1, 2048),
    (2049, 2048, 2, 1025), (5000, 2048, 3, 1667), (700, 64, 11, 64),
])
def test_soup_chunks_pad_less_than_one_per_chunk(t, chunk, k, width):
    soup = traverse.make_soup(_random_mesh(t, seed=t))
    ch = traverse._soup_chunks(soup, chunk)
    assert ch.ax.shape == (k, width) and k * width - t < k
    np.testing.assert_array_equal(np.asarray(ch.ax).reshape(-1)[:t],
                                  np.asarray(soup.ax))
    assert np.all(np.asarray(ch.nx).reshape(-1)[t:] == 0.0)


@pytest.mark.parametrize('chunk', [1, 7, 64, 333, 2048])
def test_brute_force_independent_of_chunking(chunk):
    """Same winners, t and barycentrics for every chunk width (ties go to
    the lowest triangle index); padding triangles never hit."""
    soup = traverse.make_soup(_random_mesh(333, seed=11))
    rng = np.random.default_rng(12)
    org = rng.uniform(-6, 6, (120, 3)).astype(np.float32)
    d = rng.uniform(-3, 3, (120, 3)).astype(np.float32) - org
    org = jnp.asarray(org)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    ref = traverse.brute_force_hit(soup, org, d, chunk=333)
    got = traverse.brute_force_hit(soup, org, d, chunk=chunk)
    assert (np.asarray(ref.tri) >= 0).sum() > 15
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    lim = jnp.full((120,), 4.0)
    np.testing.assert_array_equal(
        np.asarray(traverse.brute_force_any(soup, org, d, lim, chunk=chunk)),
        np.asarray(ref.t) < 4.0)


def _bool_reductions(lowered_text):
    """StableHLO reduce ops over more than one boolean (i1) element (a
    reduction over size-1 dims, as take_along_axis's bounds check makes,
    folds away)."""
    out = []
    for ln in lowered_text.splitlines():
        m = re.search(r'stablehlo\.reduce.*dimensions = \[([0-9, ]*)\] : '
                      r'\(tensor<([0-9x]*)xi1>', ln)
        if m:
            shape = [int(v) for v in m.group(2).split('x')]
            dims = [int(v) for v in m.group(1).split(',')]
            if np.prod([shape[k] for k in dims]) > 1:
                out.append(ln)
    return out


@pytest.mark.parametrize('fn', ['bvh_hit', 'brute_force_hit',
                                'brute_force_any'])
def test_no_boolean_reductions_in_mesh_intersection(fn):
    """XLA's GPU compiler sends boolean reductions to a Triton emitter
    that compiled one wavefront-wide reduction for minutes; the mesh
    intersection programs reduce ints and floats only."""
    tri = _random_mesh(50, seed=3)
    fb = bvh_mod.build_bvh(tri)
    soup = traverse.make_soup(tri[fb.order])
    bvh = traverse.upload_bvh(fb)
    org, d = _random_rays(64)
    lim = jnp.full((64,), 5.0)
    f = {'bvh_hit': lambda o, dd: traverse.bvh_hit(
             bvh, soup, o, dd, max_leaf=fb.max_leaf, any_hit_limit=lim),
         'brute_force_hit': lambda o, dd: traverse.brute_force_hit(
             soup, o, dd),
         'brute_force_any': lambda o, dd: traverse.brute_force_any(
             soup, o, dd, lim)}[fn]
    text = jax.jit(f).lower(org, d).as_text()
    assert 'stablehlo.reduce' in text or 'while' in text
    assert _bool_reductions(text) == []
