"""Particle-cluster acceleration vs brute-force oracle (fluid tier).

The clustered sweep is the wavefront form of the reference's uniform
accel grid + DDA walk (fluid.cpp:36-171); these tests pin bit-equal hits
against the dense sweeps, including the overflow reroute path.
"""

import numpy as np
import jax.numpy as jnp

from pathtracer_tpu.scene import pointset as ps_mod
from pathtracer_tpu.scene import scene as scn


def _cloud(n=3000, seed=0, spread=10.0, radius=0.35):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, spread / 3.0, (n, 3)).astype(np.float32)
    return ps_mod.fluid_pointset(pts, obj_row=3, radius=radius,
                                 clustered=True)


def _rays(n=2000, seed=1, aim=(0.0, 0.0, 0.0), jitter=3.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    target = (np.asarray(aim, np.float32)
              + rng.normal(0, jitter, (n, 3)).astype(np.float32))
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def test_clustered_entry_matches_brute():
    ps = _cloud()
    org, dirn = _rays()
    tmax = jnp.full((org.shape[0],), ps_mod.BIG_T)
    t_c, i_c = ps_mod.clustered_sphere_sweep(ps, org, dirn, tmax)
    t_b, i_b = ps_mod.sphere_sweep(ps, org, dirn, tmax)
    np.testing.assert_allclose(np.asarray(t_c), np.asarray(t_b), rtol=2e-4)
    hit = np.asarray(t_b) < 1e29
    assert hit.mean() > 0.2, "vacuous: almost no rays hit the cloud"
    # where t ties are absent the particle index must agree
    same = np.asarray(i_c)[hit] == np.asarray(i_b)[hit]
    assert same.mean() > 0.99


def test_clustered_union_exit_matches_brute():
    ps = _cloud(n=2500, spread=6.0, radius=0.6)
    rng = np.random.default_rng(7)
    # rays starting at particle centers (guaranteed inside)
    pick = rng.integers(0, 2000, 500)
    org = jnp.stack([ps.px[pick], ps.py[pick], ps.pz[pick]], axis=-1)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    e_c, i_c, in_c = ps_mod.clustered_union_exit(ps, org, d)
    e_b, i_b, in_b = ps_mod.sphere_union_exit(ps, org, d, iters=40)
    assert np.asarray(in_c).all() and np.asarray(in_b).all()
    np.testing.assert_allclose(np.asarray(e_c), np.asarray(e_b), rtol=2e-4)


def test_overflow_reroute_keeps_hits():
    # a long particle chain along +x: an axial ray enters > MAXC_P
    # clusters, forcing the overflow residual reroute
    n = ps_mod.CLUSTER_P * (ps_mod.MAXC_P + 8)
    x = np.linspace(0.0, 400.0, n).astype(np.float32)
    pts = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)
    ps = ps_mod.fluid_pointset(pts, radius=0.3, clustered=True)
    assert ps.n_clusters > ps_mod.MAXC_P
    org = jnp.asarray([[-5.0, 0.0, 0.0], [405.0, 0.2, 0.0]], jnp.float32)
    dirn = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], jnp.float32)
    tmax = jnp.full((2,), ps_mod.BIG_T)
    t_c, _ = ps_mod.clustered_sphere_sweep(ps, org, dirn, tmax)
    t_b, _ = ps_mod.sphere_sweep(ps, org, dirn, tmax)
    np.testing.assert_allclose(np.asarray(t_c), np.asarray(t_b), rtol=2e-4)


def test_fluid_pointset_auto_clusters():
    rng = np.random.default_rng(3)
    small = ps_mod.fluid_pointset(
        rng.normal(size=(100, 3)).astype(np.float32))
    big = ps_mod.fluid_pointset(
        rng.normal(size=(ps_mod.CLUSTERED_MIN, 3)).astype(np.float32))
    assert small.n_clusters == 0
    assert big.n_clusters > 0
    # padding uses far-away dummies that never intersect
    assert big.px.shape[0] % ps_mod.CLUSTER_P == 0


def test_scene_render_clustered_equals_brute():
    rng = np.random.default_rng(5)
    pts = rng.normal(0.0, 4.0, (2000, 3)).astype(np.float32)
    pts[:, 1] -= 18.0

    def build(clustered):
        ps = ps_mod.fluid_pointset(pts, obj_row=3, radius=0.6,
                                   clustered=clustered)
        ps = ps.replace(transparent=True)
        objs = scn.default_objects()
        objs.append(scn.pointset_object(ps, transp=True, refr_index=1.33))
        return scn.build_scene(objs, scn.default_light_intensity())

    org, dirn = _rays(1500, seed=9, aim=(0.0, -18.0, 0.0))
    h_c = scn.intersect(build(True), org, dirn)
    h_b = scn.intersect(build(False), org, dirn)
    # the clustered union walk runs to its fixed point while the brute
    # path is iteration-capped: tolerate the rare eps-boundary chain that
    # converges differently, but never more than a sliver of lanes
    close = np.isclose(np.asarray(h_c.t), np.asarray(h_b.t), rtol=2e-4)
    assert close.mean() > 0.998, f"{(~close).sum()} lanes differ"
    same = np.asarray(h_c.obj_id) == np.asarray(h_b.obj_id)
    assert same.mean() > 0.998
