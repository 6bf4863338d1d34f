"""Mesh intersection tiers: the platform dispatch in scene/mesh.py and the
GPU kernel tier (Pallas interpret mode here) against the XLA tiers
through the scene and the Renderer."""

import numpy as np
import jax.numpy as jnp
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.scene import mesh as mesh_mod
from pathtracer_tpu.scene import scene as scn
from pathtracer_tpu.utils import procgen


@pytest.mark.parametrize('platform,n_tris,tier', [
    ('gpu', 12, 'kernel'),
    ('gpu', 2_500_000, 'kernel'),
    ('cpu', 12, 'brute'),
    ('cpu', mesh_mod.BRUTE_FORCE_MAX_TRIS, 'brute'),
    ('cpu', mesh_mod.BRUTE_FORCE_MAX_TRIS + 1, 'bvh'),
])
def test_default_tier(platform, n_tris, tier):
    assert mesh_mod.default_tier(n_tris, platform) == tier


@pytest.mark.parametrize('platform', ['neuron', 'rocm', 'METAL'])
def test_default_tier_raises_on_unknown_platform(platform):
    with pytest.raises(ValueError, match='no mesh intersection tier'):
        mesh_mod.default_tier(100, platform)


def test_default_tier_reads_this_platform():
    # the CPU tests run on the CPU backend
    assert mesh_mod.default_tier(100) == 'brute'


def test_upload_rejects_unknown_tier():
    md = procgen.sphere_mesh(4, 4)
    with pytest.raises(ValueError, match='unknown mesh tier'):
        mesh_mod.upload_mesh(md, obj_row=2, tier='cluster')


@pytest.mark.parametrize('tier', ['kernel', 'bvh', 'brute'])
def test_upload_arrays_per_tier(tier):
    md = procgen.sphere_mesh(6, 6, radius=2.0)
    m = mesh_mod.upload_mesh(md, obj_row=2, tier=tier)
    assert m.tier == tier and m.use_brute == (tier == 'brute')
    t = md.num_triangles
    assert m.num_triangles == t
    # each tier uploads only the arrays it reads
    if tier == 'kernel':
        assert m.knodes.shape[1] == 16 and m.ktris.shape == (t, 16)
        assert m.kroot.shape == (8,) and m.bvh_depth >= 1
        assert m.soup is None and m.bvh is None
    else:
        assert m.knodes is None and m.ktris is None
        assert m.soup.ax.shape == (t,)
        assert (m.bvh is not None) == (tier == 'bvh')


@pytest.mark.parametrize('interp', [True, False])
def test_kernel_tier_tri_soup_is_the_soup(interp):
    """The kernel tier's ktris columns are the soup the XLA tiers upload,
    and its shading rows are the same."""
    md = procgen.sphere_mesh(7, 9, radius=2.0, displace_amp=0.2)
    k = mesh_mod.upload_mesh(md, obj_row=2, tier='kernel',
                             interp_normals=interp)
    b = mesh_mod.upload_mesh(md, obj_row=2, tier='brute',
                             interp_normals=interp)
    for x, y in zip(k.tri_soup(), b.tri_soup()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert k.shade_cols == b.shade_cols
    np.testing.assert_array_equal(np.asarray(k.shade_pack),
                                  np.asarray(b.shade_pack))


def _mesh_scene(tier, **obj_kw):
    md = procgen.sphere_mesh(12, 12, radius=9.0, displace_amp=0.3, seed=2)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -17.0, 0.0), **obj_kw))
    sc = scn.build_scene(objs, scn.default_light_intensity())
    m = mesh_mod.upload_mesh(
        md, obj_row=sc.meshes[0].obj_row, tier=tier,
        kernel_interpret=(tier == 'kernel'),
        interp_normals=obj_kw.get('interp_normals', True),
        default_ksub=obj_kw.get('ksub', (0.0, 0.0, 0.0)),
        texture_overrides=obj_kw.get('textures'))
    return sc.replace(meshes=(m,))


def _rays(n=200, seed=0):
    rng = np.random.default_rng(seed)
    org = np.zeros((n, 3), np.float32)
    org[:, 2] = 40.0
    org[:, :2] = rng.uniform(-12, 12, (n, 2))
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    d[:, 1] = -0.35
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


@pytest.mark.parametrize('interp', [True, False])
def test_intersect_kernel_tier_matches_bvh(interp):
    org, d = _rays()
    hk = scn.intersect(_mesh_scene('kernel', interp_normals=interp), org, d)
    hb = scn.intersect(_mesh_scene('bvh', interp_normals=interp), org, d)
    np.testing.assert_array_equal(np.asarray(hk.obj_id),
                                  np.asarray(hb.obj_id))
    assert (np.asarray(hk.obj_id) == 3).sum() > 20
    np.testing.assert_allclose(np.asarray(hk.t), np.asarray(hb.t),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(hk.n), np.asarray(hb.n),
                               atol=1e-4)


def test_shadow_kernel_tier_matches_bvh():
    org, d = _rays(seed=1)
    org = org + jnp.asarray([0.0, -30.0, -40.0])     # below, looking up
    d = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), org.shape)
    dist = jnp.full((org.shape[0],), 60.0)
    bk = scn.intersect_shadow(_mesh_scene('kernel'), org, d, dist)
    bb = scn.intersect_shadow(_mesh_scene('bvh'), org, d, dist)
    np.testing.assert_array_equal(np.asarray(bk), np.asarray(bb))
    assert np.asarray(bk).any() and not np.asarray(bk).all()


def test_closest_hit_t_min_march_kernel_tier():
    """The reservoir march's rising floor: second crossing of the shell."""
    org, d = _rays(seed=2)
    for tier in ('kernel', 'bvh'):
        sc = _mesh_scene(tier)
        m = sc.meshes[0]
        o_l, d_l = scn._local_ray_row(sc, m.obj_row, org, d)
        first = scn._mesh_closest_hit(m, o_l, d_l, jnp.full((200,), 1e30))
        second = scn._mesh_closest_hit(m, o_l, d_l, jnp.full((200,), 1e30),
                                       t_min=first.t)
        if tier == 'kernel':
            ref = (first, second)
        else:
            for a, b in zip(ref, (first, second)):
                hit = np.asarray(b.tri) >= 0
                np.testing.assert_array_equal(np.asarray(a.tri) >= 0, hit)
                np.testing.assert_allclose(np.asarray(a.t)[hit],
                                           np.asarray(b.t)[hit], rtol=1e-5)
                np.testing.assert_allclose(np.asarray(a.beta)[hit],
                                           np.asarray(b.beta)[hit],
                                           atol=1e-4)
    assert (np.asarray(ref[1].tri) >= 0).sum() > 20


def test_alpha_cutout_kernel_tier_matches_bvh():
    alpha = np.zeros((8, 8, 3), np.float32)
    alpha[:, ::2] = 1.0                       # striped cutout
    org, d = _rays(seed=3)
    hk = scn.intersect(_mesh_scene('kernel', textures={'alpha': alpha}),
                       org, d)
    hb = scn.intersect(_mesh_scene('bvh', textures={'alpha': alpha}),
                       org, d)
    np.testing.assert_array_equal(np.asarray(hk.obj_id),
                                  np.asarray(hb.obj_id))
    np.testing.assert_allclose(np.asarray(hk.t), np.asarray(hb.t),
                               rtol=1e-5)


def test_merged_meshes_through_kernel_tier(monkeypatch):
    """build_scene's merged multi-mesh BVH with the kernel tier."""
    def objs():
        o = scn.default_objects()
        o.append(scn.mesh_object(procgen.sphere_mesh(10, 10, radius=5.0),
                                 translation=(-8.0, -14.0, 0.0),
                                 kd=(0.8, 0.2, 0.2)))
        o.append(scn.mesh_object(
            procgen.sphere_mesh(8, 8, radius=4.0, displace_amp=0.3),
            translation=(8.0, -14.0, 0.0), kd=(0.2, 0.2, 0.8)))
        return o

    sc_b = scn.build_scene(objs(), scn.default_light_intensity(),
                           merge_meshes=True)
    monkeypatch.setattr(mesh_mod, 'default_tier',
                        lambda n, platform=None: 'kernel')
    sc_k = scn.build_scene(objs(), scn.default_light_intensity(),
                           merge_meshes=True)
    assert len(sc_k.meshes) == 1 and sc_k.meshes[0].world_space
    assert sc_k.meshes[0].tier == 'kernel'
    sc_k = sc_k.replace(meshes=(sc_k.meshes[0].replace(
        kernel_interpret=True),))
    org, d = _rays(seed=4)
    hk, hb = scn.intersect(sc_k, org, d), scn.intersect(sc_b, org, d)
    ids = np.asarray(hk.obj_id)
    np.testing.assert_array_equal(ids, np.asarray(hb.obj_id))
    assert {3, 4} <= set(ids.tolist())
    np.testing.assert_allclose(np.asarray(hk.kd), np.asarray(hb.kd),
                               atol=1e-6)


def test_renderer_image_kernel_tier_matches_bvh_tier():
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = pt.RenderConfig(width=24, height=16, nrays=2, nb_bounces=2,
                          compact_rays=True)
    imgs = {}
    for tier in ('kernel', 'bvh'):
        r = pt.Renderer(_mesh_scene(tier), cam, cfg)
        imgs[tier] = np.asarray(r.render().display())
    a, b = imgs['kernel'], imgs['bvh']
    assert np.isfinite(a).all() and a.mean() > 0
    rel = np.abs(a - b).max(-1) / max(np.abs(b).max(), 1e-6)
    assert (rel > 1e-3).mean() < 0.02
