"""Topology tools, OFF/VRML readers, OBJ/MTL export, presets, denoiser."""

import numpy as np
import jax.numpy as jnp
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.io import obj as obj_io
from pathtracer_tpu.models.presets import PRESETS, preset
from pathtracer_tpu.render import denoise
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.scene import scene as scn
from pathtracer_tpu.scene import topology


CUBE_OFF = """OFF
8 6 12
-1 -1 -1
1 -1 -1
1 1 -1
-1 1 -1
-1 -1 1
1 -1 1
1 1 1
-1 1 1
4 0 3 2 1
4 4 5 6 7
4 0 1 5 4
4 1 2 6 5
4 3 7 6 2
4 0 4 7 3
"""


def test_off_reader_and_topology(tmp_path):
    p = tmp_path / 'cube.off'
    p.write_text(CUBE_OFF)
    md = obj_io.read_off(str(p))
    assert md.num_triangles == 12
    info = topology.mesh_info(md)
    assert info.n_components == 1
    assert info.n_edges == 18          # 12 quad edges + 6 fan diagonals
    assert info.n_real_edges == 12
    assert info.n_triangles == 0       # all faces are quads
    assert info.n_polygons == 6
    assert info.n_non_manifold == 0
    assert info.n_boundary_edges == 0
    assert info.euler == 2             # sphere topology
    assert info.genus == 0


def test_vrml_reader(tmp_path):
    p = tmp_path / 'tri.wrl'
    p.write_text("""#VRML V2.0 utf8
Shape { geometry IndexedFaceSet {
  coord Coordinate { point [ 0 0 0, 1 0 0, 0 1 0, 1 1 0 ] }
  coordIndex [ 0, 1, 2, -1, 1, 3, 2, -1 ]
} }
""")
    md = obj_io.read_vrml(str(p))
    assert md.num_triangles == 2
    assert len(md.vertices) == 4


def test_obj_mtl_roundtrip(tmp_path):
    p = tmp_path / 'cube.off'
    p.write_text(CUBE_OFF)
    md = obj_io.read_off(str(p))
    obj_io.save_obj(md, str(tmp_path / 'out.obj'), mtl_name='out.mtl')
    obj_io.export_mtl(md, str(tmp_path / 'out.mtl'))
    md2 = obj_io.read_obj(str(tmp_path / 'out.obj'))
    assert md2.num_triangles == md.num_triangles
    np.testing.assert_allclose(md2.vertices, md.vertices, rtol=1e-5)


def test_presets_table():
    assert len(PRESETS) == 14
    g = preset('gold')
    np.testing.assert_allclose(g['kd'], (0.75164, 0.60648, 0.22648))
    assert preset('chrome_ngan')['ne'][0] == 17900.0


def test_presets_render():
    from pathtracer_tpu.core import rng_host
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, **preset('copper')))
    sc = scn.build_scene(objs, scn.default_light_intensity())
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cp = jnp.asarray(rng_host.random_per_pixel_fast(12, 8))
    img, _ = rnd.render_unsplatted(sc, cam, cp,
                                   rnd.RenderConfig(width=12, height=8,
                                                    nrays=2))
    assert np.all(np.isfinite(np.asarray(img)))


def test_atrous_denoiser_reduces_noise_keeps_edges():
    rng = np.random.default_rng(0)
    h, w = 32, 32
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, :16] = 1.0          # hard edge between two flat regions
    albedo = clean.copy()
    normal = np.tile([0.0, 0.0, 1.0], (h, w, 1)).astype(np.float32)
    noisy = clean + rng.normal(0, 0.3, clean.shape).astype(np.float32)
    out = np.asarray(denoise.denoise(jnp.asarray(noisy), jnp.asarray(albedo),
                                     jnp.asarray(normal)))
    err_before = np.abs(noisy - clean).mean()
    err_after = np.abs(out - clean).mean()
    assert err_after < err_before * 0.35, (err_before, err_after)
    # edge preserved: the two sides stay well-separated
    assert out[:, :14].mean() > 0.8 and out[:, 18:].mean() < 0.2


def test_renderer_denoised_path():
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2)))
    sc = scn.build_scene(objs, scn.default_light_intensity())
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = rnd.RenderConfig(width=24, height=16, nrays=4, samples_per_wave=2,
                           has_denoiser=True)
    r = pt.Renderer(sc, cam, cfg).render()
    out = np.asarray(r.denoised_display())
    assert out.shape == (16, 24, 3)
    assert np.all(np.isfinite(out)) and out.max() > 0


@pytest.mark.parametrize('shape,axis', [((7,), None), ((5, 9), 1),
                                        ((5, 9), 0), ((4, 0), 1),
                                        ((3, 4, 6), -1)])
def test_any_true_matches_any(shape, axis):
    """vec.any_true is jnp.any without a boolean reduction (an empty axis
    gives False, like jnp.any)."""
    import jax
    from pathtracer_tpu.core import vec
    rng = np.random.default_rng(len(shape))
    for p in (0.0, 0.05, 1.0):
        x = rng.uniform(size=shape) < p
        got = vec.any_true(jnp.asarray(x), axis=axis)
        np.testing.assert_array_equal(np.asarray(got), np.any(x, axis=axis))
    text = jax.jit(lambda a: vec.any_true(a, axis=axis)).lower(
        jnp.asarray(x)).as_text()
    from test_bvh import _bool_reductions
    assert _bool_reductions(text) == []
