"""OBJ loading + mesh rendering vs the CPU harness (BASELINE config 2 shape)."""

import math
import os
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.io import obj as obj_io
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.scene import scene as scn

import reference_cpu as ref

CUBE_OBJ = textwrap.dedent("""\
    mtllib cube.mtl
    v -1 -1 -1
    v  1 -1 -1
    v  1  1 -1
    v -1  1 -1
    v -1 -1  1
    v  1 -1  1
    v  1  1  1
    v -1  1  1
    usemtl red
    f 1 4 3 2
    f 5 6 7 8
    usemtl blue
    f 1 2 6 5
    f 2 3 7 6
    f 4 8 7 3
    f 1 5 8 4
    """)

CUBE_MTL = textwrap.dedent("""\
    newmtl red
    Kd 0.8 0.2 0.1
    Ns 10
    newmtl blue
    Kd 0.1 0.2 0.8
    Ks 0.05 0.05 0.05
    """)


@pytest.fixture
def cube_path(tmp_path):
    (tmp_path / 'cube.obj').write_text(CUBE_OBJ)
    (tmp_path / 'cube.mtl').write_text(CUBE_MTL)
    return str(tmp_path / 'cube.obj')


def test_obj_loader_semantics(cube_path):
    md = obj_io.read_obj(cube_path)
    assert md.num_triangles == 12                 # 6 quads fan-triangulated
    assert md.group_names == {'red': 0, 'blue': 1}
    np.testing.assert_allclose(md.materials[0].kd, [0.8, 0.2, 0.1])
    np.testing.assert_allclose(md.materials[0].ns, [10, 10, 10])
    np.testing.assert_allclose(md.materials[1].ks, [0.05, 0.05, 0.05])
    # fan show_edges: first tri (T,T,F)? reference marks diag edges hidden:
    # first tri of a quad: showEdges=(True,True,last) with last=False for
    # the first of two fan tris, the second (False, True, True)
    assert md.show_edges[0].tolist() == [True, True, False]
    assert md.show_edges[1].tolist() == [False, True, True]


def test_transform_normalize(cube_path):
    md = obj_io.load_mesh(cube_path, scaling=10.0, offset=(1.0, 2.0, 3.0))
    v = md.vertices
    assert np.allclose((v.min(0) + v.max(0)) / 2, [1.0, 2.0, 3.0], atol=1e-5)
    assert np.isclose((v.max(0) - v.min(0)).max(), 10.0, rtol=1e-5)
    # all corners got face normals
    assert (md.n_idx >= 0).all()


def test_mesh_render_matches_cpu(cube_path):
    W, H, SPP, BOUNCES = 20, 16, 4, 3
    md = obj_io.load_mesh(cube_path, scaling=14.0, offset=(0.0, -17.0, 0.0))

    objs = scn.default_objects()
    objs.append(scn.mesh_object(md))
    sc = scn.build_scene(objs, scn.default_light_intensity())
    assert len(sc.meshes) == 1
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    cp = rng_host.random_per_pixel_fast(W, H)
    _, smp_jax = rnd.render_unsplatted(sc, cam, jnp.asarray(cp), cfg)
    smp_jax = np.asarray(smp_jax)

    # CPU twin: same mesh (post-transform, BVH order irrelevant for brute),
    # with the reference default grey Kd=0.5... overridden by MTL per group.
    # The harness supports a single constant material per object, so split
    # the mesh into two per-group objects.
    fb_order = sc.meshes[0]  # not needed; harness uses original order
    tri_verts = md.vertices[md.vtx_idx]
    tri_norms = md.normals[md.n_idx]
    cpu_objs = [
        ref.Obj('sphere', center=(10, 23, 15), radius=10.0),
        ref.Obj('sphere', center=(0, 0, 0), radius=1e6, flip_normals=True),
        ref.Obj('plane', point=(0, 0, 0), normal=(0, 1, 0),
                translation=(0, -27.3, 0)),
    ]
    for gid, gmat in enumerate(md.materials):
        sel = md.group == gid
        cpu_objs.append(ref.Obj('mesh', tri_verts=tri_verts[sel],
                                tri_normals=tri_norms[sel],
                                kd=gmat.kd, ks=gmat.ks, ne=gmat.ns))
    cpu_scene = ref.CPUScene(cpu_objs, scn.default_light_intensity())
    cpu_cam = dict(position=np.array([0, 0, 50], np.float32),
                   direction=np.array([0, 0, -1], np.float32),
                   up=np.array([0, 1, 0], np.float32),
                   fov=35 * math.pi / 180, focus=50.0, aperture=0.1)
    smp_cpu = ref.render_cpu(cpu_scene, cpu_cam, W, H, SPP, BOUNCES, cp)

    scale = max(np.abs(smp_cpu).max(), 1e-6)
    rel = np.abs(smp_jax - smp_cpu).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05, f"{flipped.mean():.4f} samples diverge"
    mean_rel = abs(smp_jax.mean() - smp_cpu.mean()) / scale
    assert mean_rel < 0.02
