"""Config-ladder golden parity: configs 2-5 at their REAL feature mix.

Round-1 VERDICT item 6: each configs/*.json is loaded through the actual
scene-JSON loader (asset paths resolved relative to the file, like the
reference's scene loader, Raytracer.cpp:1096-1236), with procedurally
generated stand-ins written to disk for the absent showcase blobs
(lion.obj / bot.obj / antiqueOffice.obj / env.hdr / material.binary), then
rendered at a small crop and compared per-sample against the sequential
CPU harness at equal PCG sample sequences (the BASELINE north-star).

Feature mixes exercised end-to-end through the loader:
  config2: opaque smooth-normal mesh                (TriangleMesh.cpp:940-948)
  config3: Fresnel-transparent mesh + envmap dome   (Raytracer.cpp:438-489,
                                                     Geometry.h:963-977)
  config4: MERL measured BRDF + wide-aperture DoF   (MERLBRDFRead.cpp:76-207,
                                                     Vector.h:792-825)
  config5: subsurface mesh + exponential fog + envmap (Raytracer.cpp:318-410,
                                                     44-192) — small stand-in
"""

import math
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.scene import scene as scn
from pathtracer_tpu.io import scene_json
from pathtracer_tpu.io.image import save_hdr, load_hdr
from pathtracer_tpu.utils import procgen

import reference_cpu as ref

CONFIG_DIR = os.path.join(os.path.dirname(__file__), os.pardir, 'configs')


def _write_obj(path, md):
    """Write MeshData as v/vn/f OBJ text (%.9g roundtrips float32)."""
    with open(path, 'w') as f:
        for v in md.vertices:
            f.write('v %.9g %.9g %.9g\n' % tuple(v))
        for n in md.normals:
            f.write('vn %.9g %.9g %.9g\n' % tuple(n))
        for k in range(md.vtx_idx.shape[0]):
            vi = md.vtx_idx[k] + 1
            ni = md.n_idx[k] + 1
            f.write('f %d//%d %d//%d %d//%d\n'
                    % (vi[0], ni[0], vi[1], ni[1], vi[2], ni[2]))


def _write_merl(path):
    """Synthetic MERL .binary (dims + float64 data, MERLBRDFRead.cpp:212-235):
    smooth positive table so interpolation-free lookups are well-conditioned."""
    n = 90 * 90 * 180
    idx = np.arange(n, dtype=np.float64)
    data = np.stack([
        (np.sin(idx * 1e-3) + 1.2) * 55.0,
        (np.cos(idx * 7e-4) + 1.3) * 42.0,
        (np.sin(idx * 1.3e-3 + 1.0) + 1.1) * 61.0,
    ])
    with open(path, 'wb') as f:
        np.array([90, 90, 180], np.int32).tofile(f)
        data.tofile(f)


@pytest.fixture(scope='module')
def ladder_dir(tmp_path_factory):
    """Config JSONs + generated asset stand-ins in one directory."""
    d = tmp_path_factory.mktemp('ladder')
    for cfg in ('config2_mesh.json', 'config3_transparent.json',
                'config4_merl_dof.json', 'config5_office.json'):
        shutil.copy(os.path.join(CONFIG_DIR, cfg), d / cfg)
    _write_obj(d / 'lion.obj', procgen.sphere_mesh(8, 8, radius=1.0))
    _write_obj(d / 'bot.obj',
               procgen.sphere_mesh(8, 8, radius=1.0, displace_amp=0.15))
    _write_obj(d / 'antiqueOffice.obj', procgen.sphere_mesh(6, 6, radius=1.0))
    rng = np.random.default_rng(7)
    save_hdr(str(d / 'env.hdr'),
             rng.uniform(0.05, 3.0, (8, 16, 3)).astype(np.float32))
    _write_merl(d / 'material.binary')
    return d


def _cpu_objects(objects):
    """ObjectSpec list -> CPU-harness objects (mesh split per group so the
    harness's single-constant-material Obj matches upload_mesh's g_* slate)."""
    out = []
    for o in objects:
        from pathtracer_tpu.models import merl as merl_mod
        merl = titopo = None
        if o.measured_brdf is not None:
            if o.measured_brdf.kind == merl_mod.TITOPO:
                titopo = (np.asarray(o.measured_brdf.data),
                          o.measured_brdf.dims)
            else:
                merl = np.asarray(o.measured_brdf.data)
        if o.obj_type == scn.SPHERE:
            out.append(ref.Obj(
                'sphere', center=o.center, radius=o.radius,
                flip_normals=o.flip_normals, kd=o.kd, ks=o.ks, ne=o.ne,
                transp=o.transp, refr_index=o.refr_index, miroir=o.miroir,
                translation=o.translation, ksub=o.ksub, merl=merl,
                titopo=titopo))
        elif o.obj_type == scn.PLANE:
            out.append(ref.Obj(
                'plane', point=o.center, normal=o.normal,
                flip_normals=o.flip_normals, kd=o.kd, ks=o.ks, ne=o.ne,
                translation=o.translation))
        else:
            md = o.mesh_data
            tri_verts = md.vertices[md.vtx_idx]
            tri_norms = md.normals[md.n_idx]
            # canonical triangle enumeration = BVH soup order (the
            # subsurface reservoir picks the floor(u*count)-th hit in soup
            # order, scene.reservoir_same_object) — replicate it here
            from pathtracer_tpu.ops import bvh as bvh_mod
            order = bvh_mod.build_bvh(tri_verts).order
            tri_verts, tri_norms = tri_verts[order], tri_norms[order]
            group = md.group[order]
            for gid, gmat in enumerate(md.materials):
                sel = group == gid
                out.append(ref.Obj(
                    'mesh', tri_verts=tri_verts[sel],
                    tri_normals=tri_norms[sel],
                    kd=gmat.kd, ks=gmat.ks, ne=gmat.ns,
                    transp=o.transp, refr_index=o.refr_index,
                    translation=o.translation, ksub=o.ksub))
    return out


def _run_config(ladder_dir, name, W, H, SPP, BOUNCES):
    objects, li, cam, _cfg, extras = scene_json.load_scene(
        str(ladder_dir / name))
    envmap = None
    if extras['envmap']:
        envmap = load_hdr(str(ladder_dir / extras['envmap']))
    sc = scn.build_scene(objects, li,
                         envmap_intensity=extras['envmap_intensity'],
                         envmap=envmap, fog=extras['fog'])
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    cp = rng_host.random_per_pixel_fast(W, H)
    _, smp_jax = rnd.render_unsplatted(sc, cam, jnp.asarray(cp), cfg)
    smp_jax = np.asarray(smp_jax)

    cpu_scene = ref.CPUScene(
        _cpu_objects(objects), li,
        envmap_intensity=extras['envmap_intensity'],
        fog=extras['fog'],
        envmap=None if envmap is None else np.asarray(envmap))
    cpu_cam = dict(position=np.asarray(cam.position, np.float32),
                   direction=np.asarray(cam.direction, np.float32),
                   up=np.asarray(cam.up, np.float32),
                   fov=float(cam.fov), focus=float(cam.focus_distance),
                   aperture=float(cam.aperture))
    smp_cpu = ref.render_cpu(cpu_scene, cpu_cam, W, H, SPP, BOUNCES, cp)

    scale = max(np.abs(smp_cpu).max(), 1e-6)
    rel = np.abs(smp_jax - smp_cpu).max(-1) / scale          # (H,W,SPP)
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05, (
        f'{name}: {flipped.mean():.4f} of samples diverge beyond f32 noise')
    tight = rel[~flipped]
    assert tight.size == 0 or tight.max() < 1e-3
    mean_rel = abs(smp_jax.mean() - smp_cpu.mean()) / scale
    assert mean_rel < 0.02, f'{name}: aggregate mean differs {mean_rel:.4f}'
    # non-vacuous: the config's signature feature must contribute
    assert np.abs(smp_cpu).max() > 0.0
    return smp_cpu


def test_config2_matches_cpu(ladder_dir):
    smp = _run_config(ladder_dir, 'config2_mesh.json', 16, 12, 4, 3)
    assert smp.max() > 0


def test_config3_matches_cpu(ladder_dir):
    _run_config(ladder_dir, 'config3_transparent.json', 16, 12, 4, 3)


def test_config4_matches_cpu(ladder_dir):
    _run_config(ladder_dir, 'config4_merl_dof.json', 16, 12, 4, 3)


def test_config5_matches_cpu(ladder_dir):
    _run_config(ladder_dir, 'config5_office.json', 12, 10, 2, 3)
