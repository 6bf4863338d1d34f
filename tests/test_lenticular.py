"""Lenticular interlaced rendering: image-level parity vs the CPU harness.

The interlacing math (core/camera.generate_rays lenticular branch) is a
literal port of the reference Camera::generateDirection multi-view path
(Vector.h:798-812) including its axis-aligned-camera assumption; until
round 5 it only had parameter/round-trip coverage.  Here a full image is
rendered through BOTH tracers with a lenticular camera and compared
per-sample, plus a direct interlacing property check (pixel columns
within one lenticular band share a view; adjacent bands step the view).
"""

import math

import numpy as np
import jax.numpy as jnp

import pathtracer_tpu as pt
from pathtracer_tpu.core import camera as cam_mod
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.scene import scene as scn

import reference_cpu as ref

W, H, SPP, BOUNCES = 24, 16, 2, 2
NB_IMAGES, PIX_W, MAX_ANGLE = 4, 2, 0.5


def _scenes():
    li = scn.default_light_intensity()
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                           ks=(0.1, 0.1, 0.1), ne=(30.0, 30.0, 30.0)))
    cpu_objs = [
        ref.Obj('sphere', center=(10, 23, 15), radius=10.0),
        ref.Obj('sphere', center=(0, 0, 0), radius=1e6, flip_normals=True),
        ref.Obj('plane', point=(0, 0, 0), normal=(0, 1, 0),
                translation=(0, -27.3, 0)),
        ref.Obj('sphere', center=(0, -17, 0), radius=10.0,
                kd=(0.7, 0.3, 0.2), ks=(0.1, 0.1, 0.1), ne=(30, 30, 30)),
    ]
    return scn.build_scene(objs, li), ref.CPUScene(cpu_objs, li)


def _lenticular_cams():
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0),
                         is_lenticular=True,
                         lenticular_max_angle=MAX_ANGLE,
                         lenticular_nb_images=NB_IMAGES,
                         lenticular_pixel_width=PIX_W)
    cpu_cam = dict(position=np.array([0, 0, 50], np.float32),
                   direction=np.array([0, 0, -1], np.float32),
                   up=np.array([0, 1, 0], np.float32),
                   fov=35 * math.pi / 180, focus=50.0, aperture=0.1,
                   is_lenticular=True, lenticular_max_angle=MAX_ANGLE,
                   lenticular_nb_images=NB_IMAGES,
                   lenticular_pixel_width=PIX_W)
    return cam, cpu_cam


def test_lenticular_ray_generation_matches_cpu():
    """Ray origins/directions agree per pixel column (no RNG involved)."""
    cam, cpu_cam = _lenticular_cams()
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    z = jnp.zeros((H * W,))
    org, dirn = cam_mod.generate_rays(
        cam, jnp.asarray(ii.reshape(-1), jnp.float32),
        jnp.asarray(jj.reshape(-1), jnp.float32), z, z, z, z, W, H)
    org = np.asarray(org).reshape(H, W, 3)
    dirn = np.asarray(dirn).reshape(H, W, 3)
    for i in (0, H // 2):
        for j in range(W):
            o, d = ref.generate_ray(cpu_cam, i, j, 0.0, 0.0, 0.0, 0.0, W, H)
            np.testing.assert_allclose(org[i, j], o, atol=2e-4)
            np.testing.assert_allclose(dirn[i, j], d, atol=2e-5)
    # interlacing property: the view offset (hence ray origin x) is
    # constant within one PIX_W-wide band and cycles with period
    # NB_IMAGES * PIX_W across bands
    ox = org[0, :, 0]
    for j in range(W - 1):
        same_band = (j // PIX_W) == ((j + 1) // PIX_W)
        if same_band:
            assert abs(ox[j] - ox[j + 1]) < 1e-5
    assert np.allclose(ox[: W - NB_IMAGES * PIX_W],
                       ox[NB_IMAGES * PIX_W:], atol=1e-5)
    assert len(np.unique(np.round(ox[:NB_IMAGES * PIX_W], 4))) == NB_IMAGES


def test_lenticular_image_matches_cpu():
    sc, cpu_scene = _scenes()
    cam, cpu_cam = _lenticular_cams()
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    cp = rng_host.random_per_pixel_fast(W, H)
    _, smp_jax = rnd.render_unsplatted(sc, cam, jnp.asarray(cp), cfg)
    smp_jax = np.asarray(smp_jax)
    smp_cpu = ref.render_cpu(cpu_scene, cpu_cam, W, H, SPP, BOUNCES, cp)
    scale = max(np.abs(smp_cpu).max(), 1e-6)
    per_sample_rel = np.abs(smp_jax - smp_cpu).max(-1) / scale
    flipped = per_sample_rel > 1e-3
    assert flipped.mean() < 0.05, flipped.mean()
    assert per_sample_rel[~flipped].max() < 1e-3
    mean_rel = abs(smp_jax.mean() - smp_cpu.mean()) / scale
    assert mean_rel < 0.02, mean_rel
