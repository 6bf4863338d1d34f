"""Subsurface scattering: JAX wavefront vs CPU harness parity."""

import math

import numpy as np
import jax.numpy as jnp

import pathtracer_tpu as pt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.scene import scene as scn

import reference_cpu as ref

W, H, SPP, BOUNCES = 16, 12, 4, 3


def _scenes():
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.5, 0.4, 0.3),
                           ksub=(0.6, 0.4, 0.3)))
    sc = scn.build_scene(objs, scn.default_light_intensity())
    assert sc.ss_enabled
    cpu_objs = [
        ref.Obj('sphere', center=(10, 23, 15), radius=10.0),
        ref.Obj('sphere', center=(0, 0, 0), radius=1e6, flip_normals=True),
        ref.Obj('plane', point=(0, 0, 0), normal=(0, 1, 0),
                translation=(0, -27.3, 0)),
        ref.Obj('sphere', center=(0, -17, 0), radius=10.0, kd=(0.5, 0.4, 0.3),
                ksub=(0.6, 0.4, 0.3)),
    ]
    cpu = ref.CPUScene(cpu_objs, scn.default_light_intensity())
    return sc, cpu


def test_subsurface_matches_cpu():
    sc, cpu_scene = _scenes()
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cpu_cam = dict(position=np.array([0, 0, 50], np.float32),
                   direction=np.array([0, 0, -1], np.float32),
                   up=np.array([0, 1, 0], np.float32),
                   fov=35 * math.pi / 180, focus=50.0, aperture=0.1)
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    cp = rng_host.random_per_pixel_fast(W, H)
    _, smp_jax = rnd.render_unsplatted(sc, cam, jnp.asarray(cp), cfg)
    smp_jax = np.asarray(smp_jax)
    smp_cpu = ref.render_cpu(cpu_scene, cpu_cam, W, H, SPP, BOUNCES, cp)

    scale = max(np.abs(smp_cpu).max(), 1e-6)
    rel = np.abs(smp_jax - smp_cpu).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.08, f"{flipped.mean():.4f} flipped"
    assert rel[~flipped].max() < 1e-3
    mean_rel = abs(smp_jax.mean() - smp_cpu.mean()) / scale
    assert mean_rel < 0.05, f"aggregate {mean_rel:.4f}"


def test_subsurface_adds_translucency():
    """An SS sphere should be brighter than the same pure-dark sphere
    (light bleeding through the limb)."""
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cp = jnp.asarray(rng_host.random_per_pixel_fast(W, H))
    cfg = rnd.RenderConfig(width=W, height=H, nrays=8, nb_bounces=3)

    def render(ksub):
        objs = scn.default_objects()
        objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.05, 0.05, 0.05),
                               ksub=ksub))
        sc = scn.build_scene(objs, scn.default_light_intensity())
        img, _ = rnd.render_unsplatted(sc, cam, cp, cfg)
        return float(jnp.mean(img))

    dark = render((0.0, 0.0, 0.0))
    translucent = render((0.9, 0.9, 0.9))
    assert np.isfinite(dark) and np.isfinite(translucent)
    assert translucent > dark
