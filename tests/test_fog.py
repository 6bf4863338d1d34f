"""Fog: JAX wavefront vs CPU harness parity + physical sanity checks."""

import math

import numpy as np
import jax.numpy as jnp

import pathtracer_tpu as pt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.scene import scene as scn

import reference_cpu as ref

W, H, SPP, BOUNCES = 16, 12, 4, 3

FOG_UNIFORM = {'density': 0.4, 'absorption': 0.4, 'type': 0, 'phase_type': 0}
FOG_EXP = {'density': 0.5, 'absorption': 0.5, 'density_decay': 0.05,
           'absorption_decay': 0.05, 'type': 1, 'phase_type': 1,
           'phase_aniso': 0.6}


def _scenes(fog):
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2)))
    sc = scn.build_scene(objs, scn.default_light_intensity(), fog=fog)
    cpu_objs = [
        ref.Obj('sphere', center=(10, 23, 15), radius=10.0),
        ref.Obj('sphere', center=(0, 0, 0), radius=1e6, flip_normals=True),
        ref.Obj('plane', point=(0, 0, 0), normal=(0, 1, 0),
                translation=(0, -27.3, 0)),
        ref.Obj('sphere', center=(0, -17, 0), radius=10.0, kd=(0.7, 0.3, 0.2)),
    ]
    cpu = ref.CPUScene(cpu_objs, scn.default_light_intensity(), fog=fog)
    return sc, cpu


def _cams():
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cpu_cam = dict(position=np.array([0, 0, 50], np.float32),
                   direction=np.array([0, 0, -1], np.float32),
                   up=np.array([0, 1, 0], np.float32),
                   fov=35 * math.pi / 180, focus=50.0, aperture=0.1)
    return cam, cpu_cam


def _compare(fog, flip_budget=0.08):
    sc, cpu_scene = _scenes(fog)
    cam, cpu_cam = _cams()
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    cp = rng_host.random_per_pixel_fast(W, H)
    _, smp_jax = rnd.render_unsplatted(sc, cam, jnp.asarray(cp), cfg)
    smp_jax = np.asarray(smp_jax)
    smp_cpu = ref.render_cpu(cpu_scene, cpu_cam, W, H, SPP, BOUNCES, cp)

    scale = max(np.abs(smp_cpu).max(), 1e-6)
    rel = np.abs(smp_jax - smp_cpu).max(-1) / scale
    flipped = rel > 1e-3
    # fog adds more knife-edges (equiangular + visibility + RR); budget is
    # a bit wider than the surface-only tests
    assert flipped.mean() < flip_budget, f"{flipped.mean():.4f} flipped"
    tight = rel[~flipped]
    assert tight.max() < 1e-3
    mean_rel = abs(smp_jax.mean() - smp_cpu.mean()) / scale
    assert mean_rel < 0.05, f"aggregate {mean_rel:.4f}"


def test_uniform_fog_matches_cpu():
    _compare(FOG_UNIFORM)


def test_exponential_fog_schlick_matches_cpu():
    _compare(FOG_EXP)


def test_fog_attenuates_direct_light():
    """More fog -> darker direct image (transmittance monotonicity)."""
    cam, _ = _cams()
    cp = jnp.asarray(rng_host.random_per_pixel_fast(W, H))
    cfg = rnd.RenderConfig(width=W, height=H, nrays=2, nb_bounces=1)
    means = []
    for dens in (0.0, 0.5, 2.0):
        fog = None if dens == 0 else {'density': dens, 'absorption': dens,
                                      'type': 0, 'phase_type': 0}
        objs = scn.default_objects()
        objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2)))
        sc = scn.build_scene(objs, scn.default_light_intensity(), fog=fog)
        img, _ = rnd.render_unsplatted(sc, cam, cp, cfg)
        means.append(float(jnp.mean(img)))
    assert means[0] > means[1] * 0.999  # scattering can add a little back
    assert means[1] > means[2]
    assert all(np.isfinite(m) for m in means)
