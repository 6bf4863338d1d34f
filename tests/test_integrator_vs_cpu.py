"""End-to-end: wavefront JAX integrator vs sequential CPU reference tracer.

BASELINE config 1 shape: analytic spheres + plane, Phong materials, one
spherical light — the forward image must allclose the CPU render at equal
per-path PCG sample sequences (BASELINE.json north star).
"""

import math

import numpy as np
import jax.numpy as jnp

import pathtracer_tpu as pt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.scene import scene as scn

import reference_cpu as ref


W, H, SPP, BOUNCES = 24, 20, 4, 3


def _make_scenes(extra='diffuse'):
    li = scn.default_light_intensity()
    objs = scn.default_objects()
    cpu_objs = [
        ref.Obj('sphere', center=(10, 23, 15), radius=10.0),
        ref.Obj('sphere', center=(0, 0, 0), radius=1e6, flip_normals=True),
        ref.Obj('plane', point=(0, 0, 0), normal=(0, 1, 0),
                translation=(0, -27.3, 0)),
    ]
    if extra == 'diffuse':
        objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0,
                               kd=(0.7, 0.3, 0.2), ks=(0.1, 0.1, 0.1),
                               ne=(30.0, 30.0, 30.0)))
        cpu_objs.append(ref.Obj('sphere', center=(0, -17, 0), radius=10.0,
                                kd=(0.7, 0.3, 0.2), ks=(0.1, 0.1, 0.1),
                                ne=(30, 30, 30)))
    elif extra == 'mirror':
        objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, miroir=True))
        cpu_objs.append(ref.Obj('sphere', center=(0, -17, 0), radius=10.0,
                                miroir=True))
    elif extra == 'transp':
        objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, transp=True,
                               refr_index=1.4))
        cpu_objs.append(ref.Obj('sphere', center=(0, -17, 0), radius=10.0,
                                transp=True, refr_index=1.4))
    sc = scn.build_scene(objs, li)
    cpu_scene = ref.CPUScene(cpu_objs, li)
    return sc, cpu_scene


def _cams():
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cpu_cam = dict(position=np.array([0, 0, 50], np.float32),
                   direction=np.array([0, 0, -1], np.float32),
                   up=np.array([0, 1, 0], np.float32),
                   fov=35 * math.pi / 180, focus=50.0, aperture=0.1)
    return cam, cpu_cam


def _compare(extra):
    """Per-sample comparison with a boundary-flip allowance.

    Path tracing with visibility has knife-edge branches (shadow-ray horizon
    grazing, Fresnel RR at u==R, lobe choice at u==p): any f32
    order-of-operations difference (C++ vs XLA fusion, batch-size-dependent
    vectorization) flips such samples entirely.  The correctness criterion is
    therefore: the overwhelming majority of per-sample radiances must match to
    f32 precision, flipped samples must be rare, and the aggregate image must
    agree statistically.
    """
    sc, cpu_scene = _make_scenes(extra)
    cam, cpu_cam = _cams()
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    cp = rng_host.random_per_pixel_fast(W, H)

    _, smp_jax = rnd.render_unsplatted(sc, cam, jnp.asarray(cp), cfg)
    smp_jax = np.asarray(smp_jax)
    smp_cpu = ref.render_cpu(cpu_scene, cpu_cam, W, H, SPP, BOUNCES, cp)

    scale = max(np.abs(smp_cpu).max(), 1e-6)
    per_sample_rel = np.abs(smp_jax - smp_cpu).max(-1) / scale  # (H,W,SPP)
    flipped = per_sample_rel > 1e-3
    frac_flipped = flipped.mean()
    assert frac_flipped < 0.05, (
        f"{extra}: {frac_flipped:.4f} of samples diverge beyond f32 noise")
    # non-flipped samples must match tightly
    tight = per_sample_rel[~flipped]
    assert tight.max() < 1e-3
    # aggregate agreement: flips are boundary samples, roughly unbiased
    mean_rel = abs(smp_jax.mean() - smp_cpu.mean()) / scale
    assert mean_rel < 0.02, f"{extra}: aggregate mean differs {mean_rel:.4f}"


def test_config1_diffuse_matches_cpu():
    _compare('diffuse')


def test_mirror_matches_cpu():
    _compare('mirror')


def test_transparent_matches_cpu():
    _compare('transp')
