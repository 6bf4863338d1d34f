"""Render the showcase gallery (on the GPU: python docs/make_gallery.py)."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np
import jax

import pathtracer_tpu as pt
from pathtracer_tpu.io.image import save_image
from pathtracer_tpu.models.presets import preset
from pathtracer_tpu.scene import pointset as ps_mod
from pathtracer_tpu.scene import scene as scn
from pathtracer_tpu.sim import fluid as fluid_sim

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'gallery')
os.makedirs(OUT, exist_ok=True)
W, H, SPP = 512, 384, 64
# the reference default scene tilts the camera 22 deg down
# (cam.rotate(0, -22deg, 1), Raytracer.cpp:1273)
import math
_d, _u = pt.rotate_camera_np((0, 0, -1), (0, 1, 0), 0.0,
                             -22 * math.pi / 180)
CAM = pt.make_camera((0, 0, 50), _d, _u)


def render(name, objs, spp=SPP, fog=None, envmap=None, cam=CAM,
           light=None, bounces=3, only=None):
    if only and name not in only:
        return
    sc = scn.build_scene(objs, light if light is not None
                         else scn.default_light_intensity(),
                         fog=fog, envmap=envmap)
    cfg = pt.RenderConfig(width=W, height=H, nrays=spp, nb_bounces=bounces,
                          samples_per_wave=min(spp, 16))
    t0 = time.perf_counter()
    r = pt.Renderer(sc, cam, cfg).render()
    img = r.u8()
    dt = time.perf_counter() - t0
    save_image(os.path.join(OUT, f'{name}.png'), img)
    print(f'{name}: {dt:.1f}s', flush=True)


def main(only=None):
    # 1. flagship: diffuse + mirror + glass + DoF
    objs = scn.default_objects()
    objs.append(pt.sphere((0., -17., 0.), 10., kd=(.7, .3, .2),
                          ks=(.1, .1, .1), ne=(30., 30., 30.)))
    objs.append(pt.sphere((-16., -20., -10.), 7., miroir=True))
    objs.append(pt.sphere((17., -19., -5.), 8., transp=True,
                          refr_index=1.4))
    render('flagship', objs, only=only)

    # 2. preset metals
    objs = scn.default_objects()
    for i, name in enumerate(('gold', 'copper', 'chrome', 'bronze')):
        objs.append(pt.sphere((-18.0 + i * 12, -21.0, 0.0), 5.5,
                              **preset(name)))
    render('metals', objs, only=only)

    # 3. subsurface
    objs = scn.default_objects()
    objs.append(pt.sphere((0., -17., 0.), 10., kd=(.08, .08, .08),
                          ksub=(.9, .5, .3)))
    render('subsurface', objs, only=only, spp=128)

    # 4. fog
    objs = scn.default_objects()
    objs.append(pt.sphere((0., -17., 0.), 10., kd=(.7, .3, .2)))
    objs.append(pt.sphere((-18., -20., -15.), 7., kd=(.2, .5, .8)))
    render('fog', objs, only=only, spp=512,
           fog={'density': 0.08, 'absorption': 0.08, 'type': 0,
                'phase_type': 1, 'phase_aniso': 0.5})

    # 5. fluid splash (simulated then rendered)
    cfg_f = fluid_sim.FluidConfig(lo=(0., 0., 0.), hi=(1., 1., 1.),
                                  nx=24, ny=24, nz=24, dt=0.02)
    pts = fluid_sim.seed_box(cfg_f, (0.15, 0.45, 0.15), (0.85, 0.95, 0.85),
                             9000)
    st = fluid_sim.init_state(cfg_f, pts)
    st = fluid_sim.reclassify(cfg_f, st)
    st, frames = fluid_sim.run(cfg_f, st, nb_frames=10)
    world = np.asarray(frames[-1]) * 26.0 + np.array([-13., -27., -8.],
                                                     np.float32)
    objs = scn.default_objects()
    objs.append(scn.pointset_object(
        ps_mod.fluid_pointset(world, radius=0.8, color=(0.35, 0.55, 0.9))))
    render('fluid', objs, only=only, spp=32)

    # 6. env-lit scene
    # envmap texels are u8-scale: Ke = tex * 100000/255 (Geometry.h:973)
    eh, ew = 64, 128
    yy = np.linspace(0, 1, eh)[:, None]
    env = np.stack([np.broadcast_to(0.3 + 0.7 * yy, (eh, ew)),
                    np.broadcast_to(0.45 + 0.4 * yy, (eh, ew)),
                    np.broadcast_to(0.8 - 0.2 * yy, (eh, ew))],
                   axis=-1).astype(np.float32) * 400.0
    objs = scn.default_objects()
    objs.append(pt.sphere((0., -17., 0.), 10., kd=(.9, .9, .9)))
    objs.append(pt.sphere((-15., -21., -8.), 6., miroir=True))
    render('envmap', objs, only=only, envmap=env, light=2e5, spp=64)


if __name__ == '__main__':
    main(sys.argv[1:] or None)
