"""Scenes shared by bench.py and chip_smoke.py.

* flagship: the analytic showcase (light + dome + ground, a Phong
  sphere, a mirror sphere and a glass sphere);
* sphere_mesh_scene: a closed displaced procedural sphere mesh
  (utils/procgen.sphere_mesh) on the default ground — sphere_mesh(32, 32)
  is ~2k triangles, sphere_mesh(1100, 1100) is ~2.42M.
"""

from __future__ import annotations


def camera():
    from ..core import camera as cam_mod
    return cam_mod.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))


def flagship_objects():
    from ..scene import scene as scn
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                           ks=(0.1, 0.1, 0.1), ne=(30.0, 30.0, 30.0)))
    objs.append(scn.sphere((-16.0, -20.0, -10.0), 7.0, miroir=True))
    objs.append(scn.sphere((17.0, -19.0, -5.0), 8.0, transp=True,
                           refr_index=1.4))
    return objs


def flagship():
    """(SceneArrays, Camera) of the analytic flagship."""
    from ..scene import scene as scn
    return (scn.build_scene(flagship_objects(),
                            scn.default_light_intensity()), camera())


def sphere_mesh_scene(n_lat: int, n_lon: int, radius: float = 14.0,
                      displace_amp: float = 0.25):
    """(SceneArrays, Camera, MeshData) of one displaced sphere mesh."""
    from ..scene import scene as scn
    from . import procgen
    md = procgen.sphere_mesh(n_lat, n_lon, radius=radius,
                             displace_amp=displace_amp)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    return (scn.build_scene(objs, scn.default_light_intensity()), camera(),
            md)
