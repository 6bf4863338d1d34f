"""Camera model: pinhole + thin-lens DoF (+ lenticular / camera-array modes).

JAX counterpart of the reference Camera (reference: Vector.h:721-840).
The camera is a small pytree of scalars/vectors; ray generation is fully
vectorized over pixel/sample arrays so a whole wavefront of primary rays is
produced in one fused XLA op (the reference generates one ray at a time,
Vector.h:792-825).
"""

from __future__ import annotations

import math
import numpy as np
import jax.numpy as jnp

from . import vec


from ..utils import struct


@struct.dataclass
class Camera:
    """Pytree camera. Vectors are (3,) float32, scalars 0-d float32.

    Mirrors the reference fields (Vector.h:827-836); lenticular/array modes
    are static metadata because they alter the traced control flow.
    """

    position: jnp.ndarray
    direction: jnp.ndarray
    up: jnp.ndarray
    fov: jnp.ndarray            # radians
    focus_distance: jnp.ndarray
    aperture: jnp.ndarray
    # lenticular interlacing (reference: Vector.h:798-812, 827-836)
    lenticular_max_angle: jnp.ndarray = None
    is_lenticular: bool = struct.field(pytree_node=False, default=False)
    lenticular_nb_images: int = struct.field(pytree_node=False, default=10)
    lenticular_pixel_width: int = struct.field(pytree_node=False, default=1)


def make_camera(position, direction, up, fov=35.0 * math.pi / 180.0,
                focus_distance=50.0, aperture=0.1, is_lenticular=False,
                lenticular_max_angle=35.0 * math.pi / 180.0 * 0.25,
                lenticular_nb_images=10, lenticular_pixel_width=1):
    """Build a camera (defaults match the reference default scene,
    Raytracer.cpp:1250-1253; lenticular defaults Vector.h:725-727)."""
    return Camera(
        position=jnp.asarray(position, jnp.float32),
        direction=vec.normalize(jnp.asarray(direction, jnp.float32)),
        up=vec.normalize(jnp.asarray(up, jnp.float32)),
        fov=jnp.float32(fov),
        focus_distance=jnp.float32(focus_distance),
        aperture=jnp.float32(aperture),
        lenticular_max_angle=jnp.float32(lenticular_max_angle),
        is_lenticular=bool(is_lenticular),
        lenticular_nb_images=int(lenticular_nb_images),
        lenticular_pixel_width=int(lenticular_pixel_width),
    )


def camera_array(cam: Camera, nbview_x: int, nbview_y: int,
                 max_spacing_x: float, max_spacing_y: float):
    """Camera-array grid: one camera per (vx, vy) view, offset along
    right/up (the render_video camera-array mode, mainApp.cpp:868-915;
    reference fields Vector.h:832-836).  Returns a list of Cameras row by
    row, each translated by (vx - (nX-1)/2)*spacing_x along right etc."""
    import numpy as np
    right = np.asarray(vec.cross(cam.direction, cam.up))
    up = np.asarray(cam.up)
    pos = np.asarray(cam.position)
    cams = []
    for vy in range(nbview_y):
        for vx in range(nbview_x):
            ox = (vx - (nbview_x - 1) / 2.0) * max_spacing_x
            oy = (vy - (nbview_y - 1) / 2.0) * max_spacing_y
            cams.append(cam.replace(
                position=jnp.asarray(pos + ox * right + oy * up, jnp.float32)))
    return cams


def rotate_camera_np(direction, up, angle_x, angle_y):
    """Host-side camera orbit used during scene setup
    (reference: Vector.h:740-765, called e.g. Raytracer.cpp:1273).

    Rotates direction & up by angle_y around x then angle_x around y, in the
    reference's exact axis order.
    """
    d = np.asarray(direction, np.float64).copy()
    u = np.asarray(up, np.float64).copy()

    def rot(v):
        tmp = np.array([
            v[0],
            math.cos(angle_y) * v[1] - math.sin(angle_y) * v[2],
            math.sin(angle_y) * v[1] + math.cos(angle_y) * v[2],
        ])
        return np.array([
            math.cos(angle_x) * tmp[0] - math.sin(angle_x) * tmp[2],
            tmp[1],
            math.sin(angle_x) * tmp[0] + math.cos(angle_x) * tmp[2],
        ])

    return rot(d).astype(np.float32), rot(u).astype(np.float32)


def generate_rays(cam: Camera, i, j, dx, dy, dx_aperture, dy_aperture,
                  width, height, init_t=0.0):
    """Vectorized primary-ray generation (reference: Vector.h:792-825).

    Args:
      cam: Camera.
      i, j: pixel row / column index arrays (float or int), any shape (...,).
      dx, dy: sensor jitter in [-0.5, 0.5].
      dx_aperture, dy_aperture: lens offsets (already scaled by aperture).
      width, height: static ints.
      init_t: near-frustum push-out distance (s.double_frustum_start_t).

    Returns:
      (origins, directions): (..., 3) float32 each.
    """
    i = jnp.asarray(i, jnp.float32)
    j_int = jnp.asarray(j, jnp.int32)
    j = jnp.asarray(j, jnp.float32)
    k = width / (2.0 * jnp.tan(cam.fov / 2.0))
    camera_right = vec.cross(cam.direction, cam.up)

    if cam.is_lenticular:
        # interlaced multi-view offsets (reference: Vector.h:798-812; the
        # world-axis projection math is reproduced literally, including its
        # assumption of an axis-aligned camera)
        nimg = cam.lenticular_nb_images
        el = (cam.focus_distance * jnp.tan(cam.lenticular_max_angle / 2.0)
              / (nimg / 2.0))
        offset = -((j_int // cam.lenticular_pixel_width) % nimg
                   - nimg // 2).astype(jnp.float32)
        p_focus = cam.position + cam.focus_distance * jnp.asarray(
            [0.0, 0.0, 1.0])
        c1 = cam.position + offset[..., None] * el * camera_right
        v1 = vec.normalize(p_focus - c1)
        pproj = (k / vec.dot3(v1, cam.direction)) * v1 + c1
        pix_j = pproj[..., 0] + width / 2.0 - 0.5
        pix_i = pproj[..., 1] + height / 2.0 - 0.5
        dvx = (j - pix_j) + dx
        dvy = (i - pix_i) + dy
    else:
        c1 = cam.position
        # sensor-space direction: (j - W/2 + 0.5 + dx, i - H/2 + 0.5 + dy, k)
        dvx = j - width / 2.0 + 0.5 + dx
        dvy = i - height / 2.0 + 0.5 + dy
    dvz = jnp.broadcast_to(k, dvx.shape)
    d = jnp.stack([dvx, dvy, dvz], axis=-1)
    d = vec.normalize(d)
    # to world space
    world_dir = (d[..., 0:1] * camera_right + d[..., 1:2] * cam.up
                 + d[..., 2:3] * cam.direction)

    # focal-plane target, then jittered lens origin
    denom = jnp.abs(vec.dot3(world_dir, cam.direction))
    destination = c1 + cam.focus_distance / denom * world_dir
    new_origin = (c1 + dx_aperture[..., None] * camera_right
                  + dy_aperture[..., None] * cam.up)
    new_dir = vec.normalize(destination - new_origin)
    origin = new_origin + init_t * new_dir / vec.dot3(new_dir, cam.direction)
    return origin, new_dir
