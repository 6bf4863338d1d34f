"""pathtracer_tpu — a differentiable wavefront path tracer in JAX.

Reproduces the capabilities of nbonneel/pathtracer (C++/OpenMP/Embree CPU
path tracer): wavefront path tracing over SoA ray arrays, a per-ray BVH
traversal kernel for NVIDIA GPUs (Pallas, Triton route), shard_map
multi-device sharding, and detached-sampling differentiability.
See SURVEY.md at the repo root for the reference structural analysis.
"""

from .core.camera import Camera, make_camera, rotate_camera_np
from .io.obj import load_mesh
from .render.renderer import RenderConfig, Renderer
from .scene.scene import (SceneArrays, build_scene, default_light_intensity,
                          default_objects, mesh_object, plane, sphere)

__all__ = [
    'Camera', 'make_camera', 'rotate_camera_np',
    'RenderConfig', 'Renderer', 'load_mesh',
    'SceneArrays', 'build_scene', 'default_light_intensity',
    'default_objects', 'mesh_object', 'plane', 'sphere',
]

__version__ = '0.1.0'
