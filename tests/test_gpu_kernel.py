"""The BVH traversal kernel compiled for the card (no interpret mode),
against the XLA oracles.  Marked `gpu`: skips on other platforms; on a
card run `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer_tpu.ops import bvh_kernel
from pathtracer_tpu.ops import traverse
from pathtracer_tpu.scene import mesh as mesh_mod
from pathtracer_tpu.utils import procgen

pytestmark = pytest.mark.gpu


def _mesh_and_rays(lat, n, seed=0):
    md = procgen.sphere_mesh(lat, lat, radius=10.0, displace_amp=0.3,
                             seed=seed)
    m = mesh_mod.upload_mesh(md, obj_row=2)
    rng = np.random.default_rng(seed)
    org = jnp.asarray(rng.uniform(-14, 14, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    return m, org, d


@pytest.mark.parametrize('lat', [32, 224])
def test_compiled_kernel_matches_brute_force(gpu_device, lat):
    m, org, d = _mesh_and_rays(lat, 65536)
    assert m.tier == 'kernel'
    t, tri = bvh_kernel.kernel_hit(m.kroot, m.knodes, m.ktris, org, d,
                                   max_leaf=m.max_leaf, depth=m.bvh_depth)
    ref = traverse.brute_force_hit(m.tri_soup(), org, d)
    tri, ref_tri = np.asarray(tri), np.asarray(ref.tri)
    assert np.mean(tri == ref_tri) >= 0.9999
    both = (tri == ref_tri) & (tri >= 0)
    t, ref_t = np.asarray(t)[both], np.asarray(ref.t)[both]
    assert np.all(np.abs(t - ref_t) <= 1e-5 * ref_t)


def test_compiled_any_hit_matches_brute_force(gpu_device):
    m, org, d = _mesh_and_rays(64, 65536, seed=1)
    limit = jnp.full((65536,), 8.0, jnp.float32)
    _, tri = bvh_kernel.kernel_hit(m.kroot, m.knodes, m.ktris, org, d,
                                   limit, max_leaf=m.max_leaf,
                                   depth=m.bvh_depth, any_hit=True)
    ref = np.asarray(traverse.brute_force_any(m.tri_soup(), org, d, limit))
    assert np.mean((np.asarray(tri) >= 0) == ref) >= 0.9999
