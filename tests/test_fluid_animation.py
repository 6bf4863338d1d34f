"""Fluid ANIMATION parity: per-frame particle snapshots drive per-frame
cluster rebuilds, the wavefront stand-in for the reference's
d.time-indexed per-frame acceleration grids (fluid.cpp:36-73,
fluid.h:940-957).  VERDICT r03 missing #6.

Checks: (a) the simulation's frame snapshots actually move, (b) every
frame's clustered intersection equals that frame's brute intersection
(the rebuild is per-frame sound), and (c) consecutive frames change the
rendered hits (the animation is visible to the renderer, not just the
sim)."""

import numpy as np
import jax.numpy as jnp

from pathtracer_tpu.scene import pointset as ps_mod
from pathtracer_tpu.scene import scene as scn
from pathtracer_tpu.sim import fluid


def _rays(n=1200, seed=3):
    rng = np.random.default_rng(seed)
    org = np.array([0.0, 10.0, 40.0], np.float32) + \
        rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    aim = np.array([4.0, 2.0, 4.0], np.float32)
    d = aim[None, :] - org + rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def test_fluid_animation_per_frame_clusters():
    cfg = fluid.FluidConfig(nx=12, ny=12, nz=12, lo=(0., 0., 0.),
                            hi=(8., 8., 8.), nsubsteps=4, dt=0.03)
    st = fluid.init_state(cfg, fluid.seed_box(
        cfg, (1., 4., 1.), (7., 7.5, 7.), 4000, seed=2))
    st, frames = fluid.run(cfg, st, nb_frames=3)
    assert len(frames) == 4

    # (a) the fluid falls: mean height decreases monotonically
    heights = [f[:, 1].mean() for f in frames]
    assert heights[-1] < heights[0] - 0.1, heights

    org, dirn = _rays()
    tmax = jnp.full((org.shape[0],), np.float32(1e30))
    prev_t = None
    for i, particles in enumerate(frames):
        # (b) per-frame rebuild: clustered == brute on the SAME snapshot
        ps_c = ps_mod.fluid_pointset(particles, obj_row=0, radius=0.35,
                                     clustered=True)
        ps_b = ps_mod.fluid_pointset(particles, obj_row=0, radius=0.35,
                                     clustered=False)
        assert ps_c.n_clusters > 0
        t_c, _ = ps_mod.clustered_sphere_sweep(ps_c, org, dirn, tmax)
        t_b, _ = ps_mod.sphere_sweep(ps_b, org, dirn, tmax)
        close = np.isclose(np.asarray(t_c), np.asarray(t_b), rtol=2e-4)
        assert close.mean() > 0.998, \
            f'frame {i}: {(~close).sum()} lanes differ'

        # (c) consecutive frames hit differently (animation visible)
        t_now = np.asarray(t_c)
        if prev_t is not None:
            hit_now = t_now < 1e29
            hit_prev = prev_t < 1e29
            changed = (hit_now != hit_prev) | (
                hit_now & hit_prev & ~np.isclose(t_now, prev_t, rtol=1e-3))
            assert changed.mean() > 0.02, \
                f'frame {i}: only {changed.mean():.3f} changed'
        prev_t = t_now
