"""Multi-chip execution: pixel/sample sharding over a device mesh.

The reference's only parallelism is OpenMP threads over pixel rows / 4x4
batches on one machine (reference: Raytracer.cpp:1455-1459, 1590-1597;
SURVEY §2.7).  The wavefront equivalents implemented here:

  * 'dp' mesh axis — image rows sharded across chips (the OpenMP-row-loop
    analogue): each chip traces its pixel rows' wavefront.
  * 'sp' mesh axis — samples-per-pixel sharded across chips (the
    progressive-iteration analogue): chips trace disjoint sample sets of
    the same pixels.

Film partials live per-chip and are summed with `jax.lax.psum` (the
per-thread-accumulator merge, Raytracer.cpp:1576-1685).  Gradients of the
differentiable render are psum'd by the shard_map transpose automatically.

Scene/BVH partitioning over devices (per-partition sub-BVHs with
broadcast-combine, routed or ring-pipelined rays) lives in
parallel/scene_shard.py as standalone hit functions; the renderer itself
replicates the scene on every device.

On bounce-stage pipelining (the PP analogue, SURVEY §2.7): deliberately
NOT implemented as a device axis.  PP exists in ML stacks to split
*parameter memory* across stages; a wavefront path tracer has no
per-stage parameters — every bounce needs the SAME scene data, so
pipelining bounces across chips would replicate (or re-shard) the scene
anyway while adding warmup/drain bubbles and a full ray-state ppermute
per bounce.  dp/sp sharding reaches the same utilization with zero
transfers; the scene-memory problem PP would solve belongs to a scene
axis (parallel/scene_shard.py).  The in-chip analogue of pipelining — keeping
the chip busy across bounce stages — is the wavefront itself (bounce-
major loop + compaction + octant sort, render/integrator.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core import camera as cam_mod
from ..core import qmc
from ..core import rng as prng
from ..render import film as film_mod
from ..render import integrator


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: int = 1) -> Mesh:
    """Build a ('dp', 'sp') mesh over the first devices (a flat reshape:
    every pair of cards is one NVLink hop apart, so placement does not
    matter)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if dp is None:
        dp = n // sp
    need = dp * sp
    assert need <= len(devs), f"need {need} devices, have {len(devs)}"
    arr = np.array(devs[:need]).reshape(dp, sp)
    return Mesh(arr, ('dp', 'sp'))


def _render_shard(sc, cam, cp_shard, sample_ids, pix_i, pix_j, row0, cfg):
    """Trace this chip's (pixel-rows x samples) block, return film partial.

    Runs *inside* shard_map: all arrays are the local shard; the film
    partial is full-size padded (splat windows cross row-shard boundaries;
    per-chip full films + psum replaces halo exchange — the film is small
    next to the wavefront)."""
    w, h = cfg.width, cfg.height
    nspp = cfg.nrays
    block_rows = pix_i.shape[0] // w
    film_spec = film_mod.make_film_spec_static(w, h, cfg.sigma_filter)
    image, count = film_mod.alloc(film_spec)
    pix_flat = pix_i * w + pix_j

    def per_sample(carry, k):
        image, count = carry
        key_lo = (pix_flat.astype(jnp.uint32) * jnp.uint32(nspp)
                  + k.astype(jnp.uint32))
        key_hi = jnp.full_like(key_lo, jnp.uint32(cfg.seed))
        rng_state = prng.make_stream(key_hi, key_lo)
        u_dx, rng_state = prng.next_uniform(rng_state)
        u_dy, rng_state = prng.next_uniform(rng_state)
        u_ax, rng_state = prng.next_uniform(rng_state)
        u_ay, rng_state = prng.next_uniform(rng_state)
        org, dirn = cam_mod.generate_rays(
            cam, pix_i, pix_j, u_dx - 0.5, u_dy - 0.5,
            (u_ax - 0.5) * cam.aperture, (u_ay - 0.5) * cam.aperture,
            w, h, init_t=cfg.double_frustum_start_t)
        lattice = qmc.extensible_lattice_2d(k.astype(jnp.uint32))
        cp_r12 = qmc.cranley_patterson(lattice[None, :], cp_shard)
        from ..render.renderer import _background_pixels
        bg_pixel = _background_pixels(sc, pix_i, pix_j, w, h)
        color, _, _ = integrator.trace_paths(sc, org, dirn, rng_state, cp_r12,
                                             cfg.nb_bounces,
                                             bg_pixel=bg_pixel)
        image, count = film_mod.splat(film_spec, image, count, color,
                                      u_dx - 0.5, u_dy - 0.5,
                                      row0=row0, block_rows=block_rows)
        return (image, count), None

    (image, count), _ = jax.lax.scan(per_sample, (image, count), sample_ids)
    return image, count


def make_sharded_render(mesh: Mesh, cfg, film_ratio):
    """Jitted multi-chip render: (scene, camera, cp_table) -> (image, count).

    Pixel rows shard over 'dp', sample ids over 'sp'; film partials psum
    over both axes.  cp_table must be passed row-sharded-compatible
    ((H*W, 2), H divisible by dp axis size).
    """
    w, h = cfg.width, cfg.height
    dp = mesh.shape['dp']
    sp = mesh.shape['sp']
    assert h % dp == 0, f"height {h} must divide dp={dp}"
    assert cfg.nrays % sp == 0, f"nrays {cfg.nrays} must divide sp={sp}"

    ii, jj = np.meshgrid(np.arange(h, dtype=np.int32),
                         np.arange(w, dtype=np.int32), indexing='ij')
    pix_i_all = jnp.asarray(ii.reshape(-1))
    pix_j_all = jnp.asarray(jj.reshape(-1))
    sample_ids = jnp.arange(cfg.nrays, dtype=jnp.int32)

    rows_per_shard = h // dp

    def sharded(sc, cam, cp_table):
        def body(sc, cam, cp_shard, ks, pi, pj):
            row0 = jax.lax.axis_index('dp') * rows_per_shard
            image, count = _render_shard(sc, cam, cp_shard, ks, pi, pj,
                                         row0, cfg)
            image = jax.lax.psum(image, ('dp', 'sp'))
            count = jax.lax.psum(count, ('dp', 'sp'))
            return image, count

        return shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P('dp'), P('sp'), P('dp'), P('dp')),
            out_specs=(P(), P()),
            check_vma=False,
        )(sc, cam, cp_table, sample_ids, pix_i_all, pix_j_all)

    return jax.jit(sharded)


def make_train_step(mesh: Mesh, cfg, film_ratio, lr=1e-2):
    """Differentiable-render training step: fit material/light params to a
    target image by gradient descent.  Gradients flow through the
    detached-sampling estimator and are all-reduced by the shard_map
    transpose (the psum in the forward becomes identity in the cotangent,
    and the replicated-param cotangents are psum'd) — gradient all-reduce
    overlapped with backward.

    Returns jitted fn: (params, sc, cam, cp_table, target) ->
    (loss, new_params), where params = dict(kd, ks, light_intensity).
    """
    render = make_sharded_render(mesh, cfg, film_ratio)

    def apply_params(sc, params):
        return sc.replace(kd=params['kd'], ks=params['ks'],
                          light_intensity=params['light_intensity'])

    film_spec = film_mod.make_film_spec_static(cfg.width, cfg.height,
                                               cfg.sigma_filter)

    def loss_fn(params, sc, cam, cp_table, target):
        image, count = render(apply_params(sc, params), cam, cp_table)
        image = film_mod.crop(film_spec, image)
        count = film_mod.crop(film_spec, count)
        hdr = image / film_mod.RADIANCE_SCALE / jnp.maximum(count, 1e-9)[..., None]
        return jnp.mean((hdr - target) ** 2)

    @jax.jit
    def step(params, sc, cam, cp_table, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, sc, cam, cp_table,
                                                  target)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return loss, new_params

    return step
