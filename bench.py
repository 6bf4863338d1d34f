"""Benchmark: wavefront path-tracing throughput on one GPU.

Prints the device (JAX platform, device_kind, count, and the card's name
and power limit from nvidia-smi), then ONE JSON line:
  value / metric — live-lane rays per second of the analytic flagship at
      1080p, 3 bounces (Renderer.rays_traced: hit + NEE shadow sweeps
      over lanes that are actually alive);
  hardware_ray_ops_per_s — the flagship's lockstep accounting
      (W*H*spp*bounces*2 / s, dead lanes included);
  mesh_scene_rays_per_s / mesh_scene_tris — live-lane rays/s of a full
      1080p render of a ~2k-triangle displaced sphere;
  big_mesh_e2e_rays_per_s / big_mesh_e2e_tris — the closed 2.42M-triangle
      displaced sphere through the full renderer at 1080p, 3 bounces,
      compaction + octant sort;
  fwd_ms_per_frame_1080p64 / fwd_bwd_ms_per_frame_1080p64 — forward and
      forward+backward 64-spp frame times through the same jitted
      render_unsplatted path (the backward includes the remat re-forward).

Every window is timed on the host clock around work that ends in
jax.block_until_ready, after a warm-up call of the same shape.  Exits
with an error when JAX finds no GPU.
"""

import json
import time

import jax
import jax.numpy as jnp


def _bench_renderer(r, warm_spp, bench_spp):
    r.step(warm_spp)
    jax.block_until_ready(r.image)
    t0 = time.perf_counter()
    done = 0
    while done < bench_spp:
        r.step(warm_spp)
        done += warm_spp
    jax.block_until_ready(r.image)
    return done, time.perf_counter() - t0


def _live_rays_per_s(r, done, dt):
    # rays_traced accumulates over warm-up and the window (samples_done
    # spp in all); scale it to the window's share
    return (r.stats(dt)['rays_traced'] * done / r.samples_done) / dt


def main():
    from pathtracer_tpu.utils import compile_cache, device
    device.require_gpu()
    compile_cache.enable()
    print(json.dumps({'device': device.describe(),
                      'card': device.card_line()}), flush=True)

    import pathtracer_tpu as pt
    from pathtracer_tpu.core import rng_host
    from pathtracer_tpu.render import renderer as rnd
    from pathtracer_tpu.utils import bench_scenes

    W, H, BOUNCES = 1920, 1080, 3
    WARMUP_SPP, BENCH_SPP = 16, 32

    sc, cam = bench_scenes.flagship()
    cfg = pt.RenderConfig(width=W, height=H, nrays=64, nb_bounces=BOUNCES,
                          samples_per_wave=WARMUP_SPP)
    flag_r = pt.Renderer(sc, cam, cfg)
    done, dt = _bench_renderer(flag_r, WARMUP_SPP, BENCH_SPP)
    rays_per_s = _live_rays_per_s(flag_r, done, dt)
    hw_ray_ops_per_s = W * H * done * BOUNCES * 2 / dt

    msc, _, md = bench_scenes.sphere_mesh_scene(32, 32, radius=12.0)
    mcfg = rnd.RenderConfig(width=W, height=H, nrays=8, nb_bounces=BOUNCES,
                            samples_per_wave=2, compact_rays=True)
    mr = rnd.Renderer(msc, cam, mcfg)
    mdone, mdt = _bench_renderer(mr, 2, 4)
    mesh_rays_per_s = _live_rays_per_s(mr, mdone, mdt)

    bsc, _, bmd = bench_scenes.sphere_mesh_scene(1100, 1100)
    bcfg = rnd.RenderConfig(width=W, height=H, nrays=8, nb_bounces=BOUNCES,
                            samples_per_wave=1, compact_rays=True)
    br = rnd.Renderer(bsc, cam, bcfg)
    bdone, bdt = _bench_renderer(br, 1, 2)
    big_mesh_rays_per_s = _live_rays_per_s(br, bdone, bdt)

    # forward and forward+backward of a full 64-spp 1080p frame;
    # remat_samples recomputes each sample wave in the backward so the
    # whole frame fits one call
    gcfg = pt.RenderConfig(width=W, height=H, nrays=64, nb_bounces=BOUNCES,
                           remat_samples=True)
    cp = jnp.asarray(rng_host.random_per_pixel_fast(W, H))

    def loss(kd, li):
        img, _ = rnd.render_unsplatted(
            sc.replace(kd=kd, light_intensity=li), cam, cp, gcfg)
        return jnp.mean(img)

    fwd_only = jax.jit(loss)
    fwd_bwd = jax.jit(jax.grad(loss, argnums=(0, 1)))

    def timed_ms(f):
        jax.block_until_ready(f(sc.kd, sc.light_intensity))
        t0 = time.perf_counter()
        jax.block_until_ready(f(sc.kd, sc.light_intensity))
        return (time.perf_counter() - t0) * 1e3

    fwd_frame_ms = timed_ms(fwd_only)
    fwd_bwd_frame_ms = timed_ms(fwd_bwd)

    print(json.dumps({
        "metric": "rays_per_second_per_chip",
        "value": rays_per_s,
        "unit": "live rays/s",
        "device": device.describe(),
        "hardware_ray_ops_per_s": hw_ray_ops_per_s,
        "mesh_scene_rays_per_s": mesh_rays_per_s,
        "mesh_scene_tris": int(md.num_triangles),
        "big_mesh_e2e_rays_per_s": big_mesh_rays_per_s,
        "big_mesh_e2e_tris": int(bmd.num_triangles),
        "fwd_ms_per_frame_1080p64": fwd_frame_ms,
        "fwd_bwd_ms_per_frame_1080p64": fwd_bwd_frame_ms,
    }))


if __name__ == '__main__':
    main()
