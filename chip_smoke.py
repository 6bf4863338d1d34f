#!/usr/bin/env python3
"""Smoke run of the path tracer on one GPU, in one process.

    python chip_smoke.py            # the single-card phases 0-5
    python chip_smoke.py --four     # only the 4-card phase and its
                                    # single-card comparison
    python chip_smoke.py --tiny     # CPU rehearsal at tiny sizes

Phases (each prints one line with its wall time; any failure stops the
run with a non-zero exit):
  0 device    — JAX must report a GPU; prints device_kind, count and the
                card's name and power limit (nvidia-smi);
  1 flagship  — analytic flagship scene, 1920x1080, 64 spp, 3 bounces,
                through Renderer;
  2 big mesh  — closed 2.42M-triangle displaced sphere, 1920x1080, 8 spp,
                3 bounces, compact_rays, through Renderer on the GPU
                kernel tier; then 1 spp of the same render on the XLA
                `bvh` tier (phase 5 times the two per call);
  3 CLI       — cli.main on configs/config1_analytic.json, then on a
                written scene JSON over a ~100k-triangle procedural OBJ;
  4 gradient  — forward and forward+backward at 1080p x 64 spp with
                remat_samples; a finite-difference check of
                d mean / d light_intensity at a small size;
  5 parity    — mesh kernel vs traverse.bvh_hit on the phase-2 rays,
                kernel vs brute force on a 100k-triangle mesh, and images
                vs the sequential CPU reference (tests/reference_cpu.py);
  6 four      — (--four) dp x sp sharded render and train step on 4 cards
                against the single-card results.

The last line of a card run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Device arrays reach every jitted function as arguments (an array a jitted
function closes over is compiled into the program as a constant).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, 'chiprun_out', 'chip_smoke')


class Sizes:
    """Card sizes; --tiny shrinks every one of them for a CPU rehearsal."""

    def __init__(self, tiny: bool):
        self.tiny = tiny
        self.w, self.h = (32, 18) if tiny else (1920, 1080)
        self.flag_spp = 4 if tiny else 64
        self.mesh_spp = 2 if tiny else 8
        self.big_lat = 24 if tiny else 1100       # sphere_mesh(n, n)
        self.cli_lat = 16 if tiny else 224        # ~100k tris on the card
        self.grad_spp = 2 if tiny else 64
        self.brute_rays = 256 if tiny else 65536
        self.brute_lat = 16 if tiny else 224
        self.four_spp = 4


def log(msg):
    print(msg, flush=True)


def peak_bytes():
    import jax
    st = jax.devices()[0].memory_stats() or {}
    return st.get('peak_bytes_in_use', 'not reported')


def phase(n, name):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            extra = fn(*a, **kw) or ''
            log(f'phase {n} {name}: ok  wall {time.perf_counter() - t0:.2f} s'
                f'  {extra}')
        return run
    return deco


# ---------------------------------------------------------------- phases

@phase(0, 'device')
def phase_device(sz):
    import jax
    from pathtracer_tpu.utils import device
    d = device.describe()
    if not sz.tiny:
        device.require_gpu()
    log(f'card: {device.card_line()}')
    return (f"platform={d['platform']} kind={d['kind']} count={d['count']} "
            f"jax={jax.__version__}")


def _timed_render(r, spw):
    """(first wave incl. compile, full render time, live rays/s)."""
    import jax
    t0 = time.perf_counter()
    r.step(spw)
    jax.block_until_ready(r.image)
    first = time.perf_counter() - t0
    r.reset()
    t0 = time.perf_counter()
    r.render()
    dt = time.perf_counter() - t0
    return first, dt, r.stats(dt)['rays_per_second']


def _finite_image(r, shape):
    import numpy as np
    img = np.asarray(r.display())
    assert img.shape == shape, img.shape
    assert np.isfinite(img).all(), 'non-finite pixels'
    assert img.mean() > 0, 'black image'
    return img


@phase(1, 'flagship')
def phase_flagship(sz):
    import pathtracer_tpu as pt
    from pathtracer_tpu.utils import bench_scenes
    sc, cam = bench_scenes.flagship()
    spw = 8 if not sz.tiny else 2
    cfg = pt.RenderConfig(width=sz.w, height=sz.h, nrays=sz.flag_spp,
                          nb_bounces=3, samples_per_wave=spw)
    r = pt.Renderer(sc, cam, cfg)
    first, dt, rps = _timed_render(r, spw)
    _finite_image(r, (sz.h, sz.w, 3))
    return (f'{sz.w}x{sz.h} {sz.flag_spp}spp first-wave(incl compile) '
            f'{first:.2f}s render {dt:.3f}s live {rps / 1e6:.2f} Mrays/s '
            f'peak_bytes {peak_bytes()}')


class BigMesh:
    """The phase-2 scene and its `bvh`-tier mesh, kept for phase 5."""
    sc = cam = md = bvh_mesh = None


@phase(2, 'big mesh')
def phase_big_mesh(sz, big):
    import jax
    import pathtracer_tpu as pt
    from pathtracer_tpu.scene import mesh as mesh_mod
    from pathtracer_tpu.utils import bench_scenes
    t0 = time.perf_counter()
    sc, cam, md = bench_scenes.sphere_mesh_scene(sz.big_lat, sz.big_lat)
    setup = time.perf_counter() - t0
    big.sc, big.cam, big.md = sc, cam, md
    mesh = sc.meshes[0]
    tier = mesh.tier
    if jax.devices()[0].platform == 'gpu':
        assert tier == 'kernel', f'GPU mesh tier is {tier!r}'
    cfg = pt.RenderConfig(width=sz.w, height=sz.h, nrays=sz.mesh_spp,
                          nb_bounces=3, samples_per_wave=1,
                          compact_rays=True)
    r = pt.Renderer(sc, cam, cfg)
    first, dt, rps = _timed_render(r, 1)
    _finite_image(r, (sz.h, sz.w, 3))
    line = (f'tris={mesh.num_triangles} tier={tier} build+upload '
            f'{setup:.1f}s {sz.w}x{sz.h} {sz.mesh_spp}spp first-wave(incl '
            f'compile) {first:.2f}s render {dt:.3f}s = '
            f'{dt / sz.mesh_spp * 1e3:.1f} ms/spp live {rps / 1e6:.2f} '
            f'Mrays/s peak_bytes {peak_bytes()}')
    # the same render, 1 spp, on the XLA lockstep traversal tier
    t0 = time.perf_counter()
    big.bvh_mesh = mesh_mod.upload_mesh(md, obj_row=mesh.obj_row, tier='bvh')
    setup_b = time.perf_counter() - t0
    rb = pt.Renderer(sc.replace(meshes=(big.bvh_mesh,)), cam,
                     cfg._replace(nrays=1))
    first_b, dt_b, rps_b = _timed_render(rb, 1)
    _finite_image(rb, (sz.h, sz.w, 3))
    return (line + f'; tier=bvh upload {setup_b:.1f}s 1spp first-wave(incl '
            f'compile) {first_b:.2f}s render {dt_b * 1e3:.1f} ms/spp live '
            f'{rps_b / 1e6:.2f} Mrays/s')


def _write_obj(path, md):
    import numpy as np
    with open(path, 'w') as f:
        f.write('# procedural displaced sphere (utils/procgen.sphere_mesh)\n')
        np.savetxt(f, md.vertices, fmt='v %.6f %.6f %.6f')
        np.savetxt(f, md.vtx_idx + 1, fmt='f %d %d %d')


@phase(3, 'cli')
def phase_cli(sz):
    from pathtracer_tpu import cli
    from pathtracer_tpu.utils import procgen
    os.makedirs(OUT_DIR, exist_ok=True)
    size = f'{sz.w}x{sz.h}'
    out1 = os.path.join(OUT_DIR, 'config1.png')
    rc = cli.main([os.path.join(HERE, 'configs', 'config1_analytic.json'),
                   out1, '--size', size, '--spp', '4'])
    assert rc == 0 and os.path.getsize(out1) > 0, rc
    md = procgen.sphere_mesh(sz.cli_lat, sz.cli_lat, radius=1.0,
                             displace_amp=0.25, seed=7)
    obj = os.path.join(OUT_DIR, 'sphere.obj')
    _write_obj(obj, md)
    # config 1's light, dome and ground with the OBJ in place of its
    # spheres
    with open(os.path.join(HERE, 'configs', 'config1_analytic.json')) as f:
        scene = json.load(f)
    keep = scene['objects'][:2] + [o for o in scene['objects'][2:]
                                   if o['type'] == 'plane']
    mesh_obj = dict(keep[-1])
    for k in ('point', 'normal', 'center', 'radius'):
        mesh_obj.pop(k, None)
    mesh_obj.update(type='mesh', mesh_path='sphere.obj', mesh_scaling=24.0,
                    mesh_offset=[0.0, -15.0, 0.0], flip_normals=False,
                    kd=[0.6, 0.4, 0.3], translation=[0.0, 0.0, 0.0],
                    rotation=None, rotation_center=[0.0, -15.0, 0.0])
    scene['objects'] = keep + [mesh_obj]
    scene['render'].update(width=sz.w, height=sz.h, nrays=4)
    sp = os.path.join(OUT_DIR, 'mesh_scene.json')
    with open(sp, 'w') as f:
        json.dump(scene, f)
    out2 = os.path.join(OUT_DIR, 'mesh_scene.png')
    rc = cli.main([sp, out2])
    assert rc == 0 and os.path.getsize(out2) > 0, rc
    return f'config1 -> {out1}; {md.num_triangles}-tri OBJ scene -> {out2}'


@phase(4, 'gradient')
def phase_gradient(sz):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import pathtracer_tpu as pt
    from pathtracer_tpu.core import rng_host
    from pathtracer_tpu.render import renderer as rnd
    from pathtracer_tpu.utils import bench_scenes
    sc, cam = bench_scenes.flagship()

    def make_loss(w, h, spp):
        cfg = pt.RenderConfig(width=w, height=h, nrays=spp, nb_bounces=3,
                              remat_samples=True)

        def loss(kd, li, sc, cam, cp):
            img, _ = rnd.render_unsplatted(
                sc.replace(kd=kd, light_intensity=li), cam, cp, cfg)
            return jnp.mean(img)
        return loss

    def pixels(w, h):
        return jnp.asarray(rng_host.random_per_pixel_fast(w, h))

    loss = make_loss(sz.w, sz.h, sz.grad_spp)
    fwd = jax.jit(loss)
    fwd_bwd = jax.jit(jax.grad(loss, argnums=(0, 1)))
    args = (sc.kd, sc.light_intensity, sc, cam, pixels(sz.w, sz.h))
    times = {}
    for name, f in (('fwd', fwd), ('fwd_bwd', fwd_bwd)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args))
        times[name] = (first, time.perf_counter() - t0)
    g_kd, g_li = (np.asarray(x) for x in out)
    assert np.isfinite(g_kd).all() and np.isfinite(g_li).all()
    # finite difference on the light intensity at a small size; the
    # estimator is linear in it, so a central difference is exact up to
    # float32 rounding
    small = jax.jit(make_loss(48, 32, 4))
    rest = (sc, cam, pixels(48, 32))
    li = float(sc.light_intensity)
    eps = 1e-2 * li
    fd = (float(small(sc.kd, jnp.float32(li + eps), *rest))
          - float(small(sc.kd, jnp.float32(li - eps), *rest))) / (2 * eps)
    ad = float(jax.jit(jax.grad(make_loss(48, 32, 4), argnums=1))(
        sc.kd, jnp.float32(li), *rest))
    rel = abs(fd - ad) / max(abs(ad), 1e-30)
    assert rel < 1e-2, (fd, ad)
    return (f"1080p-class {sz.w}x{sz.h} {sz.grad_spp}spp fwd first "
            f"{times['fwd'][0]:.2f}s steady {times['fwd'][1] * 1e3:.1f}ms; "
            f"fwd+bwd first {times['fwd_bwd'][0]:.2f}s steady "
            f"{times['fwd_bwd'][1] * 1e3:.1f}ms; d/dlight fd {fd:.6g} "
            f"ad {ad:.6g} rel {rel:.2e}; peak_bytes {peak_bytes()}")


# ---------------------------------------------------------------- parity

def _hit_parity(t_ref, tri_ref, t_new, tri_new):
    """(fraction of lanes whose winner differs, worst |dt|/t over lanes
    where both hit the same triangle)."""
    import numpy as np
    t_ref, t_new = np.asarray(t_ref), np.asarray(t_new)
    tri_ref, tri_new = np.asarray(tri_ref), np.asarray(tri_new)
    same = tri_ref == tri_new
    both = same & (tri_ref >= 0)
    dt = (np.abs(t_ref[both] - t_new[both])
          / np.maximum(np.abs(t_ref[both]), 1e-30))
    return 1.0 - same.mean(), float(dt.max()) if dt.size else 0.0


def _bounce_rays(org, d, t, tri, soup, seed=0):
    """First-bounce diffuse rays from camera-ray hits, octant-sorted."""
    import jax
    import jax.numpy as jnp
    hit = tri >= 0
    i = jnp.maximum(tri, 0)
    nrm = jnp.stack([soup.nx[i], soup.ny[i], soup.nz[i]], -1)
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = jnp.where(jnp.sum(nrm * d, -1, keepdims=True) > 0, -nrm, nrm)
    rd = jax.random.normal(jax.random.PRNGKey(seed), d.shape)
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    rd = jnp.where(jnp.sum(rd * nrm, -1, keepdims=True) < 0, -rd, rd)
    p = org + jnp.where(hit, t, 0.0)[:, None] * d
    o2 = jnp.where(hit[:, None], p + 1e-3 * nrm, org)
    d2 = jnp.where(hit[:, None], rd, d)
    octant = ((d2[:, 0] > 0) * 4 + (d2[:, 1] > 0) * 2 + (d2[:, 2] > 0))
    perm = jnp.argsort(octant, stable=True)
    return o2[perm], d2[perm]


def _time(f, *a):
    import jax
    jax.block_until_ready(f(*a))
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*a))
    return out, (time.perf_counter() - t0) * 1e3


def _camera_rays(sc, cam, w, h):
    import numpy as np
    import jax.numpy as jnp
    from pathtracer_tpu.core import camera as cam_mod
    from pathtracer_tpu.scene import scene as scn
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    pi = jnp.asarray(ii.reshape(-1), jnp.int32)
    pj = jnp.asarray(jj.reshape(-1), jnp.int32)
    z = jnp.zeros(pi.shape, jnp.float32)
    org, d = cam_mod.generate_rays(cam, pi, pj, z, z, z, z, w, h)
    return scn._local_ray_row(sc, sc.meshes[0].obj_row, org, d)


def _kernel_fn(mesh, any_hit=False):
    """kernel_hit over the mesh's packed arrays, jitted with the arrays as
    arguments: (org, dirn, t_max) -> (t, tri)."""
    import jax
    from pathtracer_tpu.ops import bvh_kernel
    f = jax.jit(functools.partial(
        bvh_kernel.kernel_hit, max_leaf=mesh.max_leaf, depth=mesh.bvh_depth,
        any_hit=any_hit, interpret=mesh.kernel_interpret))
    return lambda o, d, lim=None: f(mesh.kroot, mesh.knodes, mesh.ktris,
                                    o, d, lim)


def _kernel_mesh(md, mesh):
    """The kernel-tier mesh: `mesh` itself on the card; on the CPU
    rehearsal the same mesh re-uploaded for the kernel in interpret mode."""
    from pathtracer_tpu.scene import mesh as mesh_mod
    if mesh.tier == 'kernel':
        return mesh
    return mesh_mod.upload_mesh(md, obj_row=mesh.obj_row, tier='kernel',
                                kernel_interpret=True)


def _same_triangles(kmesh, soup):
    """The kernel's triangle rows and an XLA tier's soup hold the same
    triangles in the same (BVH) order, so triangle ids compare."""
    import jax.numpy as jnp
    assert int(jnp.sum(kmesh.ktris != jnp.stack(list(soup), 1))) == 0


def parity_kernel_vs_bvh(sz, big):
    """Kernel vs traverse.bvh_hit on the phase-2 mesh: camera rays and
    first-bounce rays at full width, closest and any hit; per-call
    times of both."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pathtracer_tpu.ops import traverse
    mesh = _kernel_mesh(big.md, big.sc.meshes[0])
    bm = big.bvh_mesh
    _same_triangles(mesh, bm.soup)
    kc, ka = _kernel_fn(mesh), _kernel_fn(mesh, any_hit=True)
    xb_full = jax.jit(traverse.bvh_hit, static_argnames=('max_leaf',))

    def xb(o, d):
        mh = xb_full(bm.bvh, bm.soup, o, d, max_leaf=bm.max_leaf)
        return mh.t, mh.tri
    org, d = _camera_rays(big.sc, big.cam, sz.w, sz.h)
    lines = []
    rays = {'camera': (org, d)}
    t_k, tri_k = kc(org, d)
    rays['bounce'] = _bounce_rays(org, d, t_k, tri_k, bm.soup)
    for name, (o, dd) in rays.items():
        (t_k, tri_k), ms_k = _time(kc, o, dd)
        (t_b, tri_b), ms_b = _time(xb, o, dd)
        diff, dt = _hit_parity(t_b, tri_b, t_k, tri_k)
        lim = jnp.full((o.shape[0],), 20.0, jnp.float32)
        (_, tri_a), ms_a = _time(ka, o, dd, lim)
        occ_diff = float(np.mean((np.asarray(tri_a) >= 0)
                                 != (np.asarray(t_b) < 20.0)))
        assert diff <= 1e-4 and dt <= 1e-5 and occ_diff <= 1e-4, \
            (name, diff, dt, occ_diff)
        lines.append(f'{name}: kernel {ms_k:.2f}ms bvh_hit {ms_b:.2f}ms '
                     f'any-hit {ms_a:.2f}ms; tri differ {diff:.2e} '
                     f'max|dt|/t {dt:.1e} occlusion differ {occ_diff:.2e}')
    return (f'{mesh.num_triangles} tris, {org.shape[0]} rays: '
            + '; '.join(lines))


def parity_kernel_vs_brute(sz):
    """Kernel vs brute_force_hit / brute_force_any on the card: ~100k
    triangles, 65,536 random rays from a box around the mesh."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pathtracer_tpu.ops import traverse
    from pathtracer_tpu.scene import mesh as mesh_mod
    from pathtracer_tpu.utils import procgen
    md = procgen.sphere_mesh(sz.brute_lat, sz.brute_lat, radius=10.0,
                             displace_amp=0.3, seed=3)
    soup = mesh_mod.upload_mesh(md, obj_row=2, tier='brute').soup
    on_gpu = jax.devices()[0].platform == 'gpu'
    mesh = mesh_mod.upload_mesh(md, obj_row=2, tier='kernel',
                                kernel_interpret=not on_gpu)
    _same_triangles(mesh, soup)
    rng = np.random.default_rng(5)
    n = sz.brute_rays
    org = jnp.asarray(rng.uniform(-14, 14, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    lim = jnp.asarray(rng.uniform(1, 30, n), jnp.float32)
    (t_k, tri_k), ms_k = _time(_kernel_fn(mesh), org, d)
    (_, tri_a), ms_a = _time(_kernel_fn(mesh, any_hit=True), org, d, lim)
    ref, ms_b = _time(jax.jit(traverse.brute_force_hit), soup, org, d)
    occ_b, ms_ba = _time(jax.jit(traverse.brute_force_any), soup, org, d,
                         lim)
    diff, dt = _hit_parity(ref.t, ref.tri, t_k, tri_k)
    occ_diff = float(np.mean((np.asarray(tri_a) >= 0) != np.asarray(occ_b)))
    assert diff <= 1e-4 and dt <= 1e-5 and occ_diff <= 1e-4, \
        (diff, dt, occ_diff)
    return (f'{mesh.num_triangles} tris x {n} random rays: kernel '
            f'{ms_k:.2f}ms brute {ms_b:.2f}ms, any-hit kernel {ms_a:.2f}ms '
            f'brute {ms_ba:.2f}ms; tri differ {diff:.2e} max|dt|/t '
            f'{dt:.1e} occlusion differ {occ_diff:.2e}')


def _per_sample(smp, smp_cpu, flip_budget=0.05):
    import numpy as np
    smp = np.asarray(smp)
    scale = max(np.abs(smp_cpu).max(), 1e-6)
    rel = np.abs(smp - smp_cpu).max(-1) / scale
    flipped = rel > 1e-3
    tight = float(rel[~flipped].max()) if (~flipped).any() else 0.0
    mean_rel = abs(smp.mean() - smp_cpu.mean()) / scale
    ok = flipped.mean() < flip_budget and tight < 1e-3 and mean_rel < 0.02
    return ok, float(flipped.mean()), tight, float(mean_rel)


def parity_images():
    """Per-sample image parity against tests/reference_cpu.py (the
    criterion of tests/test_integrator_vs_cpu.py): fewer than 5% of
    samples flipped (8% with fog, as in tests/test_fog.py), the rest
    within 1e-3 of the image scale, the means within 2%."""
    import numpy as np
    import jax.numpy as jnp
    import pathtracer_tpu as pt
    from pathtracer_tpu.core import rng_host
    from pathtracer_tpu.render import renderer as rnd
    from pathtracer_tpu.scene import scene as scn
    from pathtracer_tpu.utils import procgen
    import reference_cpu as ref

    W, H, SPP, B = 16, 12, 4, 3
    li = scn.default_light_intensity()
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cpu_cam = dict(position=np.array([0, 0, 50], np.float32),
                   direction=np.array([0, 0, -1], np.float32),
                   up=np.array([0, 1, 0], np.float32),
                   fov=35 * math.pi / 180, focus=50.0, aperture=0.1)
    base = [
        ref.Obj('sphere', center=(10, 23, 15), radius=10.0),
        ref.Obj('sphere', center=(0, 0, 0), radius=1e6, flip_normals=True),
        ref.Obj('plane', point=(0, 0, 0), normal=(0, 1, 0),
                translation=(0, -27.3, 0)),
    ]
    md = procgen.sphere_mesh(10, 10, radius=9.0, displace_amp=0.2, seed=1)
    cases = {
        'analytic': ([scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                                 ks=(0.1, 0.1, 0.1), ne=(30.0, 30.0, 30.0))],
                     [ref.Obj('sphere', center=(0, -17, 0), radius=10.0,
                              kd=(0.7, 0.3, 0.2), ks=(0.1, 0.1, 0.1),
                              ne=(30, 30, 30))], None, 0.05),
        'mesh': ([scn.mesh_object(md, translation=(0.0, -17.0, 0.0),
                                  interp_normals=False, kd=(0.6, 0.5, 0.3))],
                 [ref.Obj('mesh', tri_verts=md.vertices[md.vtx_idx],
                          translation=(0, -17, 0), kd=(0.6, 0.5, 0.3))],
                 None, 0.05),
        'fog': ([scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2))],
                [ref.Obj('sphere', center=(0, -17, 0), radius=10.0,
                         kd=(0.7, 0.3, 0.2))],
                {'density': 0.4, 'absorption': 0.4, 'type': 0,
                 'phase_type': 0}, 0.08),
        'subsurface': ([scn.sphere((0.0, -17.0, 0.0), 10.0,
                                   kd=(0.5, 0.4, 0.3), ksub=(0.6, 0.4, 0.3))],
                       [ref.Obj('sphere', center=(0, -17, 0), radius=10.0,
                                kd=(0.5, 0.4, 0.3), ksub=(0.6, 0.4, 0.3))],
                       None, 0.05),
    }
    cp = rng_host.random_per_pixel_fast(W, H)
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=B)
    out = []
    for name, (objs, cpu_objs, fog, budget) in cases.items():
        sc = scn.build_scene(scn.default_objects() + objs, li, fog=fog)
        _, smp = rnd.render_unsplatted(sc, cam, jnp.asarray(cp), cfg)
        cpu = ref.CPUScene(base + cpu_objs, li, fog=fog)
        smp_cpu = ref.render_cpu(cpu, cpu_cam, W, H, SPP, B, cp)
        ok, flip, tight, mean_rel = _per_sample(smp, smp_cpu, budget)
        out.append(f'{name}: flipped {flip:.4f} tight-max {tight:.1e} '
                   f'mean {mean_rel:.4f}')
        assert ok, out[-1]
    return '; '.join(out)


@phase(5, 'parity')
def phase_parity(sz, big):
    parts = [parity_kernel_vs_bvh(sz, big), parity_kernel_vs_brute(sz),
             parity_images()]
    for p in parts:
        log(f'  parity {p}')
    return ''


# ---------------------------------------------------------------- four

@phase(6, 'four cards')
def phase_four(sz):
    """dp x sp sharded render (flagship and the 2.42M-tri mesh, 1080p,
    2 bounces) and one train step on all four cards against the
    single-card results."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import pathtracer_tpu as pt
    from pathtracer_tpu.core import rng_host
    from pathtracer_tpu.parallel import sharding
    from pathtracer_tpu.render import film as film_mod
    from pathtracer_tpu.utils import bench_scenes
    devs = jax.devices()
    assert len(devs) == 4, f'--four needs 4 devices, found {len(devs)}'
    mesh4 = sharding.make_mesh(4, dp=2, sp=2)
    assert set(d.id for d in mesh4.devices.flat) == set(d.id for d in devs)
    mesh1 = sharding.make_mesh(1, dp=1, sp=1)
    w, h, spp = sz.w, sz.h, sz.four_spp
    cp = jnp.asarray(rng_host.random_per_pixel_fast(w, h))
    lines = []
    scenes = {'flagship': bench_scenes.flagship()}
    bsc, bcam, _ = bench_scenes.sphere_mesh_scene(sz.big_lat, sz.big_lat)
    scenes['mesh'] = (bsc, bcam)
    for name, (sc, cam) in scenes.items():
        cfg = pt.RenderConfig(width=w, height=h, nrays=spp, nb_bounces=2)
        film = film_mod.make_film(w, h, cfg.sigma_filter)
        times = {}
        imgs = {}
        for label, m in (('1card', mesh1), ('4card', mesh4)):
            f = sharding.make_sharded_render(m, cfg, film.ratio)
            t0 = time.perf_counter()
            jax.block_until_ready(f(sc, cam, cp))
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            img, cnt = jax.block_until_ready(f(sc, cam, cp))
            times[label] = (first, time.perf_counter() - t0)
            imgs[label] = np.asarray(img) / np.maximum(
                np.asarray(cnt), 1e-9)[..., None]
        a, b = imgs['1card'], imgs['4card']
        assert np.isfinite(b).all()
        scale = max(np.abs(a).max(), 1e-6)
        rel = np.abs(a - b).max(-1) / scale
        flip = float((rel > 1e-3).mean())
        mean_rel = float(abs(a.mean() - b.mean()) / scale)
        assert flip < 0.05 and mean_rel < 0.02, (name, flip, mean_rel)
        lines.append(
            f"{name} {w}x{h} {spp}spp: 1 card {times['1card'][1]:.3f}s, "
            f"4 cards {times['4card'][1]:.3f}s (first incl compile "
            f"{times['4card'][0]:.1f}s); pixels differing >1e-3 {flip:.4f}"
            f", mean rel {mean_rel:.2e}")
    # one train step: gradients on 4 cards vs 1 card
    sc, cam = scenes['flagship']
    tw, th = (w // 4, h // 4) if not sz.tiny else (w, h)
    cfg = pt.RenderConfig(width=tw, height=th, nrays=4, nb_bounces=2)
    film = film_mod.make_film(tw, th, cfg.sigma_filter)
    cpt = jnp.asarray(rng_host.random_per_pixel_fast(tw, th))
    params = {'kd': sc.kd, 'ks': sc.ks, 'light_intensity': sc.light_intensity}
    target = jnp.zeros((th, tw, 3), jnp.float32)
    res = {}
    for label, m in (('1card', mesh1), ('4card', mesh4)):
        step = sharding.make_train_step(m, cfg, film.ratio, lr=1.0)
        loss, new = step(params, sc, cam, cpt, target)
        res[label] = (float(loss), jax.tree.map(
            lambda p, q: np.asarray(p) - np.asarray(q), params, new))
    l1, g1 = res['1card']
    l4, g4 = res['4card']
    worst = max(float(np.max(np.abs(g4[k] - g1[k]))
                      / max(float(np.max(np.abs(g1[k]))), 1e-30))
                for k in g1)
    assert np.isfinite(l4) and abs(l4 - l1) <= 1e-3 * abs(l1) + 1e-12, \
        (l1, l4)
    assert worst < 1e-2, worst
    lines.append(f'train step {tw}x{th}: loss 1 card {l1:.6g} 4 cards '
                 f'{l4:.6g}; worst gradient rel diff {worst:.2e}')
    for ln in lines:
        log(f'  four {ln}')
    return ''


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the 4-card phase and its comparison')
    ap.add_argument('--tiny', action='store_true',
                    help='CPU rehearsal at tiny sizes (prints no result)')
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, 'pathtracer_tpu')):
        print('chip_smoke.py: the pathtracer_tpu package is not next to '
              'this script', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, 'tests'))   # reference_cpu

    import jax
    if jax.devices()[0].platform != 'gpu' and not args.tiny:
        print(f'chip_smoke.py: no GPU (JAX platform '
              f'{jax.devices()[0].platform!r})', file=sys.stderr)
        return 1
    from pathtracer_tpu.utils import compile_cache, device
    compile_cache.enable()
    sz = Sizes(args.tiny)
    try:
        phase_device(sz)
        if args.four:
            phase_four(sz)
        else:
            big = BigMesh()
            phase_flagship(sz)
            phase_big_mesh(sz, big)
            phase_cli(sz)
            phase_gradient(sz)
            phase_parity(sz, big)
    except Exception:
        traceback.print_exc()
        print('chip_smoke.py: a phase failed', file=sys.stderr)
        return 1
    if args.tiny:
        log('rehearsal ok (no result: not a card run)')
        return 0
    log(json.dumps({'ok': True, 'device': device.describe()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
