"""Top-level renderer: sample scheduling, camera draws, waves, film.

JAX counterpart of render_image / render_image_nopreviz
(reference: Raytracer.cpp:1424-1563, 1565-1797).  The reference's
OpenMP-dynamic loops over rows / 4x4 batches become *waves*: all W*H pixels
x chunk-of-samples rendered as one jitted SoA wavefront, host-looped over
sample chunks (the progressive schedule), film accumulated on device.

RNG keying: path (pixel p, sample k) owns PCG32 stream key
  key64 = (seed << 32) | (p * nspp + k)
seeded as pcg32(key, key) — the wavefront replacement for the reference's 64
thread-local engines (Raytracer.cpp:1325-1327; SURVEY §2.7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core import camera as cam_mod
from ..core import qmc
from ..core import rng as prng
from ..core import rng_host
from ..scene import scene as scn
from . import film as film_mod
from . import integrator


class RenderConfig(NamedTuple):
    width: int = 1000           # reference defaults (Raytracer.cpp:1246-1255)
    height: int = 800
    nrays: int = 100            # samples per pixel
    nb_bounces: int = 3
    sigma_filter: float = 0.5
    gamma: float = 2.2
    seed: int = 0
    samples_per_wave: int = 4   # spp chunk traced per jit call
    double_frustum_start_t: float = 0.0
    has_denoiser: bool = False  # accumulate unsplatted aux for denoising
    tile_size: int = -1         # >0: trace rays in tile-major order (a
                                # kernel block traces neighbouring pixels);
                                # 0: row-major; -1 AUTO: 32 when the scene
                                # holds meshes/pointsets/yarns
    sort_rays: bool = False     # re-sort the wavefront by direction octant
                                # between bounces (secondary-ray coherence)
    compact_rays: bool = False  # stream compaction: skip all-dead lane
                                # segments after each bounce (implies the
                                # octant sort; SURVEY §2.7 wavefront queue)
    remat_samples: bool = False  # jax.checkpoint the per-sample scan body
                                # in render_unsplatted: the backward pass
                                # recomputes each sample wave instead of
                                # holding every iterate live — a FULL
                                # 1080p x 64spp fwd+bwd fits one call



def _near_divisor(n: int, ts: int) -> int:
    """The divisor of n closest to ts (searching up to 2*ts) — keeps the
    tile walk a pure reshape/transpose (no gather) at ANY resolution,
    e.g. 1080 -> 30, 1920 -> 32."""
    best = 1
    for d in range(1, min(n, ts * 2) + 1):
        if n % d == 0 and abs(d - ts) < abs(best - ts):
            best = d
    return best


def _pixel_order(w, h, tile_size):
    """Pixel index arrays + an untile fn mapping lane order -> row-major.

    tile_size=0: row-major (identity).  Otherwise tile-major: lanes walk
    ~ts x ~ts pixel tiles (per-dimension nearest divisors) — neighbouring
    lanes trace neighbouring pixels, so a block of the mesh traversal
    kernel walks similar BVH paths.
    """
    ii, jj = jnp.meshgrid(jnp.arange(h, dtype=jnp.int32),
                          jnp.arange(w, dtype=jnp.int32), indexing='ij')
    if tile_size > 0:
        tsh = _near_divisor(h, tile_size)
        tsw = _near_divisor(w, tile_size)
        if tsh > 1 or tsw > 1:
            ht, wt = h // tsh, w // tsw

            def tile(a):
                return (a.reshape(ht, tsh, wt, tsw)
                        .transpose(0, 2, 1, 3).reshape(-1))

            def untile(x):
                lead = x.shape[1:]
                return (x.reshape(ht, wt, tsh, tsw, *lead)
                        .transpose(0, 2, 1, 3,
                                   *(4 + i for i in range(len(lead))))
                        .reshape(h * w, *lead))

            return tile(ii), tile(jj), untile
    return ii.reshape(-1), jj.reshape(-1), (lambda x: x)


def _background_pixels(sc, pix_i, pix_j, w, h):
    """Per-pixel photo color (reference: Raytracer.cpp:260-266 index math)."""
    if sc.background is None:
        return None
    bgh, bgw = sc.background.shape[0], sc.background.shape[1]
    bi = jnp.clip((pix_i.astype(jnp.float32) / h * bgh).astype(jnp.int32),
                  0, bgh - 1)
    bj = jnp.clip((pix_j.astype(jnp.float32) / w * bgw).astype(jnp.int32),
                  0, bgw - 1)
    return sc.background[bi, bj]


def _wave(sc: scn.SceneArrays, cam: cam_mod.Camera, cp_table, cfg: RenderConfig,
          image, sample_count, film_spec_ratio, sample_ids, aux=None):
    """Render one wave: all pixels x len(sample_ids) samples. Jitted.

    With cfg.has_denoiser, `aux` carries (color, albedo, normal) unsplatted
    accumulators (the OIDN feed, Raytracer.cpp:1631-1645)."""
    w, h = cfg.width, cfg.height
    nspp = cfg.nrays
    film_spec = film_mod.FilmSpec(w, h, cfg.sigma_filter,
                                  int(np.ceil(cfg.sigma_filter * 2)),
                                  film_spec_ratio)

    ts = cfg.tile_size
    if ts < 0:   # AUTO: packet coherence matters iff tiered sweeps run
        ts = 32 if (sc.meshes or sc.pointsets or sc.yarns) else 0
    pix_i, pix_j, untile = _pixel_order(w, h, ts)
    pix_flat = pix_i * w + pix_j
    bg_pixel = _background_pixels(sc, pix_i, pix_j, w, h)

    def per_sample(carry, k):
        image, sample_count, aux, rays, ss_ov = carry
        # --- per-path PCG streams ---
        key_lo = (pix_flat.astype(jnp.uint32) * jnp.uint32(nspp)
                  + k.astype(jnp.uint32))
        key_hi = jnp.full_like(key_lo, jnp.uint32(cfg.seed))
        rng_state = prng.make_stream(key_hi, key_lo)

        # --- camera draws (canonical order: dx, dy, dxa, dya) ---
        u_dx, rng_state = prng.next_uniform(rng_state)
        u_dy, rng_state = prng.next_uniform(rng_state)
        u_ax, rng_state = prng.next_uniform(rng_state)
        u_ay, rng_state = prng.next_uniform(rng_state)
        dx = u_dx - 0.5
        dy = u_dy - 0.5
        dxa = (u_ax - 0.5) * cam.aperture
        dya = (u_ay - 0.5) * cam.aperture

        org, dirn = cam_mod.generate_rays(
            cam, pix_i, pix_j, dx, dy, dxa, dya, w, h,
            init_t=cfg.double_frustum_start_t)

        # --- indirect-bounce QMC sample: CP rotation of the lattice point ---
        lattice = qmc.extensible_lattice_2d(k.astype(jnp.uint32))
        cp_r12 = qmc.cranley_patterson(lattice[None, :], cp_table)

        color, naux, aaux, live, ss_over = integrator.trace_paths(
            sc, org, dirn, rng_state, cp_r12, cfg.nb_bounces,
            bg_pixel=bg_pixel, sort_rays=cfg.sort_rays or cfg.compact_rays,
            compact_rays=cfg.compact_rays, return_stats=True)

        color_rm = untile(color)
        image, sample_count = film_mod.splat(
            film_spec, image, sample_count, color_rm, untile(dx), untile(dy))
        if cfg.has_denoiser:
            aux = (aux[0] + color_rm.reshape(h, w, 3),
                   aux[1] + untile(aaux).reshape(h, w, 3),
                   aux[2] + untile(naux).reshape(h, w, 3))
        # honest ray accounting: one closest-hit + one NEE shadow sweep per
        # LIVE lane per bounce (dead lanes cost ~nothing under compaction);
        # int32 is safe per wave (host accumulates across waves in Python)
        rays = rays + 2 * jnp.sum(live)
        return (image, sample_count, aux, rays, ss_ov + ss_over), None

    if aux is None:
        aux = (jnp.zeros((h, w, 3)),) * 3
    (image, sample_count, aux, rays, ss_ov), _ = jax.lax.scan(
        per_sample, (image, sample_count, aux, jnp.int32(0), jnp.int32(0)),
        sample_ids)
    return image, sample_count, aux, rays, ss_ov


_wave_jit = jax.jit(_wave, static_argnames=('cfg',))


@functools.partial(jax.jit, static_argnames=('cfg',))
def render_unsplatted(sc: scn.SceneArrays, cam: cam_mod.Camera, cp_table,
                      cfg: RenderConfig):
    """Per-pixel mean radiance over all cfg.nrays samples, no pixel filter.

    Debug/test entry point: isolates the integrator from the film so images
    can be compared 1:1 against the sequential CPU reference tracer.
    """
    w, h = cfg.width, cfg.height
    nspp = cfg.nrays
    ii, jj = jnp.meshgrid(jnp.arange(h, dtype=jnp.int32),
                          jnp.arange(w, dtype=jnp.int32), indexing='ij')
    pix_i = ii.reshape(-1)
    pix_j = jj.reshape(-1)
    pix_flat = pix_i * w + pix_j
    bg_pixel = _background_pixels(sc, pix_i, pix_j, w, h)

    def per_sample(acc, k):
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
        cp_r12 = qmc.cranley_patterson(lattice[None, :], cp_table)
        color, _, _ = integrator.trace_paths(
            sc, org, dirn, rng_state, cp_r12, cfg.nb_bounces,
            bg_pixel=bg_pixel, sort_rays=cfg.sort_rays or cfg.compact_rays,
            compact_rays=cfg.compact_rays)
        return acc + color, color

    body = jax.checkpoint(per_sample) if cfg.remat_samples else per_sample
    acc, samples = jax.lax.scan(body, jnp.zeros((h * w, 3), jnp.float32),
                                jnp.arange(nspp, dtype=jnp.int32))
    # samples: (nspp, N, 3) -> (h, w, nspp, 3)
    samples = jnp.moveaxis(samples, 0, 1).reshape(h, w, nspp, 3)
    return (acc / nspp).reshape(h, w, 3), samples


class Renderer:
    """Stateful host-side orchestrator (the reference Raytracer class role).

    Holds the film accumulators and per-pixel CP table; `render()` is the
    offline path (render_image_nopreviz), `step()` exposes the progressive
    schedule (render_image's realtime_ray_iter loop) for interactive use.
    """

    def __init__(self, sc: scn.SceneArrays, cam: cam_mod.Camera,
                 cfg: RenderConfig):
        self.scene = sc
        self.cam = cam
        self.cfg = cfg
        self.film = film_mod.make_film(cfg.width, cfg.height, cfg.sigma_filter)
        # per-pixel CP shifts, exactly the reference's engine[0] fill
        # (Raytracer.cpp:1340-1344)
        self.cp_table = jnp.asarray(
            rng_host.random_per_pixel_fast(cfg.width, cfg.height))
        self.reset()

    def reset(self):
        self.image, self.sample_count = film_mod.alloc(self.film)
        h, w = self.cfg.height, self.cfg.width
        self.aux = tuple(jnp.zeros((h, w, 3), jnp.float32) for _ in range(3))
        self.samples_done = 0
        self.rays_traced = 0    # live-lane ray ops (hit + shadow sweeps)
        # subsurface reservoir-march slot overflows (biased probe misses
        # if ever common — scene._mesh_reservoir_march docstring)
        self.ss_overflow = 0

    def step(self, nsamples: Optional[int] = None):
        """Trace the next `nsamples` samples per pixel (default: one wave)."""
        nsamples = nsamples or self.cfg.samples_per_wave
        k0 = self.samples_done
        ks = jnp.arange(k0, k0 + nsamples, dtype=jnp.int32)
        self.image, self.sample_count, self.aux, rays, ss_ov = _wave_jit(
            self.scene, self.cam, self.cp_table, self.cfg,
            self.image, self.sample_count, self.film.ratio, ks, self.aux)
        self.samples_done += nsamples
        # device-scalar accumulate: no host sync until stats()/checkpoint
        self.rays_traced = self.rays_traced + rays
        self.ss_overflow = self.ss_overflow + ss_ov
        return self

    def render(self):
        """Full offline render: all nrays samples."""
        while self.samples_done < self.cfg.nrays:
            n = min(self.cfg.samples_per_wave,
                    self.cfg.nrays - self.samples_done)
            self.step(n)
        jax.block_until_ready(self.image)
        return self

    def render_resumable(self, path: str, guard=None,
                         save_every: Optional[int] = None):
        """Preemption-safe render: resume `path` if present, checkpoint on
        preemption (and every `save_every` samples), delete the checkpoint
        on completion.

        `guard` is a parallel.distributed.PreemptionGuard (or anything
        with a `requested` flag); when it trips, the in-flight wave
        finishes, the state is saved, and the loop returns early with
        `samples_done < cfg.nrays`.  Re-running the same call later picks
        up exactly where it left off — waves are keyed by absolute sample
        index, so the resumed image is bit-identical to an uninterrupted
        render (test_checkpoint.py).  SURVEY §5 failure recovery; the
        reference has no analogue (a killed render loses everything).
        """
        import os as _os
        assert path.endswith('.npz'), 'np.savez appends .npz; pass it'
        if _os.path.exists(path):
            self.load_checkpoint(path)
        last_saved = self.samples_done
        while self.samples_done < self.cfg.nrays:
            n = min(self.cfg.samples_per_wave,
                    self.cfg.nrays - self.samples_done)
            self.step(n)
            preempted = guard is not None and guard.requested
            if preempted or (save_every is not None
                             and self.samples_done - last_saved
                             >= save_every):
                jax.block_until_ready(self.image)
                self.save_checkpoint(path)
                last_saved = self.samples_done
                if preempted:
                    return self
        jax.block_until_ready(self.image)
        if _os.path.exists(path):
            _os.remove(path)
        return self

    def hdr(self):
        """Accumulated HDR image (pre-tonemap), divided by splat weights."""
        img = film_mod.crop(self.film, self.image)
        cnt = film_mod.crop(self.film, self.sample_count)
        return img / film_mod.RADIANCE_SCALE / jnp.maximum(cnt, 1e-9)[..., None]

    PREVIEW_FACTOR = 16       # 1/16-per-axis low-res buffer (the
                              # reference's Wlr/Hlr, Raytracer.cpp:1508)
    PREVIEW_BLEND_SPP = 6     # blend while sample_count <= 5
                              # (mainApp.cpp:1219-1238: alpha = count/6)

    def preview(self, spp: int = 1):
        """Render (and cache) the 1/16-per-axis low-res preview buffer.

        The reference keeps a Wlr=W/16 accumulation image so early
        progressive views are DENSE (Raytracer.cpp:1508-1510); its
        scanline scheduling left holes, our waves leave noise — either
        way the cheap low-res pass (1/256 of the rays) gives an instant
        dense preview long before the first full wave lands.  Lazy: the
        low-res trace compiles separately, so it only runs when a caller
        actually asks for fill-in (CLI --progressive does)."""
        if getattr(self, '_preview_lin', None) is None:
            f = self.PREVIEW_FACTOR
            wlr = max(self.cfg.width // f, 2)
            hlr = max(self.cfg.height // f, 2)
            pcfg = self.cfg._replace(width=wlr, height=hlr,
                                     nrays=spp, remat_samples=False)
            cp = jnp.asarray(rng_host.random_per_pixel_fast(wlr, hlr))
            img, _ = render_unsplatted(self.scene, self.cam, cp, pcfg)
            self._preview_lin = img          # (hlr, wlr, 3) linear
        return self._preview_lin

    def display_fill_in(self):
        """Display image with the reference's low-res fill-in blend:
        pixels with sample_count <= 5 mix toward the bilinear-upsampled
        preview with alpha = count/6 (mainApp.cpp:1214-1240).  Falls back
        to plain display once every pixel has PREVIEW_BLEND_SPP samples."""
        cnt = film_mod.crop(self.film, self.sample_count)
        if int(jnp.min(cnt)) >= self.PREVIEW_BLEND_SPP:
            return self.display()
        low = self.preview()
        h, w = self.cfg.height, self.cfg.width
        up = jax.image.resize(low, (h, w, 3), method='bilinear')
        img = film_mod.crop(self.film, self.image)
        lin = img / film_mod.RADIANCE_SCALE / jnp.maximum(cnt, 1.0)[..., None]
        alpha = jnp.clip(cnt / float(self.PREVIEW_BLEND_SPP),
                         0.0, 1.0)[..., None]
        blended = alpha * lin + (1.0 - alpha) * up
        return jnp.clip(jnp.power(jnp.maximum(blended, 0.0),
                                  1.0 / self.cfg.gamma), 0.0, 1.0)

    def display(self):
        return film_mod.to_display(film_mod.crop(self.film, self.image),
                                   film_mod.crop(self.film, self.sample_count),
                                   gamma=self.cfg.gamma)

    def u8(self):
        return film_mod.to_u8(self.display())

    def stats(self, seconds: float):
        """Observability record: rays/s + time-per-sample (the reference's
        status-bar metrics, mainApp.cpp:1168-1170).  rays_per_second uses
        the MEASURED live-lane count (dead lanes don't inflate it)."""
        spp = max(self.samples_done, 1)
        rays = int(self.rays_traced)
        return {
            'samples_done': self.samples_done,
            'time_per_sample_s': seconds / spp,
            'rays_traced': rays,
            'rays_per_second': rays / max(seconds, 1e-12),
            # count of subsurface probes lost to the crossing-march slot
            # cap (RESERVOIR_MAX_CROSSINGS) — each is a biased miss; the
            # honest-estimator expectation is ~0 on real scenes
            # (tests/test_subsurface_mesh.py asserts it)
            'ss_reservoir_overflow': int(self.ss_overflow),
        }

    def save_checkpoint(self, path: str):
        """Mid-render checkpoint: framebuffer + splat weights + progress
        (SURVEY §5 — the reference has no mid-render resume; a preempted
        pod slice resumes from here)."""
        np.savez(path, image=np.asarray(self.image),
                 sample_count=np.asarray(self.sample_count),
                 aux0=np.asarray(self.aux[0]), aux1=np.asarray(self.aux[1]),
                 aux2=np.asarray(self.aux[2]),
                 samples_done=self.samples_done,
                 rays_traced=int(self.rays_traced),
                 ss_overflow=int(self.ss_overflow),
                 cfg=repr(self.cfg))

    def load_checkpoint(self, path: str):
        """Resume a checkpoint written by save_checkpoint (same config)."""
        d = np.load(path, allow_pickle=False)
        assert str(d['cfg']) == repr(self.cfg), (
            'checkpoint was written with a different RenderConfig')
        self.image = jnp.asarray(d['image'])
        self.sample_count = jnp.asarray(d['sample_count'])
        self.aux = (jnp.asarray(d['aux0']), jnp.asarray(d['aux1']),
                    jnp.asarray(d['aux2']))
        self.samples_done = int(d['samples_done'])
        self.rays_traced = int(d['rays_traced']) if 'rays_traced' in d else 0
        self.ss_overflow = int(d['ss_overflow']) if 'ss_overflow' in d else 0
        return self

    def denoised_display(self, iterations: int = 4):
        """Denoised output from the aux buffers (the OIDN path,
        Raytracer.cpp:1719-1756).  Requires cfg.has_denoiser."""
        from . import denoise as dn
        assert self.cfg.has_denoiser, 'render with has_denoiser=True'
        n = max(self.samples_done, 1)
        color = self.aux[0] / n
        albedo = self.aux[1] / n
        nrm = self.aux[2]
        nrm = nrm / jnp.maximum(
            jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        out = dn.denoise(color, albedo, nrm, iterations=iterations)
        # unsplatted buffers are already per-sample means; rows flip to
        # image orientation like the splat path
        out = out[::-1] / film_mod.RADIANCE_SCALE
        return jnp.clip(jnp.power(jnp.maximum(out, 0.0),
                                  1.0 / self.cfg.gamma), 0.0, 1.0)
