"""Wavefront path integrator — the JAX getColor.

The reference integrates radiance with a per-thread circular queue of path
continuations popped one at a time (reference: Raytracer.cpp:196-664,
Contrib queue Raytracer.h:15-23,114-115).  Here the queue becomes a
*wavefront*: every path in flight is a lane of big SoA arrays, the bounce
loop is bounce-major, and branch divergence (miss/dome/light/mirror/
refract/diffuse) becomes lane masking that XLA fuses into a handful of
vector kernels.  One continuation ray per path per bounce (exactly the
reference's push pattern for surface events; fog adds a second branch and is
handled by its own wavefront pass in a later milestone).

Per-path randomness: each (pixel, sample) path owns a PCG32 stream
(core/rng.py).  The canonical draw order reproduces the reference's
data-dependent engine draws (gated draws leave the lane's stream untouched,
matching e.g. the Fresnel-RR uniform only being drawn on transparent
surfaces):

    camera:      dx, dy, dx_aperture, dy_aperture      (4 draws)
    per bounce:  [subsurface RR  — gated, later milestone]
                 NEE r1, r2                (diffuse surface lanes)
                 Fresnel RR u              (transparent lanes)
                 Phong lobe-choice u       (diffuse lanes, BRDF.h:73)

The indirect 2D sample is NOT an engine draw: it is the per-pixel
Cranley–Patterson rotation of the per-sample lattice point, reused at every
bounce depth, exactly as the reference does (Raytracer.cpp:580-589).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rng as prng
from ..core import sampling, vec
from ..models import brdf
from ..models import merl as merl_mod
from ..scene import scene as scn


def _eval_brdf(sc, hit, wi, wo, nrm):
    """BRDF dispatch: Phong everywhere, overridden per measured table
    (the reference's per-Object virtual brdf->eval, Raytracer.cpp:543)."""
    f = brdf.phong_eval(hit.kd, hit.ks, hit.ne, wi, wo, nrm)
    for k, table in enumerate(sc.measured_brdfs):
        mask = (hit.brdf_type == k + 1)[:, None]
        f = jnp.where(mask, merl_mod.measured_eval(table, wi, wo, nrm), f)
    return f

M_PI = np.float32(np.pi)


def _int_exponential(y0, ysol, beta, s, uy):
    """Optical depth of exponential-height extinction along a segment
    (reference: int_exponential, Raytracer.cpp:20-38), with the small
    |uy*beta| series branch."""
    small = jnp.abs(uy * beta) < 1e-4
    # exponent clamps: dome-distance segments (y ~ 1e6) would overflow
    # exp to inf, and grad-of-where then turns the zero cotangent into
    # 0 * exp'(inf) = NaN (config-5 fog gradcheck); +-80 keeps every
    # primal finite while leaving all physical fog depths untouched
    e1 = jnp.clip(-beta * (y0 - ysol), -80.0, 80.0)
    e2 = jnp.clip(-beta * (y0 + s * uy - ysol), -80.0, 80.0)
    near = jnp.exp(e1) * s
    denom = jnp.where(small, 1.0, uy * beta)
    far = (jnp.exp(e1) - jnp.exp(e2)) / denom
    return jnp.where(small, near, far)


def _fog_optical_depth(sc, org_y, dir_y, s):
    """alpha * integral of extinction over [0, s] (Raytracer.cpp:58-63)."""
    if sc.fog_type == 0:
        return sc.fog_absorption * s * 0.05
    return sc.fog_absorption * _int_exponential(
        org_y, sc.ground_level, sc.fog_absorption_decay, s, dir_y)


def _fog_event(sc, org, dirn, seg_t, sample_light_pos, rng_st):
    """Fog in-scattering event for one wavefront of segments
    (reference: fogContribution, Raytracer.cpp:44-192).

    Returns (T, fog_dir, fog_org, fog_weight, fog_valid, rng_st):
      T          — transmittance of the segment (multiplies all surface
                   contributions of this event),
      fog_*      — the in-scatter continuation ray and its weight factor
                   (pathWeight multiplier), valid where fog_valid.
    Draw order: t-sample u, direction-choice u, dir u1, u2 (4 gated draws).
    The reference's rejection loop for the truncated-exponential t-sample
    (Raytracer.cpp:91-93) is replaced by exact CDF inversion (one draw).
    """
    # miss lanes carry seg_t ~ 1e30; the event is gated off for them
    # AFTER the math, but inf primals here (tan near pi/2, exp overflow)
    # would 0*NaN-poison the whole BACKWARD pass — grad-of-where passes a
    # zero cotangent, and 0 * f'(inf) = NaN (caught by the config-5
    # fog_density gradcheck, tests/test_gradcheck_ladder.py)
    seg_t = jnp.minimum(seg_t, 1e6)
    ray_y = dirn[:, 1]
    org_y = org[:, 1]
    int_ext = jnp.clip(_fog_optical_depth(sc, org_y, ray_y, seg_t),
                       -80.0, 80.0)
    transmittance = jnp.exp(-int_ext)

    gate = jnp.ones(org.shape[0], bool)
    u_t, rng_st = prng.next_uniform(rng_st, gate=gate)
    u_choice, rng_st = prng.next_uniform(rng_st, gate=gate)
    u1, u2, rng_st = prng.next_uniform2(rng_st, gate=gate)

    clamped_t = jnp.minimum(1000.0, seg_t)

    # equiangular t-sampling toward the light when a > 0 (Raytracer.cpp:70-82)
    a = vec.dot(sample_light_pos - org, dirn)
    proj_p = org + a[:, None] * dirn
    dd = jnp.sqrt(jnp.maximum(vec.norm2(sample_light_pos - proj_p), 1e-12))
    theta_a = -jnp.arctan2(a, dd)
    theta_b = jnp.arctan2(seg_t - a, dd)
    t_eq = dd * jnp.tan((1.0 - u_t) * theta_a + u_t * theta_b)
    p_eq = dd / ((theta_b - theta_a) * (dd * dd + t_eq * t_eq))
    t_eq = t_eq + a

    # truncated-exponential fallback (Raytracer.cpp:89-97), CDF-inverted
    alpha_s = 5.0 / clamped_t
    cdf_max = 1.0 - jnp.exp(-alpha_s * clamped_t)
    t_ex = -jnp.log(jnp.maximum(1.0 - u_t * cdf_max, 1e-30)) / alpha_s
    norm_ex = (1.0 / alpha_s) * cdf_max
    p_ex = jnp.exp(-alpha_s * t_ex) / norm_ex

    use_eq = a > 0.0
    random_t = jnp.where(use_eq, t_eq, t_ex)
    proba_t = jnp.where(use_eq, p_eq, p_ex)
    # finite-by-construction sampling state (same 0*NaN backward hazard)
    random_t = jnp.clip(random_t, 0.0, seg_t)
    proba_t = jnp.clip(proba_t, 1e-30, 1e30)

    int_ext_part = jnp.clip(
        _fog_optical_depth(sc, org_y, ray_y, random_t), -80.0, 80.0)
    random_p = org + random_t[:, None] * dirn
    above_ground = random_p[:, 1] >= sc.ground_level

    # direction: MIS uniform sphere vs cosine-cone to the light (:112-126)
    axe_op = vec.normalize(random_p - sc.center_light)
    d_uniform = sampling.random_uniform_sphere(u1, u2)
    d_cos = sampling.random_cos(axe_op, u1, u2)
    point_al = d_cos * sc.radius_light + sc.center_light
    to_light = point_al - random_p
    d_light = vec.normalize(to_light)
    is_uniform = u_choice < 0.5
    random_dir = jnp.where(is_uniform[:, None], d_uniform, d_light)

    # phase function (:129-141)
    mu = vec.dot(random_dir, dirn)
    if sc.fog_phase_type == 0:
        phase = jnp.full_like(mu, 1.0 / (4.0 * np.pi))
    elif sc.fog_phase_type == 1:
        k = sc.phase_aniso
        phase = (1.0 - k * k) / (4.0 * np.pi * (1.0 + k * (-mu)))
    else:
        phase = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)

    # probe the scene along the scatter ray for visibility + light pdf (:143-172)
    hit = scn.intersect(sc, random_p, random_dir)
    d_light2 = vec.norm2(to_light)
    vis_block = hit.hit & (hit.t * hit.t < d_light2 * 0.99)
    visible = is_uniform | ~vis_block
    # miss lanes carry hit.p ~ 1e30: finite stand-ins keep the pdf chain's
    # primals finite (0*NaN backward hazard, see the seg_t note above)
    hit_light = hit.hit & (hit.obj_id == 0)
    hit_p = jnp.where(hit_light[:, None], hit.p, random_p + random_dir)
    hit_n = jnp.where(hit_light[:, None], hit.n, -random_dir)

    # area->solid-angle Jacobian of the light-cone sample; at grazing light
    # hits jac -> 0 (or slightly negative in f32), which must push pdf_light
    # -> +inf, NOT flip it negative: a negative mixture pdf under the
    # max(denominator, eps) clamp exploded into 1e26-weight fireflies (the
    # reference has the same latent defect, Raytracer.cpp:170-172)
    jac = vec.dot(hit_n, -random_dir) / jnp.maximum(
        vec.norm2(hit_p - random_p), 1e-12)
    jac = jnp.maximum(jac, 1e-9)
    pdf_light_sa = (vec.dot(vec.normalize(hit_p - sc.center_light), axe_op)
                    / (np.pi * sc.radius_light ** 2) / jac)
    pdf_light = jnp.where(hit_light, jnp.maximum(pdf_light_sa, 0.0), 0.0)
    proba_dir = 0.5 * (1.0 / (4.0 * np.pi)) + 0.5 * pdf_light

    if sc.fog_type == 0:
        ext = jnp.full_like(random_t, 1.0) * (sc.fog_density * 0.05)
    else:
        # exponent clamp: same finite-primal rule as _int_exponential
        ext = sc.fog_density * jnp.exp(jnp.clip(
            -sc.fog_density_decay * (random_p[:, 1] - sc.ground_level),
            -80.0, 80.0))
    fog_w = (phase * ext * jnp.exp(-int_ext_part)
             / jnp.maximum(proba_t * proba_dir, 1e-30))
    fog_valid = above_ground & visible & (fog_w > 0.0) & jnp.isfinite(fog_w)
    return (transmittance, random_dir, random_p, fog_w, fog_valid, rng_st)


class PathState(NamedTuple):
    org: jnp.ndarray          # (N,3)
    dirn: jnp.ndarray         # (N,3)
    weight: jnp.ndarray       # (N,3) path throughput
    color: jnp.ndarray        # (N,3) accumulated radiance
    alive: jnp.ndarray        # (N,) bool
    show_lights: jnp.ndarray  # (N,) bool — NEE double-count guard
    show_env: jnp.ndarray     # (N,) bool
    had_ss: jnp.ndarray       # (N,) bool — subsurface re-entry guard (:318)
    rng: tuple                # 4x (N,) uint32 PCG state
    # denoiser aux captured at the primary hit (Raytracer.cpp:254-257)
    normal_aux: jnp.ndarray   # (N,3)
    albedo_aux: jnp.ndarray   # (N,3)
    # surface-locality key of this bounce's hit (scene.Hit.lkey): the
    # octant sort's secondary key.  NOT preserved across the sort — the
    # next bounce recomputes it from its own hit before any use.
    lkey: jnp.ndarray = None  # (N,) int32
    # per-lane count of subsurface reservoir-march slot overflows
    # (scene._mesh_reservoir_march reports found=False past
    # RESERVOIR_MAX_CROSSINGS crossings — the estimator treats that as a
    # probe miss, which is biased if it is ever COMMON; this counter
    # makes the rate observable, Renderer.stats ss_reservoir_overflow).
    # Summed at the end, so the octant sort may carry it unpermuted.
    ss_over: jnp.ndarray = None  # (N,) int32


SS_SIGMA = np.float32(1.5)                       # Raytracer.cpp:330
SS_DISK_R = np.float32((12.46 ** 0.5) * 1.5)     # Raytracer.cpp:331
SS_PROBA = np.float32(0.6)                       # Raytracer.cpp:318


def _subsurface_event(sc, hit, p, nrm, ray_dir, take_ss, rng_st):
    """Disk-probe BSSRDF relocation (reference: Raytracer.cpp:317-406).

    Gaussian disk sample above the surface, probe-axis MIS over
    {-N: 0.5, Tg: 0.25, Tg2: 0.25}, restricted reservoir intersection on
    the same object, weight = pdfdisk/max(pdfgauss,0.05)*chris*(2|4)*Ksub/pi.

    Returns (ss_ok, new_p, new_n, new_dir, ss_factor (N,3), probe_ksub,
    rng, probe_overflow (N,) bool).
    Draws (all gated on take_ss): randR u, angle u, axis u, [offset u gated
    tangent-axis], reservoir u.
    """
    sigma = SS_SIGMA
    disk_r = SS_DISK_R
    u_r, rng_st = prng.next_uniform(rng_st, gate=take_ss)
    u_ang, rng_st = prng.next_uniform(rng_st, gate=take_ss)

    integ = 1.0 - np.exp(-float(disk_r) ** 2 / (2.0 * float(sigma) ** 2))
    rand_r = sigma * jnp.sqrt(-2.0 * jnp.log(
        jnp.maximum(1.0 - u_r * integ, 1e-30)))
    angle = u_ang * (2.0 * np.pi)
    gx = rand_r * jnp.sin(angle)
    gy = rand_r * jnp.cos(angle)
    gz = rand_r
    gaussval = (1.0 / (sigma * sigma * 2.0 * np.pi)
                * jnp.exp(-(gz * gz) / (2.0 * sigma * sigma)))
    pdfgauss = gaussval / integ

    tg = vec.get_tangent(nrm)
    tg2 = vec.cross(nrm, tg)
    pt_above = p + gx[:, None] * tg + gy[:, None] * tg2 + nrm * disk_r

    u_ax, rng_st = prng.next_uniform(rng_st, gate=take_ss)
    h = jnp.sqrt(jnp.maximum(disk_r * disk_r - gz * gz, 0.0))
    subs_org = pt_above + (disk_r - h)[:, None] * (-nrm)
    axis_is_n = u_ax < 0.5
    w_axis = jnp.where(axis_is_n, 0.5, 0.25)
    tmax_p = jnp.where(axis_is_n, 2.0 * h, 2.0 * gz)
    axis = jnp.where(axis_is_n[:, None], -nrm,
                     jnp.where((u_ax < 0.75)[:, None], tg, tg2))
    u_off, rng_st = prng.next_uniform(rng_st, gate=take_ss & ~axis_is_n)
    subs_org = jnp.where((~axis_is_n & (u_off < 0.5))[:, None],
                         subs_org - h[:, None] * nrm, subs_org)

    u_res, rng_st = prng.next_uniform(rng_st, gate=take_ss)
    probe = scn.reservoir_same_object(sc, subs_org, axis, tmax_p,
                                      hit.obj_id, u_res)
    ss_ok = take_ss & probe.found

    chris = jnp.exp(-vec.norm2(p - probe.p) / (2.0 * sigma * sigma))
    sumpdfs = ((0.5 * vec.dot(probe.n, nrm)) ** 2
               + (0.25 * vec.dot(probe.n, tg)) ** 2
               + (0.25 * vec.dot(probe.n, tg2)) ** 2)
    pdfdisk = w_axis * jnp.abs(vec.dot(axis, probe.n)) / jnp.maximum(sumpdfs,
                                                                     1e-20)
    mult = jnp.where(axis_is_n, 2.0, 4.0)
    factor = (pdfdisk / jnp.maximum(pdfgauss, 0.05) * chris * mult)[:, None] \
        * (hit.ksub / M_PI)

    new_dir = vec.normalize(probe.p - p)
    new_p = probe.p + 0.005 * probe.n
    over = (take_ss & probe.overflow) if probe.overflow is not None \
        else jnp.zeros_like(take_ss)
    return ss_ok, new_p, probe.n, new_dir, factor, probe.ksub, rng_st, over


def _masked_update(mask, new, old):
    if new.ndim > mask.ndim:
        mask = mask[..., None]
    return jnp.where(mask, new, old)


def _sort_wavefront(state: PathState, cp_r12, bg_pixel, lane_id):
    """Reorder lanes: alive first, grouped by direction octant.

    The secondary-ray re-sorting of SURVEY §2.7 (the Embree coherent/
    incoherent hint become explicit): lanes of similar directions keep a
    block of the GPU BVH traversal kernel on similar paths after the
    first bounce, and dead lanes cluster at the tail.  A stable argsort
    keeps determinism; the original order is restored through lane_id at
    the end of the trace.  Within an octant the stable sort keeps
    pixel-tile order, which on smooth surfaces carries position locality;
    other keys (finer direction bins, Morton order of origins) have not
    been measured on the GPU.
    """
    with jax.named_scope('octant_sort'):
        d = state.dirn
        octant = ((d[:, 0] > 0).astype(jnp.int32) * 4
                  + (d[:, 1] > 0).astype(jnp.int32) * 2
                  + (d[:, 2] > 0).astype(jnp.int32))
        # direction-major, surface-patch-minor: within an octant, lanes
        # group by the BVH-order bucket of the triangle their ray STARTS
        # on (hit.lkey)
        lk = jnp.clip(state.lkey, 0, 8191)
        key = jnp.where(state.alive, (octant << 13) | lk, 8 << 13)
        perm = jnp.argsort(key, stable=True)

        # Apply the permutation as ONE row gather of a packed (N, C)
        # matrix instead of ~18 per-array gathers.
        f32 = [state.org, state.dirn, state.weight, state.color,
               state.normal_aux, state.albedo_aux, cp_r12]
        if bg_pixel is not None:
            f32.append(bg_pixel)
        u32 = list(state.rng) + [lane_id.view(jnp.uint32)]
        bools = [state.alive, state.show_lights, state.show_env,
                 state.had_ss]
        packed = jnp.concatenate(
            f32 + [x.view(jnp.float32)[:, None] for x in u32]
            + [jnp.packbits(jnp.stack(bools, 1), axis=1, bitorder='little')
               .astype(jnp.float32)], axis=1)
        packed = packed[perm]

        def col3(i):
            return packed[:, 3 * i:3 * i + 3]

        cp_r12 = packed[:, 18:20]
        off = 20
        if bg_pixel is not None:
            bg_pixel = packed[:, off:off + 3]
            off += 3
        rng = tuple(packed[:, off + i].view(jnp.uint32) for i in range(4))
        lane_id = packed[:, off + 4].view(jnp.int32)
        flags = packed[:, off + 5].astype(jnp.uint8)
        state = PathState(
            org=col3(0), dirn=col3(1), weight=col3(2), color=col3(3),
            alive=(flags & 1) != 0,
            show_lights=(flags & 2) != 0, show_env=(flags & 4) != 0,
            had_ss=(flags & 8) != 0, rng=rng,
            normal_aux=col3(4), albedo_aux=col3(5),
            lkey=jnp.zeros_like(state.lkey),  # recomputed next bounce
            # overflow counter rides UNPERMUTED: only its sum is read
            ss_over=state.ss_over)
    return state, cp_r12, bg_pixel, lane_id


COMPACT_SEGMENTS = 16   # dead-tail segment granularity (see _segmented)


def trace_paths(sc: scn.SceneArrays, origins, dirs, rng_state, cp_r12,
                nb_bounces: int, bg_pixel=None, sort_rays: bool = False,
                compact_rays: bool = False, return_stats: bool = False):
    """Trace a wavefront of paths to completion.

    Args:
      sc: SceneArrays.
      origins, dirs: (N,3) primary rays.
      rng_state: per-lane PCG streams (already past the camera draws).
      cp_r12: (N,2) Cranley–Patterson-rotated lattice sample for the indirect
        bounce direction (same value at every depth, Raytracer.cpp:580-589).
      nb_bounces: static bounce budget (reference default 3).
      compact_rays: stream compaction (SURVEY §2.7 / the reference's bounded
        Contrib queue, Raytracer.h:114-115): with sort_rays the alive lanes
        are contiguous at the front after every bounce, so later bounces run
        only ceil(live/SEG) fixed-size segments instead of all N lanes —
        dead lanes cost nothing.  Requires sort_rays (it IS the compaction
        permutation); lanes are independent, so skipping dead segments is
        exact, not an approximation.
      return_stats: also return the (nb_bounces,) int32 live-lane count per
        bounce (honest rays/s accounting).

    Returns:
      (color (N,3), normal_aux (N,3), albedo_aux (N,3)[, live_counts])
    """
    n = origins.shape[0]
    if compact_rays and not sort_rays:
        raise ValueError('compact_rays requires sort_rays (the octant sort '
                         'is the compaction permutation)')
    zeros3 = jnp.zeros((n, 3), jnp.float32)
    state = PathState(
        org=origins, dirn=dirs,
        weight=jnp.ones((n, 3), jnp.float32),
        color=zeros3,
        alive=jnp.ones((n,), bool),
        show_lights=jnp.ones((n,), bool),
        show_env=jnp.ones((n,), bool),
        had_ss=jnp.zeros((n,), bool),
        rng=rng_state,
        normal_aux=zeros3, albedo_aux=zeros3,
        lkey=jnp.zeros((n,), jnp.int32),
        ss_over=jnp.zeros((n,), jnp.int32),
    )
    ss_enabled = sc.ss_enabled

    light_power = sc.light_power
    center_light = sc.center_light
    radius_light = sc.radius_light

    def bounce(depth, state: PathState, cp_r12, bg_pixel):
        is_primary = depth == 0

        # ---- weight cull (Raytracer.cpp:241) ----
        alive = state.alive & (vec.norm2(state.weight) >= 1e-4)

        # ---- closest hit ----
        with jax.named_scope('closest_hit'):
            hit = scn.intersect(sc, state.org, state.dirn)
        p, nrm = hit.p, hit.n
        ray_dir = state.dirn

        if is_primary:
            state = state._replace(
                normal_aux=_masked_update(hit.hit, nrm, state.normal_aux),
                albedo_aux=_masked_update(hit.hit, hit.kd, state.albedo_aux))

        miss = alive & ~hit.hit
        at_dome = alive & hit.hit & (hit.obj_id == 1)
        at_light = alive & hit.hit & (hit.obj_id == 0)
        at_surface = alive & hit.hit & (hit.obj_id >= 2)

        # background-photo compositing on PRIMARY miss/dome (:260-268)
        bg_hit = jnp.zeros_like(alive)
        if bg_pixel is not None and is_primary:
            bg_hit = miss | at_dome
            at_dome = at_dome & ~bg_hit
            miss = miss & ~bg_hit

        # ---- surface classification ----
        is_mirror = at_surface & hit.miroir
        is_transp = at_surface & hit.transp & ~hit.miroir
        is_diffuse = at_surface & ~hit.miroir & ~hit.transp

        # === subsurface entry RR (Raytracer.cpp:318-327; draws first) ===
        is_sub_mat = vec.norm2(hit.ksub) > 1e-8
        can_ss = is_diffuse & is_sub_mat & ~state.had_ss
        if sc.ss_obj_ok is not None:
            # rows without a reservoir path opt out of the SS RR entirely
            # (subsProba = 0) so the estimator stays unbiased
            can_ss = can_ss & scn._sel_table(sc.ss_obj_ok, hit.obj_id,
                                             sc.num_objects)
        u_ss, rng_st = prng.next_uniform(state.rng, gate=can_ss)
        take_ss = can_ss & (u_ss < SS_PROBA)
        # subsW: 1/p on the SS branch, 1/(1-p) on the surviving surface
        # branch of an SS-capable material, 1 otherwise
        subs_w = jnp.where(take_ss, 1.0 / SS_PROBA,
                           jnp.where(can_ss, 1.0 / (1.0 - SS_PROBA), 1.0)
                           )[:, None] * jnp.ones((1, 3))
        if ss_enabled:
            (ss_ok, ss_p, ss_n, ss_dir, ss_factor, ss_ksub,
             rng_st, ss_probe_over) = _subsurface_event(
                sc, hit, p, nrm, ray_dir, take_ss, rng_st)
            p = jnp.where(ss_ok[:, None], ss_p, p)
            nrm = jnp.where(ss_ok[:, None], ss_n, nrm)
            ray_dir = jnp.where(ss_ok[:, None], ss_dir, ray_dir)
            subs_w = jnp.where(ss_ok[:, None], subs_w * ss_factor, subs_w)
        else:
            ss_ok = jnp.zeros_like(take_ss)
            ss_ksub = hit.ksub

        # === NEE to the spherical light (Raytracer.cpp:492-556) ===
        u1, u2, rng_st = prng.next_uniform2(rng_st, gate=is_diffuse)
        axe_op = vec.normalize(p - center_light)
        dir_al = sampling.random_cos(axe_op, u1, u2)
        point_al = dir_al * radius_light + center_light
        to_light = point_al - p
        d_light2 = vec.norm2(to_light)
        wi = vec.normalize(to_light)
        cos_surf = vec.dot(nrm, wi)
        shadow_org = p + 0.01 * wi
        dist = jnp.sqrt(d_light2) - 0.01
        # Only diffuse front-facing lanes consume the NEE visibility test
        # (the reference casts the shadow ray inside the diffuse branch,
        # Raytracer.cpp:492-556).  Zeroing the limit for every other lane
        # lets the mesh any-hit cull drop them for free — miss/sky lanes
        # otherwise sweep clusters from garbage argmin hit points.
        nee_gate = is_diffuse & (cos_surf >= 0.0)
        with jax.named_scope('shadow_nee'):
            blocked = scn.intersect_shadow(sc, shadow_org, wi,
                                           jnp.where(nee_gate, dist, 0.0),
                                           avoid_ghosts=True)
        shadowed = (cos_surf < 0.0) | blocked
        f_brdf = _eval_brdf(sc, hit, wi, -ray_dir, nrm)
        # after a subsurface exit the BRDF is Ksub/pi (Raytracer.cpp:540-544)
        f_brdf = jnp.where(ss_ok[:, None], ss_ksub / M_PI, f_brdf)
        jac = vec.dot(dir_al, -wi) / jnp.maximum(d_light2, 1e-12)
        proba = vec.dot(axe_op, dir_al) / (M_PI * radius_light * radius_light)
        nee = (light_power * jnp.maximum(cos_surf, 0.0) * jac
               / jnp.where(proba > 0.0, proba, 1.0))[:, None] * f_brdf * subs_w
        nee_ok = is_diffuse & ~shadowed & (proba > 0.0) & ~hit.ghost

        # === fog event for this segment (Raytracer.cpp:44-192) ===
        if sc.fog_enabled:
            # diffuse lanes aim the equiangular sample at the NEE light
            # point, others at the light center (:278 vs :558)
            sample_lp = jnp.where(is_diffuse[:, None], point_al,
                                  center_light[None, :])
            fog_gate = alive & hit.hit
            # fog integrates the INCOMING segment: original ray, not the
            # subsurface-relocated one (:278 uses currentRay)
            trans_T, fog_dir, fog_org, fog_w, fog_valid, rng_st = _fog_event(
                sc, state.org, state.dirn, hit.t, sample_lp, rng_st)
            trans_T = jnp.where(fog_gate, trans_T, 1.0)
            fog_valid = fog_valid & fog_gate
        else:
            trans_T = jnp.ones_like(hit.t)
            fog_valid = jnp.zeros_like(alive)
            fog_dir = ray_dir
            fog_org = p
            fog_w = jnp.zeros_like(hit.t)

        color = state.color
        if bg_pixel is not None and is_primary:
            color = color + jnp.where(bg_hit[:, None],
                                      state.weight * bg_pixel, 0.0)
        # dome: envmap radiance if the path may see it (Raytracer.cpp:274-302)
        dome_rad = sc.envmap_intensity * hit.ke
        color = color + jnp.where((at_dome & state.show_env)[:, None],
                                  trans_T[:, None] * state.weight * dome_rad,
                                  0.0)
        # light sphere: emitted power only on NEE-deduped paths (:303-316)
        color = color + jnp.where((at_light & state.show_lights)[:, None],
                                  trans_T[:, None] * state.weight * light_power,
                                  0.0)
        # emission — NOT fog-attenuated, matching the reference (:411)
        color = color + jnp.where(at_surface[:, None],
                                  state.weight * hit.ke * sc.envmap_intensity,
                                  0.0)
        # NEE contribution, attenuated (:557-567)
        color = color + jnp.where(nee_ok[:, None],
                                  trans_T[:, None] * state.weight * nee, 0.0)

        # === continuations ===
        # mirror (Raytracer.cpp:413-437)
        mirror_dir = vec.reflect(ray_dir, nrm)
        mirror_org = p + 0.001 * nrm

        # transparent: Fresnel RR reflect/refract (Raytracer.cpp:438-489)
        u_fresnel, rng_st = prng.next_uniform(rng_st, gate=is_transp)
        cos_in = vec.dot(ray_dir, nrm)
        exiting = cos_in > 0.0
        n1 = jnp.where(exiting, hit.refr_index, 1.0)
        n2 = jnp.where(exiting, 1.0, hit.refr_index)
        n_t = jnp.where(exiting[:, None], -nrm, nrm)  # normale_pour_transparence
        eta = n1 / n2
        cos_t = vec.dot(n_t, ray_dir)
        radical = 1.0 - eta * eta * (1.0 - cos_t * cos_t)
        tir = radical <= 0.0
        refr_dir = (eta[:, None] * (ray_dir - cos_t[:, None] * n_t)
                    - n_t * jnp.sqrt(jnp.maximum(radical, 0.0))[:, None])
        r0 = ((n1 - n2) / (n1 + n2)) ** 2
        fres = jnp.where(
            exiting,
            r0 + (1.0 - r0) * jnp.power(jnp.maximum(
                1.0 - vec.dot(refr_dir, nrm), 0.0), 5.0),
            r0 + (1.0 - r0) * jnp.power(jnp.maximum(1.0 + cos_in, 0.0), 5.0))
        take_reflect = tir | (u_fresnel < fres)
        transp_dir = jnp.where(take_reflect[:, None],
                               vec.reflect(ray_dir, nrm), refr_dir)
        transp_org = jnp.where(take_reflect[:, None],
                               p + 0.001 * n_t, p - 0.001 * n_t)

        # diffuse indirect: Phong MIS with CP-lattice 2D sample (:569-631);
        # subsurface exits continue diffuse-only with pdf = cos/pi and
        # BRDF = Ksub/pi (:584-587, :603-607); their lobe-choice draw is
        # skipped (gate), matching the reference's branch
        # measured BRDFs sample pure cosine (BRDF.h:126-131, :198-203) and
        # draw no lobe-choice uniform — gate it to true Phong lanes
        is_measured = hit.brdf_type > 0
        u_choice, rng_st = prng.next_uniform(
            rng_st, gate=is_diffuse & ~ss_ok & ~is_measured)
        ind_dir, ind_pdf, _sampled_diff = brdf.phong_sample(
            hit.kd, hit.ks, hit.ne, -ray_dir, nrm,
            u_choice, cp_r12[:, 0], cp_r12[:, 1])
        dir_cos = sampling.random_cos(nrm, cp_r12[:, 0], cp_r12[:, 1])
        use_cos = ss_ok | is_measured
        ind_dir = jnp.where(use_cos[:, None], dir_cos, ind_dir)
        ind_pdf = jnp.where(use_cos, vec.dot(nrm, dir_cos) / M_PI, ind_pdf)
        ind_dir = jax.lax.stop_gradient(ind_dir)
        ind_pdf = jax.lax.stop_gradient(ind_pdf)
        reject = ((vec.dot(ind_dir, nrm) < 0.0)
                  | (vec.dot(ind_dir, vec.reflect(ray_dir, nrm)) < 0.0)
                  | (ind_pdf <= 0.0))
        f_ind = _eval_brdf(sc, hit, ind_dir, -ray_dir, nrm)
        f_ind = jnp.where(ss_ok[:, None], ss_ksub / M_PI, f_ind)
        ind_weight = (state.weight * subs_w * f_ind
                      * (vec.dot(nrm, ind_dir)
                         / jnp.where(ind_pdf > 0.0, ind_pdf, 1.0))[:, None])
        ind_org = p + 0.01 * ind_dir

        # ---- ghost objects: compositing catchers (:522-537, :614-631) ----
        # every continuation resets showenvmap to true (the Contrib default,
        # Raytracer.h:18, used by the mirror/transparent/fog pushes, and the
        # `|| !ghost` term of the indirect push :626-629); only the two
        # ghost cases below carry anything else
        new_show_env = jnp.ones_like(state.show_env)
        if sc.ghost_enabled:
            is_ghost_surf = is_diffuse & hit.ghost
            if bg_pixel is not None:
                # ghost indirect carries the photo color (:614-621)
                ind_weight = jnp.where(
                    is_ghost_surf[:, None],
                    ind_weight * bg_pixel / np.float32(196964.699),
                    ind_weight)
            # pass-through continuation when the light is visible (:522-537);
            # the reference pushes BOTH it and the indirect ray — RR 50/50
            # like the fog branch (one lane, one ray)
            ghost_pass = is_ghost_surf & ~shadowed
            both_g = ghost_pass & ~reject
            u_g, rng_st = prng.next_uniform(rng_st, gate=both_g)
            take_pass = ghost_pass & (reject | (both_g & (u_g < 0.5)))
            g_mult = jnp.where(both_g, 2.0, 1.0)
            pass_off = jnp.where(vec.dot(nrm, ray_dir)[:, None] > 0.0,
                                 nrm, -nrm)
            pass_org = p + ray_dir * 0.001 + pass_off * 0.001
            ind_org = jnp.where(take_pass[:, None], pass_org, ind_org)
            ind_dir = jnp.where(take_pass[:, None], ray_dir, ind_dir)
            ind_weight = jnp.where(take_pass[:, None],
                                   state.weight * g_mult[:, None],
                                   ind_weight * jnp.where(
                                       is_ghost_surf, g_mult, 1.0)[:, None])
            reject = reject & ~take_pass
            # ghost indirect sees the envmap only via shadowed diffuse
            # samples (:626-631); ghost pass-through carries the parent's
            # show_envmap (:533)
            new_show_env = jnp.where(
                is_ghost_surf & ~take_pass,
                state.show_env & shadowed & _sampled_diff, new_show_env)
            new_show_env = jnp.where(take_pass, state.show_env, new_show_env)

        # ---- merge continuations into next state ----
        cont_diffuse = is_diffuse & ~reject
        surf_alive = is_mirror | is_transp | cont_diffuse
        new_org = jnp.where(is_mirror[:, None], mirror_org,
                            jnp.where(is_transp[:, None], transp_org, ind_org))
        new_dir = jnp.where(is_mirror[:, None], mirror_dir,
                            jnp.where(is_transp[:, None], transp_dir, ind_dir))
        new_weight = jnp.where(cont_diffuse[:, None], ind_weight, state.weight)
        # diffuse continuations must not re-see the light (NEE dedup, :626-630)
        new_show_lights = jnp.where(cont_diffuse, False, state.show_lights)
        if sc.ghost_enabled:
            # ghost pass-through keeps show_lights (:533)
            new_show_lights = jnp.where(take_pass, state.show_lights,
                                        new_show_lights)
        new_had_ss = state.had_ss | (ss_ok & cont_diffuse)

        if sc.fog_enabled:
            # Wavefront fog branching: the reference pushes BOTH the surface
            # continuation and the in-scatter Contrib (:279-283 etc.); one
            # lane carries one ray, so russian-roulette between them.
            # Branch probability proportional to throughput magnitude
            # (importance-weighted RR — unbiased for any p in (0,1), far
            # lower variance than 50/50 when fog weights spike near the
            # light).  The CPU harness mirrors the same estimator.
            both = surf_alive & fog_valid
            w_surface = new_weight * trans_T[:, None]
            w_fog = state.weight * fog_w[:, None]
            lum_f = jnp.sum(jnp.abs(w_fog), axis=-1)
            lum_s = jnp.sum(jnp.abs(w_surface), axis=-1)
            # the RR branch probability is a SAMPLING decision: detached
            # like every other sampling choice (differentiating 1/p
            # without the score term biases the estimator — E[f] is
            # p-independent only when p itself is not differentiated; it
            # was also the config-5 fog gradcheck's NaN conduit via
            # 0 * d(1/p) on invalid-fog lanes)
            p_fog = jax.lax.stop_gradient(
                jnp.clip(lum_f / jnp.maximum(lum_f + lum_s, 1e-30),
                         0.05, 0.95))
            u_rr, rng_st = prng.next_uniform(rng_st, gate=both)
            take_fog = fog_valid & (~surf_alive | (both & (u_rr < p_fog)))
            mult = jnp.where(
                both, jnp.where(take_fog, 1.0 / p_fog, 1.0 / (1.0 - p_fog)),
                1.0)
            new_weight = jnp.where(take_fog[:, None], w_fog,
                                   w_surface) * mult[:, None]
            new_org = jnp.where(take_fog[:, None], fog_org, new_org)
            new_dir = jnp.where(take_fog[:, None], fog_dir, new_dir)
            # fog branch keeps show_lights/had_ss of the parent (:188) but
            # resets show_envmap to the Contrib default true (Raytracer.h:18)
            new_show_lights = jnp.where(take_fog, state.show_lights,
                                        new_show_lights)
            new_show_env = jnp.where(take_fog, True, new_show_env)
            new_had_ss = jnp.where(take_fog, state.had_ss, new_had_ss)
            next_alive = surf_alive | fog_valid
        else:
            next_alive = surf_alive

        return state._replace(
            org=_masked_update(next_alive, new_org, state.org),
            dirn=_masked_update(next_alive, new_dir, state.dirn),
            weight=_masked_update(next_alive, new_weight, state.weight),
            color=color,
            alive=next_alive,
            show_lights=new_show_lights,
            show_env=new_show_env,
            had_ss=new_had_ss,
            rng=rng_st,
            lkey=(jnp.where(hit.hit, hit.lkey, 0)
                  if hit.lkey is not None else state.lkey),
            ss_over=(state.ss_over + ss_probe_over.astype(jnp.int32)
                     if ss_enabled and state.ss_over is not None
                     else state.ss_over),
        )

    def segmented(depth, state, cp_r12, bg_pixel):
        """Run bounce() only over the leading segments that contain live
        lanes.  After the dead-last octant sort, alive lanes occupy a
        contiguous prefix; lanes are independent, so skipping all-dead
        segments changes nothing but the work done.

        A static-length lax.scan over segment indices with the bounce
        gated by lax.cond: dead-tail segments take the identity branch,
        which preserves the compaction win with a fixed-shape loop."""
        seg = n // COMPACT_SEGMENTS
        nseg = (jnp.sum(state.alive.astype(jnp.int32)) + seg - 1) // seg

        def body(st, i):
            off = i * seg

            def sl(x):
                return jax.lax.dynamic_slice_in_dim(x, off, seg, 0)

            def run(st):
                st_new = bounce(depth, jax.tree.map(sl, st), sl(cp_r12),
                                None if bg_pixel is None else sl(bg_pixel))

                def ups(full, s):
                    return jax.lax.dynamic_update_slice_in_dim(full, s,
                                                               off, 0)

                return jax.tree.map(ups, st, st_new)

            return jax.lax.cond(i < nseg, run, lambda st: st, st), None

        state, _ = jax.lax.scan(
            body, state, jnp.arange(COMPACT_SEGMENTS, dtype=jnp.int32))
        return state

    # bounce-major loop, unrolled (nb_bounces is small and static); the last
    # iteration's continuation is dead by construction (depth 0 cull, :240)
    lane_id = jnp.arange(n, dtype=jnp.int32)
    live_counts = []
    for depth in range(nb_bounces):
        live_counts.append(jnp.sum(state.alive.astype(jnp.int32)))
        if compact_rays and depth > 0 and n % COMPACT_SEGMENTS == 0:
            state = segmented(depth, state, cp_r12, bg_pixel)
        else:
            state = bounce(depth, state, cp_r12, bg_pixel)
        if sort_rays and depth + 1 < nb_bounces:
            state, cp_r12, bg_pixel, lane_id = _sort_wavefront(
                state, cp_r12, bg_pixel, lane_id)

    # at 1 bounce no sort ever ran (the loop sorts between bounces), so
    # the unsort would be an identity permutation: skip it
    if sort_rays and nb_bounces > 1:
        with jax.named_scope('unsort'):
            # scatter-inverse + one packed gather (see _sort_wavefront)
            inv = jnp.zeros((n,), jnp.int32).at[lane_id].set(
                jnp.arange(n, dtype=jnp.int32))
            packed = jnp.concatenate(
                [state.color, state.normal_aux, state.albedo_aux], 1)[inv]
            out = (packed[:, 0:3], packed[:, 3:6], packed[:, 6:9])
    else:
        out = (state.color, state.normal_aux, state.albedo_aux)
    if return_stats:
        return out + (jnp.stack(live_counts), jnp.sum(state.ss_over))
    return out
