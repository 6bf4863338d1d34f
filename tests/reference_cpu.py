"""Sequential per-path CPU reference tracer (numpy/python, float32).

This mirrors the *reference C++ algorithm* (nbonneel/pathtracer
Raytracer.cpp:196-664 getColor, Vector.h:792-825 generateDirection) path by
path, drawing randomness from the same keyed PCG32 streams as the JAX
wavefront renderer.  It is the ground truth for the BASELINE north-star
"forward image must match the reference CPU render (allclose at equal sample
sequences)": the thread-scheduling-dependent engine assignment of the C++
is replaced by the documented per-path keying on both sides (SURVEY §7).

Scope: analytic scene (spheres + planes), Phong/Lambert materials, mirror,
Fresnel transparency, NEE to the spherical light, envmap dome, fog
(uniform/exponential, all three phase functions, the documented
importance-weighted estimator deviation mirrored on both sides) and
subsurface scattering (disk probe + axis MIS), matching the JAX
integrator's canonical RNG draw order throughout.
"""

from __future__ import annotations

import math

import numpy as np

from pathtracer_tpu.core.rng_host import PCG32
from pathtracer_tpu.core.qmc import extensible_lattice_2d_np

F = np.float32


def normalize(v):
    return v / np.linalg.norm(v)


def get_tangent(n):
    an = np.abs(n)
    if an[0] <= an[1] and an[0] <= an[2]:
        t = np.array([0.0, -n[2], n[1]], np.float32)
    elif an[1] <= an[0] and an[1] <= an[2]:
        t = np.array([-n[2], 0.0, n[0]], np.float32)
    else:
        t = np.array([-n[1], n[0], 0.0], np.float32)
    return normalize(t)


def random_cos(n, r1, r2):
    sr2 = math.sqrt(max(0.0, 1.0 - r2))
    lx = math.cos(2.0 * math.pi * r1) * sr2
    ly = math.sin(2.0 * math.pi * r1) * sr2
    lz = math.sqrt(max(0.0, r2))
    t1 = get_tangent(n)
    t2 = np.cross(t1, n)
    return lz * n + lx * t1 + ly * t2


def random_phong(r_dir, e, r1, r2):
    z = r2 ** (1.0 / (e + 1.0))
    fac = math.sqrt(max(0.0, 1.0 - z * z))
    lx = math.cos(2.0 * math.pi * r1) * fac
    ly = math.sin(2.0 * math.pi * r1) * fac
    t1 = get_tangent(r_dir)
    t2 = np.cross(t1, r_dir)
    return z * r_dir + lx * t1 + ly * t2


def reflect(d, n):
    return d - 2.0 * np.dot(d, n) * n


# --- measured (MERL) BRDF: scalar port of models/merl.py merl_eval,
# itself a vectorization of lookup_brdf_val (MERLBRDFRead.cpp:76-207) ---
MERL_RES_TH, MERL_RES_TD, MERL_RES_PD = 90, 90, 360
MERL_SCALES = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0],
                       np.float32)


def _rot_z(v, ang):
    c, s = math.cos(ang), math.sin(ang)
    return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1], v[2]],
                    np.float32)


def _rot_y(v, ang):
    c, s = math.cos(ang), math.sin(ang)
    return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]],
                    np.float32)


def merl_eval_np(table, wi, wo, n):
    """table: (3, TH*TD*PD/2) float32.  Mirrors merl_eval exactly."""
    t1 = get_tangent(n)
    t2 = np.cross(t1, n)
    wi_l = np.array([np.dot(wi, t1), np.dot(wi, t2), np.dot(wi, n)],
                    np.float32)
    wo_l = np.array([np.dot(wo, t1), np.dot(wo, t2), np.dot(wo, n)],
                    np.float32)
    if wi_l[2] <= 0.0 or wo_l[2] <= 0.0:
        return np.zeros(3, np.float32)
    half = normalize((wi_l + wo_l) * np.float32(0.5))
    theta_half = math.acos(min(1.0, max(-1.0, float(half[2]))))
    fi_half = math.atan2(half[1], half[0])
    diff = _rot_y(_rot_z(wi_l, -fi_half), -theta_half)
    theta_diff = math.acos(min(1.0, max(-1.0, float(diff[2]))))
    fi_diff = math.atan2(diff[1], diff[0])

    th_deg = theta_half / (math.pi / 2.0) * MERL_RES_TH
    ith = int(math.sqrt(max(th_deg * MERL_RES_TH, 0.0)))
    ith = 0 if theta_half <= 0.0 else min(max(ith, 0), MERL_RES_TH - 1)
    itd = min(max(int(theta_diff / (math.pi * 0.5) * MERL_RES_TD), 0),
              MERL_RES_TD - 1)
    fi_d = fi_diff + math.pi if fi_diff < 0.0 else fi_diff
    ipd = min(max(int(fi_d / math.pi * (MERL_RES_PD // 2)), 0),
              MERL_RES_PD // 2 - 1)
    idx = ipd + itd * (MERL_RES_PD // 2) + ith * (MERL_RES_PD // 2) * MERL_RES_TD
    return np.maximum(table[:, idx] * MERL_SCALES, 0.0).astype(np.float32)


def titopo_eval_np(table, dims, wi, wo, n):
    """Scalar twin of models/merl.titopo_eval (TitopoBRDF::eval,
    BRDF.h:132-185): trilinear over the (theta_i, theta_o, phi_d) grid."""
    nti, nto, npd = dims
    t1 = get_tangent(n)
    t2 = np.cross(t1, n)
    wi_l = np.array([np.dot(wi, t1), np.dot(wi, t2), np.dot(wi, n)],
                    np.float32)
    wo_l = np.array([np.dot(wo, t1), np.dot(wo, t2), np.dot(wo, n)],
                    np.float32)
    if wi_l[2] <= 0.0 or wo_l[2] <= 0.0:
        return np.zeros(3, np.float32)
    thetai = math.acos(min(1.0, max(-1.0, float(wi_l[2]))))
    thetao = math.acos(min(1.0, max(-1.0, float(wo_l[2]))))
    phid = (math.atan2(wo_l[1], wo_l[0]) - math.atan2(wi_l[1], wi_l[0]))
    phid = phid % (2.0 * math.pi)
    fi = thetai / (math.pi / 2.0) * nti
    fo = thetao / (math.pi / 2.0) * nto
    fp = phid / (2.0 * math.pi) * npd
    i0 = min(max(int(fi), 0), nti - 1)
    o0 = min(max(int(fo), 0), nto - 1)
    p0 = min(max(int(fp), 0), npd - 1)
    i1 = min(i0 + 1, nti - 1)
    o1 = min(o0 + 1, nto - 1)
    p1 = min(p0 + 1, npd - 1)
    wif, wof, wpf = fi - i0, fo - o0, fp - p0

    def at(i, o, p_):
        return table[(i * nto + o) * npd + p_]

    v = ((at(i0, o0, p0) * (1 - wpf) + at(i0, o0, p1) * wpf) * (1 - wof)
         + (at(i0, o1, p0) * (1 - wpf) + at(i0, o1, p1) * wpf) * wof
         ) * (1 - wif) + (
        (at(i1, o0, p0) * (1 - wpf) + at(i1, o0, p1) * wpf) * (1 - wof)
        + (at(i1, o1, p0) * (1 - wpf) + at(i1, o1, p1) * wpf) * wof) * wif
    return v.astype(np.float32)


def envmap_ke_np(envmap, n_out):
    """Dome radiance lookup; twin of scene._envmap_ke (Geometry.h:963-977)."""
    eh, ew = envmap.shape[0], envmap.shape[1]
    theta = 1.0 - math.acos(min(1.0, max(-1.0, float(n_out[1])))) / math.pi
    phi = (math.atan2(-n_out[2], n_out[0]) + math.pi) / (2.0 * math.pi)
    ti = min(max(int(theta * (eh - 1)), 0), eh - 1)
    pi_ = min(max(int(phi * (ew - 1)), 0), ew - 1)
    return envmap[ti, pi_] * np.float32(100000.0 / 255.0)


def phong_eval(kd, ks, ne, wi, wo, n):
    refl = reflect(-wo, n)
    d = np.dot(refl, wi)
    if d < 0:
        return kd / np.pi
    lobe = (d ** ne) * (ne + 2.0) / (2.0 * np.pi)
    return kd / np.pi + lobe * ks


class Obj:
    def __init__(self, kind, center=None, radius=None, point=None, normal=None,
                 flip_normals=False, kd=(1, 1, 1), ks=(0, 0, 0), ne=(1, 1, 1),
                 transp=False, refr_index=1.3, miroir=False,
                 translation=(0, 0, 0), tri_verts=None, tri_normals=None,
                 ksub=(0, 0, 0), merl=None, titopo=None):
        self.kind = kind
        self.center = (np.asarray(center if center is not None else point,
                                  np.float32)
                       if (center is not None or point is not None) else None)
        self.radius = radius
        self.normal = None if normal is None else np.asarray(normal, np.float32)
        self.flip_normals = flip_normals
        self.kd = np.asarray(kd, np.float32)
        self.ks = np.asarray(ks, np.float32)
        self.ne = np.asarray(ne, np.float32)
        self.transp = transp
        self.refr_index = refr_index
        self.miroir = miroir
        self.translation = np.asarray(translation, np.float32)
        self.tri_verts = tri_verts        # (T,3,3) for kind == 'mesh'
        self.tri_normals = tri_normals    # (T,3,3) per-corner shading normals
        self.ksub = np.asarray(ksub, np.float32)
        self.merl = merl                  # (3, TH*TD*PD/2) measured table
        self.titopo = titopo              # ((Ti*To*Pd, 3) table, dims)

    def all_intersections(self, org, dirn, tmax):
        """All hits with this object in [0, tmax): list of (t, normal)."""
        o = org - self.translation
        out = []
        if self.kind == 'sphere':
            oc = o - self.center
            b = np.dot(dirn, oc)
            a = np.dot(dirn, dirn)
            c = np.dot(oc, oc) - self.radius * self.radius
            delta = b * b - a * c
            if delta >= 0:
                sq = math.sqrt(delta)
                for t in ((-b - sq) / a, (-b + sq) / a):
                    if 0 <= t < tmax:
                        n = (o + t * dirn) - self.center
                        out.append((t, -n if self.flip_normals else n))
        elif self.kind == 'plane':
            ddot = np.dot(dirn, self.normal)
            if abs(ddot) >= 1e-9:
                t = np.dot(self.center - o, self.normal) / ddot
                if 0 <= t < tmax:
                    n = -self.normal if self.flip_normals else self.normal
                    out.append((t, n))
        else:
            for k in range(len(self.tri_verts)):
                a3, b3, c3 = self.tri_verts[k]
                u = b3 - a3
                v = c3 - a3
                nrm = np.cross(u, v)
                dn = np.dot(dirn, nrm)
                t = np.dot(a3 - o, nrm) / dn
                if not (0 <= t < tmax) or np.isnan(t):
                    continue
                pp = o + t * dirn
                w = pp - a3
                m11 = np.dot(u, u); m22 = np.dot(v, v); m12 = np.dot(u, v)
                invdet = 1.0 / (m11 * m22 - m12 * m12)
                b11 = np.dot(w, u); b21 = np.dot(w, v)
                beta = (b11 * m22 - b21 * m12) * invdet
                gamma = (b21 * m11 - b11 * m12) * invdet
                alpha = 1 - beta - gamma
                # positive acceptance: NaN barycentrics of degenerate
                # triangles must be REJECTED (kernels test beta >= 0)
                if not (beta >= 0 and gamma >= 0 and alpha >= 0):
                    continue
                if self.tri_normals is not None:
                    sn = (self.tri_normals[k, 0] * alpha
                          + self.tri_normals[k, 1] * beta
                          + self.tri_normals[k, 2] * gamma)
                else:
                    sn = nrm
                out.append((t, -sn if self.flip_normals else sn))
        return out

    def intersect(self, org, dirn):
        """Returns (t, normal_localframe) or None.  Translation-only
        transforms: intersect in object space org - translation."""
        o = org - self.translation
        if self.kind == 'sphere':
            oc = o - self.center
            b = np.dot(dirn, oc)
            a = np.dot(dirn, dirn)
            c = np.dot(oc, oc) - self.radius * self.radius
            delta = b * b - a * c
            if delta < 0:
                return None
            sq = math.sqrt(delta)
            t2 = (-b + sq) / a
            if t2 < 0:
                return None
            t1 = (-b - sq) / a
            t = t1 if t1 > 0 else t2
            p = o + t * dirn
            n = p - self.center
            if self.flip_normals:
                n = -n
            return t, n
        elif self.kind == 'plane':
            ddot = np.dot(dirn, self.normal)
            if abs(ddot) < 1e-9:
                return None
            t = np.dot(self.center - o, self.normal) / ddot
            if t <= 0:
                return None
            n = self.normal
            if self.flip_normals:
                n = -n
            return t, n
        else:  # mesh: brute force over triangles, edge-matrix test
            best_t, best_n = np.inf, None
            for k in range(len(self.tri_verts)):
                a3, b3, c3 = self.tri_verts[k]
                u = b3 - a3
                v = c3 - a3
                nrm = np.cross(u, v)
                dn = np.dot(dirn, nrm)
                t = np.dot(a3 - o, nrm) / dn
                if not (t >= 0) or np.isnan(t):
                    continue
                p = o + t * dirn
                w = p - a3
                m11 = np.dot(u, u); m22 = np.dot(v, v); m12 = np.dot(u, v)
                invdet = 1.0 / (m11 * m22 - m12 * m12)
                b11 = np.dot(w, u); b21 = np.dot(w, v)
                beta = (b11 * m22 - b21 * m12) * invdet
                if not (beta >= 0):      # NaN-rejecting (degenerate tris)
                    continue
                gamma = (b21 * m11 - b11 * m12) * invdet
                if not (gamma >= 0):
                    continue
                alpha = 1 - beta - gamma
                if not (alpha >= 0):
                    continue
                if t < best_t:
                    best_t = t
                    if self.tri_normals is not None:
                        sn = (self.tri_normals[k, 0] * alpha
                              + self.tri_normals[k, 1] * beta
                              + self.tri_normals[k, 2] * gamma)
                    else:
                        sn = nrm
                    best_n = -sn if self.flip_normals else sn
            if best_n is None:
                return None
            return best_t, best_n


class CPUScene:
    def __init__(self, objects, light_intensity, envmap_intensity=1.0,
                 fog=None, envmap=None):
        self.objects = objects
        self.light_intensity = light_intensity
        self.envmap_intensity = envmap_intensity
        self.envmap = envmap              # (He,We,3) f32 lat-long or None
        light = objects[0]
        self.center_light = light.center + light.translation
        self.radius_light = light.radius
        self.light_power = light_intensity  # scale == 1
        fog = fog or {}
        self.fog_density = fog.get('density', 0.0)
        self.fog_absorption = fog.get('absorption', 0.0)
        self.fog_density_decay = fog.get('density_decay', 0.0)
        self.fog_absorption_decay = fog.get('absorption_decay', 0.0)
        self.fog_type = fog.get('type', 0)
        self.fog_phase_type = fog.get('phase_type', 0)
        self.phase_aniso = fog.get('phase_aniso', 0.8)
        self.ground_level = float(objects[2].translation[1]) if len(objects) > 2 else 0.0
        self.fog_enabled = self.fog_density > 1e-8

    def intersection(self, org, dirn):
        best_t, best_i, best_n = np.inf, -1, None
        for i, obj in enumerate(self.objects):
            res = obj.intersect(org, dirn)
            if res is not None and res[0] < best_t:
                best_t, best_i, best_n = res[0], i, res[1]
        if best_i < 0:
            return None
        return best_t, best_i, normalize(best_n)

    def intersection_shadow(self, org, dirn, dist_light):
        for obj in self.objects:
            res = obj.intersect(org, dirn)
            if res is not None and res[0] < dist_light * 0.999:
                return True
        return False


def _int_exponential(y0, ysol, beta, s, uy):
    if abs(uy * beta) < 1e-4:
        return math.exp(-beta * (y0 - ysol)) * s
    return (math.exp(-beta * (y0 - ysol))
            - math.exp(-beta * (y0 + s * uy - ysol))) / (uy * beta)


def _fog_depth(scene, y0, uy, s):
    if scene.fog_type == 0:
        return scene.fog_absorption * s * 0.05
    return scene.fog_absorption * _int_exponential(
        y0, scene.ground_level, scene.fog_absorption_decay, s, uy)


def random_uniform_sphere(r1, r2):
    s = math.sqrt(max(0.0, r2 * (1.0 - r2)))
    return np.array([2 * math.cos(2 * math.pi * r1) * s,
                     2 * math.sin(2 * math.pi * r1) * s,
                     1 - 2 * r2], np.float32)


def fog_event(scene, org, dirn, seg_t, sample_lp, eng):
    """Twin of integrator._fog_event: same canonical draws + estimator."""
    int_ext = _fog_depth(scene, org[1], dirn[1], seg_t)
    T = math.exp(-int_ext)
    u_t = eng.next_float()
    u_choice = eng.next_float()
    u1 = eng.next_float()
    u2 = eng.next_float()
    clamped_t = min(1000.0, seg_t)

    a = np.dot(sample_lp - org, dirn)
    if a > 0:
        proj = org + a * dirn
        dd = math.sqrt(max(np.dot(sample_lp - proj, sample_lp - proj), 1e-12))
        theta_a = -math.atan2(a, dd)
        theta_b = math.atan2(seg_t - a, dd)
        random_t = dd * math.tan((1 - u_t) * theta_a + u_t * theta_b)
        proba_t = dd / ((theta_b - theta_a) * (dd * dd + random_t * random_t))
        random_t += a
    else:
        alpha_s = 5.0 / clamped_t
        cdf_max = 1.0 - math.exp(-alpha_s * clamped_t)
        random_t = -math.log(max(1.0 - u_t * cdf_max, 1e-30)) / alpha_s
        proba_t = math.exp(-alpha_s * random_t) / ((1.0 / alpha_s) * cdf_max)

    int_part = _fog_depth(scene, org[1], dirn[1], random_t)
    random_p = org + random_t * dirn
    if random_p[1] < scene.ground_level:
        return T, None
    axe_op = normalize(random_p - scene.center_light)
    if u_choice < 0.5:
        random_dir = random_uniform_sphere(u1, u2)
        is_uniform = True
    else:
        d_cos = random_cos(axe_op, u1, u2)
        point_al = d_cos * scene.radius_light + scene.center_light
        random_dir = normalize(point_al - random_p)
        is_uniform = False

    mu = np.dot(random_dir, dirn)
    if scene.fog_phase_type == 0:
        phase = 1.0 / (4 * math.pi)
    elif scene.fog_phase_type == 1:
        k = scene.phase_aniso
        phase = (1 - k * k) / (4 * math.pi * (1 + k * (-mu)))
    else:
        phase = 3.0 / (16 * math.pi) * (1 + mu * mu)

    res = scene.intersection(random_p, random_dir)
    if not is_uniform:
        point_al = d_cos * scene.radius_light + scene.center_light
        d2 = np.dot(point_al - random_p, point_al - random_p)
        if res is not None and res[0] * res[0] < d2 * 0.99:
            return T, None
    pdf_light = 0.0
    if res is not None and res[1] == 0:
        t_hit, oid, n_hit = res
        p_hit = random_p + t_hit * random_dir
        jac = np.dot(n_hit, -random_dir) / max(
            np.dot(p_hit - random_p, p_hit - random_p), 1e-12)
        jac = max(jac, 1e-9)   # grazing guard, mirrors the integrator
        pdf_light = max(0.0, np.dot(normalize(p_hit - scene.center_light),
                                    axe_op)
                        / (math.pi * scene.radius_light ** 2) / jac)
    proba_dir = 0.5 / (4 * math.pi) + 0.5 * pdf_light
    if scene.fog_type == 0:
        ext = scene.fog_density * 0.05
    else:
        ext = scene.fog_density * math.exp(
            -scene.fog_density_decay * (random_p[1] - scene.ground_level))
    w = phase * ext * math.exp(-int_part) / max(proba_t * proba_dir, 1e-30)
    if not (w > 0 and np.isfinite(w)):
        return T, None
    return T, (random_p, random_dir, w)


SS_SIGMA = 1.5
SS_DISK_R = (12.46 ** 0.5) * 1.5
SS_PROBA = 0.6


def subsurface_event(scene, obj, oid, p, n, eng):
    """Twin of integrator._subsurface_event (same canonical draws)."""
    u_r = eng.next_float()
    u_ang = eng.next_float()
    sigma = SS_SIGMA
    disk_r = SS_DISK_R
    integ = 1.0 - math.exp(-disk_r ** 2 / (2 * sigma ** 2))
    rand_r = sigma * math.sqrt(-2 * math.log(max(1 - u_r * integ, 1e-30)))
    angle = u_ang * 2 * math.pi
    gx, gy, gz = (rand_r * math.sin(angle), rand_r * math.cos(angle), rand_r)
    gaussval = (1 / (sigma * sigma * 2 * math.pi)
                * math.exp(-(gz * gz) / (2 * sigma * sigma)))
    pdfgauss = gaussval / integ
    tg = get_tangent(n)
    tg2 = np.cross(n, tg)
    pt_above = p + gx * tg + gy * tg2 + n * disk_r
    u_ax = eng.next_float()
    h = math.sqrt(max(disk_r ** 2 - gz * gz, 0.0))
    subs_org = pt_above + (disk_r - h) * (-n)
    if u_ax < 0.5:
        w_axis, tmax_p, axis = 0.5, 2 * h, -n
    else:
        w_axis = 0.25
        tmax_p = 2 * gz
        axis = tg if u_ax < 0.75 else tg2
        u_off = eng.next_float()
        if u_off < 0.5:
            subs_org = subs_org - h * n
    u_res = eng.next_float()
    cands = obj.all_intersections(subs_org, axis, tmax_p)
    if not cands:
        return None
    j = min(int(u_res * len(cands)), len(cands) - 1)
    t_sel, n_sel = cands[j]
    n_sel = normalize(n_sel)
    p2 = subs_org + t_sel * axis
    chris = math.exp(-float(np.dot(p - p2, p - p2)) / (2 * sigma * sigma))
    sumpdfs = ((0.5 * np.dot(n_sel, n)) ** 2 + (0.25 * np.dot(n_sel, tg)) ** 2
               + (0.25 * np.dot(n_sel, tg2)) ** 2)
    pdfdisk = w_axis * abs(np.dot(axis, n_sel)) / max(sumpdfs, 1e-20)
    mult = 2.0 if u_ax < 0.5 else 4.0
    factor = (pdfdisk / max(pdfgauss, 0.05) * chris * mult) * (obj.ksub / np.pi)
    new_dir = normalize(p2 - p)
    return p2 + 0.005 * n_sel, n_sel, new_dir, factor


def generate_ray(cam, i, j, dx, dy, dxa, dya, W, H):
    """Mirror of Camera::generateDirection (Vector.h:792-825), float math."""
    pos, direction, up, fov, focus = (cam['position'], cam['direction'],
                                      cam['up'], cam['fov'], cam['focus'])
    k = W / (2.0 * math.tan(fov / 2.0))
    right = np.cross(direction, up)
    if cam.get('is_lenticular'):
        # scalar twin of the interlaced multi-view branch
        # (core/camera.generate_rays; reference Vector.h:798-812,
        # including its axis-aligned-camera assumption)
        nimg = cam['lenticular_nb_images']
        el = (focus * math.tan(cam['lenticular_max_angle'] / 2.0)
              / (nimg / 2.0))
        offset = -float((int(j) // cam['lenticular_pixel_width']) % nimg
                        - nimg // 2)
        p_focus = pos + focus * np.array([0.0, 0.0, 1.0], np.float32)
        c1 = pos + offset * el * right
        v1 = normalize(p_focus - c1)
        pproj = (k / np.dot(v1, direction)) * v1 + c1
        pix_j = pproj[0] + W / 2.0 - 0.5
        pix_i = pproj[1] + H / 2.0 - 0.5
        d = np.array([(j - pix_j) + dx, (i - pix_i) + dy, k], np.float32)
    else:
        c1 = pos
        d = np.array([j - W / 2.0 + 0.5 + dx, i - H / 2.0 + 0.5 + dy, k],
                     np.float32)
    d = normalize(d)
    world = right * d[0] + up * d[1] + direction * d[2]
    dest = c1 + focus / abs(np.dot(world, direction)) * world
    new_org = c1 + dxa * right + dya * up
    new_dir = normalize(dest - new_org)
    return new_org, new_dir


def trace_path(scene: CPUScene, cam, i, j, key, cp_shift, lattice_pt,
               nb_bounces, W, H):
    """One full path with the canonical draw order (see integrator.py)."""
    eng = PCG32(key, key)
    dx = eng.next_float() - 0.5
    dy = eng.next_float() - 0.5
    dxa = (eng.next_float() - 0.5) * cam['aperture']
    dya = (eng.next_float() - 0.5) * cam['aperture']
    org, dirn = generate_ray(cam, i, j, dx, dy, dxa, dya, W, H)

    r1_cp = (cp_shift[0] + lattice_pt[0]) % 1.0
    r2_cp = (cp_shift[1] + lattice_pt[1]) % 1.0

    color = np.zeros(3, np.float32)
    weight = np.ones(3, np.float32)
    show_lights = True
    show_env = True
    had_ss = False

    for _depth in range(nb_bounces):
        if np.dot(weight, weight) < 1e-4:
            break
        res = scene.intersection(org, dirn)
        if res is None:
            break
        t, oid, n = res
        p = org + t * dirn
        obj = scene.objects[oid]
        is_diffuse = oid >= 2 and not obj.miroir and not obj.transp
        is_transp = oid >= 2 and obj.transp and not obj.miroir
        is_mirror = oid >= 2 and obj.miroir

        # --- subsurface RR + event (canonical order #0) ---
        subs_w = np.ones(3, np.float32)
        ss_now = False
        if is_diffuse and np.dot(obj.ksub, obj.ksub) > 1e-8 and not had_ss:
            u_ss = eng.next_float()
            if u_ss < SS_PROBA:
                subs_w = np.full(3, 1.0 / SS_PROBA, np.float32)
                ev = subsurface_event(scene, obj, oid, p, n, eng)
                if ev is not None:
                    p2, n2, ndir, factor = ev
                    subs_w = subs_w * factor
                    p, n = p2, n2
                    dirn_shading = ndir
                    ss_now = True
            else:
                subs_w = np.full(3, 1.0 / (1.0 - SS_PROBA), np.float32)
        if not ss_now:
            dirn_shading = dirn

        # --- NEE draws + geometry (diffuse only; canonical order #1) ---
        nee_contrib = np.zeros(3, np.float32)
        point_al = None
        if is_diffuse:
            r1 = eng.next_float()
            r2 = eng.next_float()
            axe_op = normalize(p - scene.center_light)
            dir_al = random_cos(axe_op, r1, r2)
            point_al = dir_al * scene.radius_light + scene.center_light
            to_l = point_al - p
            d2 = np.dot(to_l, to_l)
            wi = normalize(to_l)
            cos_surf = np.dot(n, wi)
            if cos_surf < 0:
                shadowed = True
            else:
                shadowed = scene.intersection_shadow(p + 0.01 * wi, wi,
                                                     math.sqrt(d2) - 0.01)
            if not shadowed:
                if ss_now:
                    f = obj.ksub / np.pi
                elif obj.merl is not None:
                    f = merl_eval_np(obj.merl, wi, -dirn_shading, n)
                elif obj.titopo is not None:
                    f = titopo_eval_np(obj.titopo[0], obj.titopo[1], wi,
                                       -dirn_shading, n)
                else:
                    f = phong_eval(obj.kd, obj.ks, obj.ne, wi,
                                   -dirn_shading, n)
                jac = np.dot(dir_al, -wi) / d2
                proba = np.dot(axe_op, dir_al) / (np.pi
                                                  * scene.radius_light ** 2)
                if proba > 0:
                    nee_contrib = (weight * subs_w * (scene.light_power
                                                      * max(0.0, cos_surf)
                                                      * jac / proba) * f)

        # --- fog event (canonical order #2: 4 draws on any hit) ---
        T = 1.0
        fog_branch = None
        if scene.fog_enabled:
            sample_lp = point_al if is_diffuse else scene.center_light
            T, fog_branch = fog_event(scene, org, dirn, t, sample_lp, eng)

        # --- color adds, fog-attenuated ---
        if oid == 1:
            # dome: envmap radiance on show_env paths (Raytracer.cpp:274-302);
            # outward normal = -n (the dome sphere has flipped normals)
            if scene.envmap is not None and show_env:
                color += (T * weight * scene.envmap_intensity
                          * envmap_ke_np(scene.envmap, -n))
        elif oid == 0:
            if show_lights:
                color += T * weight * scene.light_power
        else:
            color += T * nee_contrib

        # --- surface continuation ---
        surf = None  # (org, dir, weight, show_lights)
        if is_mirror:
            surf = (p + 0.001 * n, reflect(dirn, n), weight, show_lights, had_ss)
        elif is_transp:
            cos_in = np.dot(dirn, n)
            if cos_in > 0:
                n1, n2, n_t = obj.refr_index, 1.0, -n
            else:
                n1, n2, n_t = 1.0, obj.refr_index, n
            eta = n1 / n2
            cos_t = np.dot(n_t, dirn)
            radical = 1.0 - eta * eta * (1.0 - cos_t * cos_t)
            u = eng.next_float()   # canonical order #3
            if radical > 0:
                refr = eta * (dirn - cos_t * n_t) - n_t * math.sqrt(radical)
                r0 = ((n1 - n2) / (n1 + n2)) ** 2
                if cos_in > 0:
                    fres = r0 + (1 - r0) * max(0.0, 1.0 - np.dot(refr, n)) ** 5
                else:
                    fres = r0 + (1 - r0) * max(0.0, 1.0 + cos_in) ** 5
                if u < fres:
                    surf = (p + 0.001 * n_t, reflect(dirn, n), weight,
                            show_lights, had_ss)
                else:
                    surf = (p - 0.001 * n_t, refr, weight, show_lights, had_ss)
            else:
                surf = (p + 0.001 * n_t, reflect(dirn, n), weight, show_lights, had_ss)
        elif is_diffuse:
            r_mirror = reflect(dirn_shading, n)
            if ss_now:
                d_ind = random_cos(n, r1_cp, r2_cp)
                pdf = np.dot(n, d_ind) / np.pi
                f_ind = obj.ksub / np.pi
            elif obj.merl is not None or obj.titopo is not None:
                # measured BRDFs sample pure cosine and draw no lobe-choice
                # uniform (BRDF.h:126-131, :198-203; integrator.py gate)
                d_ind = random_cos(n, r1_cp, r2_cp)
                pdf = np.dot(n, d_ind) / np.pi
                if obj.merl is not None:
                    f_ind = merl_eval_np(obj.merl, d_ind, -dirn_shading, n)
                else:
                    f_ind = titopo_eval_np(obj.titopo[0], obj.titopo[1],
                                           d_ind, -dirn_shading, n)
            else:
                u_choice = eng.next_float()   # canonical order #4
                avg_ne = float(np.mean(obj.ne))
                pdiff = 1.0 - float(np.mean(obj.ks))
                if u_choice < pdiff:
                    d_ind = random_cos(n, r1_cp, r2_cp)
                else:
                    d_ind = random_phong(r_mirror, avg_ne, r1_cp, r2_cp)
                proba_phong = ((avg_ne + 1.0) / (2.0 * np.pi)
                               * max(0.0, np.dot(r_mirror, d_ind)) ** avg_ne)
                pdf = (pdiff * np.dot(n, d_ind) / np.pi
                       + (1.0 - pdiff) * proba_phong)
                f_ind = phong_eval(obj.kd, obj.ks, obj.ne, d_ind,
                                   -dirn_shading, n)
            if not (np.dot(d_ind, n) < 0 or np.dot(d_ind, r_mirror) < 0
                    or pdf <= 0):
                w_ind = weight * subs_w * f_ind * (np.dot(n, d_ind) / pdf)
                surf = (p + 0.01 * d_ind, d_ind, w_ind, False, had_ss or ss_now)

        # --- RR-merge surface vs fog branches (canonical order #5):
        # importance-weighted branch probability, mirroring the integrator ---
        if scene.fog_enabled:
            both = surf is not None and fog_branch is not None
            if both:
                fp, fd, fw = fog_branch
                w_fog = weight * fw
                w_surf = surf[2] * T
                lum_f = float(np.abs(w_fog).sum())
                lum_s = float(np.abs(w_surf).sum())
                p_fog = min(0.95, max(0.05,
                                      lum_f / max(lum_f + lum_s, 1e-30)))
                u_rr = eng.next_float()
            if fog_branch is not None and (surf is None
                                           or (both and u_rr < p_fog)):
                fp, fd, fw = fog_branch
                mult = (1.0 / p_fog) if both else 1.0
                org, dirn = fp, fd
                weight = weight * fw * mult
                # show_lights/show_env preserved on the fog branch
            elif surf is not None:
                mult = (1.0 / (1.0 - p_fog)) if both else 1.0
                org, dirn, w_new, show_lights, had_ss = surf
                weight = w_new * T * mult
            else:
                break
        else:
            if surf is None:
                break
            org, dirn, weight, show_lights, had_ss = surf

    return color, dx, dy


def render_cpu(scene, cam, W, H, nspp, nb_bounces, cp_table, seed=0):
    """Per-sample radiance records, (H, W, nspp, 3); mean over axis 2 = image."""
    out = np.zeros((H, W, nspp, 3), np.float32)
    for i in range(H):
        for j in range(W):
            pix = i * W + j
            for k in range(nspp):
                key = (seed << 32) | (pix * nspp + k)
                lat = extensible_lattice_2d_np(np.uint32(k))
                c, _, _ = trace_path(scene, cam, i, j, key, cp_table[pix],
                                     lat, nb_bounces, W, H)
                out[i, j, k] = c
    return out
