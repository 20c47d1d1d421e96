"""Wavefront path integrator (lane-dense SoA form).

The reference's CUDA megakernel (pathTracing, PathTrace.cu:905-1416) is a
per-thread divergent loop: four material branches (diffuse / mirror /
SSS entry / SSS exit / direct refraction), nested Russian roulette, and
replay stacks of (l_dir, indir_rate) pairs composited backward at path
end (PathTrace.cu:1410-1415). Here that divergence becomes *masked
lanes*: every bounce computes all branches for all lanes and selects, and
the replay stacks become per-bounce scan outputs folded after the loop.

Layout: every per-lane quantity is a dense [M] plane; 3-vectors are
``vecmath.V3`` triples of planes. Wide-row gather outputs ([M, 16]
tri/mat/env rows) are transposed once to [16, M] so downstream reads
are contiguous rows.

Faithfulness notes (all constants/factors from the reference):

- bounce 0 re-checks emissive and breaks with l_dir = Le; combined with
  the driver's ``color = Le + pathTracing(...)`` (PathTrace.cu:1448-1451)
  primary light hits count Le twice — replicated (CUDA parity; the GLSL
  renderer does not do this);
- a path whose refraction march escapes an open surface returns 0 for
  the *whole* path, discarding its stack (PathTrace.cu:1231) — the
  ``killed`` flag replicates this;
- pdf-compensation factors: lobe select rate k = 2 for refractive
  materials (PathTrace.cu:923), 1/SSS_RATE and 1/(1-SSS_RATE)
  (PathTrace.cu:986, 1133), internal-reflection x5 / refract-out x1.25
  (PathTrace.cu:1220, 1225), mirror k/(RR/pi) (PathTrace.cu:1391);
- NEE geometric term uses the *unnormalized* light vector, giving the
  reference's |cos cos'|/d^4 * area form (PathTrace.cu:959-961);
- all random draws are site-keyed (core.rng), so the NumPy oracle in
  cpuref/ consumes identical streams.

One nearest-hit batch per bounce covers all NEE light rays, the HDR
visibility ray, and the continuation ray ([M*(E+2)] rays); the direct-
refraction march (sequential, <=32 traces) is compiled only when the
scene contains a DIR_REFRACT material (static flag).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng, vecmath as vm
from ..core.vecmath import V3, vdot, vwhere
from ..scene import envmap
from . import sampling
from .sampling import PI

S = rng.DrawSites
INF = 2147483647.0

EMIT_BREAK_EPS = 1.4e-5   # PathTrace.cu:917
EMIT_SKIP_EPS = 1.5e-4    # PathTrace.cu:1005


def _unit(v, xp):
    """Legacy row-vector unit helper (preview integrator still uses it)."""
    return vm.normalize(v, xp, eps=1e-30)


def _unit_p(v: V3, xp) -> V3:
    return vm.vnormalize(v, xp, eps=1e-30)


def _tri_mat_rows_t(sd, idx, xp):
    """Combined transposed rows: ONE [T, 32] row gather ->
    (trow_t [16, M], mrow_t [16, M])."""
    both = xp.transpose(sd.tri_mat_table[idx])
    return both[:16], both[16:]


def _nearest_planes(nearest_fn, o: V3, d: V3, excl, xp, anyhit=None):
    """Dispatch a nearest-hit query from SoA planes.

    ``anyhit=(lo, hi)`` names a row range whose caller reads only the hit
    boolean; intersectors that set ``supports_anyhit`` may stop those
    rows at their first hit."""
    o_r = vm.v3stack(o, xp)
    d_r = vm.v3stack(d, xp)
    if anyhit is not None and getattr(nearest_fn, "supports_anyhit", False):
        return nearest_fn(o_r, _unit(d_r, xp), excl, anyhit=anyhit)
    return nearest_fn(o_r, _unit(d_r, xp), excl)


def _refract_march(alive_ref, tri, miu, normal: V3, ray_src: V3, out_dir: V3,
                   sd, cfg, xp, nearest_fn, u_fn):
    """DIR_REFRACT internal march (PathTrace.cu:1180-1234), plane form.

    Returns (exit_dir V3, rate V3, escaped, last_idx, src V3). Only
    compiled when sd.has_refract.
    """
    from ..scene import scene as scene_mod

    r0 = sampling.schlick_r0(miu)
    fres_i = sampling.fresnel_entry(r0, xp.abs(vdot(normal, out_dir)))
    rdir, _ = sampling.refract_dir_p(-out_dir, normal, 1.0 / miu, xp)
    rdir = vwhere(alive_ref, rdir, 0.0, xp)  # mask non-refract lanes
    one_m = 1.0 - fres_i
    rate = V3(one_m + xp.zeros_like(one_m), one_m + xp.zeros_like(one_m),
              one_m + xp.zeros_like(one_m))
    src = ray_src
    exclude = tri
    escaped = xp.zeros(tri.shape, bool)
    exited = xp.zeros(tri.shape, bool)
    for i in range(cfg.max_refract_bounces):
        live = alive_ref & ~exited & ~escaped
        hit, idx, t = _nearest_planes(
            nearest_fn, src, rdir, xp.where(live, exclude, -2), xp)
        escaped = escaped | (live & ~hit)
        step_ok = live & hit
        rdir_u = _unit_p(rdir, xp)
        hp = src + rdir_u * t
        irow, rate_row = _tri_mat_rows_t(sd, idx, xp)
        n_i = vm.v3rows(irow, 9)                       # TRI_NORM
        new_rdir, full_reflex = sampling.refract_dir_p(rdir_u, n_i, miu, xp)
        rr8 = vm.v3rows(rate_row, 8)                   # MAT_REFRACT_RATE
        absorb = V3(rr8.x ** t, rr8.y ** t, rr8.z ** t)
        rate = vwhere(step_ok, rate * absorb, rate, xp)
        src = vwhere(step_ok, hp, src, xp)
        exclude = xp.where(step_ok, idx.astype(exclude.dtype), exclude)
        fres_o = sampling.fresnel_exit(r0, xp.abs(vdot(new_rdir, n_i)))
        u = u_fn(S.REFRACT_BASE + i)
        reflect_pick = full_reflex | (u < cfg.internal_reflect_rate)
        reflected = vm.vreflect(new_rdir, n_i)
        # exit via refraction: x1.25 compensates the 0.8 continue pdf
        rate = vwhere(step_ok & ~reflect_pick,
                      rate * (1.0 - fres_o) * 1.25, rate, xp)
        # internal (non-total) reflection: x fresnel_o x5 (PathTrace.cu:1220)
        rate = vwhere(step_ok & reflect_pick & ~full_reflex,
                      rate * fres_o * 5.0, rate, xp)
        rdir = vwhere(step_ok,
                      vwhere(reflect_pick, reflected, new_rdir, xp), rdir, xp)
        exited = exited | (step_ok & ~reflect_pick)
    return rdir, rate, escaped, exclude, src


def resolve_tail(xp, e_cnt, has_sss, has_refract, rr_rate, sss_rate,
                 ldir_list, l_ok_list, l_norms, l_emises, l_areas,
                 sky, sky_c, hdir, cdir_u,
                 nee_norm, exit_norm, bss, fr, fr_alb, emissive, c_obj_em,
                 cont_src, ref_rate, r0_sss, total_area, k, u_rr, c_t,
                 sss_entry, sss_exit, is_mirror, is_dirref, alive,
                 active, emit_break, killed, needs_nee, c_hit, h_hit,
                 ref_escaped):
    """Post-trace shading resolve: NEE light/env contributions, branch
    scales, Russian roulette acceptance, continuation rates, break
    values (bounce_step's tail — PathTrace.cu:941-1416 epilogue math).

    Plane form: every 3-vector is a V3 of [M] planes, every mask/scalar a
    flat [M] plane, so the whole tail is one elementwise dataflow XLA can
    fuse without a single padded-layout buffer. ``l_norms``/``l_emises``
    are per-light V3 of scalars, ``l_areas`` scalars.
    Returns (dir_out V3, rate_out V3, new_src V3, accept, killed).
    """
    zero = xp.zeros_like(u_rr)
    l_dir = V3(zero, zero, zero)
    for i in range(e_cnt):
        ldir = ldir_list[i]
        ok = l_ok_list[i]
        d2 = vdot(ldir, ldir)
        geom = xp.abs(
            vdot(nee_norm, ldir) * vdot(l_norms[i], ldir)
        ) / d2 / d2 * l_areas[i]
        f_entry = vwhere(sss_entry, fr_alb, fr, xp)
        contrib = l_emises[i] * f_entry * geom
        if has_sss:
            fres_o = sampling.fresnel_exit(
                r0_sss, xp.abs(vdot(_unit_p(ldir, xp), exit_norm))
            )
            contrib_exit = (
                l_emises[i] * fres_o * bss * geom / PI * total_area
            )
            contrib = vwhere(sss_exit, contrib_exit, contrib, xp)
        l_dir = l_dir + vwhere(ok, contrib, 0.0, xp)

    # ---- NEE environment (cu:968-980 / 1111-1130) ----
    cos_h = xp.abs(vdot(hdir, nee_norm))
    env_entry = (sky * vwhere(sss_entry, fr_alb, fr, xp)
                 * cos_h * (2.0 * PI))
    if has_sss:
        fres_oh = sampling.fresnel_exit(
            r0_sss, xp.abs(vdot(hdir, exit_norm))
        )
        env_exit = sky * fres_oh * bss * cos_h * 2.0  # cu:1130
        env_c = vwhere(sss_exit, env_exit, env_entry, xp)
    else:
        env_c = env_entry
    l_dir = l_dir + vwhere(needs_nee & ~h_hit, env_c, 0.0, xp)

    # ---- branch scale on l_dir (cu:986, 1133, 1322) ----
    scale = xp.where(
        sss_entry, k / sss_rate,
        xp.where(sss_exit, k / (1.0 - sss_rate), k),
    )
    l_dir = l_dir * scale
    l_dir = vwhere(needs_nee, l_dir, 0.0, xp)

    # ---- Russian roulette + continuation acceptance ----
    rr_ok = u_rr < rr_rate
    # strict (em < eps).all(), matching the oracle / reference (cu:1005
    # region; cpuref lines 141/188/273): a channel exactly AT the
    # threshold rejects continuation. max-form is boolean-identical
    # (incl. NaN propagation).
    c_nonemit = xp.maximum(xp.maximum(c_obj_em.x, c_obj_em.y),
                           c_obj_em.z) < EMIT_SKIP_EPS
    # (mirror|dirref) | c_nonemit ≡ where(mirror|dirref, True, c_nonemit)
    accept = alive & rr_ok & c_hit & ((is_mirror | is_dirref) | c_nonemit)
    killed_out = killed
    if has_refract:
        accept = accept & ~(is_dirref & ref_escaped)
        killed_out = killed | (alive & is_dirref & ref_escaped)

    cos_c = xp.abs(vdot(cdir_u, nee_norm))
    rate_diffuse = fr * cos_c / rr_rate * k  # cu:1344 (+ *k at push, 1352)
    rate_entry = fr * cos_c / rr_rate * (k / sss_rate)  # cu:1008, 1016
    if has_sss:
        fres_oc = sampling.fresnel_exit(
            r0_sss, xp.abs(vdot(cdir_u, exit_norm)))
        rate_exit = (
            bss * fres_oc * xp.abs(vdot(cdir_u, exit_norm))
            * total_area * 2.0 / rr_rate * (k / (1.0 - sss_rate))
        )  # cu:1160, 1166
    else:
        rate_exit = V3(zero, zero, zero)
    rate_mirror = fr * (k / (rr_rate / PI))  # cu:1391
    rate = vwhere(sss_entry, rate_entry, rate_diffuse, xp)
    if has_sss:
        rate = vwhere(sss_exit, rate_exit, rate, xp)
    rate = vwhere(is_mirror, rate_mirror, rate, xp)
    if has_refract:
        rate = vwhere(is_dirref, ref_rate * (k / rr_rate), rate, xp)

    # ---- break values (cu:1396, 1254) ----
    mirror_sky = sky_c * rate_mirror
    dirref_sky = sky_c * ref_rate * (k / rr_rate)
    break_val = l_dir  # diffuse / entry / exit keep their NEE sum
    zeros3 = V3(zero, zero, zero)
    break_val = vwhere(
        is_mirror & rr_ok & ~c_hit, mirror_sky,
        vwhere(is_mirror, zeros3, break_val, xp), xp,
    )
    if has_refract:
        break_val = vwhere(
            is_dirref & rr_ok & ~c_hit & ~ref_escaped, dirref_sky,
            vwhere(is_dirref, zeros3, break_val, xp), xp,
        )
    else:
        break_val = vwhere(is_dirref, zeros3, break_val, xp)
    break_val = vwhere(emit_break, emissive, break_val, xp)

    # ---- emit (dir_b, rate_b) (cu:1410-1415 stack entries) ----
    dir_out = vwhere(
        accept,
        vwhere(is_mirror | is_dirref, zeros3, l_dir, xp),
        vwhere(active, break_val, 0.0, xp), xp,
    )
    rate_out = vwhere(
        accept, rate,
        vwhere(active, 0.0, 1.0, xp), xp,
    )
    new_src = cont_src + cdir_u * c_t
    return dir_out, rate_out, new_src, accept, killed_out


import typing as _t


class FrontPre(_t.NamedTuple):
    """Precomputes for bounce_front: everything the front needs that is
    NOT pure elementwise math — RNG (one fused chain), the SSS exit pick
    + its row gathers, and the sequential refract march."""

    us: _t.Any           # [10 + 2E, M] batched per-site RNG rows
    erows_t: _t.Any      # [32, M] exit tri++mat rows (None unless has_sss)
    exit_tri: _t.Any     # [M] i32 (None unless has_sss)
    total_area: _t.Any   # [M] f32 (None unless has_sss)
    refr: _t.Any         # _refract_march outputs (None unless has_refract)


class FrontOut(_t.NamedTuple):
    """bounce_front results: masks + shading values + ray-batch pieces."""

    alive: _t.Any
    emit_break: _t.Any
    needs_nee: _t.Any
    sss_entry: _t.Any
    sss_exit: _t.Any
    is_mirror: _t.Any
    is_dirref: _t.Any
    ref_escaped: _t.Any
    k: _t.Any
    u_rr: _t.Any
    fr: V3
    fr_alb: V3
    emissive: V3
    bss: V3
    r0_sss: _t.Any
    total_area: _t.Any
    nee_norm: V3
    exit_norm: V3
    nee_src: V3
    cont_src: V3
    hdir: V3
    cdir: V3
    nee_excl: _t.Any
    cont_excl: _t.Any
    ldirs: list
    l_gates: list
    ref_rate: V3


def _branch_masks(active, u_sel, u_sss, refract_mode, reflex_mode, cfg,
                  emissive, xp):
    """Shared branch selection (PathTrace.cu:923-931): one implementation
    used by bounce_front and front_precompute (the march needs is_dirref
    before the front runs)."""
    emit_break = active & ((emissive.x > EMIT_BREAK_EPS)
                           | (emissive.y > EMIT_BREAK_EPS)
                           | (emissive.z > EMIT_BREAK_EPS))
    alive = active & ~emit_break
    take_refract = alive & (u_sel < 0.5) & (refract_mode != 0)
    is_sss = take_refract & (refract_mode == 1)
    sss_entry = is_sss & (u_sss < cfg.sss_rate)
    sss_exit = is_sss & ~(u_sss < cfg.sss_rate)
    is_dirref = take_refract & (refract_mode == 2)
    is_diffuse = alive & ~take_refract & (reflex_mode == 0)
    is_mirror = alive & ~take_refract & (reflex_mode == 1)
    return (emit_break, alive, take_refract, sss_entry, sss_exit,
            is_dirref, is_diffuse, is_mirror)


BASE_SITES = [S.SELECT_REFRACT, S.SELECT_SSS, S.AREA_CDF, S.EXIT_U,
              S.EXIT_V, S.HDR_COS, S.HDR_PHI, S.CONT_COS, S.CONT_PHI,
              S.RR]


def front_precompute(state, b, pixel_id, sample_id, tri, trow_t, mrow_t,
                     sd, cfg, xp, nearest_fn):
    """Compute FrontPre (RNG batch, SSS pick + gathers, refract march)."""
    active, ray_src, out_dir, hit_idx, killed = state
    e_cnt = sd.n_emit

    # ---- all RNG draws for this bounce in ONE [S, M] computation ----
    # The (pixel, sample) base hash is site-independent, so batching the
    # per-site mixes over a broadcast site axis yields bit-identical
    # streams in one elementwise chain; per-site reads are dense [M] rows.
    site_vals = np.asarray(
        BASE_SITES
        + [S.LIGHT_BASE + 2 * i for i in range(e_cnt)]
        + [S.LIGHT_BASE + 2 * i + 1 for i in range(e_cnt)],
        np.uint32,
    )
    def _rowb(a):  # [M] -> [1, M]; scalars broadcast as-is
        return a[None, :] if getattr(a, "ndim", 0) == 1 else a

    us = rng.uniform(xp, _rowb(pixel_id), _rowb(sample_id), _rowb(b) + 1,
                     xp.asarray(site_vals)[:, None], cfg.seed)

    erows_t = exit_tri = total_area = refr = None
    if sd.has_sss:
        import math

        obj = trow_t[12].astype(xp.int32)           # TRI_OBJ
        n_bisect = max(2, int(math.ceil(math.log2(max(sd.n_triangles, 2)))) + 1)
        if sd.sss_nb:
            # exact table-driven pick: 2 wide gathers instead of ~16
            # sequential scalar ones (see sampling.build_area_cdf_tables)
            exit_tri = sampling.area_cdf_pick_fast_p(us[2], obj, sd, xp)
        else:
            exit_tri = sampling.area_cdf_pick(
                us[2], obj, sd.prefix_area, sd.obj_total_area,
                sd.seg_begin, sd.seg_end, sd.mapping, xp, n_iters=n_bisect,
            )
        # the pick is gated on sss_exit — recompute that mask here (the
        # front recomputes it identically; both are one fused compare)
        emissive = vm.v3rows(mrow_t, 0)
        _, _, _, _, sss_exit, _, _, _ = _branch_masks(
            active, us[0], us[1], mrow_t[7].astype(xp.int32),
            mrow_t[6].astype(xp.int32), cfg, emissive, xp)
        exit_tri = xp.where(sss_exit, exit_tri, 0)
        both = xp.transpose(sd.tri_mat_table[exit_tri])
        erows_t = both
        total_area = sd.obj_total_area[both[12].astype(xp.int32)]

    if sd.has_refract:
        emissive = vm.v3rows(mrow_t, 0)
        _, _, _, _, _, is_dirref, _, _ = _branch_masks(
            active, us[0], us[1], mrow_t[7].astype(xp.int32),
            mrow_t[6].astype(xp.int32), cfg, emissive, xp)

        def u_site(site):
            return rng.uniform(xp, pixel_id, sample_id, b + 1, site,
                               cfg.seed)

        normal = vm.v3rows(trow_t, 9)
        refr = _refract_march(
            is_dirref, tri, mrow_t[14], normal, ray_src,
            out_dir, sd, cfg, xp, nearest_fn, u_site,
        )

    return FrontPre(us, erows_t, exit_tri, total_area, refr)


def bounce_front(active, ray_src, out_dir, tri, trow_t, mrow_t,
                 pre: FrontPre, light_pts, e_cnt, has_sss, has_refract,
                 cfg, xp) -> FrontOut:
    """The bounce's pre-trace ELEMENTWISE computation: branch selection,
    SSS exit shading values, direction sampling, light-point NEE
    directions. Pure function of its inputs (all per-lane planes or
    broadcastable scalars).

    ``light_pts``: list of (p1 V3, p2 V3, p3 V3) broadcastable scalar
    triples per emissive triangle."""
    us = pre.us
    m = ray_src.x.shape[-1]
    normal = vm.v3rows(trow_t, 9)                   # TRI_NORM
    emissive = vm.v3rows(mrow_t, 0)                 # MAT_EMISSIVE
    brdf = vm.v3rows(mrow_t, 3)                     # MAT_BRDF
    refract_mode = mrow_t[7].astype(xp.int32)       # MAT_REFRACT_MODE
    reflex_mode = mrow_t[6].astype(xp.int32)        # MAT_REFLEX

    # ---- branch selection (PathTrace.cu:923-925, 930-931) ----
    (emit_break, alive, take_refract, sss_entry, sss_exit, is_dirref,
     is_diffuse, is_mirror) = _branch_masks(
        active, us[0], us[1], refract_mode, reflex_mode, cfg, emissive, xp)
    k = xp.where(refract_mode != 0, 2.0, 1.0)

    fr = brdf * (1.0 / PI)
    fr_alb = vm.v3rows(mrow_t, 11) * (1.0 / PI)     # MAT_REFRACT_ALBEDO

    # ---- SSS exit point (PathTrace.cu:1029-1070) ----
    if has_sss:
        erow_t = pre.erows_t
        exit_tri = pre.exit_tri
        exit_point = sampling.triangle_point_p(
            vm.v3rows(erow_t, 0), vm.v3rows(erow_t, 3), vm.v3rows(erow_t, 6),
            us[3], us[4], xp,
        )
        exit_norm = vm.v3rows(erow_t, 9)
        inner_dir = exit_point - ray_src
        inner_dist = vm.vnorm(inner_dir, xp)
        sigma = vm.v3rows(erow_t, 16 + 8)           # MAT_REFRACT_RATE
        r0_sss = sampling.schlick_r0(mrow_t[14])    # MAT_REFRACT_INDEX
        fres_i = sampling.fresnel_entry(
            r0_sss, xp.abs(vdot(normal, out_dir))
        )
        bss = sampling.bssrdf_p(xp.maximum(inner_dist, 1e-12), sigma, xp) \
            * fres_i
        total_area = pre.total_area
    else:
        exit_tri = xp.zeros_like(tri)
        exit_point = ray_src
        exit_norm = normal
        inner_dir = out_dir
        bss = V3(xp.zeros_like(ray_src.x), xp.zeros_like(ray_src.x),
                 xp.zeros_like(ray_src.x))
        r0_sss = xp.zeros_like(ray_src.x)
        total_area = xp.ones_like(ray_src.x)

    # NEE origin/normal/exclusion: exit lanes shade from the exit point
    nee_src = vwhere(sss_exit, exit_point, ray_src, xp)
    nee_norm = vwhere(sss_exit, exit_norm, normal, xp)
    nee_excl = xp.where(sss_exit, exit_tri.astype(tri.dtype), tri)

    # ---- direct-refraction march results (precomputed; static gate) ----
    if has_refract:
        ref_dir, ref_rate, ref_escaped, ref_last, ref_src = pre.refr
    else:
        ref_dir = out_dir
        ref_rate = V3(xp.zeros_like(ray_src.x), xp.zeros_like(ray_src.x),
                      xp.zeros_like(ray_src.x))
        ref_escaped = xp.zeros_like(active)
        ref_last = tri
        ref_src = ray_src

    # ---- shadow/continuation directions ----
    # HDR NEE direction (PathTrace.cu:968-974 / 1111-1117)
    hdir_raw = sampling.uniform_sphere_p(us[5], us[6], xp)
    hdir_entry = sampling.fold_same_hemisphere_p(hdir_raw, normal, out_dir, xp)
    hdir_exit = sampling.fold_same_hemisphere_p(hdir_raw, exit_norm, inner_dir,
                                                xp)
    hdir = vwhere(sss_exit, hdir_exit, hdir_entry, xp)

    # continuation direction
    cdir_raw = sampling.uniform_sphere_p(us[7], us[8], xp)
    cdir_entry = sampling.fold_same_hemisphere_p(cdir_raw, normal, out_dir, xp)
    cdir_exit = sampling.fold_opposite_hemisphere_p(cdir_raw, exit_norm,
                                                    inner_dir, xp)
    cdir_mirror = normal * (2.0 * vdot(out_dir, normal)) - out_dir  # cu:1378
    cdir = vwhere(sss_exit, cdir_exit, cdir_entry, xp)
    cdir = vwhere(is_mirror, cdir_mirror, cdir, xp)
    if has_refract:
        cdir = vwhere(is_dirref, ref_dir, cdir, xp)
    cont_src = vwhere(is_dirref, ref_src, nee_src, xp)
    cont_excl = xp.where(is_dirref, ref_last.astype(tri.dtype), nee_excl)

    needs_nee = is_diffuse | sss_entry | sss_exit
    ldirs = []
    l_gates = []
    dot_on = vdot(out_dir, normal)
    for i in range(e_cnt):
        lp1, lp2, lp3 = light_pts[i]
        lpoint = sampling.triangle_point_p(
            lp1, lp2, lp3, us[10 + i], us[10 + e_cnt + i], xp,
        )
        ldir = lpoint - nee_src
        # entry-type hemisphere gate (PathTrace.cu:950-952); exit has none
        same_hemi = vdot(ldir, nee_norm) * dot_on >= 0
        ldirs.append(ldir)
        l_gates.append(needs_nee & (same_hemi | sss_exit))

    return FrontOut(
        alive, emit_break, needs_nee, sss_entry, sss_exit, is_mirror,
        is_dirref, ref_escaped, k, us[9], fr, fr_alb, emissive, bss,
        r0_sss, total_area, nee_norm, exit_norm, nee_src, cont_src, hdir,
        cdir, nee_excl, cont_excl, ldirs, l_gates, ref_rate,
    )


def bounce_step(state, b, pixel_id, sample_id, sd, cfg, xp, nearest_fn,
                rows=None, want_rows=False):
    """One masked megakernel bounce on SoA planes.

    ``state`` = (active [M], ray_src V3, out_dir V3, hit_idx [M] i32,
    killed [M]). Returns (state, (dir_b V3, rate_b V3)).

    ``rows=(trow_t, mrow_t)`` supplies the TRANSPOSED [16, M] per-lane
    triangle/material rows for ``where(active, hit_idx, 0)`` precomputed
    (the pool engine carries them across iterations instead of
    re-gathering them). ``want_rows=True`` appends ``(crow_t, c_mrow_t)`` — the
    continuation hit's rows — as a final returned element so the caller
    can build the next iteration's carry without another gather."""
    active, ray_src, out_dir, hit_idx, killed = state
    m = ray_src.x.shape[0]
    e_cnt = sd.n_emit

    tri = xp.where(active, hit_idx, 0)
    if rows is None:
        trow_t, mrow_t = _tri_mat_rows_t(sd, tri, xp)
    else:
        trow_t, mrow_t = rows

    pre = front_precompute(state, b, pixel_id, sample_id, tri, trow_t,
                           mrow_t, sd, cfg, xp, nearest_fn)
    lpt = lambda tbl, i: V3(tbl[i, 0], tbl[i, 1], tbl[i, 2])
    light_pts = [(lpt(sd.light_p1, i), lpt(sd.light_p2, i),
                  lpt(sd.light_p3, i)) for i in range(e_cnt)]
    f = bounce_front(active, ray_src, out_dir, tri, trow_t, mrow_t, pre,
                     light_pts, e_cnt, sd.has_sss, sd.has_refract, cfg, xp)
    (alive, emit_break, needs_nee, sss_entry, sss_exit, is_mirror,
     is_dirref, ref_escaped, k, u_rr, fr, fr_alb, emissive, bss, r0_sss,
     total_area, nee_norm, exit_norm, nee_src, cont_src, hdir, cdir,
     nee_excl, cont_excl, ldirs, l_gates, ref_rate) = f

    l_norms = [lpt(sd.light_norm, i) for i in range(e_cnt)]
    l_emises = [lpt(sd.light_emis, i) for i in range(e_cnt)]
    l_areas = [sd.light_area[i] for i in range(e_cnt)]

    # one nearest-hit batch: [M*E light] + [M hdr] + [M continuation].
    # Dead/masked lanes get zero directions: every intersector treats a
    # zero-direction ray as a miss, so dead lanes cost no traversal work
    # (their stale origins are o + d*INF garbage otherwise).
    def cat(parts):
        return xp.concatenate(parts)

    def vcat(parts):
        return V3(cat([p.x for p in parts]), cat([p.y for p in parts]),
                  cat([p.z for p in parts]))

    nee_o = vwhere(needs_nee, nee_src, 0.0, xp)
    batch_o = vcat([nee_o] * (e_cnt + 1) + [vwhere(alive, cont_src, 0.0, xp)])
    batch_d = vcat([vwhere(needs_nee, ld, 0.0, xp) for ld in ldirs]
                   + [vwhere(needs_nee, hdir, 0.0, xp),
                      vwhere(alive, cdir, 0.0, xp)])
    batch_e = cat([nee_excl] * (e_cnt + 1) + [cont_excl])
    # the HDR-visibility segment [m*e_cnt, m*e_cnt+m) is consumed as a
    # hit boolean only (h_hit below) — intersectors that advertise the
    # capability run it with a cheaper any-hit epilogue
    bhit, bidx, bt = _nearest_planes(
        nearest_fn, batch_o, batch_d, batch_e, xp,
        anyhit=(m * e_cnt, m * e_cnt + m))
    l_hits = [bhit[i * m:(i + 1) * m] for i in range(e_cnt)]
    l_idxs = [bidx[i * m:(i + 1) * m] for i in range(e_cnt)]
    h_hit = bhit[m * e_cnt: m * e_cnt + m]
    c_hit = bhit[m * e_cnt + m:]
    c_idx = bidx[m * e_cnt + m:]
    c_t = bt[m * e_cnt + m:]

    # ---- post-trace resolve: one merged env fetch, then the plane-form
    # resolve_tail (a single fused elementwise dataflow) ----
    cdir_u = _unit_p(cdir, xp)
    hdir_u = _unit_p(hdir, xp)
    env2 = envmap.sample_env_sd_p(
        sd,
        V3(cat([hdir_u.x, cdir_u.x]), cat([hdir_u.y, cdir_u.y]),
           cat([hdir_u.z, cdir_u.z])),
        xp, clamp=cfg.hdr_clamp,
    )
    sky = V3(env2.x[:m], env2.y[:m], env2.z[:m])
    sky_c = V3(env2.x[m:], env2.y[m:], env2.z[m:])

    crows_t = xp.transpose(sd.tri_mat_table[xp.where(c_hit, c_idx, 0)])
    crow_t, c_mrow_t = crows_t[:16], crows_t[16:]
    c_obj_em = vm.v3rows(c_mrow_t, 0)

    # per-light visibility: exact-index test against the nearest hit
    # (PathTrace.cu:959-961 semantics)
    l_oks = [
        l_gates[i] & l_hits[i] & (l_idxs[i] == sd.emit_idx[i])
        for i in range(e_cnt)
    ]

    dir_out, rate_out, new_src, accept, killed = resolve_tail(
        xp, e_cnt, sd.has_sss, sd.has_refract, cfg.rr_rate, cfg.sss_rate,
        ldirs, l_oks, l_norms, l_emises, l_areas, sky, sky_c, hdir, cdir_u,
        nee_norm, exit_norm, bss, fr, fr_alb, emissive, c_obj_em,
        cont_src, ref_rate, r0_sss, total_area, k, u_rr, c_t,
        sss_entry, sss_exit, is_mirror, is_dirref,
        alive, active, emit_break, killed, needs_nee,
        c_hit, h_hit, ref_escaped,
    )
    ray_src = vwhere(accept, new_src, ray_src, xp)
    out_dir = vwhere(accept, -cdir_u, out_dir, xp)
    hit_idx = xp.where(accept, c_idx.astype(hit_idx.dtype), hit_idx)
    active = accept

    new_state = (active, ray_src, out_dir, hit_idx, killed)
    if want_rows:
        return new_state, (dir_out, rate_out), (crow_t, c_mrow_t)
    return new_state, (dir_out, rate_out)


def composite(dir_ys, rate_ys, xp):
    """Backward replay-stack fold (PathTrace.cu:1410-1415), row form.

    dir_ys/rate_ys: [D, M, 3]. Init from the top entry itself (for lanes
    still alive at the depth cap the reference starts the fold from the
    last pushed l_dir — which equals the top stack entry)."""
    l = dir_ys[-1]
    d = dir_ys.shape[0]
    for i in range(d - 1, -1, -1):
        l = l * rate_ys[i] + dir_ys[i]
    return l


def composite_p(dir_ys: V3, rate_ys: V3) -> V3:
    """Plane-form composite: V3 components are [D, M] stacks."""
    l = V3(dir_ys.x[-1], dir_ys.y[-1], dir_ys.z[-1])
    d = dir_ys.x.shape[0]
    for i in range(d - 1, -1, -1):
        l = l * V3(rate_ys.x[i], rate_ys.y[i], rate_ys.z[i]) \
            + V3(dir_ys.x[i], dir_ys.y[i], dir_ys.z[i])
    return l


def trace_radiance_p(origins: V3, dirs: V3, pixel_id, sample_id, sd, cfg, xp,
                     nearest_fn, with_stats: bool = False):
    """Primary rays (SoA planes) -> radiance V3 (render_pixel body,
    cu:1426-1455).

    with_stats=True also returns the number of *useful* rays traced
    (primary + per-bounce shadow/continuation rays of live lanes) for
    Mrays/sec accounting — masked dead lanes are not counted.
    """
    m = origins.x.shape[0]
    d_unit = _unit_p(dirs, xp)
    ex0 = xp.full((m,), -1, xp.int32)
    hit0, idx0, t0 = _nearest_planes(nearest_fn, origins, d_unit, ex0, xp)
    sky0 = envmap.sample_env_sd_p(sd, d_unit, xp, clamp=cfg.hdr_clamp)
    row0_t, mrow0_t = _tri_mat_rows_t(sd, xp.where(hit0, idx0, 0), xp)
    le0 = vm.v3rows(mrow0_t, 0)

    state = (
        hit0,
        origins + d_unit * t0,
        -d_unit,
        xp.where(hit0, idx0, 0),
        xp.zeros(m, bool),
    )

    rays_per_lane = sd.n_emit + 2  # NEE lights + HDR + continuation

    if xp is jnp:
        def body(carry, b):
            st, nrays = carry
            live = jnp.sum(st[0].astype(jnp.float32))
            st, ys = bounce_step(st, b, pixel_id, sample_id, sd, cfg, jnp,
                                 nearest_fn)
            return (st, nrays + live * rays_per_lane), ys

        (state, n_rays), (dir_ys, rate_ys) = jax.lax.scan(
            body, (state, jnp.float32(m)),
            jnp.arange(cfg.max_depth, dtype=jnp.uint32),
        )
    else:
        dir_list, rate_list = [], []
        n_rays = m
        for b in range(cfg.max_depth):
            n_rays += int(state[0].sum()) * rays_per_lane
            state, (d_b, r_b) = bounce_step(
                state, np.uint32(b), pixel_id, sample_id, sd, cfg, np,
                nearest_fn,
            )
            dir_list.append(d_b)
            rate_list.append(r_b)
        dir_ys = V3(np.stack([v.x for v in dir_list]),
                    np.stack([v.y for v in dir_list]),
                    np.stack([v.z for v in dir_list]))
        rate_ys = V3(np.stack([v.x for v in rate_list]),
                     np.stack([v.y for v in rate_list]),
                     np.stack([v.z for v in rate_list]))

    li = composite_p(dir_ys, rate_ys)
    killed = state[4]
    li = vwhere(killed, 0.0, li, xp)
    radiance = vwhere(hit0, le0 + li, sky0, xp)
    if with_stats:
        return radiance, n_rays
    return radiance


def trace_radiance(origins, dirs, pixel_id, sample_id, sd, cfg, xp, nearest_fn,
                   with_stats: bool = False):
    """Row-vector wrapper around trace_radiance_p (one [M, 3] unstack at
    entry, one stack at exit — the hot engines call the plane form
    directly)."""
    out = trace_radiance_p(
        vm.v3unstack(origins), vm.v3unstack(dirs), pixel_id, sample_id, sd,
        cfg, xp, nearest_fn, with_stats=with_stats,
    )
    if with_stats:
        rad, n_rays = out
        return vm.v3stack(rad, xp), n_rays
    return vm.v3stack(out, xp)
