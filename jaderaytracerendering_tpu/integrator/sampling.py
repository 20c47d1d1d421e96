"""Sampling primitives shared by the wavefront integrator and CPU oracle.

Each helper reproduces one sampling idiom of the reference megakernel
(PathTrace.cu:905-1416) exactly — including its quirks, which are load-
bearing for CPU-vs-GPU parity:

- uniform sphere directions from (cos_theta, phi) draws
  (PathTrace.cu:968-971);
- triangle point sampling with the u+v>1 fold (PathTrace.cu:936-941);
- hemisphere folding by sign product tests (PathTrace.cu:972-974);
- Schlick Fresnel: entry form R0 + (1-R0)(1-c)^5 (PathTrace.cu:1069) and
  the reference's *exit* form R0 - (1-R0)(1-c)^5 (PathTrace.cu:1102,
  1127, 1157, 1212 — note the minus sign; kept verbatim for parity);
- the dipole-style BSSRDF (e^{-d/s} + e^{-d/(3s)}) / (s * 8 pi d)
  (PathTrace.cu:1062-1063);
- Cg-style refraction with total-internal-reflection flag
  (gen_refract_ray, PathTrace.cu:876-894);
- the per-object area-CDF binary search for BSSRDF exit points
  (PathTrace.cu:1031-1048), vectorized as a masked fixed-iteration
  bisection (data-dependent loops can't live under jit).
"""

from __future__ import annotations

from ..core import rng, vecmath as vm

PI = 3.1415926  # the reference's PI (PathTrace.cu:36)


def uniform_sphere(u_cos, u_phi, xp):
    """Unit direction from two U[0,1) draws (PathTrace.cu:968-971)."""
    cos_t = 2.0 * (u_cos - 0.5)
    sin_t = xp.sqrt(xp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * PI * u_phi
    return xp.stack([sin_t * xp.cos(phi), sin_t * xp.sin(phi), cos_t], axis=-1)


def fold_same_hemisphere(d, normal, reference, xp):
    """Flip d so sign(d.n) == sign(reference.n) (PathTrace.cu:972-974)."""
    flip = vm.dot(d, normal, xp) * vm.dot(reference, normal, xp) < 0
    return xp.where(flip, -d, d)


def fold_opposite_hemisphere(d, normal, reference, xp):
    """Flip d so sign(d.n) != sign(reference.n) (PathTrace.cu:1140-1142)."""
    flip = vm.dot(d, normal, xp) * vm.dot(reference, normal, xp) > 0
    return xp.where(flip, -d, d)


def triangle_point(p1, p2, p3, u, v, xp):
    """Uniform point via folded barycentrics (PathTrace.cu:936-945)."""
    over = u + v > 1.0
    u = xp.where(over, 1.0 - u, u)
    v = xp.where(over, 1.0 - v, v)
    return p1 + (p2 - p1) * u[..., None] + (p3 - p1) * v[..., None]


def schlick_r0(ior, xp=None):
    """R0 = ((ior-1)/(ior+1))^2 (PathTrace.cu:1066, 1184)."""
    r = (ior - 1.0) / (ior + 1.0)
    return r * r


def fresnel_entry(r0, cos_abs):
    """R0 + (1-R0)(1-|c|)^5 (PathTrace.cu:1067-1069)."""
    oc = 1.0 - cos_abs
    oc2 = oc * oc
    return r0 + (1.0 - r0) * oc2 * oc2 * oc


def fresnel_exit(r0, cos_abs):
    """R0 - (1-R0)(1-|c|)^5 — the reference's sign (PathTrace.cu:1100-1102)."""
    oc = 1.0 - cos_abs
    oc2 = oc * oc
    return r0 - (1.0 - r0) * oc2 * oc2 * oc


def bssrdf(dist, sigma, xp):
    """Dipole-style profile (PathTrace.cu:1062-1063).

    (e^{-d/sigma} + e^{-(d/3)/sigma}) / (sigma * 8 pi d), componentwise
    over the 3-channel sigma (= material refract_rate). dist [...]
    unsqueezed against sigma [..., 3].
    """
    d = dist[..., None]
    return (xp.exp(-d / sigma) + xp.exp(-(d / 3.0) / sigma)) / (
        sigma * (8.0 * PI) * d
    )


def refract_dir(d_in, normal, eta, xp):
    """Cg-style refraction (gen_refract_ray, PathTrace.cu:876-894).

    d_in points *into* the surface. Returns (dir, full_reflex): on total
    internal reflection the reference returns d_in unchanged and sets the
    flag. All lanes computed, selected by mask.
    """
    cosi = vm.dot(d_in, normal, xp)
    n = xp.where(cosi > 0, -normal, normal)
    cosi = xp.abs(cosi)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    full_reflex = cost2[..., 0] <= 0
    safe = xp.sqrt(xp.maximum(cost2, 0.0))
    refracted = d_in * eta + n * (eta * cosi - safe)
    return xp.where(full_reflex[..., None], d_in, refracted), full_reflex


def area_cdf_pick(u, obj_id, prefix_area, obj_total_area, seg_begin, seg_end,
                  mapping, xp, n_iters: int = 32):
    """Pick an exit triangle on the object by area (PathTrace.cu:1031-1048).

    Reproduces the reference's bisection over the load-order prefix-sum
    table: left/right start at the object's segment bounds, loop while
    left < right-1 moving toward the target, and the *final middle* is
    taken (then translated through mapping to the BVH-sorted index). A
    fixed iteration count replaces the data-dependent while loop; 32
    halvings cover any segment length < 2^32.
    """
    target = u * obj_total_area[obj_id]
    left = seg_begin[obj_id]
    right = seg_end[obj_id]
    middle = xp.zeros_like(left)
    for _ in range(n_iters):
        go = left < right - 1
        m = (left + right) // 2
        middle = xp.where(go, m, middle)
        le = target <= prefix_area[m]
        right = xp.where(go & le, m, right)
        # reference uses `else if (>=)`: strict complement except equality,
        # where the first branch wins
        left = xp.where(go & ~le, m, left)
    return mapping[middle]


# ---- table-driven exact replacement for area_cdf_pick ------------------
#
# Every comparison the bisection makes is `target <= prefix[m]`, which
# (prefix is monotone within a segment) equals `j <= m` for
# j = min{i : prefix[i] >= target}. The whole search path — and so the
# quirky "final middle" result — is therefore a pure integer function
# F(clip(j, l0+1, r0)) of j that can be simulated per triangle at
# assembly time. At trace time only j is data-dependent, and it resolves
# with TWO wide gathers instead of ~16 sequential scalar ones:
#   1. a per-object bucket table over u in [0,1): floor(u * NB) is exact
#      for NB a power of two, giving a [jlo, jhi] bracket of width <= 15
#      (NB is grown at build time until that holds);
#   2. one row of a sliding-window table holding the <=15 candidate
#      prefix values plus the precomputed mapping[F(j)] answers; a masked
#      compare-count picks j and a one-hot dot picks the answer.

CDF_WINDOW = 16


def build_area_cdf_tables(prefix_area, obj_total_area, seg_begin, seg_end,
                          mapping, nb: int = 1 << 7, nb_max: int = 1 << 24):
    """Host-side (numpy) tables for area_cdf_pick_fast.

    Bucket counts are PER OBJECT: each object independently escalates its
    power-of-two count until every bucket brackets within the CDF window.
    A 400k-tri buddha needs ~2^22 buckets (adjacent f32 prefix values
    leave ~40 triangles per 2^20-wide bucket) while the floor quad needs
    2^7, so a uniform count would waste O(n_obj * max_nb) table memory —
    the uniform-NB version capped at 2^20 and DISABLED the fast path (and
    with it megakernel eligibility) on 400k-tri SSS scenes.

    Returns (bucket [sum nb_o, 2] int32, window [T, 32] float32,
    nbs [O] int32, bases [O] int32), or (None, None, None, None) if any
    object defeats bucketing below nb_max (pathological distributions)."""
    import numpy as np

    p = np.asarray(prefix_area, np.float32)
    total = np.asarray(obj_total_area, np.float32)
    seg_begin = np.asarray(seg_begin, np.int64)
    seg_end = np.asarray(seg_end, np.int64)
    t_cnt = len(p)
    n_obj = len(total)
    assert t_cnt < (1 << 24), "window table stores ids as f32"

    # --- F(j): simulate the integer bisection per object, all j at once
    exit_sorted = np.zeros(t_cnt + 1, np.int32)  # indexed by global j
    mapping = np.asarray(mapping, np.int32)
    for o in range(n_obj):
        l0, r0 = int(seg_begin[o]), int(seg_end[o])
        jc = np.arange(l0 + 1, r0 + 1, dtype=np.int64)  # clipped j range
        left = np.full_like(jc, l0)
        right = np.full_like(jc, r0)
        middle = np.zeros_like(jc)
        while True:
            go = left < right - 1
            if not go.any():
                break
            m = (left + right) // 2
            middle = np.where(go, m, middle)
            le = jc <= m
            right = np.where(go & le, m, right)
            left = np.where(go & ~le, m, left)
        if r0 > l0:
            exit_sorted[l0 + 1 : r0 + 1] = mapping[middle]
        # j == l0 can't occur (target > 0 = prefix "before" the segment),
        # but keep the clip-low answer defined anyway
        exit_sorted[l0] = mapping[middle[0]] if r0 > l0 else mapping[0]

    # --- per-object j at the f32 bucket edges, per-object bucket counts
    parts = []
    nbs = np.zeros(n_obj, np.int64)
    for o in range(n_obj):
        l0, r0 = int(seg_begin[o]), int(seg_end[o])
        seg = p[l0 : r0 + 1]
        def attempt(nb_o):
            edges = np.arange(nb_o + 1, dtype=np.float64) / nb_o
            lo_u = edges[:-1].astype(np.float32)
            hi_u = np.nextafter(edges[1:].astype(np.float32),
                                np.float32(0.0), dtype=np.float32)
            t_lo = (lo_u * total[o]).astype(np.float32)
            t_hi = (hi_u * total[o]).astype(np.float32)
            jlo = l0 + np.searchsorted(seg, t_lo, side="left")
            jhi = l0 + np.searchsorted(seg, t_hi, side="left")
            jlo = np.clip(jlo, l0 + 1, r0)
            jhi = np.clip(jhi, l0 + 1, r0)
            ok = (jhi - jlo).max(initial=0) <= CDF_WINDOW - 1
            return ok, jlo, jhi

        nb_o = nb
        while True:
            ok, jlo, jhi = attempt(nb_o)
            if ok:
                break
            nb_o *= 4
            if nb_o > nb_max:
                return None, None, None, None
        if nb_o > nb:
            # x4 escalation can overshoot by one power of two (64 MB on
            # a 400k-tri object); one halving probe recovers it
            ok2, jlo2, jhi2 = attempt(nb_o // 2)
            if ok2:
                nb_o, jlo, jhi = nb_o // 2, jlo2, jhi2
        nbs[o] = nb_o
        parts.append(np.stack([jlo, jhi], axis=1).astype(np.int32))
    bases = np.concatenate([[0], np.cumsum(nbs)[:-1]]).astype(np.int64)
    bucket = np.concatenate(parts) if parts else np.zeros((0, 2), np.int32)
    # the mega kernel extracts bucket rows via f32 one-hot sums and the
    # stream mode DMAs f32-packed rows — flat ids must stay f32-exact
    assert bucket.shape[0] < (1 << 24), "bucket ids stored as f32 in mega"

    # --- sliding windows: prefix values + pre-clipped answers per j
    win = np.zeros((t_cnt, 2 * CDF_WINDOW), np.float32)
    pad_p = np.concatenate([p, np.full(CDF_WINDOW, np.inf, np.float32)])
    pad_a = np.concatenate(
        [exit_sorted, np.zeros(CDF_WINDOW, np.int32)]
    ).astype(np.float32)
    for k in range(CDF_WINDOW):
        win[:, k] = pad_p[k : k + t_cnt]
        win[:, CDF_WINDOW + k] = pad_a[k : k + t_cnt]
    return bucket, win, nbs.astype(np.int32), bases.astype(np.int32)


# ---- lane-dense (SoA plane) variants ---------------------------------------
#
# Identical math to the [..., 3] forms above, on vecmath.V3 component
# planes: per-component elementwise ops in the same association order, so
# results are bit-compatible with the row-vector forms (which remain the
# oracle-facing API). The integrator's hot path runs entirely on planes
# to keep XLA layouts dense.

from ..core.vecmath import V3, vdot, vwhere


def uniform_sphere_p(u_cos, u_phi, xp) -> V3:
    """Plane form of uniform_sphere (PathTrace.cu:968-971)."""
    cos_t = 2.0 * (u_cos - 0.5)
    sin_t = xp.sqrt(xp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * PI * u_phi
    return V3(sin_t * xp.cos(phi), sin_t * xp.sin(phi), cos_t)


def fold_same_hemisphere_p(d: V3, normal: V3, reference: V3, xp) -> V3:
    flip = vdot(d, normal) * vdot(reference, normal) < 0
    return vwhere(flip, -d, d, xp)


def fold_opposite_hemisphere_p(d: V3, normal: V3, reference: V3, xp) -> V3:
    flip = vdot(d, normal) * vdot(reference, normal) > 0
    return vwhere(flip, -d, d, xp)


def triangle_point_p(p1: V3, p2: V3, p3: V3, u, v, xp) -> V3:
    """Plane form of triangle_point (PathTrace.cu:936-945)."""
    over = u + v > 1.0
    u = xp.where(over, 1.0 - u, u)
    v = xp.where(over, 1.0 - v, v)
    return V3(p1.x + (p2.x - p1.x) * u + (p3.x - p1.x) * v,
              p1.y + (p2.y - p1.y) * u + (p3.y - p1.y) * v,
              p1.z + (p2.z - p1.z) * u + (p3.z - p1.z) * v)


def bssrdf_p(dist, sigma: V3, xp) -> V3:
    """Plane form of bssrdf (PathTrace.cu:1062-1063); dist is a plane."""
    def chan(s):
        return (xp.exp(-dist / s) + xp.exp(-(dist / 3.0) / s)) / (
            s * (8.0 * PI) * dist
        )

    return V3(chan(sigma.x), chan(sigma.y), chan(sigma.z))


def refract_dir_p(d_in: V3, normal: V3, eta, xp):
    """Plane form of refract_dir (gen_refract_ray, PathTrace.cu:876-894)."""
    cosi = vdot(d_in, normal)
    n = vwhere(cosi > 0, -normal, normal, xp)
    cosi = xp.abs(cosi)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    full_reflex = cost2 <= 0
    safe = xp.sqrt(xp.maximum(cost2, 0.0))
    refracted = d_in * eta + n * (eta * cosi - safe)
    return vwhere(full_reflex, d_in, refracted, xp), full_reflex


def area_cdf_pick_fast_p(u, obj_id, sd, xp):
    """area_cdf_pick_fast on planes with transposed row fetches: the
    [M, 2]/[M, 32] gather outputs are transposed to [2, M]/[32, M] so
    every downstream read is a contiguous row."""
    nbv = sd.sss_bnb[obj_id]                              # [M] i32
    b = xp.clip((u * nbv.astype(xp.float32)).astype(xp.int32), 0, nbv - 1)
    brow = xp.transpose(sd.sss_bucket[sd.sss_bbase[obj_id] + b])  # [2, M]
    jlo, jhi = brow[0], brow[1]
    target = u * sd.obj_total_area[obj_id]
    wrow = xp.transpose(sd.sss_window[jlo])               # [32, M]
    width = jhi - jlo
    cnt = xp.zeros_like(jlo)
    for k in range(CDF_WINDOW):
        cnt = cnt + ((k < width) & (wrow[k] < target)).astype(jlo.dtype)
    picked = xp.zeros_like(target)
    for k in range(CDF_WINDOW):
        picked = picked + xp.where(cnt == k, wrow[CDF_WINDOW + k], 0.0)
    return picked.astype(xp.int32)


def area_cdf_pick_fast(u, obj_id, sd, xp):
    """Exact table-driven area_cdf_pick (see build_area_cdf_tables)."""
    nbv = sd.sss_bnb[obj_id]                            # [M] i32
    b = xp.clip((u * nbv.astype(xp.float32)).astype(xp.int32), 0, nbv - 1)
    brow = sd.sss_bucket[sd.sss_bbase[obj_id] + b]      # [M, 2]
    jlo, jhi = brow[..., 0], brow[..., 1]
    target = u * sd.obj_total_area[obj_id]
    wrow = sd.sss_window[jlo]                           # [M, 32]
    k = xp.arange(CDF_WINDOW, dtype=xp.int32)
    # j = jlo + #(prefix[i] < target) for i in [jlo, jhi); window col k
    # holds prefix[jlo + k]
    cnt = xp.sum(
        ((k[None, :] < (jhi - jlo)[..., None])
         & (wrow[..., :CDF_WINDOW] < target[..., None])).astype(xp.int32),
        axis=-1,
    )
    picked = xp.sum(
        xp.where(k[None, :] == cnt[..., None],
                 wrow[..., CDF_WINDOW:], 0.0),
        axis=-1,
    )
    return picked.astype(xp.int32)
