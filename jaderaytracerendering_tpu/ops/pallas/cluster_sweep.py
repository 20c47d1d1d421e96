"""Pallas-Triton kernel: two-level cluster sweep nearest hit.

One program owns a block of BM rays and keeps their nearest hit in
registers while it walks the scene's cluster hierarchy in BVH order:

  1. level 1: each group of G consecutive clusters (one union AABB) is
     slab-tested against the whole block; a group no live ray enters
     before its current best hit is skipped with one branch;
  2. level 2: inside an accepted group, each cluster's AABB is tested
     the same way;
  3. an accepted cluster's K triangles (rows 0-8 of its [12, K] block
     in SceneData.cluster_tris, read through L2) are tested against
     every ray of the block with Moller-Trumbore, and a min-reduction
     folds the [BM, K] tile into the block's (t, index) carry.

Clusters are visited in ascending triangle order and ties keep the
earlier (lower) index, so the result equals ops.bruteforce bit for bit
up to the fp32 rounding of the Moller-Trumbore terms. All arithmetic is
fp32 on the CUDA cores; nothing goes through the tensor cores.

Rays flagged any-hit only need a hit boolean (the HDR visibility
segment of a bounce batch): once such a ray has a hit it stops taking
part, and a block whose rays are all finished leaves the walk early.
Their index/t are those of *a* hit, not the nearest.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...core import vecmath as vm
from .. import intersect

INF = intersect.INF

# Rays per program, clusters per group box and warps per program, with
# K = 64 triangles per cluster (scene.assemble's max_cluster): the best
# of the block shapes timed end to end on the H100 at 20k and 400k
# triangles (PERF.md). Triton needs powers of two.
BLOCK_RAYS = 32
GROUP = 16
NUM_WARPS = 4


def group_boxes(aa, bb, group: int = GROUP):
    """Level-1 boxes: the union AABB of each run of ``group`` consecutive
    (BVH-ordered) clusters -> (gaa, gbb) [ceil(C/group), 3] (NumPy)."""
    n_c = len(aa)
    n_g = -(-n_c // group)
    gaa = np.zeros((n_g, 3), np.float32)
    gbb = np.zeros((n_g, 3), np.float32)
    for g in range(n_g):
        gaa[g] = np.min(aa[g * group:(g + 1) * group], axis=0)
        gbb[g] = np.max(bb[g * group:(g + 1) * group], axis=0)
    return gaa, gbb


def _slab(aa_ref, bb_ref, i, o, inv, best_t, done):
    """Rays [BM] vs AABB ``i`` of an [N, 3] box table -> wanted [BM].

    A box is wanted by a ray that is not done, crosses it in front of
    its origin, and enters it no later than its best hit. NaN axes (a
    zero direction component on a box plane) are ignored, which keeps
    the cull conservative."""
    t0 = None
    t1 = None
    for ax in range(3):
        f = (bb_ref[i, ax] - o[ax]) * inv[ax]
        n = (aa_ref[i, ax] - o[ax]) * inv[ax]
        nan = (f != f) | (n != n)
        lo = jnp.where(nan, -jnp.inf, jnp.minimum(f, n))
        hi = jnp.where(nan, jnp.inf, jnp.maximum(f, n))
        t0 = lo if t0 is None else jnp.maximum(t0, lo)
        t1 = hi if t1 is None else jnp.minimum(t1, hi)
    return (t1 >= t0) & (t1 > 0.0) & (jnp.maximum(t0, 0.0) <= best_t) & ~done


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _test_cluster(c, carry, o, d, ex, any_row, cbeg_ref, ccnt_ref, tri_ref,
                  k: int):
    """Moller-Trumbore of the block's rays against cluster ``c``'s K
    slots, same operation order as intersect.ray_triangle."""
    best_t, best_i, done = carry
    p1 = [tri_ref[c, j, :][None, :] for j in range(0, 3)]
    p2 = [tri_ref[c, j, :][None, :] for j in range(3, 6)]
    p3 = [tri_ref[c, j, :][None, :] for j in range(6, 9)]
    slot = jax.lax.broadcasted_iota(jnp.int32, (1, k), 1)
    ids = cbeg_ref[c] + slot
    e1 = [p2[j] - p1[j] for j in range(3)]
    e2 = [p3[j] - p1[j] for j in range(3)]
    dx, dy, dz = (v[:, None] for v in d)
    h = [dy * e2[2] - dz * e2[1], dz * e2[0] - dx * e2[2],
         dx * e2[1] - dy * e2[0]]
    a = (e1[0] * h[0] + e1[1] * h[1]) + e1[2] * h[2]
    f = 1.0 / a
    s = [o[j][:, None] - p1[j] for j in range(3)]
    u = f * ((s[0] * h[0] + s[1] * h[1]) + s[2] * h[2])
    q = [s[1] * e1[2] - s[2] * e1[1], s[2] * e1[0] - s[0] * e1[2],
         s[0] * e1[1] - s[1] * e1[0]]
    v = f * ((dx * q[0] + dy * q[1]) + dz * q[2])
    t = f * ((e2[0] * q[0] + e2[1] * q[1]) + e2[2] * q[2])
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & (slot < ccnt_ref[c]) & (ids != ex[:, None]) & ~done[:, None])
    t = jnp.where(ok, t, INF)
    tmin = jnp.min(t, axis=1)
    imin = jnp.min(jnp.where(t == tmin[:, None], ids, jnp.int32(2**31 - 1)),
                   axis=1)
    better = tmin < best_t
    best_t = jnp.where(better, tmin, best_t)
    best_i = jnp.where(better, imin, best_i)
    if any_row is not None:
        done = done | (any_row & (best_t < INF))
    return best_t, best_i, done


def _kernel(ray_ref, ex_ref, gaa_ref, gbb_ref, caa_ref, cbb_ref, cbeg_ref,
            ccnt_ref, tri_ref, t_ref, i_ref, *, bm: int, k: int, group: int,
            n_groups: int, n_clusters: int, has_anyhit: bool):
    o = [ray_ref[j] for j in range(3)]
    d = [ray_ref[j] for j in range(3, 6)]
    ex = ex_ref[...]
    inv = [1.0 / dj for dj in d]
    mag = (jnp.abs(d[0]) + jnp.abs(d[1])) + jnp.abs(d[2])
    done = ~(mag > 0.0)                      # zero / NaN directions miss
    any_row = ray_ref[6] > 0.0 if has_anyhit else None
    test = functools.partial(_test_cluster, o=o, d=d, ex=ex, any_row=any_row,
                             cbeg_ref=cbeg_ref, ccnt_ref=ccnt_ref,
                             tri_ref=tri_ref, k=k)

    def cluster_step(j, carry, g):
        c = g * group + j
        want = _slab(caa_ref, cbb_ref, jnp.minimum(c, n_clusters - 1), o,
                     inv, carry[0], carry[2])
        return jax.lax.cond((c < n_clusters) & _any(want),
                            lambda cr: test(c, cr),
                            lambda cr: cr, carry)

    def group_step(carry):
        g, inner = carry[0], carry[1:]
        want = _slab(gaa_ref, gbb_ref, g, o, inv, inner[0], inner[2])
        inner = jax.lax.cond(
            _any(want),
            lambda cr: jax.lax.fori_loop(
                0, group, functools.partial(cluster_step, g=g), cr),
            lambda cr: cr, inner)
        return (g + 1,) + inner

    def more(carry):
        return (carry[0] < n_groups) & _any(~carry[3])

    init = (jnp.int32(0), jnp.full((bm,), INF, jnp.float32),
            jnp.zeros((bm,), jnp.int32), done)
    _, best_t, best_i, _ = jax.lax.while_loop(more, group_step, init)
    t_ref[...] = best_t
    i_ref[...] = best_i


@functools.partial(jax.jit, static_argnames=("interpret", "has_anyhit", "bm",
                                             "num_warps"))
def nearest_hit_rays(rays, exclude, sd, interpret=False, has_anyhit=False,
                     bm=BLOCK_RAYS, num_warps=NUM_WARPS):
    """Kernel entry on packed rays: ``rays`` [8, M] f32 rows (ox, oy, oz,
    dx, dy, dz, anyhit flag, unused) with unit (or zero) directions,
    ``exclude`` [M] i32. Rows whose flag is > 0 stop at their first hit
    (read only when ``has_anyhit``). Returns (hit [M], index [M] i32,
    t [M] f32)."""
    m = rays.shape[1]
    if sd.n_clusters == 0:
        return (jnp.zeros((m,), bool), jnp.zeros((m,), jnp.int32),
                jnp.full((m,), INF, jnp.float32))
    pad = (-m) % bm
    if pad:
        rays = jnp.concatenate([rays, jnp.zeros((8, pad), rays.dtype)], 1)
        exclude = jnp.concatenate(
            [exclude, jnp.full((pad,), -1, exclude.dtype)])
    mp = m + pad
    kern = functools.partial(
        _kernel, bm=bm, k=sd.cluster_k, group=sd.cluster_group,
        n_groups=sd.cluster_group_aa.shape[0], n_clusters=sd.n_clusters,
        has_anyhit=has_anyhit)
    whole = pl.BlockSpec()
    t, idx = pl.pallas_call(
        kern,
        grid=(mp // bm,),
        in_specs=[pl.BlockSpec((8, bm), lambda i: (0, i)),
                  pl.BlockSpec((bm,), lambda i: (i,)),
                  whole, whole, whole, whole, whole, whole, whole],
        out_specs=[pl.BlockSpec((bm,), lambda i: (i,)),
                   pl.BlockSpec((bm,), lambda i: (i,))],
        out_shape=[jax.ShapeDtypeStruct((mp,), jnp.float32),
                   jax.ShapeDtypeStruct((mp,), jnp.int32)],
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        name="cluster_sweep",
    )(rays, exclude.astype(jnp.int32), sd.cluster_group_aa,
      sd.cluster_group_bb, sd.cluster_aa, sd.cluster_bb, sd.cluster_begin,
      sd.cluster_count, sd.cluster_tris)
    t, idx = t[:m], idx[:m]
    hit = t < INF
    return hit, jnp.where(hit, idx, 0), t


def pack_rays(o: vm.V3, d: vm.V3, xp=jnp, anyhit=None):
    """SoA planes -> the kernel's [8, M] ray rows. ``anyhit=(lo, hi)``
    flags rows lo..hi-1 as any-hit rows."""
    z = xp.zeros_like(o.x)
    flag = z
    if anyhit is not None:
        row = xp.arange(o.x.shape[0])
        flag = ((row >= anyhit[0]) & (row < anyhit[1])).astype(o.x.dtype)
    return xp.stack([o.x, o.y, o.z, d.x, d.y, d.z, flag, z])


@functools.partial(jax.jit, static_argnames=("interpret", "anyhit"))
def nearest_hit_sweep_jnp(origins, dirs, exclude, sd, interpret=False,
                          anyhit=None):
    """Row-vector entry, same contract as ops.bruteforce.nearest_hit_jnp:
    origins/dirs [M, 3] (dirs normalized here), exclude [M] i32.
    ``anyhit=(lo, hi)``: a static row range whose caller reads only the
    hit flag (its index/t are those of *a* hit)."""
    d = vm.normalize(dirs, jnp)
    rays = pack_rays(vm.v3unstack(origins), vm.v3unstack(d), anyhit=anyhit)
    return nearest_hit_rays(rays, exclude, sd, interpret=interpret,
                            has_anyhit=anyhit is not None)
