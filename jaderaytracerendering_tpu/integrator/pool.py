"""Persistent ray-pool renderer: wavefront with respawn compaction.

The scan-based integrator (wavefront.trace_radiance) keeps all M lanes
through every bounce even after their paths terminate; Russian roulette
plus sky misses leave most lanes dead past bounce 2. This engine keeps a
*pool* of M lanes fully utilized: each loop iteration advances every live
path one bounce, terminated paths scatter-add their radiance into the
film and the freed lanes respawn on the next (pixel, sample) from the
work queue. This is the classic production wavefront design the
reference's megakernel occupancy model approximates with SIMT residency.

Path math is identical to the scan engine — the same bounce_step with the
same site-keyed draws, now with per-lane bounce counters — so a pool
render of (pixels x spp) equals the scan render of the same samples to
float precision (tested). The replay-stack composite
(PathTrace.cu:1410-1415) becomes forward throughput accumulation:

    L += T * dir_b ; T *= rate_b

with the reference's depth-cap quirk (the fold seeds from the last pushed
l_dir) reproduced as an extra ``T * dir`` term when a lane hits
max_depth, and the refraction-escape kill zeroing the path's L.

Layout: the whole loop carry is SoA — [M] planes, vecmath.V3
triples, transposed [16, M] row tables, and a flat per-channel film.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import camera as camera_mod
from ..core.film import Film
from ..core.vecmath import V3, vwhere
from ..scene import envmap
from ..utils.config import RenderConfig
from . import render as render_mod, wavefront
from .wavefront import _nearest_planes, _tri_mat_rows_t, _unit_p


def assign_samples(fresh, next_sample, total_samples):
    """Work-queue assignment for respawning lanes: the k-th fresh lane
    (in lane order) takes sample ``next_sample + k - 1``.

    Returns (got [M] bool, sample_index [M] i32, consumed i32): lanes
    past the end of the queue get nothing."""
    k = jnp.cumsum(fresh.astype(jnp.int32))
    # int32 throughout: render_film_pool asserts < 2^31 samples/call
    sample_index = next_sample + (k - 1)
    got = fresh & (sample_index < total_samples)
    consumed = jnp.minimum(k[-1], total_samples - next_sample)
    return got, sample_index, consumed


def _pool_render_impl(sd, eye, cam_rot, total_samples, cfg: RenderConfig,
                      pool_m: int, sample_base, pixel_ids=None,
                      max_iters: int = 1_000_000):
    """Core pool loop. ``pixel_ids`` (optional [P] u32) maps local film
    slots to global pixel ids — the film-shard case (parallel/): the film
    scatter targets local slots while camera rays and RNG streams use the
    global pixel id, so sharded results equal single-device ones."""
    npix = (cfg.width * cfg.height if pixel_ids is None
            else pixel_ids.shape[0])
    nearest = render_mod.make_nearest(sd, cfg, jnp)
    m = pool_m
    # loop-invariant "empty lane" rows (triangle 0): carried rows of
    # inactive lanes must equal what a fresh where(active, hit_idx, 0)
    # gather would produce. [16, 1] columns broadcast against [16, M].
    trow0 = sd.tri_mat_table[0][:16, None]
    mrow0 = sd.tri_mat_table[0][16:, None]

    def spawn(fresh, next_sample, slot, pix, smp):
        """Assign queue samples to fresh lanes -> updated ids + masks."""
        got, sample_index, consumed = assign_samples(fresh, next_sample,
                                                     total_samples)
        new_slot = (sample_index % npix).astype(jnp.uint32)
        slot = jnp.where(got, new_slot, slot)
        if pixel_ids is None:
            pix = jnp.where(got, new_slot, pix)
        else:
            pix = jnp.where(got, pixel_ids[new_slot], pix)
        smp = jnp.where(
            got,
            (sample_index // npix).astype(jnp.uint32)
            + jnp.asarray(sample_base, jnp.uint32),
            smp,
        )
        return got, next_sample + consumed, slot, pix, smp

    def primary(pix, smp, mask):
        o, d = camera_mod.generate_rays_p(
            jnp, eye, cam_rot, cfg.width, cfg.height, pix, smp, cfg.seed,
            cfg.jitter,
        )
        d = vwhere(mask, d, 0.0, jnp)
        hit, idx, t = _nearest_planes(
            nearest, o, d, jnp.full((m,), -1, jnp.int32), jnp)
        return o, d, hit, idx, t

    # ---- packed carry ----------------------------------------------------
    # The whole state is 5 buffers: [48, M] f32 (15 state planes + the
    # two [16, M] row tables), [8, M] u32 (masks/ids/bounce counters), a
    # flat [3*(npix+1)] film (which also merges the 3 per-channel
    # scatters into one), a [4] i32 counter vector and the f32 ray
    # counter. Row slices and stacks fuse into their neighbours.
    P = npix + 1

    def unpack(fst, ust):
        src = V3(fst[0], fst[1], fst[2])
        out = V3(fst[3], fst[4], fst[5])
        t_put = V3(fst[6], fst[7], fst[8])
        l_acc = V3(fst[9], fst[10], fst[11])
        le0 = V3(fst[12], fst[13], fst[14])
        trow = fst[16:32]
        mrow = fst[32:48]
        active = ust[0] != 0
        hit_idx = ust[1].astype(jnp.int32)
        b = ust[2]
        slot, pix, smp = ust[3], ust[4], ust[5]
        return (active, src, out, hit_idx, b, t_put, l_acc, le0, slot, pix,
                smp, trow, mrow)

    def body(carry):
        fst, ust, accum, cnt, n_rays0 = carry
        (active, ray_src, out_dir, hit_idx, b, t_put, l_acc, le0, slot, pix,
         smp, trow, mrow) = unpack(fst, ust)
        next_sample, it = cnt[0], cnt[2]

        # ---- advance live paths one bounce ----
        st = (active, ray_src, out_dir, hit_idx, jnp.zeros(m, bool))
        st2, (dir_b, rate_b), (crow, c_mrow) = wavefront.bounce_step(
            st, b, pix, smp, sd, cfg, jnp, nearest, rows=(trow, mrow),
            want_rows=True,
        )
        accept, ray_src2, out_dir2, hit_idx2, killed = st2
        l_acc = l_acc + t_put * dir_b
        t_put = t_put * rate_b
        b2 = jnp.where(active, b + 1, b)
        depth_capped = accept & (b2 >= cfg.max_depth)
        # reference fold seeds from the last pushed l_dir at the cap
        l_acc = l_acc + vwhere(depth_capped, t_put * dir_b, 0.0, jnp)
        finished = (active & ~accept) | depth_capped
        still = accept & ~depth_capped

        # ---- bank finished paths ----
        l_final = vwhere(killed, 0.0, l_acc, jnp) + le0
        contrib = vwhere(finished, l_final, 0.0, jnp)
        slot_done = jnp.where(finished, slot, npix)
        zrow = jnp.zeros((1, m), jnp.float32)
        fst_cont = jnp.concatenate([
            jnp.stack([ray_src2.x, ray_src2.y, ray_src2.z,
                       out_dir2.x, out_dir2.y, out_dir2.z,
                       t_put.x, t_put.y, t_put.z,
                       l_acc.x, l_acc.y, l_acc.z,
                       le0.x, le0.y, le0.z]),
            zrow, crow, c_mrow,
        ])

        # ---- respawn freed lanes on fresh samples ----
        # cfg.spawn_rounds primary-spawn attempts per iteration: a lane
        # whose sample misses the scene retires it immediately and pulls
        # the next sample in the SAME iteration, so sky-heavy workloads
        # are not bounded by one sample per lane per loop iteration.
        fresh = ~still & ~active | finished  # idle or just finished
        started = jnp.zeros(m, bool)
        o_acc = d_acc = le_acc = V3(jnp.zeros(m, jnp.float32),
                                    jnp.zeros(m, jnp.float32),
                                    jnp.zeros(m, jnp.float32))
        p_idx_acc = jnp.zeros(m, jnp.int32)
        row0_acc = trow0 + jnp.zeros((16, m), jnp.float32)
        mrow0_acc = mrow0 + jnp.zeros((16, m), jnp.float32)
        miss_ids = []
        miss_sky = []
        n_miss = jnp.float32(0)
        n_prim = jnp.float32(0)
        for _ in range(max(1, cfg.spawn_rounds)):
            got, next_sample, slot, pix, smp = spawn(
                fresh, next_sample, slot, pix, smp)
            o, d, p_hit, p_idx, p_t = primary(pix, smp, got)
            d_u = _unit_p(d, jnp)
            sky = envmap.sample_env_sd_p(sd, d_u, jnp, clamp=cfg.hdr_clamp)
            row0, p_mrow = _tri_mat_rows_t(sd, jnp.where(p_hit, p_idx, 0),
                                           jnp)
            miss = got & ~p_hit
            st_r = got & p_hit
            miss_ids.append(jnp.where(miss, slot, npix))
            miss_sky.append(vwhere(miss, sky, 0.0, jnp))
            started = started | st_r
            o_acc = vwhere(st_r, o + d_u * p_t, o_acc, jnp)
            d_acc = vwhere(st_r, -d_u, d_acc, jnp)
            p_idx_acc = jnp.where(st_r, p_idx, p_idx_acc)
            le_acc = vwhere(st_r, V3(p_mrow[0], p_mrow[1], p_mrow[2]),
                            le_acc, jnp)
            st2d = st_r[None, :]
            row0_acc = jnp.where(st2d, row0, row0_acc)
            mrow0_acc = jnp.where(st2d, p_mrow, mrow0_acc)
            n_miss = n_miss + jnp.sum(miss.astype(jnp.float32))
            n_prim = n_prim + jnp.sum(got.astype(jnp.float32))
            fresh = fresh & ~st_r  # miss lanes stay fresh for next round

        # One flat scatter covers every channel of the finished paths and
        # all spawn rounds' sky misses: channel c lives at
        # [c*P, c*P + npix) of the flat film; row npix is the drop slot.
        ids2 = jnp.concatenate([slot_done] + miss_ids)
        ids6 = jnp.concatenate([ids2, ids2 + jnp.uint32(P),
                                ids2 + jnp.uint32(2 * P)])
        vals6 = jnp.concatenate(
            [contrib.x] + [s.x for s in miss_sky]
            + [contrib.y] + [s.y for s in miss_sky]
            + [contrib.z] + [s.z for s in miss_sky])
        accum = accum.at[ids6].add(vals6, mode="drop")
        # one merged reduction for the per-iteration counters; f32 sums
        # of 0/1 masks are exact up to 2^24 >> pool_m. n_rays is a
        # metric-only f32 counter (can exceed 2^31 on big renders, never
        # exact-compared).
        red = jnp.sum(jnp.stack(
            [finished, active], axis=0).astype(jnp.float32), axis=1)
        done = cnt[1] + (red[0] + n_miss).astype(jnp.int32)
        n_rays = n_rays0 + red[1] * (sd.n_emit + 2) + n_prim

        # ---- block-form next-carry merge: started lanes take the
        # primary block, continuing lanes the fused-tail block, idle
        # lanes the tri-0 column ----
        active = still | started
        one_m = jnp.ones((m,), jnp.float32)
        zero_m = jnp.zeros((m,), jnp.float32)
        zrow = jnp.zeros((1, m), jnp.float32)
        fst_started = jnp.concatenate([
            jnp.stack([o_acc.x, o_acc.y, o_acc.z,
                       d_acc.x, d_acc.y, d_acc.z,
                       one_m, one_m, one_m,            # t_put = 1
                       zero_m, zero_m, zero_m,         # l_acc = 0
                       le_acc.x, le_acc.y, le_acc.z]),
            zrow, row0_acc, mrow0_acc,
        ])
        fst_idle = jnp.concatenate([
            jnp.zeros((16, 1), jnp.float32), trow0, mrow0,
        ])
        st2d = started[None, :]
        cont2d = still[None, :]
        fst_n = jnp.where(st2d, fst_started,
                          jnp.where(cont2d, fst_cont, fst_idle))
        hit_idx_n = jnp.where(started, p_idx_acc, hit_idx2)
        b_n = jnp.where(started, 0, b2)
        zu = jnp.zeros((m,), jnp.uint32)
        ust_n = jnp.stack([
            active.astype(jnp.uint32), hit_idx_n.astype(jnp.uint32),
            b_n.astype(jnp.uint32), slot, pix, smp, zu, zu,
        ])
        cnt_n = jnp.stack([next_sample, done, it + 1, jnp.int32(0)])
        return (fst_n, ust_n, accum, cnt_n, n_rays)

    fst0 = jnp.concatenate([
        jnp.zeros((6, m), jnp.float32),
        jnp.ones((3, m), jnp.float32),             # t_put
        jnp.zeros((7, m), jnp.float32),            # l_acc, le0, pad
        jnp.broadcast_to(trow0, (trow0.shape[0], m)),
        jnp.broadcast_to(mrow0, (mrow0.shape[0], m)),
    ])
    init = (
        fst0,
        jnp.zeros((8, m), jnp.uint32),
        jnp.zeros((3 * P,), jnp.float32),
        jnp.zeros((4,), jnp.int32),
        jnp.float32(0),  # useful-ray counter (metric only)
    )

    def cond(carry):
        return (carry[3][1] < total_samples) & (carry[3][2] < max_iters)

    fst, ust, acc, cnt, n_rays = jax.lax.while_loop(cond, body, init)
    film = jnp.stack([acc[0:npix], acc[P:P + npix], acc[2 * P:2 * P + npix]],
                     axis=-1)
    # (film, samples done, useful rays, loop iterations) — iterations are
    # the perf diagnostic: wall time / iters is the per-bounce step cost
    return film, cnt[1], n_rays, cnt[2]


@functools.partial(jax.jit, static_argnames=("cfg", "pool_m", "max_iters"))
def _pool_render(sd, eye, cam_rot, total_samples, cfg: RenderConfig,
                 pool_m: int, sample_base, max_iters: int = 1_000_000):
    return _pool_render_impl(sd, eye, cam_rot, total_samples, cfg, pool_m,
                             sample_base, None, max_iters)


# Max pixels per pool call: the film accumulator lives in the while-loop
# carry, and XLA's in-loop scatter-add rewrites it per iteration — large
# films make every iteration film-bound (1080p measured 6x slower than
# 256^2 per sample). Tiling the film keeps the carry small.
FILM_TILE = 1 << 16


def render_film_pool(sd, cam, cfg: RenderConfig,
                     film: Optional[Film] = None,
                     rays: Optional[list] = None) -> Film:
    """Pool-compacted render of cfg.spp samples per pixel -> Film.

    ``rays``: if a list is given, each pool call appends its useful-ray
    count (a device scalar) to it."""
    npix = cfg.width * cfg.height
    if film is None:
        film = Film.create(cfg.height, cfg.width)
    eye = jnp.asarray(cam.eye, jnp.float32)
    rot = jnp.asarray(cam.camera_rotate, jnp.float32)
    # queue counters are int32 by design; one pool call must stay under
    # 2^31 samples (a 64k-pixel film tile allows spp up to ~32k)
    assert FILM_TILE * cfg.spp < 2**31, "spp too large for one pool pass"

    if npix <= FILM_TILE:
        pool_m = int(min(cfg.rays_per_launch, npix * cfg.spp))
        accum, done, n_rays, _ = _pool_render(
            sd, eye, rot, npix * cfg.spp, cfg, pool_m, film.count
        )
        if rays is not None:
            rays.append(n_rays)
        return Film(
            accum=film.accum + accum.reshape(cfg.height, cfg.width, 3),
            count=film.count + jnp.int32(cfg.spp),
        )

    # large film: fixed-size pixel tiles (last tile wraps; dup work on the
    # wrapped ids is avoided by masking their contributions out)
    out = film.accum.reshape(-1, 3)
    all_ids = np.arange(npix, dtype=np.uint32)
    for start in range(0, npix, FILM_TILE):
        end = min(start + FILM_TILE, npix)
        ids_np = all_ids[start:end]
        pad = FILM_TILE - len(ids_np)
        if pad:
            ids_np = np.concatenate([ids_np, all_ids[:pad]])
        ids = jnp.asarray(ids_np)
        total = ids.shape[0] * cfg.spp
        pool_m = int(min(cfg.rays_per_launch, total))
        accum, done, n_rays, _ = _pool_render_tiled(
            sd, eye, rot, total, cfg, pool_m, film.count, ids
        )
        if rays is not None:
            rays.append(n_rays)
        take = end - start
        out = out.at[start:end].add(accum[:take])
    return Film(accum=out.reshape(cfg.height, cfg.width, 3),
                count=film.count + jnp.int32(cfg.spp))


@functools.partial(jax.jit, static_argnames=("cfg", "pool_m", "max_iters"))
def _pool_render_tiled(sd, eye, cam_rot, total_samples, cfg: RenderConfig,
                       pool_m: int, sample_base, pixel_ids,
                       max_iters: int = 1_000_000):
    return _pool_render_impl(sd, eye, cam_rot, total_samples, cfg, pool_m,
                             sample_base, pixel_ids, max_iters)
