"""Render orchestration: wavefront launches -> film -> display image.

Replaces the reference's render_pixel grid launch (PathTrace.cu:1725-1731)
and the GL offline_render path (PathTrace.cpp:920-952): primary rays are
generated for (pixel, sample) lanes, traced in fixed-size wavefront
launches (bounded by cfg.rays_per_launch), and radiance *sums* are
accumulated into a Film so progressive preview, batch render and
checkpoint/resume all share one code path.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import camera as camera_mod
from ..core.film import Film
from ..post import tonemap
from ..ops import bruteforce, traverse
from ..utils import backend
from ..utils.config import RenderConfig
from . import wavefront


ENGINES = ("pool", "scan")
TRAVERSALS = ("sweep", "clusters", "bvh", "gemm", "brute")


def make_nearest(sd, cfg: RenderConfig, xp) -> Callable:
    """Bind a nearest-hit function to the scene (traversal choice)."""
    if cfg.traversal == "brute":
        if xp is np:
            return lambda o, d, e, **_kw: bruteforce.nearest_hit_np(
                o, d, e, sd.tri_p1, sd.tri_p2, sd.tri_p3
            )
        return lambda o, d, e, **_kw: bruteforce.nearest_hit_jnp(
            o, d, e, sd.tri_p1, sd.tri_p2, sd.tri_p3
        )
    if cfg.traversal == "bvh":
        # overflow would silently drop the near child -> wrong nearest hit
        assert cfg.bvh_stack_size >= sd.bvh_depth + 1, (
            f"bvh_stack_size={cfg.bvh_stack_size} < tree depth "
            f"{sd.bvh_depth} + 1; raise RenderConfig.bvh_stack_size"
        )
        if xp is np:
            return lambda o, d, e, **_kw: traverse.nearest_hit_bvh_np(
                o, d, e, sd, stack_size=cfg.bvh_stack_size
            )
        return lambda o, d, e, **_kw: traverse.nearest_hit_bvh_jnp(
            o, d, e, sd, stack_size=cfg.bvh_stack_size
        )
    if cfg.traversal == "gemm":
        from ..ops import gemm_intersect

        if xp is np:
            return lambda o, d, e, **_kw: gemm_intersect.nearest_hit_gemm_np(
                o, d, e, sd.tri_gemm
            )
        return lambda o, d, e, **_kw: gemm_intersect.nearest_hit_gemm_jnp(
            o, d, e, sd.tri_gemm
        )
    if cfg.traversal == "clusters":
        from ..ops import cluster_traverse

        if xp is np:
            return lambda o, d, e, **_kw: cluster_traverse.nearest_hit_clusters_np(
                o, d, e, sd
            )
        return lambda o, d, e, **_kw: cluster_traverse.nearest_hit_clusters_jnp(
            o, d, e, sd
        )
    if cfg.traversal == "sweep":
        if xp is np:  # NumPy walk of the same cluster decomposition
            from ..ops import cluster_traverse

            return lambda o, d, e, **_kw: cluster_traverse.nearest_hit_clusters_np(
                o, d, e, sd
            )
        from ..ops.pallas import cluster_sweep

        interpret = backend.kernel_interpret()
        fn = lambda o, d, e, anyhit=None: cluster_sweep.nearest_hit_sweep_jnp(
            o, d, e, sd, interpret=interpret, anyhit=anyhit
        )
        fn.supports_anyhit = True
        return fn
    raise ValueError(f"unknown traversal {cfg.traversal!r}")


@functools.partial(jax.jit, static_argnames=("cfg", "sppb"))
def render_batch(sd, eye, cam_rot, pixel_ids, sample_base, cfg: RenderConfig,
                 sppb: int):
    """Jitted launch: radiance *sum* over sppb samples for each pixel id.

    Returns [P, 3]. This is the framework's forward step — the unit the
    driver compile-checks and the mesh shards (parallel/).
    """
    p = pixel_ids.shape[0]
    pid = jnp.tile(pixel_ids, sppb)
    sid = (jnp.repeat(jnp.arange(sppb, dtype=jnp.uint32), p)
           + jnp.asarray(sample_base, jnp.uint32))
    o, d = camera_mod.generate_rays_p(
        jnp, eye, cam_rot, cfg.width, cfg.height, pid, sid, cfg.seed, cfg.jitter
    )
    nearest = make_nearest(sd, cfg, jnp)
    if cfg.integrator == "preview":
        from . import preview as preview_mod

        rad = preview_mod.trace_preview_p(
            o, d, pid, sid, sd, cfg, jnp, nearest,
            max_bounce=cfg.preview_bounces,
        )
    else:
        rad = wavefront.trace_radiance_p(o, d, pid, sid, sd, cfg, jnp,
                                         nearest)

    def fold(c):  # radiance sum over the sppb sample axis, per plane
        return c.reshape(sppb, p).sum(axis=0)

    return jnp.stack([fold(rad.x), fold(rad.y), fold(rad.z)], axis=-1)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "sppb", "chunk_px", "display"),
                   donate_argnums=(0,))
def _preview_frame(accum, sd, eye, cam_rot, sample_base, n_after,
                   cfg: RenderConfig, sppb: int, chunk_px: int,
                   display: bool = False):
    """One WHOLE progressive preview frame as a single dispatch.

    The interactive loop (cli/preview.py, reference display loop
    PathTrace.cpp:1180-1187) unrolls the chunk loop inside one jit
    (accum donated, so the film updates in place): a frame costs ONE
    dispatch and no host round trip between chunks. With ``display``
    the same dispatch also produces the tonemapped u8 frame (the
    reference's pass2/pass3 screen output, fshader_pass3.fsh) so the
    interactive loop transfers 3 bytes/pixel, not the f32 film."""
    npix = cfg.width * cfg.height
    n_chunks = -(-npix // chunk_px)
    for c in range(n_chunks):
        ids = (jnp.arange(chunk_px, dtype=jnp.uint32)
               + jnp.uint32(c * chunk_px)) % jnp.uint32(npix)
        out = render_batch(sd, eye, cam_rot, ids, sample_base, cfg, sppb)
        take = min(chunk_px, npix - c * chunk_px)
        accum = accum.at[c * chunk_px : c * chunk_px + take].add(out[:take])
    if not display:
        return accum
    rad = accum.reshape(cfg.height, cfg.width, 3)[::-1]
    rad = rad / jnp.maximum(n_after.astype(jnp.float32), 1.0)
    return accum, tonemap.finalize(rad, jnp, cfg.tonemap)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "sppb", "chunk_px", "band_px"),
                   donate_argnums=(0,))
def _preview_band_frame(accum, sd, eye, cam_rot, frame, cfg: RenderConfig,
                        sppb: int, chunk_px: int, band_px: int):
    """One BANDED progressive preview frame (cfg.preview_bands = B > 1),
    engine-generic: band ``frame % B`` gets ``sppb`` new samples at
    sample base ``(frame // B) * sppb``; the u8 display divides every
    pixel by its own sample count (derived from the frame counter).
    Display rate ~B x the full-frame rate; per-pixel sampling is
    unbiased and identical to B=1. ``accum`` is the flat [npix, 3]
    film, donated."""
    npix = cfg.width * cfg.height
    bands = npix // band_px
    band = frame % bands
    base = ((frame // bands) * sppb).astype(jnp.uint32)
    off = band * band_px
    n_chunks = -(-band_px // chunk_px)
    for c in range(n_chunks):
        take = min(chunk_px, band_px - c * chunk_px)
        ids = (jnp.arange(take, dtype=jnp.uint32) + jnp.uint32(c * chunk_px)
               + off.astype(jnp.uint32))
        out = render_batch(sd, eye, cam_rot, ids, base, cfg, sppb)
        cur = jax.lax.dynamic_slice(accum, (off + c * chunk_px, 0),
                                    (take, 3))
        accum = jax.lax.dynamic_update_slice(accum, cur + out,
                                             (off + c * chunk_px, 0))
    pband = jnp.arange(npix, dtype=jnp.int32) // band_px
    cnt = ((frame // bands + (pband <= band).astype(jnp.int32))
           * sppb).astype(jnp.float32)
    img = accum / jnp.maximum(cnt, 1.0)[:, None]
    img = img.reshape(cfg.height, cfg.width, 3)[::-1]
    return accum, tonemap.finalize(img, jnp, cfg.tonemap)


def render_film_preview_banded(sd, cam, cfg: RenderConfig, film,
                               frame_idx: int):
    """Banded progressive preview: render ONE display frame advancing
    band ``frame_idx % cfg.preview_bands``. Always returns (film, disp).
    film.count tracks the MAX per-pixel sample count."""
    npix = cfg.width * cfg.height
    if film is None:
        film = Film.create(cfg.height, cfg.width)
    band_px = npix // cfg.preview_bands
    assert band_px * cfg.preview_bands == npix, \
        "preview_bands must divide the pixel count"
    chunk_px = max(1, min(band_px, cfg.rays_per_launch // max(1, cfg.spp)))
    accum, disp = _preview_band_frame(
        film.accum.reshape(-1, 3), sd, jnp.asarray(cam.eye, jnp.float32),
        jnp.asarray(cam.camera_rotate, jnp.float32),
        jnp.int32(frame_idx), cfg, cfg.spp, chunk_px, band_px)
    count = (int(frame_idx) // cfg.preview_bands + 1) * cfg.spp
    return (Film(accum=accum.reshape(cfg.height, cfg.width, 3),
                 count=jnp.int32(count)), disp)


def render_film_preview(sd, cam, cfg: RenderConfig,
                        film: Optional[Film] = None,
                        display: bool = False,
                        frame_idx: Optional[int] = None):
    """Preview-integrator film accumulation, one dispatch per frame.

    With ``display`` returns ``(film, u8_frame)`` where the [H, W, 3] u8
    frame is computed device-side inside the final frame's dispatch.
    With cfg.preview_bands > 1 and a ``frame_idx``, renders one BANDED
    frame (render_film_preview_banded): ~B x the display rate at the
    same per-pixel sample rate."""
    npix = cfg.width * cfg.height
    if cfg.preview_bands > 1 and frame_idx is not None and display:
        return render_film_preview_banded(sd, cam, cfg, film, frame_idx)
    if film is None:
        film = Film.create(cfg.height, cfg.width)
    eye = jnp.asarray(cam.eye, jnp.float32)
    rot = jnp.asarray(cam.camera_rotate, jnp.float32)
    sppb = max(1, min(cfg.spp_batch, cfg.spp))
    chunk_px = max(1, min(npix, cfg.rays_per_launch // sppb))
    accum = film.accum.reshape(-1, 3)
    done = 0
    disp = None
    while done < cfg.spp:
        step = min(sppb, cfg.spp - done)
        last = done + step >= cfg.spp
        out = _preview_frame(accum, sd, eye, rot, film.count + done,
                             film.count + done + step, cfg, step, chunk_px,
                             display=display and last)
        accum, disp = out if display and last else (out, disp)
        done += step
    new_film = Film(accum=accum.reshape(cfg.height, cfg.width, 3),
                    count=film.count + done)
    return (new_film, disp) if display else new_film


def render_radiance_np(sd, cam, cfg: RenderConfig) -> np.ndarray:
    """NumPy end-to-end render (small sizes; shares all integrator code).

    This is *not* the independent oracle (see cpuref/) — it runs the same
    wavefront code on the NumPy backend, which pins down XLA-vs-NumPy
    divergence separately from algorithmic bugs.
    """
    npix = cfg.width * cfg.height
    pid = np.arange(npix, dtype=np.uint32)
    accum = np.zeros((npix, 3), np.float32)
    nearest = make_nearest(sd, cfg, np)
    for s in range(cfg.spp):
        o, d = camera_mod.generate_rays(
            np, cam.eye, cam.camera_rotate, cfg.width, cfg.height, pid,
            np.uint32(s), cfg.seed, cfg.jitter,
        )
        accum += wavefront.trace_radiance(
            o, d, pid, np.uint32(s), sd, cfg, np, nearest
        )
    return (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)


def render_film(
    sd,
    cam,
    cfg: RenderConfig,
    film: Optional[Film] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    rays: Optional[list] = None,
) -> Film:
    """Accumulate cfg.spp samples into a Film.

    ``rays``: a list to which the pool engine appends its useful-ray
    counts (device scalars); other engines leave it untouched.

    cfg.engine='pool' uses the respawn-compacted persistent ray pool
    (integrator/pool.py); 'scan' runs fixed wavefront launches (also the
    multi-device building block). The preview integrator always runs
    the scan form."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.engine == "pool" and cfg.integrator == "full":
        from . import pool as pool_mod

        film = pool_mod.render_film_pool(sd, cam, cfg, film=film, rays=rays)
        if progress:
            progress(cfg.spp, cfg.spp)
        return film
    if cfg.integrator == "preview":
        film = render_film_preview(sd, cam, cfg, film=film)
        if progress:
            progress(cfg.spp, cfg.spp)
        return film
    npix = cfg.width * cfg.height
    if film is None:
        film = Film.create(cfg.height, cfg.width)
    eye = jnp.asarray(cam.eye, jnp.float32)
    rot = jnp.asarray(cam.camera_rotate, jnp.float32)

    # fixed-size pixel chunks (pad the last) to avoid shape churn
    sppb = max(1, min(cfg.spp_batch, cfg.spp))
    chunk_px = max(1, min(npix, cfg.rays_per_launch // sppb))
    n_chunks = -(-npix // chunk_px)
    pad_npix = n_chunks * chunk_px
    pixel_ids = np.arange(pad_npix, dtype=np.uint32) % npix  # pad wraps

    done = 0
    accum = film.accum.reshape(-1, 3)
    while done < cfg.spp:
        step = min(sppb, cfg.spp - done)
        for c in range(n_chunks):
            ids = jnp.asarray(pixel_ids[c * chunk_px : (c + 1) * chunk_px])
            out = render_batch(sd, eye, rot, ids, film.count + done, cfg, step)
            take = min(chunk_px, npix - c * chunk_px)
            accum = accum.at[c * chunk_px : c * chunk_px + take].add(out[:take])
        done += step
        if progress:
            progress(done, cfg.spp)
    return Film(accum=accum.reshape(cfg.height, cfg.width, 3),
                count=film.count + done)


def render_image(sd, cam, cfg: RenderConfig) -> np.ndarray:
    """Full pipeline -> display u8 RGB [H, W, 3], row 0 = top.

    The film itself is bottom-up (pixel row 0 has ndc_y = -1, matching the
    reference's pixel indexing, PathTrace.cu:1431); flipping here means
    image_io.write_bmp reproduces the reference's bottom-up BMP layout
    byte-for-byte."""
    film = render_film(sd, cam, cfg)
    rad = np.asarray(film.mean())[::-1]
    return np.asarray(tonemap.finalize(rad, np, cfg.tonemap))
