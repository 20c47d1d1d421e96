"""Benchmark: jade demo scene render throughput in Mrays/s on one GPU.

Prints one JSON line per configuration. Each line names the device as
JAX reports it (platform, device kind, count) and the card's name and
power limit as ``nvidia-smi`` reports them.

Rays counted are *useful* rays: primary rays plus every NEE shadow, HDR
visibility and continuation ray of live path lanes (dead masked lanes
are excluded), matching how the reference's megakernel spends its
traversal work (SURVEY §3.3 hot loops). The timed window is whole
renders of the configuration, ended by ``block_until_ready``; the first
render (compilation included) is reported separately as set-up.

``--engine``, ``--traversal`` and ``--tris`` take comma lists; every
combination runs in this one process (one process per card). ``--all``
runs the configuration matrix (default / depth16 / 100k tris / 400k
tris / 1024x1024 preview frame rate).

    python bench.py                      # default config
    python bench.py --traversal sweep,clusters,bvh --tris 20000,400000
    python bench.py --cpu --small        # CPU rehearsal (not a GPU number)
"""

from __future__ import annotations

import argparse
import copy
import functools
import itertools
import json
import subprocess
import sys
import time

import numpy as np


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    'not available' where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--tris", default="20000")
    ap.add_argument("--spp-batch", type=int, default=4)
    ap.add_argument("--rays-per-launch", default=str(1 << 16))
    ap.add_argument("--traversal", default="sweep")
    ap.add_argument("--engine", default="pool")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed renders per configuration (best is kept)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a rehearsal, not a device number)")
    ap.add_argument("--small", action="store_true", help="tiny smoke config")
    ap.add_argument("--all", action="store_true",
                    help="run the config matrix; one JSON line per config")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_compilation_cache", False)
    dev = device_info()
    if dev["platform"] != "gpu" and not args.cpu:
        print(f"bench.py: JAX found no GPU (platform {dev['platform']!r}); "
              "pass --cpu for a CPU rehearsal", file=sys.stderr)
        return 1
    if args.small:
        args.width = args.height = 32
        args.spp = 2
        args.depth = 3
        args.tris = "2000"
    card = card_name_and_power_limit()
    print(f"# card: {card}", flush=True)

    if args.all:
        rows = [("default", {}), ("depth16", {"depth": 16}),
                ("tris100k", {"tris": "100000"}),
                ("tris400k", {"tris": "400000"})]
    else:
        rows = [("custom", {})]
    failed = 0
    for name, over in rows:
        base = copy.copy(args)
        for k, v in over.items():
            setattr(base, k, v)
        for eng, trav, tris, rpl in itertools.product(
                base.engine.split(","), base.traversal.split(","),
                base.tris.split(","), base.rays_per_launch.split(",")):
            run = copy.copy(base)
            run.engine, run.traversal = eng, trav
            run.tris, run.rays_per_launch = int(tris), int(rpl)
            try:
                res = _measure(run)
            except Exception as e:  # reported; the exit code says so
                failed += 1
                print(json.dumps(dict(
                    metric="Mrays/s", value=None, error=repr(e)[:300],
                    config=name, engine=eng, traversal=trav, tris=run.tris,
                    rays_per_launch=run.rays_per_launch, device=dev,
                    card=card)), flush=True)
                continue
            print(json.dumps(dict(
                metric="Mrays/s", value=res.pop("mrays"), unit="Mrays/s",
                config=name, engine=eng, traversal=trav, tris=run.tris,
                rays_per_launch=run.rays_per_launch, width=run.width,
                height=run.height, spp=run.spp, depth=run.depth, **res,
                device=dev, card=card)), flush=True)
    if args.all:
        for bands in (1, 4):
            fps = _measure_preview_fps(args, 1024, 1024, bands=bands)
            print(json.dumps(dict(
                metric="preview frames/s @1024x1024", value=fps,
                unit="frames/s", config=f"preview1024_band{bands}",
                device=dev, card=card)), flush=True)
    return 1 if failed else 0


def _scene(tris: int):
    import jax.numpy as jnp

    from jaderaytracerendering_tpu.models import demo
    from jaderaytracerendering_tpu.scene.scene import assemble

    ds = demo.jade_scene(n_buddha_tris=tris, env_shape=(128, 256))
    ds.camera.r = 2.2
    ds.camera.up_angle = 10.0
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    return ds, sd


def _measure_preview_fps(base, width: int, height: int, frames: int = 6,
                         bands: int = 1) -> float:
    """Frames per second of the progressive 2-bounce preview at the
    reference's window resolution, as the preview CLI runs it: one
    dispatch per frame, device-side tonemap, u8 frame to the host."""
    from jaderaytracerendering_tpu.core.film import Film
    from jaderaytracerendering_tpu.integrator import render as R
    from jaderaytracerendering_tpu.utils.config import RenderConfig

    ds, sd = _scene(20_000)
    cfg = RenderConfig(width=width, height=height, spp=1, spp_batch=1,
                       max_depth=2, rays_per_launch=1 << 18,
                       traversal=base.traversal.split(",")[0],
                       integrator="preview", preview_bands=bands)
    film = Film.create(cfg.height, cfg.width)
    film, disp = R.render_film_preview(sd, ds.camera, cfg, film=film,
                                       display=True, frame_idx=0)
    np.asarray(disp)
    t0 = time.perf_counter()
    for fi in range(1, frames + 1):
        film, disp = R.render_film_preview(sd, ds.camera, cfg, film=film,
                                           display=True, frame_idx=fi)
        np.asarray(disp)
    return frames / (time.perf_counter() - t0)


def _prepare(args):
    """Scene + jitted whole-render function of one configuration.

    Returns ``one(sample_base)`` -> device [4] f32 (samples done, pool
    loop iterations, useful rays, film checksum) and the config."""
    import jax
    import jax.numpy as jnp

    from jaderaytracerendering_tpu.core import camera as camera_mod
    from jaderaytracerendering_tpu.integrator import pool, render as R
    from jaderaytracerendering_tpu.integrator import wavefront
    from jaderaytracerendering_tpu.utils.config import RenderConfig

    ds, sd = _scene(args.tris)
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        spp_batch=args.spp_batch, max_depth=args.depth,
        rays_per_launch=args.rays_per_launch, traversal=args.traversal,
        engine=args.engine,
    )
    eye = jnp.asarray(ds.camera.eye, jnp.float32)
    rot = jnp.asarray(ds.camera.camera_rotate, jnp.float32)
    npix = cfg.width * cfg.height

    if cfg.engine == "pool":
        @functools.partial(jax.jit, static_argnames=("cfg_", "pool_m"))
        def render(sd_, eye_, rot_, total, cfg_, pool_m, base):
            film, done, n_rays, iters = pool._pool_render_impl(
                sd_, eye_, rot_, total, cfg_, pool_m, base)
            return jnp.stack([done.astype(jnp.float32),
                              iters.astype(jnp.float32), n_rays,
                              jnp.sum(film)])

        pool_m = int(min(cfg.rays_per_launch, npix * cfg.spp))

        def one(base):
            return render(sd, eye, rot, npix * cfg.spp, cfg, pool_m, base)
    else:
        @functools.partial(jax.jit, static_argnames=("sppb",))
        def launch(sd_, eye_, rot_, pixel_ids_, sample_base_, sppb):
            p = pixel_ids_.shape[0]
            pid = jnp.tile(pixel_ids_, sppb)
            sid = (jnp.repeat(jnp.arange(sppb, dtype=jnp.uint32), p)
                   + jnp.asarray(sample_base_, jnp.uint32))
            o, d = camera_mod.generate_rays(
                jnp, eye_, rot_, cfg.width, cfg.height, pid, sid, cfg.seed,
                cfg.jitter)
            nearest = R.make_nearest(sd_, cfg, jnp)
            rad, n_rays = wavefront.trace_radiance(
                o, d, pid, sid, sd_, cfg, jnp, nearest, with_stats=True)
            return jnp.sum(rad), n_rays

        sppb = cfg.spp_batch
        chunk_px = max(1, min(npix, cfg.rays_per_launch // sppb))
        n_chunks = -(-npix // chunk_px)
        ids_all = np.arange(n_chunks * chunk_px, dtype=np.uint32) % npix
        chunks = [jnp.asarray(ids_all[c * chunk_px:(c + 1) * chunk_px])
                  for c in range(n_chunks)]

        def one(base):
            sums, rays = [], []
            done = 0
            while done < cfg.spp:
                step = min(sppb, cfg.spp - done)
                for ids in chunks:
                    s, n = launch(sd, eye, rot, ids, base + done, step)
                    sums.append(s)
                    rays.append(n)
                done += step
            return jnp.stack([jnp.float32(npix * cfg.spp), jnp.float32(0),
                              sum(rays), sum(sums)])

    return one, cfg


def _measure(args) -> dict:
    """Whole renders of one configuration -> best Mrays/s and set-up."""
    t0 = time.perf_counter()
    one, cfg = _prepare(args)
    npix = cfg.width * cfg.height
    one(0).block_until_ready()
    setup = time.perf_counter() - t0
    best = None
    for rep in range(max(1, args.reps)):
        t0 = time.perf_counter()
        stats = one((rep + 1) * cfg.spp).block_until_ready()
        wall = time.perf_counter() - t0
        done, iters, rays, checksum = (float(x) for x in np.asarray(stats))
        assert np.isfinite(checksum), "non-finite film"
        assert int(done) == npix * cfg.spp, "samples lost"
        if best is None or wall < best[0]:
            best = (wall, rays, iters)
    wall, rays, iters = best
    return dict(mrays=rays / wall / 1e6, wall_s=wall, rays=rays,
                loop_iters=iters, setup_s=setup)


if __name__ == "__main__":
    sys.exit(main())
