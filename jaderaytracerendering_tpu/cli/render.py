"""Batch renderer CLI — the PathTrace.cu main equivalent.

Consumes a scene (render_args.txt from the preview's F command, a JSON
spec, or a named demo scene), renders width x height at the requested
spp, and writes the image (default RenderResult.bmp, after the
reference's RenderResultCuda.bmp, PathTrace.cu:76).

    python -m jaderaytracerendering_tpu.cli.render \
        --render-args render_args.txt --spp 256 --out out.bmp

Several GPUs: --mesh TILExSPP (e.g. --mesh 2x2) shards film tiles and
the sample axis over the available devices.
"""

from __future__ import annotations

import argparse
import time

from . import common


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="jade-render")
    common.add_common_args(ap)
    ap.add_argument("--out", default="RenderResult.bmp")
    ap.add_argument("--mesh", help="device mesh TILExSPP, e.g. 2x2")
    ap.add_argument("--save-film", dest="save_film",
                    help="checkpoint the raw film (npz) for resume")
    ap.add_argument("--resume-film", dest="resume_film",
                    help="resume accumulation from a film checkpoint")
    args = ap.parse_args(argv)
    common.select_backend(args)

    import jax.numpy as jnp
    import numpy as np

    from ..core.film import Film
    from ..integrator import render as R
    from ..post import image_io, tonemap
    from ..scene.scene import assemble
    from ..utils.logging import stage

    objects, env, cam = common.load_scene(args)
    cfg = common.config_from_args(args)
    sd = assemble(objects, env, leaf_size=cfg.bvh_leaf_size, xp=jnp)
    stage(f"scene: {sd.n_triangles} triangles, {sd.n_nodes} BVH nodes, "
          f"{sd.n_emit} emissive")

    film = Film.load(args.resume_film) if args.resume_film else None
    rays = []
    t0 = time.perf_counter()
    if args.mesh:
        from ..parallel import sharding

        t, s = (int(x) for x in args.mesh.split("x"))
        mesh = sharding.make_mesh((t, s))
        film = sharding.render_film_distributed(sd, cam, cfg, mesh, film=film)
    else:
        def progress(done, total):
            stage(f"spp {done}/{total}  ({time.perf_counter() - t0:.1f}s)")

        film = R.render_film(sd, cam, cfg, film=film, progress=progress,
                             rays=rays)
    film.accum.block_until_ready()
    dt = time.perf_counter() - t0
    spp_done = int(film.count)
    n_rays = float(sum(float(r) for r in rays))
    stage(f"rendered {cfg.width}x{cfg.height} @ {spp_done}spp in {dt:.1f}s "
          f"({cfg.width * cfg.height * spp_done / max(dt, 1e-9) / 1e6:.2f} "
          f"Msamples/s"
          + (f", {n_rays:.0f} rays, {n_rays / max(dt, 1e-9) / 1e6:.2f} "
             "Mrays/s" if n_rays else "") + "; compilation included)")

    if args.save_film:
        film.save(args.save_film)
        stage(f"film checkpoint -> {args.save_film}")
    rad = np.asarray(film.mean())[::-1]
    img = np.asarray(tonemap.finalize(rad, np, cfg.tonemap))
    image_io.save(args.out, img)
    stage(f"wrote {args.out}")


if __name__ == "__main__":
    main()
