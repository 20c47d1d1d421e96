"""Time the traversal routes on one bounce-sized ray batch (GPU).

    python tools/tune_sweep.py [--tris 20000,400000] [--rays 65536]

The batch mixes coherent camera rays with secondary-like rays leaving
random surface points, about what one pool iteration traces (pool
width x (lights + 2) segments). For each scene size it times the sweep
kernel over a small grid of its block sizes — triangles per cluster K
(``assemble(max_cluster=)``), clusters per group G, rays per block and
warps per block — and the plain-jnp ``clusters`` and ``bvh`` routes on
the same rays, one JSON line each, each beside the card's name and power
limit. A kernel's answers are checked against the first configuration's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rays(ds, sdn, n, seed=0):
    import numpy as np

    from jaderaytracerendering_tpu.core import camera as camera_mod

    rng = np.random.default_rng(seed)
    half = n // 2
    pid = rng.integers(0, 1024 * 1024, half).astype(np.uint32)
    o1, d1 = camera_mod.generate_rays(
        np, ds.camera.eye, ds.camera.camera_rotate, 1024, 1024, pid,
        np.uint32(0), 0, "cuda")
    tri = rng.integers(0, sdn.n_triangles, n - half)
    o2 = (sdn.tri_p1[tri] + sdn.tri_p2[tri] + sdn.tri_p3[tri]) / 3.0
    d2 = rng.normal(size=o2.shape)
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ex = np.concatenate([np.full(half, -1), tri]).astype(np.int32)
    return o, d, ex


def _time(fn, *args, reps=5):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    return out, first, best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", default="20000,400000")
    ap.add_argument("--rays", type=int, default=65_536)
    ap.add_argument("--plain", default="clusters,bvh",
                    help="plain-jnp routes to time beside the kernel")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (kernel interpreted; no "
                         "device numbers)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import bench
    from jaderaytracerendering_tpu.core import vecmath as vm
    from jaderaytracerendering_tpu.integrator import render as R
    from jaderaytracerendering_tpu.models import demo
    from jaderaytracerendering_tpu.ops.pallas import cluster_sweep
    from jaderaytracerendering_tpu.scene.scene import assemble
    from jaderaytracerendering_tpu.utils import backend
    from jaderaytracerendering_tpu.utils.config import RenderConfig

    if jax.devices()[0].platform != "gpu" and not args.cpu:
        print("tune_sweep.py needs a GPU", file=sys.stderr)
        return 1
    card = bench.card_name_and_power_limit()
    interpret = backend.kernel_interpret()
    for tris in (int(t) for t in args.tris.split(",")):
        ds = demo.jade_scene(n_buddha_tris=tris)
        sdn = assemble(ds.objects, ds.env_map, xp=np)
        o, d, ex = _rays(ds, sdn, args.rays)
        oj, dj, exj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex)
        rays = cluster_sweep.pack_rays(vm.v3unstack(oj),
                                       vm.v3unstack(vm.normalize(dj, jnp)))
        ref = None

        def line(**kv):
            print(json.dumps(dict(tris=tris, rays=args.rays, **kv,
                                  card=card)), flush=True)

        grid = [(k, g, 32, 4) for k in (32, 64) for g in (8, 16, 32)]
        grid += [(k, 16, bm, w) for k in (32, 64) for bm in (16, 32, 64)
                 for w in (1, 2, 4)]
        scenes = {}
        for k, g, bm, w in grid:
            if (k, g) not in scenes:
                scenes[(k, g)] = jax.tree.map(jnp.asarray, assemble(
                    ds.objects, ds.env_map, xp=np, max_cluster=k,
                    cluster_group=g))
            sd = scenes[(k, g)]
            fn = jax.jit(lambda r, e, s, bm=bm, w=w: cluster_sweep.
                         nearest_hit_rays(r, e, s, bm=bm, num_warps=w,
                                          interpret=interpret))
            try:
                out, first, best = _time(fn, rays, exj, sd)
            except Exception as e:  # reported; the line says so
                line(route="sweep", k=k, group=g, bm=bm, warps=w,
                     error=repr(e)[:300])
                continue
            out = tuple(map(np.asarray, out))
            if ref is None:
                ref = out
            agree = float((out[0] == ref[0]).mean())
            line(route="sweep", k=k, group=g, bm=bm, warps=w,
                 clusters=sd.n_clusters, compile_s=first - best,
                 call_ms=best * 1e3, Mrays_s=args.rays / best / 1e6,
                 hit_flags_agree=agree)
        sd = jax.tree.map(jnp.asarray, sdn)
        for route in args.plain.split(","):
            cfg = RenderConfig(traversal=route)

            @jax.jit
            def fn(sd_, o_, d_, e_, cfg=cfg):
                return R.make_nearest(sd_, cfg, jnp)(o_, d_, e_)

            try:
                out, first, best = _time(fn, sd, oj, dj, exj, reps=2)
            except Exception as e:
                line(route=route, error=repr(e)[:300])
                continue
            out = tuple(map(np.asarray, out))
            line(route=route, compile_s=first - best, call_ms=best * 1e3,
                 Mrays_s=args.rays / best / 1e6,
                 hit_flags_agree=(float((out[0] == ref[0]).mean())
                                  if ref is not None else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
