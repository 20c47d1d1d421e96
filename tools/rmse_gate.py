"""North-star quality gate: RMSE of the device pipeline vs the CPU oracle
at the literal BASELINE.md setting (1024 spp).

BASELINE.md: "RMSE < 1e-3 vs CPU reference at 1024 spp". docs/PARITY.md
argued from RNG-stream identity that the error is spp-independent
(~1e-6 relative); this script closes the claim with a measured number:
an 8x8 film at 1024 spp through (a) the scalar NumPy oracle
(cpuref.integrator — independent branchy-scalar transcription) and
(b) the production pipeline at the default engine and traversal, on the
current JAX backend (run on the GPU for the hardware number; --cpu for
the backend-exact check).

Writes the result line for docs/PARITY.md to stdout.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--size", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--tris", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_compilation_cache", False)
    import jax.numpy as jnp
    import numpy as np

    from jaderaytracerendering_tpu.cpuref import integrator as oracle
    from jaderaytracerendering_tpu.integrator import render as R
    from jaderaytracerendering_tpu.models import demo
    from jaderaytracerendering_tpu.scene.scene import assemble
    from jaderaytracerendering_tpu.utils.config import RenderConfig

    ds = demo.jade_scene(n_buddha_tris=args.tris, env_shape=(16, 32))
    ds.camera.r = 2.0  # statue covers lanes -> SSS/mirror branches active
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       spp_batch=8, max_depth=args.depth)

    sdn = assemble(ds.objects, ds.env_map, xp=np)
    t0 = time.perf_counter()
    ref = oracle.render_radiance(sdn, ds.camera, cfg)
    t_oracle = time.perf_counter() - t0

    sdj = assemble(ds.objects, ds.env_map, xp=jnp)
    t0 = time.perf_counter()
    film = R.render_film(sdj, ds.camera, cfg)
    got = np.asarray(film.mean())
    t_dev = time.perf_counter() - t0

    scale = max(float(np.abs(ref).max()), 1e-12)
    rmse_rel = float(np.sqrt(np.mean((got - ref) ** 2))) / scale
    max_rel = float(np.abs(got - ref).max()) / scale
    backend = jax.default_backend()
    print(
        f"RMSE gate: {args.size}x{args.size} @ {args.spp} spp depth "
        f"{args.depth} ({args.tris} tris, {cfg.engine}+{cfg.traversal}, "
        f"backend={backend}): "
        f"relative RMSE = {rmse_rel:.3e}, max rel err = {max_rel:.3e} "
        f"(gate < 1e-3; oracle {t_oracle:.0f}s, pipeline {t_dev:.0f}s)"
    )
    assert rmse_rel < 1e-3, "north-star RMSE gate FAILED"
    print("PASS")


if __name__ == "__main__":
    main()
