"""Profile one warm bench render on the GPU and reduce the trace.

    python tools/trace_render.py [--tris 20000] [--engine pool]
        [--traversal sweep] [--out traces]

Runs the bench.py configuration once to compile, then once more under
``jax.profiler.trace``, and prints one JSON line with, from the device
plane of the trace: kernel launches in the window, launches per pool
loop iteration (one iteration = one bounce of every live lane), the
device's busy and idle share of the window, and the ten kernels that
took the most device time. Needs a GPU; the plane and line names it
reads are those of JAX's CUDA profiler (``/device:GPU:0``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def reduce_trace(path: str, device: str = "/device:GPU:0") -> dict:
    """Device-plane totals of one .xplane.pb file."""
    from jax._src.profiler import ProfileData

    prof = ProfileData.from_file(path)
    plane = prof.find_plane_with_name(device)
    if plane is None:
        raise RuntimeError(f"no plane {device!r} in {path}: "
                           f"{[p.name for p in prof.planes]}")
    lines = {ln.name: list(ln.events) for ln in plane.lines}
    # kernel activity sits on the per-stream lines; 'XLA Modules' and
    # 'XLA Ops' re-describe the same intervals at coarser grain
    kern = [e for name, evs in lines.items() if name.startswith("Stream")
            for e in evs]
    if not kern:
        raise RuntimeError(f"no stream lines on {device}: {list(lines)}")
    spans = sorted((e.start_ns, e.end_ns) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    per = {}
    for e in kern:
        n, t = per.get(e.name, (0, 0.0))
        per[e.name] = (n + 1, t + e.duration_ns)
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(
        lines={k: len(v) for k, v in lines.items()},
        kernels=len(kern), window_ms=window / 1e6, busy_ms=busy / 1e6,
        idle_share=1.0 - busy / max(window, 1),
        top=[dict(name=k[:80], count=n, ms=t / 1e6) for k, (n, t) in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=20_000)
    ap.add_argument("--engine", default="pool")
    ap.add_argument("--traversal", default="sweep")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--out", default="traces")
    args = ap.parse_args(argv)

    import jax

    from jaderaytracerendering_tpu.utils.config import RenderConfig

    if jax.devices()[0].platform != "gpu":
        print("trace_render.py needs a GPU", file=sys.stderr)
        return 1
    run = argparse.Namespace(
        width=args.width, height=args.width, spp=args.spp, depth=args.depth,
        tris=args.tris, spp_batch=4,
        rays_per_launch=RenderConfig().rays_per_launch,
        traversal=args.traversal, engine=args.engine, reps=1)
    res = bench._measure(run)  # untraced: compile + timed renders
    one, cfg = bench._prepare(run)
    one(0).block_until_ready()  # compiled already; warms this closure
    out = os.path.join(args.out, f"{args.engine}_{args.traversal}_"
                       f"{args.tris}")
    with jax.profiler.trace(out):
        t0 = time.perf_counter()
        stats = one(cfg.spp).block_until_ready()
        wall = time.perf_counter() - t0
    files = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                             recursive=True))
    red = reduce_trace(files[-1])
    iters = float(stats[1])
    print(json.dumps(dict(
        config=vars(args), untraced=res, traced_wall_s=wall,
        loop_iters=iters,
        kernels_per_loop_iter=red["kernels"] / iters if iters else None,
        **red, card=bench.card_name_and_power_limit(),
        device=bench.device_info())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
