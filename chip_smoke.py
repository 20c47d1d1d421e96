#!/usr/bin/env python3
"""Smoke test of the render path on one NVIDIA GPU (or four).

    python chip_smoke.py               # phases a-f on one card
    python chip_smoke.py --devices 4   # phase g only: --mesh renders on 4
    python chip_smoke.py --rehearse    # tiny sizes on the CPU; exits 1

Phases, all in this one process (one JAX process per card):

  a. device check: JAX's platform must be 'gpu' (no CPU fallback);
  b. the production traversal on 16,384 rays in the 20k- and
     400k-triangle jade scenes against ops/bruteforce.py;
  c. the three 64x64 goldens (tests/goldens, the oracle renders of
     tests/goldens/regen.py) on the card, by the route each golden
     names and by the default route;
  d. batch render through cli.render: jade, 20k tris, 1024^2, 16 spp;
  e. headless preview through cli.preview: 8 frames at 1024^2;
  f. large scene through cli.render: 400k tris, 256^2, 4 spp;
  g. (--devices 4) cli.render --mesh 2x2 and --mesh 4x1 of the jade
     scene at 1024^2, 16 spp, against a one-card render of the same
     samples in this process.

Every phase prints its wall time and results beside the card's name and
power limit. A failed phase makes the script exit non-zero. The last
line of standard output, on success only, is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


class Smoke:
    def __init__(self, small: bool, card: str, tmp: str):
        self.small = small
        self.card = card
        self.tmp = tmp
        self.failed = []

    def report(self, phase: str, **kv) -> None:
        fields = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"[{phase}] {fields} | card: {self.card}", flush=True)

    def run(self, phase: str, fn) -> None:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # reported, counted, and the exit code says so
            traceback.print_exc()
            self.failed.append(phase)
            self.report(phase, status="FAILED",
                        wall_s=f"{time.perf_counter() - t0:.3f}")
            return
        self.report(phase, status="ok",
                    wall_s=f"{time.perf_counter() - t0:.3f}")

    # ---- b -------------------------------------------------------------
    def traversal(self, tris: int, n_rays: int, np_subset: int) -> None:
        import jax
        import jax.numpy as jnp
        import numpy as np

        from jaderaytracerendering_tpu.core import camera as camera_mod
        from jaderaytracerendering_tpu.integrator import render as R
        from jaderaytracerendering_tpu.models import demo
        from jaderaytracerendering_tpu.ops import bruteforce
        from jaderaytracerendering_tpu.scene.scene import assemble
        from jaderaytracerendering_tpu.utils.config import RenderConfig

        ds = demo.jade_scene(n_buddha_tris=tris)
        sdn = assemble(ds.objects, ds.env_map, xp=np)
        sd = jax.tree.map(jnp.asarray, sdn)
        # half coherent camera rays over a 1024^2 film, half secondary-
        # like rays leaving random surface points in random directions
        rng = np.random.default_rng(0)
        half = n_rays // 2
        pid = rng.integers(0, 1024 * 1024, half).astype(np.uint32)
        o1, d1 = camera_mod.generate_rays(
            np, ds.camera.eye, ds.camera.camera_rotate, 1024, 1024, pid,
            np.uint32(0), 0, "cuda")
        tri = rng.integers(0, sdn.n_triangles, n_rays - half)
        o2 = (sdn.tri_p1[tri] + sdn.tri_p2[tri] + sdn.tri_p3[tri]) / 3.0
        d2 = rng.normal(size=o2.shape)
        o = np.concatenate([o1, o2]).astype(np.float32)
        d = np.concatenate([d1, d2]).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        ex = np.concatenate([np.full(half, -1), tri]).astype(np.int32)

        cfg = RenderConfig()

        @jax.jit  # the scene is an argument, never a baked constant
        def nearest(sd_, o_, d_, e_):
            return R.make_nearest(sd_, cfg, jnp)(o_, d_, e_)

        args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex))
        t0 = time.perf_counter()
        got = jax.block_until_ready(nearest(sd, *args))
        first = time.perf_counter() - t0
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(nearest(sd, *args))
            times.append(time.perf_counter() - t0)
        got = tuple(map(np.asarray, got))
        best = min(times)

        brute = jax.jit(bruteforce.nearest_hit_jnp)
        want = tuple(map(np.asarray, brute(*args, sd.tri_p1, sd.tri_p2,
                                           sd.tri_p3)))
        # tolerance: both sides are fp32 Moller-Trumbore in the same
        # operation order on CUDA cores (no tensor cores, no TF32); they
        # differ only by FMA contraction and division rounding, so t
        # agrees to ~1e-6 relative (rtol 1e-5), and indices differ only
        # at near-ties (shared edges, coplanar faces), each re-checked
        res = bruteforce.compare_hits(want, got, o, d, sdn.tri_p1,
                                      sdn.tri_p2, sdn.tri_p3, rtol=1e-5)
        self.report(f"b.traversal.{tris}", traversal=cfg.traversal,
                    tris=sdn.n_triangles,
                    clusters=sdn.n_clusters, cluster_k=sdn.cluster_k,
                    compile_s=f"{first - best:.3f}", call_s=f"{best:.6f}",
                    Mrays_s=f"{n_rays / best / 1e6:.3f}",
                    vs="bruteforce_jnp", **res)
        if np_subset:
            # NumPy oracle on a subset, spread over the host's cores
            sub = rng.choice(n_rays, np_subset, replace=False)
            parts = np.array_split(sub, 64)

            def one(ix):
                return bruteforce.nearest_hit_np(
                    o[ix], d[ix], ex[ix], sdn.tri_p1, sdn.tri_p2,
                    sdn.tri_p3)

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(
                    os.cpu_count() or 4) as pool:
                outs = list(pool.map(one, parts))
            want_np = tuple(np.concatenate([x[i] for x in outs])
                            for i in range(3))
            res = bruteforce.compare_hits(
                want_np, tuple(a[np.concatenate(parts)] for a in got),
                o[np.concatenate(parts)], d[np.concatenate(parts)],
                sdn.tri_p1, sdn.tri_p2, sdn.tri_p3, rtol=1e-5)
            self.report(f"b.traversal.{tris}.numpy",
                        oracle_s=f"{time.perf_counter() - t0:.1f}",
                        vs="bruteforce_np", **res)

    # ---- c -------------------------------------------------------------
    def goldens(self) -> None:
        import jax
        import jax.numpy as jnp
        import numpy as np

        from jaderaytracerendering_tpu.integrator import render as R
        from jaderaytracerendering_tpu.models import demo
        from jaderaytracerendering_tpu.scene.scene import assemble
        from jaderaytracerendering_tpu.utils.config import RenderConfig

        def jade():
            ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
            ds.camera.r = 2.0
            return ds

        # (golden, scene, named route) as tests/test_goldens.py runs them
        cases = [
            ("diffuse_64x64_4spp.npy",
             lambda: demo.diffuse_scene(n_buddha_tris=400, env_shape=(16, 32)),
             dict(max_depth=4, traversal="bvh", engine="scan")),
            ("jade_64x64_4spp.npy", jade,
             dict(max_depth=5, traversal="bvh", engine="pool",
                  rays_per_launch=4096)),
            ("cornell_64x64_4spp.npy", demo.cornell_scene,
             dict(max_depth=4, traversal="bvh", engine="scan")),
        ]
        default = RenderConfig()
        misses = []
        for name, make, route in cases:
            want = np.load(os.path.join(HERE, "tests", "goldens", name))
            ds = make()
            sd = jax.tree.map(jnp.asarray,
                              assemble(ds.objects, ds.env_map, xp=np))
            base = RenderConfig(width=64, height=64, spp=4, spp_batch=4,
                                seed=5, **route)
            gpu_default = base.replace(traversal=default.traversal,
                                       engine=default.engine,
                                       rays_per_launch=default.rays_per_launch)
            for label, cfg in (("named", base), ("default", gpu_default)):
                t0 = time.perf_counter()
                got = np.asarray(R.render_film(sd, ds.camera, cfg).mean())
                wall = time.perf_counter() - t0
                # the golden test's own tolerance (tests/test_goldens.py):
                # fp32 summation order and rounding across backends
                scale = max(np.abs(want).max(), 1.0)
                err = np.abs(got - want)
                lim = 2e-4 * scale + 2e-3 * np.abs(want)
                ok = bool(np.isfinite(got).all() and (err <= lim).all())
                self.report(f"c.golden.{name[:-4]}.{label}",
                            engine=cfg.engine, traversal=cfg.traversal,
                            max_abs_err=f"{err.max():.3e}",
                            worst_err_over_tol=f"{(err / lim).max():.3f}",
                            wall_s=f"{wall:.3f}", ok=ok)
                if not ok:
                    misses.append(f"{name}:{label}")
        if misses:
            raise AssertionError(f"goldens missed: {misses}")

    # ---- d / f -----------------------------------------------------------
    def batch(self, phase: str, tris: int, size: int, spp: int,
              extra=()) -> "object":
        import numpy as np

        from jaderaytracerendering_tpu.cli import render as cli_render
        from jaderaytracerendering_tpu.post import image_io

        out = os.path.join(self.tmp, f"{phase}.bmp")
        film_path = os.path.join(self.tmp, f"{phase}.npz")
        argv = ["--scene", "jade", "--tris", str(tris), "--width", str(size),
                "--height", str(size), "--spp", str(spp), "--out", out,
                "--save-film", film_path, *extra]
        if self.small:  # the CPU rehearsal
            argv.append("--cpu")
        t0 = time.perf_counter()
        cli_render.main(argv)
        wall = time.perf_counter() - t0
        film = np.load(film_path)
        accum, count = film["accum"], int(film["count"])
        img = image_io.read_bmp(out)
        finite = bool(np.isfinite(accum).all())
        mean = float(accum.mean() / max(count, 1))
        self.report(phase, argv=" ".join(argv[:10]),
                    wall_s_incl_compile=f"{wall:.3f}", spp=count,
                    film_finite=finite, film_mean=f"{mean:.5f}",
                    image_mean_u8=f"{img.mean():.2f}")
        assert count == spp, f"film count {count} != {spp}"
        assert finite, "non-finite film"
        assert mean > 0 and img.mean() > 1.0, "black image"
        return accum

    def warm_rate(self, phase: str, tris: int, size: int, spp: int) -> None:
        """A second, warm render of the same configuration through the
        same entry point (integrator.render.render_film) -> Mrays/s."""
        import jax.numpy as jnp

        from jaderaytracerendering_tpu.integrator import render as R
        from jaderaytracerendering_tpu.models import demo
        from jaderaytracerendering_tpu.scene.scene import assemble
        from jaderaytracerendering_tpu.utils.config import RenderConfig

        ds = demo.jade_scene(n_buddha_tris=tris)
        sd = assemble(ds.objects, ds.env_map, xp=jnp)
        cfg = RenderConfig(width=size, height=size, spp=spp)
        rays = []
        t0 = time.perf_counter()
        film = R.render_film(sd, ds.camera, cfg, rays=rays)
        film.accum.block_until_ready()
        wall = time.perf_counter() - t0
        n = float(sum(float(r) for r in rays))
        self.report(phase, engine=cfg.engine, traversal=cfg.traversal,
                    wall_s=f"{wall:.3f}", rays=f"{n:.0f}",
                    Mrays_s=f"{n / wall / 1e6:.3f}" if n else "n/a")

    # ---- e -------------------------------------------------------------
    def preview(self, size: int, frames: int) -> None:
        from jaderaytracerendering_tpu.cli import preview as cli_preview
        from jaderaytracerendering_tpu.post import image_io

        out = os.path.join(self.tmp, "preview.bmp")
        t0 = time.perf_counter()
        cli_preview.main(["--frames", str(frames), "--width", str(size),
                          "--height", str(size), "--out", out]
                         + (["--cpu"] if self.small else []))
        wall = time.perf_counter() - t0
        img = image_io.read_bmp(out)
        self.report("e.preview", frames=frames, size=size,
                    wall_s_incl_compile=f"{wall:.3f}",
                    image_mean_u8=f"{img.mean():.2f}")
        assert img.mean() > 1.0, "black preview"

    # ---- g -------------------------------------------------------------
    def mesh(self, size: int, spp: int, n_dev: int) -> None:
        import jax
        import jax.numpy as jnp
        import numpy as np

        from jaderaytracerendering_tpu.integrator import render as R
        from jaderaytracerendering_tpu.models import demo
        from jaderaytracerendering_tpu.scene.scene import assemble
        from jaderaytracerendering_tpu.utils.config import RenderConfig

        assert len(jax.devices()) >= n_dev, (
            f"need {n_dev} devices, JAX sees {len(jax.devices())}")
        tris = 2_000 if self.small else 20_000
        ds = demo.jade_scene(n_buddha_tris=tris)
        sd = assemble(ds.objects, ds.env_map, xp=jnp)
        t0 = time.perf_counter()
        single = R.render_film(
            sd, ds.camera, RenderConfig(width=size, height=size, spp=spp))
        single = np.asarray(single.accum)
        self.report("g.single", wall_s_incl_compile=
                    f"{time.perf_counter() - t0:.3f}")
        bad = []
        for shape in ("2x2", "4x1"):
            accum = self.batch(f"g.mesh{shape}", tris, size, spp,
                               extra=("--mesh", shape))
            # RNG streams are keyed by (pixel, sample): only the order of
            # the per-pixel fp32 sums differs between the two renders
            diff = np.abs(accum - single)
            lim = 1e-5 * np.abs(single).max() + 1e-4 * np.abs(single)
            ok = bool((diff <= lim).all())
            self.report(f"g.mesh{shape}.vs_single",
                        max_abs_diff=f"{diff.max():.3e}",
                        max_rel_diff=f"{(diff / np.maximum(np.abs(single), 1e-30)).max():.3e}",
                        worst_diff_over_tol=f"{(diff / lim).max():.3f}",
                        ok=ok)
            if not ok:
                bad.append(shape)
        assert not bad, f"mesh renders differ from one card: {bad}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at tiny sizes on the CPU; never "
                         "reports ok")
    args = ap.parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=4")

    # ---- a. device check ----------------------------------------------
    try:
        import jax
    except ImportError as e:
        print(f"[a.device] FAILED: JAX is not importable: {e}")
        return 1
    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu" and not args.rehearse:
        print(f"[a.device] FAILED: JAX's platform is {platform!r}, not "
              "'gpu'; this smoke test runs only on an NVIDIA GPU")
        return 1
    sys.path.insert(0, HERE)
    try:
        import jaderaytracerendering_tpu  # noqa: F401
    except ImportError as e:
        print(f"[a.device] FAILED: the renderer package is not next to "
              f"this script ({e})")
        return 1
    card = card_line()
    device = {"platform": platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    print(f"[a.device] ok platform={platform} kind={device['kind']} "
          f"count={device['count']} | card: {card}", flush=True)

    small = args.rehearse
    with tempfile.TemporaryDirectory() as tmp:
        s = Smoke(small, card, tmp)
        if args.devices == 4:
            s.run("g.mesh", lambda: s.mesh(32 if small else 1024,
                                           4 if small else 16, 4))
        else:
            s.run("b.traversal.20k", lambda: s.traversal(
                2_000 if small else 20_000, 256 if small else 16_384, 0))
            s.run("b.traversal.400k", lambda: s.traversal(
                8_000 if small else 400_000, 256 if small else 16_384,
                64 if small else 4_096))
            s.run("c.goldens", s.goldens)
            s.run("d.batch", lambda: s.batch(
                "d.batch", 2_000 if small else 20_000, 32 if small else 1024,
                2 if small else 16))
            s.run("d.batch.warm", lambda: s.warm_rate(
                "d.batch.warm", 2_000 if small else 20_000,
                32 if small else 1024, 2 if small else 16))
            s.run("e.preview", lambda: s.preview(32 if small else 1024,
                                                 2 if small else 8))
            s.run("f.large", lambda: s.batch(
                "f.large", 8_000 if small else 400_000, 16 if small else 256,
                1 if small else 4))
    if s.failed:
        print(f"FAILED phases: {s.failed} | card: {card}")
        return 1
    if platform != "gpu":
        print(f"rehearsal complete on {platform!r}; not a GPU result")
        return 1
    print(f"all phases ok | card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
