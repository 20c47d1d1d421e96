"""Monte-Carlo convergence evidence: RMSE vs spp against a high-spp
reference render (expected ~1/sqrt(spp) slope).

Run on the GPU from the repo root:  python docs/convergence.py
Writes docs/CONVERGENCE.md.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from jaderaytracerendering_tpu.core.film import Film  # noqa: E402
from jaderaytracerendering_tpu.integrator import render as R  # noqa: E402
from jaderaytracerendering_tpu.models import demo  # noqa: E402
from jaderaytracerendering_tpu.scene.scene import assemble  # noqa: E402
from jaderaytracerendering_tpu.utils.config import RenderConfig  # noqa: E402


def _device() -> str:
    import bench

    d = bench.device_info()
    return f"{d['platform']} {d['kind']} ({bench.card_name_and_power_limit()})"


def main():
    ds = demo.jade_scene(n_buddha_tris=20_000, env_shape=(128, 256))
    ds.camera.r = 2.2
    ds.camera.up_angle = 10.0
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    size = 64

    def render(spp, seed):
        cfg = RenderConfig(width=size, height=size, spp=spp,
                           spp_batch=min(spp, 8), max_depth=6, seed=seed)
        return np.asarray(R.render_film(sd, ds.camera, cfg).mean())

    ref = render(2048, seed=0)
    scale = np.abs(ref).max()
    rows = []
    for spp in (1, 4, 16, 64, 256):
        img = render(spp, seed=1)  # independent stream from the reference
        rmse = float(np.sqrt(((img - ref) ** 2).mean())) / scale
        rows.append((spp, rmse))
        print(f"spp={spp:4d}  relative RMSE={rmse:.5f}", flush=True)

    # fit log-log slope (expect ~ -0.5 for Monte Carlo)
    xs = np.log2([r[0] for r in rows])
    ys = np.log2([r[1] for r in rows])
    slope = float(np.polyfit(xs, ys, 1)[0])
    print(f"log-log slope: {slope:.3f} (ideal -0.5)")

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "CONVERGENCE.md"), "w") as f:
        f.write(
            "# Monte-Carlo convergence (jade demo, 64x64, depth 6)\n\n"
            "Relative RMSE of the default route at spp s vs a 2048-spp\n"
            "reference render (independent RNG streams). Expected\n"
            "~1/sqrt(spp); measured log-log slope: "
            f"**{slope:.3f}** (ideal -0.5).\n\n"
            "| spp | relative RMSE |\n|---|---|\n"
            + "".join(f"| {s} | {r:.5f} |\n" for s, r in rows)
            + f"\nGenerated by docs/convergence.py on {_device()}.\n"
        )
    print("wrote docs/CONVERGENCE.md")


if __name__ == "__main__":
    main()
