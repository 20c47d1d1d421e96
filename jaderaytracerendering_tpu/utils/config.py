"""Render configuration.

Replaces the reference's compile-time ``#define`` wall (WIDTH/HEIGHT
PathTrace.cpp:26-27; RENDER_WIDTH/HEIGHT, TILE_SIZE, STACK_CAPACITY,
RR_RATE, SSS_RATE, MAX_FULL_REFLEX_TIME PathTrace.cu:24-47; GLSL
STACK_CAPACITY/RR_RATE fshader_render.fsh:32-33) plus its stdin spp prompt
with one dataclass, JSON-serializable for batch runs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1024                 # PathTrace.cpp:26
    height: int = 1024                # PathTrace.cpp:27
    spp: int = 16                     # runtime stdin in reference
    max_depth: int = 16               # bounce cap; GLSL 16 / CUDA 128
    rr_rate: float = 0.9              # PathTrace.cu:35 (GLSL uses 0.8)
    sss_rate: float = 0.5             # PathTrace.cu:47
    max_refract_bounces: int = 32     # MAX_FULL_REFLEX_TIME, PathTrace.cu:39
    internal_reflect_rate: float = 0.2  # PathTrace.cu:1215
    hdr_clamp: float = 10.0           # PathTrace.cu:700
    emissive_break_eps: float = 1.4e-5  # path-termination test, PathTrace.cu:917
    emissive_skip_eps: float = 1.5e-4   # continuation skip test, PathTrace.cu:1005
    seed: int = 0
    jitter: str = "cuda"              # 'cuda' | 'gl' film jitter convention
    tonemap: str = "aces"             # 'aces' (CUDA) | 'reinhard' (GL pass3)
    spp_batch: int = 4                # samples per wavefront launch
    rays_per_launch: int = 1 << 16    # ray-pool width (pool) and wavefront
    # lanes per launch (scan); measured on the H100 against 1<<14 and
    # 1<<18 (PERF.md)
    traversal: str = "sweep"          # 'sweep' (cluster sweep kernel) |
    #                                   'clusters' | 'bvh' | 'gemm' | 'brute'
    integrator: str = "full"          # 'full' (NEE megakernel) | 'preview'
    preview_bounces: int = 2          # fshader_preview.fsh:397
    preview_bands: int = 1            # progressive preview: pixels split
    # into B flat bands, ONE band sampled per displayed frame (band
    # n % B at sample n // B) — display rate decouples from the
    # per-pixel sample rate. 1 = reference parity (every pixel every
    # frame). Requires npix % B == 0; the CLI picks a valid B.
    engine: str = "pool"              # 'pool' (respawn-compacted ray
    # pool, integrator/pool.py) | 'scan' (fixed wavefront launches)
    spawn_rounds: int = 1             # pool: primary-spawn attempts per loop
    # iteration. >1 lets sky-miss samples retire at spawn time and pull
    # the next sample in the SAME iteration, at the cost of repeating the
    # spawn chain (cumsum + camera + trace + env/rows) per round.
    bvh_leaf_size: int = 8            # PathTrace.cpp:1086 / PathTrace.cu:1565
    bvh_stack_size: int = 128         # reference capacity (PathTrace.cu:34);
    # make_nearest asserts it covers the built tree's depth + 1
    mesh_shape: Optional[Tuple[int, ...]] = None  # device mesh, None = one device

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RenderConfig":
        data = json.loads(text)
        if data.get("mesh_shape") is not None:
            data["mesh_shape"] = tuple(data["mesh_shape"])
        # tolerate fields from older configs (e.g. the removed
        # pallas_shading flag) so archived render_args survive upgrades
        known = {f.name for f in dataclasses.fields(RenderConfig)}
        return RenderConfig(**{k: v for k, v in data.items() if k in known})

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# ---- reference-parity presets ----------------------------------------------

def cuda_parity(**kw) -> RenderConfig:
    """PathTrace.cu settings: RR 0.9, depth cap 128, CUDA jitter, ACES."""
    base = dict(rr_rate=0.9, max_depth=128, jitter="cuda", tonemap="aces",
                engine="pool")
    base.update(kw)
    return RenderConfig(**base)


def gl_render_parity(**kw) -> RenderConfig:
    """fshader_render.fsh settings: RR 0.8, depth 16, GL jitter, Reinhard
    pass3. (The GL encoding drops refract fields; pair with a diffuse
    scene for full parity — models.demo.diffuse_scene.)"""
    base = dict(rr_rate=0.8, max_depth=16, jitter="gl", tonemap="reinhard")
    base.update(kw)
    return RenderConfig(**base)


def gl_preview_parity(**kw) -> RenderConfig:
    """fshader_preview.fsh settings: 2-bounce no-NEE progressive preview."""
    base = dict(integrator="preview", preview_bounces=2, jitter="gl",
                tonemap="reinhard", spp=1, spp_batch=1)
    base.update(kw)
    return RenderConfig(**base)
