"""Shared CLI plumbing: scene loading from render_args/JSON/demo names."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from ..core.camera import FixedCamera, OrbitCamera
from ..models import demo
from ..scene import hdr as hdr_mod, objloader, procedural, serialization
from ..scene.scene import SceneObject
from ..utils.config import RenderConfig
from ..utils.logging import stage
from ..integrator.render import ENGINES, TRAVERSALS

_PROCEDURAL = {
    "procedural://buddha": lambda: procedural.buddha_standin(20_000),
    "procedural://light": procedural.quad,
    "procedural://floor": procedural.box,
    "procedural://box": procedural.box,
    "procedural://quad": procedural.quad,
    "procedural://sphere": procedural.uv_sphere,
}


def load_scene_spec(spec: serialization.SceneSpec, env_path: Optional[str]):
    """SceneSpec -> (objects, env_map, camera) — the CUDA main prologue
    equivalent (PathTrace.cu:1486-1532 + HDR load 1647-1691)."""
    objects = []
    for o in spec.objects:
        if o.path in _PROCEDURAL:
            v, f = _PROCEDURAL[o.path]()
            mesh = objloader.mesh_from_arrays(
                v, f, transform=o.transform, normalize=o.normalize
            )
        else:
            mesh = objloader.read_obj(
                o.path, transform=o.transform, normalize=o.normalize
            )
        objects.append(
            SceneObject(mesh=mesh, material=o.material,
                        name=os.path.basename(o.path), source_path=o.path,
                        transform=o.transform, normalize=o.normalize)
        )
        stage(f"loaded {o.path}: {mesh.n_triangles} triangles")
    if env_path and os.path.exists(env_path):
        env = hdr_mod.read_hdr(env_path)
        stage(f"HDR environment: {env_path} {env.shape}")
    else:
        env = hdr_mod.procedural_sky(256, 512)
        stage("HDR environment: procedural sky (no background.hdr found)")
    cam = FixedCamera(eye_point=spec.eye, rotate=spec.camera_rotate)
    return objects, env, cam


def load_scene(args) -> Tuple[list, np.ndarray, object]:
    """Resolve --scene / --args into (objects, env_map, camera)."""
    if getattr(args, "render_args", None):
        spec = serialization.read_render_args(args.render_args)
        stage(f"read {args.render_args}: {len(spec.objects)} objects")
        return load_scene_spec(spec, getattr(args, "hdr", None))
    if getattr(args, "scene_json", None):
        with open(args.scene_json) as f:
            spec = serialization.spec_from_json(f.read())
        return load_scene_spec(spec, getattr(args, "hdr", None))
    name = getattr(args, "scene", "jade")
    tris = getattr(args, "tris", 20_000)
    if name == "jade":
        ds = demo.jade_scene(n_buddha_tris=tris)
    elif name == "diffuse":
        ds = demo.diffuse_scene(n_buddha_tris=tris)
    elif name == "cornell":
        ds = demo.cornell_scene()
    elif name == "tiny":
        ds = demo.tiny_scene()
    else:
        raise SystemExit(f"unknown scene {name!r}")
    if getattr(args, "hdr", None) and os.path.exists(args.hdr):
        ds = dataclasses.replace(ds, env_map=hdr_mod.read_hdr(args.hdr))
    return ds.objects, ds.env_map, ds.camera


def config_from_args(args, **overrides) -> RenderConfig:
    cfg = RenderConfig()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = RenderConfig.from_json(f.read())
    kw = {}
    for field in ("width", "height", "spp", "max_depth", "traversal",
                  "spp_batch", "rays_per_launch", "seed", "tonemap", "engine"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    kw.update(overrides)
    return cfg.replace(**kw) if kw else cfg


def add_common_args(ap) -> None:
    ap.add_argument("--scene", default="jade", help="jade|diffuse|cornell|tiny")
    ap.add_argument("--render-args", dest="render_args",
                    help="render_args.txt produced by the preview (F key)")
    ap.add_argument("--scene-json", dest="scene_json")
    ap.add_argument("--hdr", help="background .hdr path")
    ap.add_argument("--tris", type=int, default=20_000,
                    help="procedural statue triangle count")
    ap.add_argument("--config", help="RenderConfig JSON path")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--spp", type=int)
    ap.add_argument("--max-depth", dest="max_depth", type=int)
    ap.add_argument("--traversal", choices=list(TRAVERSALS))
    ap.add_argument("--engine", choices=list(ENGINES))
    ap.add_argument("--spp-batch", dest="spp_batch", type=int)
    ap.add_argument("--rays-per-launch", dest="rays_per_launch", type=int)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--tonemap", choices=["aces", "reinhard", "none"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (kernels interpreted; tests and "
                         "rehearsals at small sizes)")


def select_backend(args) -> None:
    """--cpu selects the CPU backend; otherwise JAX must find a GPU (no
    silent CPU fallback)."""
    import jax

    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
        # CPU executable serialization segfaults (package __init__)
        jax.config.update("jax_enable_compilation_cache", False)
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"JAX found no GPU (platform {platform!r}); pass "
                         "--cpu to run on the CPU")
