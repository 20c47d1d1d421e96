"""BASELINE.md milestone configs, scaled to CI sizes.

Each test is a shrunken version of one driver config; the full-size runs
go through bench.py / the render CLI and chip_smoke.py on the GPU.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from jaderaytracerendering_tpu.accel import bvh, native
from jaderaytracerendering_tpu.cpuref import integrator as oracle
from jaderaytracerendering_tpu.integrator import render as R
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.parallel import sharding
from jaderaytracerendering_tpu.post import tonemap
from jaderaytracerendering_tpu.scene import procedural
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.utils.config import RenderConfig


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def test_config1_diffuse_cpu_parity():
    """Config 1: diffuse scene, CPU oracle vs the jit pipeline at matched
    seeds — RMSE must be float-noise only (same RNG streams)."""
    ds = demo.diffuse_scene(n_buddha_tris=400, env_shape=(16, 32))
    cfg = RenderConfig(width=12, height=12, spp=4, spp_batch=4, max_depth=4,
                       traversal="brute")
    sdn = assemble(ds.objects, ds.env_map, xp=np)
    ref = oracle.render_radiance(sdn, ds.camera, cfg)
    sdj = jax.tree.map(jnp.asarray, sdn)
    film = R.render_film(sdj, ds.camera, cfg)
    got = np.asarray(film.mean())
    scale = max(np.abs(ref).max(), 1.0)
    assert _rmse(got, ref) / scale < 1e-3


def test_config2_full_jade_sss_parity():
    """Config 2: full jade material (mirror + SSS) oracle parity."""
    ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    cfg = RenderConfig(width=10, height=10, spp=4, spp_batch=4, max_depth=5,
                       traversal="brute")
    sdn = assemble(ds.objects, ds.env_map, xp=np)
    ref = oracle.render_radiance(sdn, ds.camera, cfg)
    sdj = jax.tree.map(jnp.asarray, sdn)
    got = np.asarray(R.render_film(sdj, ds.camera, cfg).mean())
    scale = max(np.abs(ref).max(), 1.0)
    assert _rmse(got, ref) / scale < 1e-3


def test_config3_bvh_100k_tris():
    """Config 3: BVH build + traversal on a 100k+ triangle mesh."""
    v, f = procedural.buddha_standin(110_000)
    assert len(f) >= 100_000
    p1 = v[f[:, 0]].astype(np.float32)
    p2 = v[f[:, 1]].astype(np.float32)
    p3 = v[f[:, 2]].astype(np.float32)
    nodes, perm = native.build(p1, p2, p3, leaf_size=8)
    bvh.check_invariants(nodes, len(f), leaf_size=8)
    # traversal on the sorted soup agrees with brute force on sample rays
    from jaderaytracerendering_tpu.models.demo import _obj  # noqa
    import jaderaytracerendering_tpu.scene.objloader as ol
    mesh = ol.mesh_from_arrays(v, f)
    from jaderaytracerendering_tpu.scene.material import Material
    from jaderaytracerendering_tpu.scene.scene import SceneObject
    from jaderaytracerendering_tpu.scene import hdr
    sd = assemble(
        [SceneObject(mesh=mesh, material=Material())],
        hdr.procedural_sky(8, 16), xp=np,
    )
    from jaderaytracerendering_tpu.ops import bruteforce, cluster_traverse
    rng = np.random.default_rng(0)
    n = 64
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ex = np.full(n, -1, np.int32)
    hb, ib, tb = bruteforce.nearest_hit_np(o, d, ex, sd.tri_p1, sd.tri_p2, sd.tri_p3)
    hc, ic, tc = cluster_traverse.nearest_hit_clusters_np(o, d, ex, sd)
    np.testing.assert_array_equal(hb, hc)
    np.testing.assert_allclose(tb[hb], tc[hb], rtol=1e-5)


@pytest.mark.slow
def test_config4_wavefront_pipeline_smoke():
    """Config 4 (scaled): the full wavefront pipeline end-to-end through
    tonemap on the jade scene — finite, displayable output."""
    ds = demo.jade_scene(n_buddha_tris=1_000, env_shape=(16, 32))
    cfg = RenderConfig(width=16, height=16, spp=4, spp_batch=2, max_depth=6,
                       traversal="bvh")
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    img = R.render_image(sd, ds.camera, cfg)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert img.max() > 0


@pytest.mark.slow
def test_config5_multichip_tiled_film_with_tonemap():
    """Config 5: film sharded over the mesh, psum spp accumulation, then
    the pass2/pass3-equivalent post over the gathered film."""
    ds = demo.tiny_scene()
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    cfg = RenderConfig(width=8, height=8, spp=4, spp_batch=2, max_depth=2,
                       traversal="bvh")
    mesh = sharding.make_mesh((2, 2))  # configs/config5: four GPUs
    film = sharding.render_film_distributed(sd, ds.camera, cfg, mesh)
    img = tonemap.finalize(np.asarray(film.mean())[::-1], np, "aces")
    assert img.shape == (8, 8, 3)
    # matches the single-device render exactly
    film_s = R.render_film(sd, ds.camera, cfg)
    img_s = tonemap.finalize(np.asarray(film_s.mean())[::-1], np, "aces")
    assert (np.abs(img.astype(int) - img_s.astype(int)) <= 1).all()


def test_jade_material_constants():
    """The hero material matches the reference scene (PathTrace.cpp:981-989)."""
    m = dataclasses.asdict(demo.jade_scene(n_buddha_tris=100, env_shape=(8, 16)).objects[0].material)
    assert m["brdf"] == (0.02, 0.02, 0.02)
    assert m["refract_rate"] == (0.1, 0.1, 0.1)
    assert m["refract_albedo"] == (0.3, 0.3, 0.3)
    assert m["refract_index"] == 2.66
