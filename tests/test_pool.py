"""Persistent ray-pool engine: equivalence with the scan engine."""

import numpy as np
import pytest
import jax.numpy as jnp

from jaderaytracerendering_tpu.integrator import pool, render as R
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.utils.config import RenderConfig


def _setup(**kw):
    ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    base = dict(width=8, height=8, spp=4, spp_batch=4, max_depth=4,
                traversal="bvh", rays_per_launch=64)
    base.update(kw)
    return ds, sd, RenderConfig(**base)


def test_pool_equals_scan():
    ds, sd, cfg = _setup()
    a = np.asarray(R.render_film(sd, ds.camera, cfg.replace(engine="scan")).mean())
    b = np.asarray(pool.render_film_pool(sd, ds.camera, cfg).mean())
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.slow
def test_pool_small_pool_size():
    # pool smaller than the sample count forces many respawn rounds
    ds, sd, cfg = _setup(rays_per_launch=16)
    a = np.asarray(R.render_film(sd, ds.camera, cfg.replace(engine="scan")).mean())
    b = np.asarray(pool.render_film_pool(sd, ds.camera, cfg).mean())
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3)


def test_pool_resume_counts():
    ds, sd, cfg = _setup(spp=2)
    f1 = pool.render_film_pool(sd, ds.camera, cfg)
    f2 = pool.render_film_pool(sd, ds.camera, cfg, film=f1)
    assert int(f2.count) == 4
    # resumed pool render consumes sample ids 2..3 -> equals straight 4spp
    f4 = pool.render_film_pool(sd, ds.camera, cfg.replace(spp=4))
    np.testing.assert_allclose(
        np.asarray(f2.mean()), np.asarray(f4.mean()), rtol=1e-4, atol=1e-5
    )


def test_render_film_dispatches_to_pool():
    ds, sd, cfg = _setup()
    a = R.render_film(sd, ds.camera, cfg)  # engine defaults to pool
    assert int(a.count) == cfg.spp
    assert np.isfinite(np.asarray(a.accum)).all()


@pytest.mark.slow
def test_pool_film_tiling_matches_untiled(monkeypatch):
    # large-film path: shrink FILM_TILE so an 8x8 film needs tiling; 24
    # doesn't divide 64 so the last tile exercises the wrap-pad masking
    ds, sd, cfg = _setup(spp=2)
    a = np.asarray(pool.render_film_pool(sd, ds.camera, cfg).mean())
    for tile in (16, 24):
        monkeypatch.setattr(pool, "FILM_TILE", tile)
        f = pool.render_film_pool(sd, ds.camera, cfg)
        assert int(f.count) == cfg.spp
        np.testing.assert_allclose(np.asarray(f.mean()), a,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_pool_distributed_matches_single():
    from jaderaytracerendering_tpu.parallel import sharding

    ds, sd, cfg = _setup(spp=4)
    for shape in ((4, 1), (2, 2)):
        mesh = sharding.make_mesh(shape)
        f_d = sharding.render_film_distributed(sd, ds.camera, cfg, mesh)
        f_s = pool.render_film_pool(sd, ds.camera, cfg)
        np.testing.assert_allclose(
            np.asarray(f_d.mean()), np.asarray(f_s.mean()),
            rtol=1e-3, atol=1e-4,
        )


def _many_lights_setup(**kw):
    """The jade scene plus an emissive sphere: more than 19 emissive
    triangles, one NEE shadow-ray segment per light."""
    from jaderaytracerendering_tpu.scene import material, objloader, procedural
    from jaderaytracerendering_tpu.scene import transforms
    from jaderaytracerendering_tpu.scene.scene import SceneObject

    ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    v, f = procedural.uv_sphere(3, 6)
    mesh = objloader.mesh_from_arrays(v, f, transform=transforms.transform_matrix(
        translate=(0.6, 0.8, 0.3), scale=(0.15, 0.15, 0.15)))
    ds.objects.append(SceneObject(mesh=mesh, material=material.LIGHT_1000,
                                  name="sphere_light"))
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    base = dict(width=8, height=8, spp=2, spp_batch=2, max_depth=3,
                traversal="bvh", rays_per_launch=64)
    base.update(kw)
    return ds, sd, RenderConfig(**base)


@pytest.mark.parametrize("case", ["many_lights", "sweep", "sweep_many_lights"])
def test_pool_matches_scan_on_gpu_route(case):
    """The pool engine (its one XLA path) equals the scan engine — with
    more than 19 emissive triangles and with the sweep kernel."""
    if case == "sweep":
        ds, sd, cfg = _setup(traversal="sweep", rays_per_launch=128)
    else:
        ds, sd, cfg = _many_lights_setup(
            traversal="sweep" if case.startswith("sweep") else "bvh")
        assert sd.n_emit > 19
    a = np.asarray(R.render_film(sd, ds.camera, cfg.replace(engine="scan")).mean())
    b = np.asarray(pool.render_film_pool(sd, ds.camera, cfg).mean())
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3)


def test_pool_reports_useful_rays():
    ds, sd, cfg = _setup(spp=2)
    rays = []
    R.render_film(sd, ds.camera, cfg, rays=rays)
    n = sum(float(r) for r in rays)
    # at least the primary rays, at most every lane's full (E+2) fan-out
    # per bounce plus the primaries
    assert 64 * 2 <= n <= 64 * 2 * (1 + cfg.max_depth * (sd.n_emit + 2))
