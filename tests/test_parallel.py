"""Multi-(fake-)device sharding tests on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaderaytracerendering_tpu.integrator import render as R
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.parallel import sharding
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.utils.config import RenderConfig


@pytest.fixture(scope="module")
def scene():
    ds = demo.tiny_scene()
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    return ds, sd


def _cfg(**kw):
    base = dict(width=8, height=8, spp=2, spp_batch=2, max_depth=2,
                traversal="bvh")
    base.update(kw)
    return RenderConfig(**base)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_scan_path_clamps_last_pass(scene):
    # spp=6 on a 2-wide spp axis with spp_batch=2 (per_pass 4) previously
    # rendered 8 samples; the last pass must clamp to exactly cfg.spp
    ds, sd = scene
    mesh = sharding.make_mesh((4, 2))
    cfg = _cfg(spp=6, spp_batch=2)
    film_d = sharding.render_film_distributed(sd, ds.camera, cfg, mesh)
    assert int(film_d.count) == 6
    film_s = R.render_film(sd, ds.camera, cfg)
    np.testing.assert_allclose(
        np.asarray(film_d.mean()), np.asarray(film_s.mean()),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)],
                         ids=["tile8", "tile4spp2", "tile2spp4", "spp8"])
@pytest.mark.slow
def test_sharded_matches_single_device(scene, mesh_shape):
    ds, sd = scene
    cfg = _cfg()
    mesh = sharding.make_mesh(mesh_shape)
    n_spp = mesh.shape["spp"]
    # distributed pass adds sppb * n_spp samples; single-device reference
    # runs the same total with the same sample ids
    film_d = sharding.render_film_distributed(
        sd, ds.camera, cfg.replace(spp=2 * n_spp), mesh
    )
    film_s = R.render_film(sd, ds.camera, cfg.replace(spp=2 * n_spp))
    assert int(film_d.count) == int(film_s.count) == 2 * n_spp
    np.testing.assert_allclose(
        np.asarray(film_d.mean()), np.asarray(film_s.mean()),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("engine", ["scan", "pool"])
@pytest.mark.slow
def test_sharded_production_sweep_kernel(scene, engine):
    """shard_map x pallas_call composition: the PRODUCTION traversal
    (Pallas cluster sweep, interpret mode on CPU) must run and match the
    single-device render inside both sharded engines — this is the code
    path a multi-GPU host executes."""
    ds, sd = scene
    cfg = _cfg(traversal="sweep", engine=engine, spp=4)
    mesh = sharding.make_mesh((2, 2))
    film_d = sharding.render_film_distributed(sd, ds.camera, cfg, mesh)
    film_s = R.render_film(sd, ds.camera, cfg)
    assert int(film_d.count) == int(film_s.count) == 4
    np.testing.assert_allclose(
        np.asarray(film_d.mean()), np.asarray(film_s.mean()),
        rtol=1e-4, atol=1e-5,
    )


def test_film_shard_layout(scene):
    ds, sd = scene
    cfg = _cfg()
    mesh = sharding.make_mesh((8, 1))
    pixel_ids = jnp.arange(64, dtype=jnp.uint32)
    out = sharding.render_batch_sharded(
        sd, jnp.asarray(ds.camera.eye, jnp.float32),
        jnp.asarray(ds.camera.camera_rotate, jnp.float32),
        pixel_ids, 0, cfg, 1, mesh,
    )
    assert out.shape == (64, 3)
    # output is sharded over the tile axis
    assert len(out.sharding.device_set) == 8


def test_progressive_accumulation_distributed(scene):
    ds, sd = scene
    cfg = _cfg(spp=4, spp_batch=2)
    mesh = sharding.make_mesh((4, 2))
    f1 = sharding.render_film_distributed(sd, ds.camera, cfg, mesh)
    # resume: render 4 more spp on top
    f2 = sharding.render_film_distributed(sd, ds.camera, cfg, mesh, film=f1)
    assert int(f2.count) == 2 * int(f1.count)
    # resumed accumulation consumes the same sample ids as one straight
    # 8-spp render, so the films must match exactly (bitwise-stable RNG)
    f8 = R.render_film(sd, ds.camera, cfg.replace(spp=8))
    np.testing.assert_allclose(
        np.asarray(f2.mean()), np.asarray(f8.mean()), rtol=1e-4, atol=1e-5
    )


def test_gather_film_all_gather(scene):
    ds, sd = scene
    cfg = _cfg()
    mesh = sharding.make_mesh((8, 1))
    pixel_ids = jnp.arange(64, dtype=jnp.uint32)
    out = sharding.render_batch_sharded(
        sd, jnp.asarray(ds.camera.eye, jnp.float32),
        jnp.asarray(ds.camera.camera_rotate, jnp.float32),
        pixel_ids, 0, cfg, 1, mesh,
    )
    full = sharding.gather_film(out, mesh)
    # replicated result equals the sharded values
    np.testing.assert_allclose(np.asarray(full), np.asarray(out), rtol=1e-6)
    assert len(full.sharding.device_set) == 8  # replicated on all


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_mesh_render_matches_single_device(scene, shape):
    """The --mesh render at the GPU defaults (pool engine, sweep kernel
    interpreted here) equals the one-device render of the same samples:
    RNG streams are keyed by (pixel, sample), so only the fp32 summation
    order differs."""
    ds, sd = scene
    cfg = RenderConfig(width=8, height=8, spp=4, spp_batch=2, max_depth=2,
                       rays_per_launch=64)
    mesh = sharding.make_mesh(shape)
    film_d = sharding.render_film_distributed(sd, ds.camera, cfg, mesh)
    film_s = R.render_film(sd, ds.camera, cfg)
    assert int(film_d.count) == int(film_s.count) == 4
    a, b = np.asarray(film_d.accum), np.asarray(film_s.accum)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())
