"""The GPU program, lowered for ``cuda`` on this CPU host.

With the capability switch forced to compiled kernels, each render path
lowers exactly as the card's compiler receives it: the cluster sweep
must appear as a Triton call (not inlined by the Pallas interpreter)
and nothing may target another accelerator. This catches a kernel that
the Triton route cannot lower, without the card.
"""

import dataclasses
import re

import jax.numpy as jnp
import pytest

from jaderaytracerendering_tpu.integrator import pool, render as R
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.scene import material
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.utils import backend
from jaderaytracerendering_tpu.utils.config import RenderConfig

TRITON = "__gpu$xla.gpu.triton"


def _scene(name):
    if name == "cornell":
        ds = demo.cornell_scene()
    else:
        ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
        if name == "refract":
            o = ds.objects[0]
            ds.objects[0] = dataclasses.replace(o, material=dataclasses.replace(
                o.material, refract_mode=material.DIR_REFRACT,
                refract_index=1.5, refract_rate=(0.9, 0.9, 0.9)))
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    return ds, sd


def _lower(path, ds, sd):
    cfg = RenderConfig(width=8, height=8, spp=2, spp_batch=2, max_depth=3,
                       rays_per_launch=128, max_refract_bounces=4)
    eye = jnp.asarray(ds.camera.eye, jnp.float32)
    rot = jnp.asarray(ds.camera.camera_rotate, jnp.float32)
    ids = jnp.arange(64, dtype=jnp.uint32)
    if path == "pool-full":
        traced = pool._pool_render.trace(sd, eye, rot, 128, cfg, 128, 0)
    elif path == "scan-full":
        traced = R.render_batch.trace(sd, eye, rot, ids, 0,
                                      cfg.replace(engine="scan"), 2)
    elif path == "scan-preview":
        traced = R._preview_frame.trace(
            jnp.zeros((64, 3)), sd, eye, rot, 0, 1,
            cfg.replace(integrator="preview"), 1, 64, True)
    else:  # banded preview
        traced = R._preview_band_frame.trace(
            jnp.zeros((64, 3)), sd, eye, rot, jnp.int32(0),
            cfg.replace(integrator="preview", preview_bands=4), 1, 16, 16)
    return traced.lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("scene", ["jade", "refract", "cornell"])
@pytest.mark.parametrize("path", ["pool-full", "scan-full", "scan-preview",
                                  "scan-preview-banded"])
def test_render_lowers_for_cuda_with_compiled_kernels(path, scene):
    ds, sd = _scene(scene)
    if scene == "refract":
        assert sd.has_refract and not sd.has_sss
    elif scene == "jade":
        assert sd.has_sss
    with backend.compiled_kernels():
        txt = _lower(path, ds, sd)
    targets = set(re.findall(r"custom_call @([\w$.]+)", txt))
    # the traversal runs as compiled Triton kernels, nothing else is a
    # custom call, and no other accelerator's kernel route appears
    assert TRITON in targets, targets
    assert targets == {TRITON}, targets
    assert "mosaic" not in txt.lower()
    assert txt.count(TRITON) >= 1
