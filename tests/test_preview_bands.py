"""Banded progressive preview (cfg.preview_bands): one pixel band per
displayed frame. A full rotation of B banded frames delivers exactly the
samples of ONE full-frame pass (same (pixel, sample-id) set), so the
accumulated film must match bit-exactly — display rate decoupled from
sample rate without touching the estimator. Reference UX: the fluid
interactive window loop, /root/reference/PathTrace.cpp:1180-1187.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from jaderaytracerendering_tpu.core.film import Film
from jaderaytracerendering_tpu.integrator import render as R
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.utils.config import RenderConfig


@pytest.fixture(scope="module")
def scene():
    ds = demo.jade_scene(n_buddha_tris=600, env_shape=(16, 32))
    sd = assemble(ds.objects, ds.env_map, xp=jnp)
    return ds, sd


def _full_frame(ds, sd, cfg):
    film, disp = R.render_film_preview(sd, ds.camera, cfg.replace(
        preview_bands=1), film=None, display=True)
    return film, disp


def _banded_rotation(ds, sd, cfg):
    film = None
    disp = None
    for f in range(cfg.preview_bands):
        film, disp = R.render_film_preview(sd, ds.camera, cfg, film=film,
                                           display=True, frame_idx=f)
    return film, disp


def test_banded_rotation_matches_full_frame_pool(scene):
    ds, sd = scene
    cfg = RenderConfig(width=16, height=16, spp=2, spp_batch=2,
                       max_depth=2, integrator="preview",
                       traversal="clusters", engine="scan",
                       rays_per_launch=128, preview_bands=4)
    full, full_disp = _full_frame(ds, sd, cfg)
    band, band_disp = _banded_rotation(ds, sd, cfg)
    np.testing.assert_array_equal(np.asarray(full.accum),
                                  np.asarray(band.accum))
    assert int(band.count) == int(full.count)
    # after a whole rotation the count map is uniform -> same display
    np.testing.assert_array_equal(np.asarray(full_disp),
                                  np.asarray(band_disp))


def test_partial_rotation_display_counts(scene):
    # after ONE banded frame only band 0's rows are populated and the
    # display must divide band 0 by its real count (not the film count)
    ds, sd = scene
    cfg = RenderConfig(width=16, height=16, spp=2, spp_batch=2,
                       max_depth=2, integrator="preview",
                       traversal="clusters", engine="scan",
                       rays_per_launch=128, preview_bands=4)
    film, disp = R.render_film_preview(sd, ds.camera, cfg, film=None,
                                       display=True, frame_idx=0)
    a = np.asarray(film.accum).reshape(-1, 3)
    band_px = 16 * 16 // 4
    assert np.abs(a[band_px:]).max() == 0.0
    assert np.abs(a[:band_px]).sum() > 0.0
    d = np.asarray(disp).reshape(-1, 3)
    # film row 0 = scene bottom; display is flipped, so band 0 (flat
    # pixels 0..band_px) is the BOTTOM quarter = the display's last rows
    assert d[-band_px:].sum() > 0
