"""Checks that need an NVIDIA GPU: the compiled sweep kernel against the
brute-force oracle. They skip elsewhere; ``python chip_smoke.py`` runs
the same comparison at full size on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.ops import bruteforce
from jaderaytracerendering_tpu.ops.pallas import cluster_sweep
from jaderaytracerendering_tpu.scene.scene import assemble


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [None, (256, 768)])
def test_compiled_sweep_matches_bruteforce(gpu, anyhit):
    ds = demo.jade_scene(n_buddha_tris=20_000, env_shape=(16, 32))
    sdn = assemble(ds.objects, ds.env_map, xp=np)
    sd = jax.tree.map(jnp.asarray, sdn)
    rng = np.random.default_rng(0)
    o = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    d = rng.normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ex = np.full(1000, -1, np.int32)
    got = tuple(map(np.asarray, cluster_sweep.nearest_hit_sweep_jnp(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex), sd,
        anyhit=anyhit)))
    want = bruteforce.nearest_hit_np(o, d, ex, sdn.tri_p1, sdn.tri_p2,
                                     sdn.tri_p3)
    np.testing.assert_array_equal(want[0], got[0])
    if anyhit is None:
        bruteforce.compare_hits(want, got, o, d, sdn.tri_p1, sdn.tri_p2,
                                sdn.tri_p3, rtol=1e-5)
