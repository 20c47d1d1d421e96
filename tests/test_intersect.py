"""Intersection kernels: analytic cases, method cross-checks, and
BVH-vs-brute-force equivalence on random scenes (SURVEY §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from jaderaytracerendering_tpu.ops import bruteforce, intersect, traverse
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.scene import procedural
from jaderaytracerendering_tpu.core import vecmath as vm

INF = intersect.INF


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("method", ["mt", "shadow"])
@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
class TestRayTriangle:
    def test_direct_hit(self, xp, method):
        o = xp.asarray([[0.0, 0.0, 5.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])
        p1 = xp.asarray([[-1.0, -1.0, 0.0]])
        p2 = xp.asarray([[2.0, -1.0, 0.0]])
        p3 = xp.asarray([[-1.0, 2.0, 0.0]])
        hit, t = intersect.ray_triangle(o, d, p1, p2, p3, xp, method)
        assert bool(np.asarray(hit)[0])
        assert float(np.asarray(t)[0]) == pytest.approx(5.0, rel=1e-5)

    def test_miss_outside(self, xp, method):
        o = xp.asarray([[5.0, 5.0, 5.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])
        p1 = xp.asarray([[-1.0, -1.0, 0.0]])
        p2 = xp.asarray([[1.0, -1.0, 0.0]])
        p3 = xp.asarray([[0.0, 1.0, 0.0]])
        hit, t = intersect.ray_triangle(o, d, p1, p2, p3, xp, method)
        assert not bool(np.asarray(hit)[0])
        assert float(np.asarray(t)[0]) == pytest.approx(INF, rel=1e-6)

    def test_behind_origin(self, xp, method):
        o = xp.asarray([[0.0, 0.0, -5.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])  # triangle at z=0 is behind
        p1 = xp.asarray([[-1.0, -1.0, 0.0]])
        p2 = xp.asarray([[2.0, -1.0, 0.0]])
        p3 = xp.asarray([[-1.0, 2.0, 0.0]])
        hit, _ = intersect.ray_triangle(o, d, p1, p2, p3, xp, method)
        assert not bool(np.asarray(hit)[0])


def test_methods_agree_on_random_rays():
    rng = np.random.default_rng(0)
    n = 3000
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    # avoid the shadow method's dir.z ~ 0 singularity for the comparison
    mask = np.abs(d[:, 2]) > 0.05
    o, d = o[mask], d[mask]
    p1 = np.tile(np.array([[-1.0, -1.0, 0.0]], np.float32), (len(o), 1))
    p2 = np.tile(np.array([[1.0, -1.0, 0.0]], np.float32), (len(o), 1))
    p3 = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (len(o), 1))
    h1, t1 = intersect.ray_triangle(o, d, p1, p2, p3, np, "mt")
    h2, t2 = intersect.ray_triangle(o, d, p1, p2, p3, np, "shadow")
    # boundary hits may differ (strict vs inclusive); interior must agree
    interior = h1 & h2
    assert interior.sum() > 50
    np.testing.assert_allclose(t1[interior], t2[interior], rtol=1e-3, atol=1e-4)
    disagree = h1 != h2
    assert disagree.mean() < 0.01


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
class TestRayAABB:
    def test_outside_entry(self, xp):
        o = xp.asarray([[0.0, 0.0, 5.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])
        aa = xp.asarray([[-1.0, -1.0, -1.0]])
        bb = xp.asarray([[1.0, 1.0, 1.0]])
        enter, dist = intersect.ray_aabb(o, d, aa, bb, xp)
        assert float(np.asarray(dist)[0]) == pytest.approx(4.0)
        assert float(np.asarray(enter)[0]) == pytest.approx(4.0)

    def test_inside_returns_exit(self, xp):
        o = xp.asarray([[0.0, 0.0, 0.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])
        aa = xp.asarray([[-1.0, -1.0, -1.0]])
        bb = xp.asarray([[1.0, 1.0, 1.0]])
        enter, dist = intersect.ray_aabb(o, d, aa, bb, xp)
        assert float(np.asarray(dist)[0]) == pytest.approx(1.0)  # exit t
        assert float(np.asarray(enter)[0]) == pytest.approx(0.0)

    def test_miss(self, xp):
        o = xp.asarray([[5.0, 5.0, 5.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])
        aa = xp.asarray([[-1.0, -1.0, -1.0]])
        bb = xp.asarray([[1.0, 1.0, 1.0]])
        _, dist = intersect.ray_aabb(o, d, aa, bb, xp)
        assert float(np.asarray(dist)[0]) == -1.0

    def test_zero_dir_component_on_aa_plane_hits(self, xp):
        # 0 * inf -> NaN hazard: ray starts exactly ON the x = aa.x plane
        # with dir.x == 0. The reference's ternary max + NaN-dropping
        # fminf reductions make the NaN axis fall out of the slab test,
        # so this HITS; propagate-NaN min/max would false-miss.
        o = xp.asarray([[-1.0, 0.0, 5.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])
        aa = xp.asarray([[-1.0, -1.0, -1.0]])
        bb = xp.asarray([[1.0, 1.0, 1.0]])
        enter, dist = intersect.ray_aabb(o, d, aa, bb, xp)
        assert float(np.asarray(dist)[0]) == pytest.approx(4.0)
        assert float(np.asarray(enter)[0]) == pytest.approx(4.0)

    def test_zero_dir_component_on_bb_plane_misses(self, xp):
        # asymmetric twin: on the bb plane the reference ternary keeps
        # n = -inf for tmax, so t1 = -inf -> miss
        o = xp.asarray([[1.0, 0.0, 5.0]])
        d = xp.asarray([[0.0, 0.0, -1.0]])
        aa = xp.asarray([[-1.0, -1.0, -1.0]])
        bb = xp.asarray([[1.0, 1.0, 1.0]])
        _, dist = intersect.ray_aabb(o, d, aa, bb, xp)
        assert float(np.asarray(dist)[0]) == -1.0


def _random_rays(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    return o, d


class TestNearestHit:
    @pytest.fixture(scope="class")
    def scene_np(self):
        ds = demo.jade_scene(n_buddha_tris=2000, env_shape=(16, 32))
        return assemble(ds.objects, ds.env_map, xp=np)

    def test_brute_np_vs_jnp(self, scene_np):
        sd = scene_np
        o, d = _random_rays(512, 1)
        ex = np.full(512, -1, np.int32)
        h1, i1, t1 = bruteforce.nearest_hit_np(o, d, ex, sd.tri_p1, sd.tri_p2, sd.tri_p3)
        h2, i2, t2 = bruteforce.nearest_hit_jnp(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex),
            jnp.asarray(sd.tri_p1), jnp.asarray(sd.tri_p2), jnp.asarray(sd.tri_p3),
        )
        np.testing.assert_array_equal(h1, np.asarray(h2))
        np.testing.assert_array_equal(i1, np.asarray(i2))
        np.testing.assert_allclose(t1, np.asarray(t2), rtol=1e-5)

    def test_bvh_np_matches_brute(self, scene_np):
        sd = scene_np
        o, d = _random_rays(512, 2)
        ex = np.full(512, -1, np.int32)
        hb, ib, tb = bruteforce.nearest_hit_np(o, d, ex, sd.tri_p1, sd.tri_p2, sd.tri_p3)
        hv, iv, tv = traverse.nearest_hit_bvh_np(o, d, ex, sd)
        np.testing.assert_array_equal(hb, hv)
        # indices can differ only on exact-tie distances; distances must match
        np.testing.assert_allclose(np.where(hb, tb, 0), np.where(hv, tv, 0), rtol=1e-5)
        assert (ib == iv)[hb].mean() > 0.999

    def test_bvh_jnp_matches_np(self, scene_np):
        sd = scene_np
        import jax
        sd_j = jax.tree.map(jnp.asarray, sd)
        o, d = _random_rays(256, 3)
        ex = np.full(256, -1, np.int32)
        h1, i1, t1 = traverse.nearest_hit_bvh_np(o, d, ex, sd)
        h2, i2, t2 = traverse.nearest_hit_bvh_jnp(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex), sd_j
        )
        np.testing.assert_array_equal(h1, np.asarray(h2))
        np.testing.assert_array_equal(i1, np.asarray(i2))
        np.testing.assert_allclose(t1, np.asarray(t2), rtol=1e-5)

    def test_bvh_dead_lanes_miss_without_walking(self, scene_np):
        """Zero-direction (masked) lanes start with an empty stack: they
        miss and cost the walk no steps, so live lanes' results are
        unchanged and the loop runs no longer than for the live lanes."""
        import jax

        sd = scene_np
        sd_j = jax.tree.map(jnp.asarray, sd)
        o, d = _random_rays(64, 4)
        d[::2] = 0.0
        ex = np.full(64, -1, np.int32)
        h, i, t = traverse.nearest_hit_bvh_np(o, d, ex, sd)
        assert not h[::2].any() and (t[::2] == traverse.INF).all()
        hl, il, tl = traverse.nearest_hit_bvh_np(o[1::2], d[1::2], ex[1::2], sd)
        np.testing.assert_array_equal(h[1::2], hl)
        np.testing.assert_array_equal(i[1::2], il)
        sp0 = traverse._init_state(jnp.asarray(d), 8, jnp)[0]
        np.testing.assert_array_equal(np.asarray(sp0), np.arange(64) % 2)
        h2, _, _ = traverse.nearest_hit_bvh_jnp(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex), sd_j)
        np.testing.assert_array_equal(h, np.asarray(h2))

    def test_exclusion(self, scene_np):
        sd = scene_np
        # shoot a ray straight at a known triangle, then exclude it
        tri = 0
        c = (sd.tri_p1[tri] + sd.tri_p2[tri] + sd.tri_p3[tri]) / 3
        n = sd.tri_norm[tri]
        o = (c + n * 0.05)[None, :]
        d = (-n)[None, :]
        ex_none = np.array([-1], np.int32)
        h1, i1, _ = bruteforce.nearest_hit_np(o, d, ex_none, sd.tri_p1, sd.tri_p2, sd.tri_p3)
        assert h1[0] and i1[0] == tri
        ex_self = np.array([tri], np.int32)
        h2, i2, _ = bruteforce.nearest_hit_np(o, d, ex_self, sd.tri_p1, sd.tri_p2, sd.tri_p3)
        assert (not h2[0]) or i2[0] != tri

    def test_rays_from_inside_hit(self, scene_np):
        # rays from the scene interior should mostly hit the floor slab
        sd = scene_np
        n = 128
        o = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n, 1))
        rng = np.random.default_rng(5)
        d = _unit(rng.normal(size=(n, 3)))
        d[:, 1] = -np.abs(d[:, 1]) - 0.5  # downward
        d = _unit(d)
        ex = np.full(n, -1, np.int32)
        h, _, _ = traverse.nearest_hit_bvh_np(o, d, ex, sd)
        assert h.mean() > 0.95
