"""Unit tests: vector math, RNG, camera, film."""

import jax.numpy as jnp
import numpy as np
import pytest

from jaderaytracerendering_tpu.core import camera, film, rng, vecmath


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
class TestVecmath:
    def test_cross_matches_numpy(self, xp):
        a = xp.asarray(np.random.default_rng(0).normal(size=(7, 3)), xp.float32)
        b = xp.asarray(np.random.default_rng(1).normal(size=(7, 3)), xp.float32)
        got = np.asarray(vecmath.cross(a, b, xp))
        want = np.cross(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_mixed_product(self, xp):
        a = xp.asarray([1.0, 0, 0])
        b = xp.asarray([0.0, 1, 0])
        c = xp.asarray([0.0, 0, 1])
        assert float(vecmath.mixed_product(a, b, c, xp)) == 1.0

    def test_normalize(self, xp):
        v = xp.asarray([[3.0, 0.0, 4.0]])
        n = np.asarray(vecmath.normalize(v, xp))
        np.testing.assert_allclose(n, [[0.6, 0.0, 0.8]], rtol=1e-6)

    def test_reflect(self, xp):
        d = xp.asarray([[1.0, -1.0, 0.0]])
        n = xp.asarray([[0.0, 1.0, 0.0]])
        r = np.asarray(vecmath.reflect(d, n, xp))
        np.testing.assert_allclose(r, [[1.0, 1.0, 0.0]], atol=1e-6)

    def test_triangle_area(self, xp):
        p1 = xp.asarray([0.0, 0, 0])
        p2 = xp.asarray([1.0, 0, 0])
        p3 = xp.asarray([0.0, 1, 0])
        assert float(vecmath.triangle_area(p1, p2, p3, xp)) == pytest.approx(0.5)

    def test_transform_matches_reference_layout(self, xp):
        # m[col, row] layout: translation lives in m[3, 0..2]
        # (PathTrace.cu:268-276).
        m = np.eye(4, dtype=np.float32)
        m[3, 0], m[3, 1], m[3, 2] = 1.0, 2.0, 3.0
        v = xp.asarray([[1.0, 1.0, 1.0]])
        p = np.asarray(vecmath.transform_point(xp.asarray(m), v, xp))
        np.testing.assert_allclose(p, [[2.0, 3.0, 4.0]])
        d = np.asarray(vecmath.transform_dir(xp.asarray(m), v, xp))
        np.testing.assert_allclose(d, [[1.0, 1.0, 1.0]])


class TestRng:
    def test_numpy_jax_bitwise_identical(self):
        pid = np.arange(4096, dtype=np.uint32)
        a = rng.uniform(np, pid, 3, 2, 7, seed=9)
        b = np.asarray(rng.uniform(jnp, jnp.asarray(pid), 3, 2, 7, seed=9))
        np.testing.assert_array_equal(a, b)

    def test_range_and_uniformity(self):
        pid = np.arange(200_000, dtype=np.uint32)
        u = rng.uniform(np, pid, 0, 0, 0)
        assert u.min() >= 0.0 and u.max() < 1.0
        # mean ~0.5, variance ~1/12
        assert abs(u.mean() - 0.5) < 2e-3
        assert abs(u.var() - 1.0 / 12.0) < 2e-3

    def test_site_decorrelation(self):
        pid = np.arange(100_000, dtype=np.uint32)
        u1 = rng.uniform(np, pid, 0, 0, 1)
        u2 = rng.uniform(np, pid, 0, 0, 2)
        corr = np.corrcoef(u1, u2)[0, 1]
        assert abs(corr) < 0.01

    def test_deterministic(self):
        assert float(rng.uniform(np, 5, 6, 7, 8)) == float(rng.uniform(np, 5, 6, 7, 8))

    def test_uniform_sites_matches_per_site_calls(self):
        # the bounce's batched [S, M] draw (a broadcast site column, as
        # wavefront.front_precompute makes it) must be bit-identical to
        # S independent uniform() calls (oracle parity depends on it)
        pid = np.arange(512, dtype=np.uint32).reshape(1, 512)
        sites = [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 64, 65, 66, 67]
        for xp in (np, jnp):
            col = xp.asarray(np.asarray(sites, np.uint32)[:, None])
            batched = np.asarray(rng.uniform(
                xp, xp.asarray(pid), 3, 2, col, seed=9))
            for i, s in enumerate(sites):
                single = np.asarray(rng.uniform(
                    xp, xp.asarray(pid), 3, 2, int(s), seed=9))
                np.testing.assert_array_equal(batched[i:i + 1], single)


class TestCamera:
    def test_lookat_inverse_is_rigid_inverse(self):
        cam = camera.OrbitCamera(up_angle=10.0, rotate_angle=30.0, r=4.0)
        m = cam.camera_rotate
        # applying inverse(lookAt) to the origin-direction (0,0,-1.5) must
        # produce a vector pointing from eye toward eye_center
        d = vecmath.transform_dir(m.astype(np.float32), np.array([[0.0, 0.0, -1.5]]), np)
        d = d / np.linalg.norm(d)
        want = cam.eye_center - cam.eye
        want = want / np.linalg.norm(want)
        np.testing.assert_allclose(d[0], want, atol=1e-5)

    def test_default_eye_radius(self):
        cam = camera.OrbitCamera()
        np.testing.assert_allclose(cam.eye, [0.0, 0.0, 4.0], atol=1e-12)

    def test_ray_gen_shapes_and_norm(self):
        cam = camera.OrbitCamera()
        pid = np.arange(16, dtype=np.uint32)
        o, d = camera.generate_rays(
            np, cam.eye, cam.camera_rotate, 4, 4, pid, 0
        )
        assert o.shape == (16, 3) and d.shape == (16, 3)
        np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-5)
        # all rays look roughly toward -z from eye at +z
        assert (d[:, 2] < 0).all()

    def test_gl_vs_cuda_jitter_close(self):
        cam = camera.OrbitCamera()
        pid = np.arange(64, dtype=np.uint32)
        _, d1 = camera.generate_rays(np, cam.eye, cam.camera_rotate, 8, 8, pid, 0, jitter="cuda")
        _, d2 = camera.generate_rays(np, cam.eye, cam.camera_rotate, 8, 8, pid, 0, jitter="gl")
        assert np.abs(d1 - d2).max() < 0.2


class TestFilm:
    def test_accumulate_and_mean(self):
        f = film.Film.create(2, 2)
        ones = jnp.ones((2, 2, 3))
        f = f.add(ones * 4.0, 4)
        np.testing.assert_allclose(np.asarray(f.mean()), 1.0)
        f = f.add(ones * 0.0, 4)
        np.testing.assert_allclose(np.asarray(f.mean()), 0.5)

    def test_reset(self):
        f = film.Film.create(2, 2).add(jnp.ones((2, 2, 3)), 1).reset()
        assert int(f.count) == 0
        np.testing.assert_allclose(np.asarray(f.accum), 0.0)

    def test_save_load_roundtrip(self, tmp_path):
        f = film.Film.create(3, 2).add(jnp.full((3, 2, 3), 2.5), 5)
        p = str(tmp_path / "film.npz")
        f.save(p)
        g = film.Film.load(p)
        np.testing.assert_array_equal(np.asarray(f.accum), np.asarray(g.accum))
        assert int(g.count) == 5


class TestCompatRng:
    def test_wang_hash_known_values(self):
        # hand-computed from the reference algorithm
        def ref(seed):
            seed = (seed ^ 61) ^ (seed >> 16)
            seed = (seed * 9) & 0xFFFFFFFF
            seed = seed ^ (seed >> 4)
            seed = (seed * 0x27D4EB2D) & 0xFFFFFFFF
            return seed ^ (seed >> 15)
        for s in (1, 42, 1973, 0xDEADBEEF):
            got = int(rng.wang_hash(np.uint32(s), np))
            assert got == ref(s)
        # numpy == jax
        a = rng.wang_hash(np.arange(100, dtype=np.uint32), np)
        b = np.asarray(rng.wang_hash(jnp.arange(100, dtype=jnp.uint32), jnp))
        np.testing.assert_array_equal(a, b)

    def test_glsl_seed_is_odd(self):
        s = rng.glsl_seed(np.float32(0.25), np.float32(-0.5), 1024, 1024, 7, np)
        assert int(s) % 2 == 1


class TestConfigPresets:
    def test_presets(self):
        from jaderaytracerendering_tpu.utils import config as C
        cu = C.cuda_parity(width=64)
        assert cu.rr_rate == 0.9 and cu.max_depth == 128 and cu.width == 64
        gl = C.gl_render_parity()
        assert gl.rr_rate == 0.8 and gl.max_depth == 16 and gl.jitter == "gl"
        pv = C.gl_preview_parity()
        assert pv.integrator == "preview" and pv.preview_bounces == 2

    def test_config_json_roundtrip(self):
        from jaderaytracerendering_tpu.utils.config import RenderConfig
        cfg = RenderConfig(width=33, mesh_shape=(2, 4), traversal="gemm")
        back = RenderConfig.from_json(cfg.to_json())
        assert back == cfg
