"""Cluster decomposition, cluster-queue traversal, GEMM intersector, and
the Pallas-Triton sweep kernel (interpret mode on CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jaderaytracerendering_tpu.core import vecmath
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.ops import bruteforce, cluster_traverse, gemm_intersect
from jaderaytracerendering_tpu.ops.pallas import cluster_sweep
from jaderaytracerendering_tpu.scene.scene import assemble


@pytest.fixture(scope="module")
def scene():
    ds = demo.jade_scene(n_buddha_tris=2_000, env_shape=(16, 32))
    sdn = assemble(ds.objects, ds.env_map, xp=np)
    sdj = jax.tree.map(jnp.asarray, sdn)
    return sdn, sdj


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, -1, np.int32)


class TestClusters:
    def test_partition_and_bounds(self, scene):
        sdn, _ = scene
        begin = np.asarray(sdn.cluster_begin)
        count = np.asarray(sdn.cluster_count)
        cover = np.zeros(sdn.n_triangles, np.int32)
        for b, c in zip(begin, count):
            cover[b : b + c] += 1
        assert (cover == 1).all()
        assert count.max() <= sdn.cluster_k

    def test_blocks_match_triangles(self, scene):
        sdn, _ = scene
        ci = 0
        b, c = int(sdn.cluster_begin[ci]), int(sdn.cluster_count[ci])
        block = np.asarray(sdn.cluster_tris[ci])  # [12, K]
        np.testing.assert_allclose(block[0:3, :c].T, sdn.tri_p1[b : b + c])
        np.testing.assert_allclose(block[6:9, :c].T, sdn.tri_p3[b : b + c])
        # padding slots degenerate
        assert (block[:, c:] == 0).all()

    def test_cluster_aabbs_contain_triangles(self, scene):
        sdn, _ = scene
        for ci in range(min(10, sdn.n_clusters)):
            b, c = int(sdn.cluster_begin[ci]), int(sdn.cluster_count[ci])
            pts = np.concatenate([sdn.tri_p1[b:b+c], sdn.tri_p2[b:b+c], sdn.tri_p3[b:b+c]])
            assert (pts >= np.asarray(sdn.cluster_aa[ci]) - 1e-4).all()
            assert (pts <= np.asarray(sdn.cluster_bb[ci]) + 1e-4).all()


class TestTraversalEquivalence:
    def test_cluster_np_vs_brute(self, scene):
        sdn, _ = scene
        o, d, ex = _rays(512, 1)
        hb, ib, tb = bruteforce.nearest_hit_np(o, d, ex, sdn.tri_p1, sdn.tri_p2, sdn.tri_p3)
        hc, ic, tc = cluster_traverse.nearest_hit_clusters_np(o, d, ex, sdn)
        np.testing.assert_array_equal(hb, hc)
        np.testing.assert_array_equal(ib[hb], ic[hb])

    def test_cluster_jnp_vs_np(self, scene):
        sdn, sdj = scene
        o, d, ex = _rays(256, 2)
        h1, i1, t1 = cluster_traverse.nearest_hit_clusters_np(o, d, ex, sdn)
        h2, i2, t2 = cluster_traverse.nearest_hit_clusters_jnp(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex), sdj
        )
        np.testing.assert_array_equal(h1, np.asarray(h2))
        np.testing.assert_array_equal(i1, np.asarray(i2))

    def test_gemm_np_vs_brute(self, scene):
        sdn, _ = scene
        o, d, ex = _rays(512, 3)
        hb, ib, tb = bruteforce.nearest_hit_np(o, d, ex, sdn.tri_p1, sdn.tri_p2, sdn.tri_p3)
        hg, ig, tg = gemm_intersect.nearest_hit_gemm_np(o, d, ex, sdn.tri_gemm)
        assert (hb == hg).mean() > 0.999  # f32 boundary flips only
        both = hb & hg
        assert (ib[both] == ig[both]).mean() > 0.999
        np.testing.assert_allclose(tb[both], tg[both], rtol=5e-3, atol=1e-3)

    def test_gemm_jnp_vs_np(self, scene):
        sdn, sdj = scene
        o, d, ex = _rays(256, 4)
        h1, i1, t1 = gemm_intersect.nearest_hit_gemm_np(o, d, ex, sdn.tri_gemm)
        h2, i2, t2 = gemm_intersect.nearest_hit_gemm_jnp(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex), sdj.tri_gemm
        )
        assert (h1 == np.asarray(h2)).mean() > 0.999

    def test_zero_direction_rays_miss(self, scene):
        sdn, sdj = scene
        o = np.zeros((16, 3), np.float32)
        d = np.zeros((16, 3), np.float32)
        ex = np.full(16, -1, np.int32)
        h, _, _ = cluster_traverse.nearest_hit_clusters_np(o, d, ex, sdn)
        assert not h.any()
        hs, _, _ = _sweep(o, d, ex, sdj)
        assert not hs.any()


def test_cumsum_indicator_exact():
    """The pool's respawn queue: the k-th fresh lane (lane order) takes
    sample next + k - 1, exactly, and lanes past the queue end get none."""
    from jaderaytracerendering_tpu.integrator import pool

    rng = np.random.default_rng(3)
    for m in (1, 7, 128, 129, 1000, 16384):
        fresh = rng.random(m) < 0.3
        nxt, total = 5, 5 + int(fresh.sum()) // 2
        got, idx, consumed = map(np.asarray, pool.assign_samples(
            jnp.asarray(fresh), jnp.int32(nxt), jnp.int32(total)))
        want_idx = nxt + np.cumsum(fresh.astype(np.int32)) - 1
        want_got = fresh & (want_idx < total)
        np.testing.assert_array_equal(got, want_got)
        np.testing.assert_array_equal(idx[got], want_idx[want_got])
        assert int(consumed) == int(want_got.sum()) == total - nxt


# ---- the Pallas-Triton cluster sweep, interpreted on the CPU ------------

def _sweep(o, d, ex, sd, **kw):
    return tuple(map(np.asarray, cluster_sweep.nearest_hit_sweep_jnp(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex), sd,
        interpret=True, **kw)))


def _brute(o, d, ex, sdn):
    return bruteforce.nearest_hit_np(o, d, ex, sdn.tri_p1, sdn.tri_p2,
                                     sdn.tri_p3)


def _assert_same_hits(want, got, o, d, sdn):
    """Flags equal, t to 1e-5, indices equal except at checked near-ties
    (coplanar or edge-sharing triangles hit at the same distance)."""
    res = bruteforce.compare_hits(want, got, o, d, sdn.tri_p1, sdn.tri_p2,
                                  sdn.tri_p3, rtol=1e-5)
    assert res["near_ties"] <= max(2, res["hits"] // 50), res
    return res


def _build(name):
    if name == "jade":
        ds = demo.jade_scene(n_buddha_tris=2_000, env_shape=(16, 32))
        kw = {}
    elif name == "jade_fine":  # many small clusters, several groups
        ds = demo.jade_scene(n_buddha_tris=2_000, env_shape=(16, 32))
        kw = dict(max_cluster=16)
    else:
        ds = demo.cornell_scene()
        kw = {}
    sdn = assemble(ds.objects, ds.env_map, xp=np, **kw)
    return sdn, jax.tree.map(jnp.asarray, sdn)


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        _SCENES[name] = _build(name)
    return _SCENES[name]


class TestSweepKernel:
    @pytest.mark.parametrize("n", [1, 33, 300])
    @pytest.mark.parametrize("name", ["jade", "jade_fine", "cornell"])
    def test_interpret_vs_brute(self, name, n):
        """Ray counts off the block multiple, cluster counts off the
        group multiple (jade: 53 clusters in groups of 16)."""
        sdn, sdj = _scene(name)
        o, d, ex = _rays(n, 5 + n)
        if name == "cornell":
            o = o * 0.2  # inside the box: most rays hit
        _assert_same_hits(_brute(o, d, ex, sdn), _sweep(o, d, ex, sdj),
                          o, d, sdn)

    @pytest.mark.parametrize("name", ["jade", "jade_fine"])
    def test_exclusion(self, name):
        sdn, sdj = _scene(name)
        tri = 5
        c = (sdn.tri_p1[tri] + sdn.tri_p2[tri] + sdn.tri_p3[tri]) / 3
        n = sdn.tri_norm[tri]
        o = np.tile((c + n * 0.05)[None], (8, 1)).astype(np.float32)
        d = np.tile((-n)[None], (8, 1)).astype(np.float32)
        ex = np.full(8, tri, np.int32)
        hs, isw, _ = _sweep(o, d, ex, sdj)
        assert ((~hs) | (isw != tri)).all()
        # without the exclusion the same rays report tri itself
        _assert_same_hits(_brute(o, d, ex * 0 - 1, sdn),
                          _sweep(o, d, ex * 0 - 1, sdj), o, d, sdn)

    def test_random_exclusions_vs_brute(self):
        sdn, sdj = _scene("jade")
        o, d, _ = _rays(200, 31)
        ex = np.random.default_rng(1).integers(
            -1, sdn.n_triangles, 200).astype(np.int32)
        hb = _brute(o, d, np.full(200, -1, np.int32), sdn)
        ex[hb[0]] = hb[1][hb[0]]  # exclude each ray's own nearest hit
        _assert_same_hits(_brute(o, d, ex, sdn), _sweep(o, d, ex, sdj),
                          o, d, sdn)

    def test_zero_direction_rays_miss(self):
        sdn, sdj = _scene("jade")
        o, d, ex = _rays(64, 9)
        d[::2] = 0.0  # dead lanes interleaved with live ones
        got = _sweep(o, d, ex, sdj)
        assert not got[0][::2].any()
        assert (got[2][::2] == cluster_sweep.INF).all()
        _assert_same_hits(_brute(o[1::2], d[1::2], ex[1::2], sdn),
                          tuple(a[1::2] for a in got), o[1::2], d[1::2], sdn)

    @pytest.mark.parametrize("rng_", [(128, 384), (0, 512), (5, 77)])
    def test_anyhit_rows(self, rng_):
        """Any-hit rows report the nearest path's hit boolean; rows
        outside the range keep full nearest results."""
        sdn, sdj = _scene("jade")
        o, d, ex = _rays(512, 13)
        want = _brute(o, d, ex, sdn)
        got = _sweep(o, d, ex, sdj, anyhit=rng_)
        np.testing.assert_array_equal(want[0], got[0])
        lo, hi = rng_
        out = np.ones(512, bool)
        out[lo:hi] = False
        _assert_same_hits(tuple(a[out] for a in want),
                          tuple(a[out] for a in got), o[out], d[out], sdn)

    @pytest.mark.parametrize("warps", [1, 2])
    @pytest.mark.parametrize("bm", [16, 64])
    def test_block_sizes(self, bm, warps):
        sdn, sdj = _scene("jade_fine")
        o, d, ex = _rays(100, 21)
        rays = cluster_sweep.pack_rays(
            *(vecmath.v3unstack(jnp.asarray(a)) for a in (
                o, vecmath.normalize(d, np))))
        got = tuple(map(np.asarray, cluster_sweep.nearest_hit_rays(
            rays, jnp.asarray(ex), sdj, interpret=True, bm=bm,
            num_warps=warps)))
        _assert_same_hits(_brute(o, d, ex, sdn), got, o, d, sdn)

    def test_group_boxes_bound_their_clusters(self):
        sdn, _ = _scene("jade_fine")
        g = sdn.cluster_group
        n_g = -(-sdn.n_clusters // g)
        assert sdn.cluster_group_aa.shape == (n_g, 3)
        for j in range(n_g):
            sl = slice(j * g, (j + 1) * g)
            assert (sdn.cluster_group_aa[j] <= sdn.cluster_aa[sl]).all()
            assert (sdn.cluster_group_bb[j] >= sdn.cluster_bb[sl]).all()

    @pytest.mark.parametrize("max_cluster", [16, 40, 64])
    def test_cluster_k_is_padded_power_of_two(self, max_cluster):
        ds = demo.jade_scene(n_buddha_tris=600, env_shape=(16, 32))
        sdn = assemble(ds.objects, ds.env_map, xp=np,
                       max_cluster=max_cluster)
        k = sdn.cluster_k
        assert k & (k - 1) == 0 and k >= 16
        assert sdn.cluster_count.max() <= min(k, max_cluster)
        assert sdn.cluster_tris.shape == (sdn.n_clusters, 12, k)
        for ci in range(sdn.n_clusters):
            assert (sdn.cluster_tris[ci, :, sdn.cluster_count[ci]:] == 0).all()

    def test_lowers_for_cuda_compiled(self):
        """With compiled kernels forced, the kernel lowers for ``cuda`` as
        one Triton call (the CPU host runs the same lowering the card's
        compiler receives)."""
        from jaderaytracerendering_tpu.utils import backend

        _, sdj = _scene("jade")
        o, d, ex = _rays(300, 3)
        with backend.compiled_kernels():
            assert not backend.kernel_interpret()
            txt = jax.jit(lambda a, b, c: cluster_sweep.nearest_hit_sweep_jnp(
                a, b, c, sdj, anyhit=(0, 100))).trace(
                    jnp.asarray(o), jnp.asarray(d), jnp.asarray(ex)).lower(
                        lowering_platforms=("cuda",)).as_text()
        assert txt.count("__gpu$xla.gpu.triton") == 1
