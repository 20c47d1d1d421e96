"""Brute-force nearest-hit: every ray against every triangle.

The reference's hitArray (PathTrace.cu:776-792) is the leaf-range version
of this; applied to the whole scene it is the oracle traversal
(SURVEY §4 property-test row): the [rays x tris] sweep is dense work
with zero divergence, chunked over the triangle axis to bound memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import vecmath as vm
from . import intersect

INF = intersect.INF


def nearest_hit_np(origins, dirs, exclude, p1, p2, p3, method="mt"):
    """NumPy oracle: [M] rays vs [T] triangles, chunked. Returns
    (hit [M] bool, index [M] i32 — 0 on miss, t [M] f32 — INF on miss)."""
    m = origins.shape[0]
    t_all = np.full(m, INF, np.float32)
    i_all = np.zeros(m, np.int32)
    dirs = vm.normalize(dirs.astype(np.float32), np)
    chunk = 4096
    for c0 in range(0, len(p1), chunk):
        c1 = min(c0 + chunk, len(p1))
        hit, t = intersect.ray_triangle(
            origins[:, None, :], dirs[:, None, :],
            p1[None, c0:c1], p2[None, c0:c1], p3[None, c0:c1], np, method,
        )
        ids = np.arange(c0, c1, dtype=np.int32)
        valid = hit & (ids[None, :] != exclude[:, None])
        t = np.where(valid, t, INF)
        j = np.argmin(t, axis=1)
        tc = t[np.arange(m), j]
        better = tc < t_all
        t_all = np.where(better, tc, t_all)
        i_all = np.where(better, ids[j], i_all)
    return t_all < INF, i_all, t_all


@functools.partial(jax.jit, static_argnames=("method", "chunk"))
def nearest_hit_jnp(origins, dirs, exclude, p1, p2, p3, method="mt", chunk=2048):
    """JAX brute-force nearest hit, lax.scan over triangle chunks.

    Triangle arrays are padded to a multiple of ``chunk`` with degenerate
    triangles (never hit). Same return convention as nearest_hit_np.
    """
    m = origins.shape[0]
    t_count = p1.shape[0]
    pad = (-t_count) % chunk
    if pad:
        z = jnp.zeros((pad, 3), p1.dtype)
        p1, p2, p3 = (jnp.concatenate([a, z]) for a in (p1, p2, p3))
    n_chunks = p1.shape[0] // chunk
    p1c = p1.reshape(n_chunks, chunk, 3)
    p2c = p2.reshape(n_chunks, chunk, 3)
    p3c = p3.reshape(n_chunks, chunk, 3)

    dirs = vm.normalize(dirs, jnp)

    def body(carry, tris):
        best_t, best_i, base = carry
        q1, q2, q3 = tris
        hit, t = intersect.ray_triangle(
            origins[:, None, :], dirs[:, None, :],
            q1[None], q2[None], q3[None], jnp, method,
        )
        ids = base + jnp.arange(chunk, dtype=jnp.int32)
        valid = hit & (ids[None, :] != exclude[:, None]) & (ids[None, :] < t_count)
        t = jnp.where(valid, t, INF)
        j = jnp.argmin(t, axis=1)
        tc = t[jnp.arange(m), j]
        better = tc < best_t
        best_t = jnp.where(better, tc, best_t)
        best_i = jnp.where(better, ids[j], best_i)
        return (best_t, best_i, base + chunk), None

    init = (jnp.full((m,), INF, jnp.float32), jnp.zeros((m,), jnp.int32),
            jnp.int32(0))
    (best_t, best_i, _), _ = jax.lax.scan(body, init, (p1c, p2c, p3c))
    return best_t < INF, best_i, best_t


def compare_hits(want, got, origins, dirs, p1, p2, p3, rtol=1e-5):
    """Check an intersector's (hit, index, t) against this oracle's.

    ``want``/``got`` are (hit, index, t) NumPy triples for the same rays.
    Hit flags must be equal and hit distances agree to ``rtol``. Indices
    must be equal except at *near-ties*: rays that hit two triangles at
    the same distance up to rounding (shared edges, coplanar faces),
    where fp32 rounding decides the winner. A differing index counts as
    a near-tie only if NumPy re-intersects the ray with the reported
    triangle at a distance within ``rtol`` of the oracle's.

    Returns a dict of counts and the largest relative t error; raises
    AssertionError on any other disagreement."""
    hb, ib, tb = (np.asarray(a) for a in want)
    hs, is_, ts = (np.asarray(a) for a in got)
    flag_bad = int((hb != hs).sum())
    both = hb & hs
    rel = np.abs(ts[both] - tb[both]) / np.maximum(np.abs(tb[both]), 1e-30)
    t_err = float(rel.max()) if rel.size else 0.0
    diff = np.nonzero(both & (ib != is_))[0]
    ties = 0
    if diff.size:
        j = is_[diff]
        hit, t = intersect.ray_triangle(
            np.asarray(origins, np.float32)[diff],
            vm.normalize(np.asarray(dirs, np.float32)[diff], np),
            p1[j], p2[j], p3[j], np)
        ties = int((hit & (np.abs(t - tb[diff])
                           <= rtol * np.abs(tb[diff]))).sum())
    out = dict(rays=int(hb.size), hits=int(hb.sum()),
               flag_mismatch=flag_bad, index_mismatch=int(diff.size),
               near_ties=ties, t_max_rel_err=t_err)
    assert flag_bad == 0, f"hit flags differ: {out}"
    assert ties == diff.size, f"index differs off a near-tie: {out}"
    assert t_err <= rtol, f"t off by more than rtol={rtol}: {out}"
    return out
