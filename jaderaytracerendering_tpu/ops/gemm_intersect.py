"""Ray-triangle intersection as matrix products ("tracing as GEMM").

The Moller-Trumbore scalars factor into bilinear forms: with unnormalized
determinant-form terms and per-ray features

    r = [d, w = d x o, o, 1]            (10 floats per ray)

each triangle contributes four coefficient rows such that

    a  = -(d . n)                    n  = e1 x e2
    su = -(w . e2) - d . (e2 x p1)
    sv =  (w . e1) - d . (p1 x e1)
    st =  (o . n)  - (p1 . n)

and u = su/a, v = sv/a, t = st/a reproduce the classic test. One
[M, 10] @ [10, 4T] matmul therefore evaluates every ray against every
triangle — a dense replacement for the reference's per-thread triangle
loop (hitArray, PathTrace.cu:776-792) with zero gathers and zero
divergence. An alternative whole-scene intersector (traversal='gemm'),
chunked over triangles with a lax.scan so [M, chunk] epilogues fuse
into the product instead of materializing [M, T] buffers. The product
runs at Precision.HIGHEST (full fp32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import vecmath as vm
from . import intersect

INF = intersect.INF


def pack_coefficients(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray) -> np.ndarray:
    """Triangles -> [10, 4*T] float32 coefficient matrix (numpy, host).

    Column layout per triangle i: columns 4i..4i+3 = (a, su, sv, st) rows.
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    p3 = np.asarray(p3, np.float64)
    e1 = p2 - p1
    e2 = p3 - p1
    n = np.cross(e1, e2)
    t_cnt = len(p1)
    coef = np.zeros((t_cnt, 4, 10), np.float64)
    # feature order: d (0:3), w = d x o (3:6), o (6:9), const (9)
    coef[:, 0, 0:3] = -n
    coef[:, 1, 0:3] = -np.cross(e2, p1)
    coef[:, 1, 3:6] = -e2
    coef[:, 2, 0:3] = -np.cross(p1, e1)
    coef[:, 2, 3:6] = e1
    coef[:, 3, 6:9] = n
    coef[:, 3, 9] = -np.sum(p1 * n, axis=-1)
    return coef.reshape(t_cnt * 4, 10).T.astype(np.float32).copy()


def ray_features(origins, dirs, xp):
    """[M, 10] feature matrix for packed coefficients."""
    w = vm.cross(dirs, origins, xp)
    ones = xp.ones(origins.shape[:-1] + (1,), origins.dtype)
    return xp.concatenate([dirs, w, origins, ones], axis=-1)


@functools.partial(jax.jit, static_argnames=("chunk",))
def nearest_hit_gemm_jnp(origins, dirs, exclude, coefs, chunk=2048):
    """Matrix-product brute-force nearest hit.

    coefs: [10, 4*T] from pack_coefficients (T padded to chunk multiples
    upstream or handled by masking here). Returns (hit, index, t) with t
    measured along the *unit* direction like every other intersector.
    """
    m = origins.shape[0]
    dirs_u = vm.normalize(dirs, jnp)
    feats = ray_features(origins, dirs_u, jnp)  # [M, 10]
    t_cnt = coefs.shape[1] // 4
    pad = (-t_cnt) % chunk
    if pad:
        coefs = jnp.concatenate(
            [coefs, jnp.zeros((10, 4 * pad), coefs.dtype)], axis=1
        )
    n_chunks = (t_cnt + pad) // chunk
    coefs_c = coefs.reshape(10, n_chunks, chunk * 4).transpose(1, 0, 2)

    def body(carry, cchunk):
        best_t, best_i, base = carry
        # HIGHEST: a default-precision f32 product may run in TF32 on the
        # GPU, moving t by ~1e-3 relative
        s = jnp.dot(feats, cchunk, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
        s = s.reshape(m, chunk, 4)
        a = s[..., 0]
        inv = 1.0 / a
        u = s[..., 1] * inv
        v = s[..., 2] * inv
        t = s[..., 3] * inv
        ids = base + jnp.arange(chunk, dtype=jnp.int32)
        ok = (
            (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
            & (ids[None, :] != exclude[:, None])
            & (ids[None, :] < t_cnt)
        )
        t = jnp.where(ok, t, INF)
        j = jnp.argmin(t, axis=1)
        tc = t[jnp.arange(m), j]
        better = tc < best_t
        best_t = jnp.where(better, tc, best_t)
        best_i = jnp.where(better, ids[j], best_i)
        return (best_t, best_i, base + chunk), None

    init = (jnp.full((m,), INF, jnp.float32), jnp.zeros((m,), jnp.int32),
            jnp.int32(0))
    (best_t, best_i, _), _ = jax.lax.scan(body, init, coefs_c)
    return best_t < INF, best_i, best_t


def nearest_hit_gemm_np(origins, dirs, exclude, coefs, chunk=4096):
    """NumPy mirror (oracle cross-checks)."""
    m = origins.shape[0]
    dirs_u = vm.normalize(np.asarray(dirs, np.float32), np)
    feats = ray_features(np.asarray(origins, np.float32), dirs_u, np)
    t_cnt = coefs.shape[1] // 4
    best_t = np.full(m, INF, np.float32)
    best_i = np.zeros(m, np.int32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for c0 in range(0, t_cnt, chunk):
            c1 = min(c0 + chunk, t_cnt)
            s = (feats @ coefs[:, 4 * c0 : 4 * c1]).reshape(m, c1 - c0, 4)
            inv = 1.0 / s[..., 0]
            u = s[..., 1] * inv
            v = s[..., 2] * inv
            t = s[..., 3] * inv
            ids = np.arange(c0, c1, dtype=np.int32)
            ok = ((u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 0)
                  & (ids[None, :] != exclude[:, None]))
            t = np.where(ok, t, INF)
            j = np.argmin(t, axis=1)
            tc = t[np.arange(m), j]
            better = tc < best_t
            best_t = np.where(better, tc, best_t)
            best_i = np.where(better, ids[j], best_i)
    return best_t < INF, best_i, best_t
