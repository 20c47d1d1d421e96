"""Cluster-queue nearest-hit in plain jnp (see accel.clusters).

Per while-loop iteration every live ray visits its nearest unvisited
candidate cluster (argmin over a [M, C] entry-distance matrix) and
dense-tests that cluster's contiguous K-triangle block. Visiting in
entry order makes the early-exit exact: once the nearest remaining
cluster starts beyond the current best hit, the lane is done. Iteration
count is the max clusters-actually-visited over the wavefront (typically
single digits), vs the per-node walk's hundreds of steps.

Same (hit, index, t) contract and index-exclusion semantics as
ops.bruteforce / ops.traverse; equivalence-tested against both.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import vecmath as vm
from . import intersect

INF = intersect.INF


def _visit(state, origins, dirs, exclude, sd, k, xp):
    best_t, best_i, entry = state
    m = origins.shape[0]
    rows = xp.arange(m)

    j = xp.argmin(entry, axis=1)  # nearest unvisited cluster per ray
    e = entry[rows, j]
    live = e < best_t

    base = sd.cluster_begin[j]
    cnt = sd.cluster_count[j]
    ks = xp.arange(k, dtype=xp.int32)
    ids = base[:, None] + ks[None, :]
    valid = live[:, None] & (ks[None, :] < cnt[:, None]) & (ids != exclude[:, None])
    block = sd.cluster_tris[j]  # [M, 12, K] one contiguous row per lane
    q1 = xp.swapaxes(block[:, 0:3, :], 1, 2)
    q2 = xp.swapaxes(block[:, 3:6, :], 1, 2)
    q3 = xp.swapaxes(block[:, 6:9, :], 1, 2)
    hit, t = intersect.ray_triangle(
        origins[:, None, :], dirs[:, None, :], q1, q2, q3, xp,
    )
    t = xp.where(valid & hit, t, INF)
    jj = xp.argmin(t, axis=1)
    tc = t[rows, jj]
    better = tc < best_t
    best_t = xp.where(better, tc, best_t)
    best_i = xp.where(better, ids[rows, jj].astype(best_i.dtype), best_i)

    entry = entry.at[rows, j].set(INF) if xp is jnp else _np_setinf(entry, rows, j)
    return best_t, best_i, entry


def _np_setinf(entry, rows, j):
    entry = entry.copy()
    entry[rows, j] = INF
    return entry


def _init(origins, dirs, sd, xp):
    m = origins.shape[0]
    enter, dist = intersect.ray_aabb(
        origins[:, None, :], dirs[:, None, :],
        sd.cluster_aa[None], sd.cluster_bb[None], xp,
    )  # [M, C]
    ray_ok = xp.sum(xp.abs(dirs), axis=-1) > 0  # zero-dir = masked lane
    entry = xp.where((dist > 0) & ray_ok[:, None], enter, INF)
    best_t = xp.full((m,), INF, xp.float32)
    best_i = xp.zeros(m, xp.int32)
    return best_t, best_i, entry


def nearest_hit_clusters_np(origins, dirs, exclude, sd):
    origins = np.asarray(origins, np.float32)
    dirs = vm.normalize(np.asarray(dirs, np.float32), np)
    exclude = np.asarray(exclude, np.int32)
    k = sd.cluster_k
    state = _init(origins, dirs, sd, np)
    while (state[2].min(axis=1) < state[0]).any():
        state = _visit(state, origins, dirs, exclude, sd, k, np)
    best_t, best_i, _ = state
    return best_t < INF, best_i, best_t


@functools.partial(jax.jit, static_argnames=("max_iters",))
def nearest_hit_clusters_jnp(origins, dirs, exclude, sd, max_iters=100_000):
    dirs = vm.normalize(dirs, jnp)
    k = sd.cluster_k
    state = _init(origins, dirs, sd, jnp) + (jnp.int32(0),)

    def cond(s):
        best_t, _, entry, it = s
        return jnp.any(jnp.min(entry, axis=1) < best_t) & (it < max_iters)

    def body(s):
        best_t, best_i, entry = _visit(s[:3], origins, dirs, exclude, sd, k, jnp)
        return best_t, best_i, entry, s[3] + 1

    best_t, best_i, _, _ = jax.lax.while_loop(cond, body, state)
    return best_t < INF, best_i, best_t
