"""Batched BVH traversal over ray wavefronts.

The reference traverses with a per-thread int stack in a divergent SIMT
loop (hitBVH, PathTrace.cu:795-859 / fshader_render.fsh:266-328). This
version keeps the same algorithm — explicit stack, root at node 1,
near-child-first ordering by AABB entry distance, leaf ranges tested
brute-force with source-index exclusion — but runs it as a *lockstep
wavefront*: every lane carries its own stack in a [M, S] array and all
lanes step together under one while-loop, with masked lanes idle.

Beyond the reference it adds ordered pruning (skip a child whose box
entry distance exceeds the lane's current best hit), which never changes
the nearest hit but cuts visited nodes sharply.

The same body drives NumPy (Python while loop — the oracle) and JAX
(lax.while_loop under jit) so oracle and device traversals are the same
code, not a port of a port.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import vecmath as vm
from . import intersect

INF = intersect.INF


def _scatter_set(arr, rows, cols, vals, mask, xp):
    """arr[rows[i], cols[i]] = vals[i] where mask[i]; xp-agnostic."""
    if xp is np:
        arr[rows[mask], cols[mask]] = vals[mask]
        return arr
    cols = xp.where(mask, cols, arr.shape[1])  # out-of-range -> dropped
    return arr.at[rows, cols].set(vals, mode="drop")


def _step(state, origins, dirs, exclude, sd, stack_size, xp, method):
    sp, stack, best_t, best_i = state
    m = origins.shape[0]
    rows = xp.arange(m)
    leaf = sd.leaf_size

    has = sp > 0
    spm = xp.where(has, sp - 1, 0)
    top = xp.where(has, stack[rows, spm], 0)

    node_n = sd.bvh_n[top]
    node_index = sd.bvh_index[top]
    node_left = sd.bvh_left[top]
    node_right = sd.bvh_right[top]

    # ---- leaf: test up to leaf_size triangles (hitArray equivalent) ----
    is_leaf = has & (node_n > 0)
    ks = xp.arange(leaf, dtype=xp.int32)
    tri_ids = node_index[:, None] + ks[None, :]
    tri_valid = is_leaf[:, None] & (ks[None, :] < node_n[:, None])
    tri_valid = tri_valid & (tri_ids != exclude[:, None])
    safe_ids = xp.where(tri_valid, tri_ids, 0)
    q1 = sd.tri_p1[safe_ids]
    q2 = sd.tri_p2[safe_ids]
    q3 = sd.tri_p3[safe_ids]
    hit, t = intersect.ray_triangle(
        origins[:, None, :], dirs[:, None, :], q1, q2, q3, xp, method
    )
    t = xp.where(tri_valid & hit, t, INF)
    j = xp.argmin(t, axis=1)
    tc = t[rows, j]
    better = tc < best_t
    best_t = xp.where(better, tc, best_t)
    best_i = xp.where(better, tri_ids[rows, j].astype(best_i.dtype), best_i)

    # ---- inner: child AABB tests, near-first push with pruning ----
    is_inner = has & (node_n <= 0)
    l_ok = is_inner & (node_left > 0)
    r_ok = is_inner & (node_right > 0)
    safe_l = xp.where(l_ok, node_left, 0)
    safe_r = xp.where(r_ok, node_right, 0)
    enter_l, dist_l = intersect.ray_aabb(
        origins, dirs, sd.bvh_aa[safe_l], sd.bvh_bb[safe_l], xp
    )
    enter_r, dist_r = intersect.ray_aabb(
        origins, dirs, sd.bvh_aa[safe_r], sd.bvh_bb[safe_r], xp
    )
    push_l = l_ok & (dist_l > 0) & (enter_l < best_t)
    push_r = r_ok & (dist_r > 0) & (enter_r < best_t)
    both = push_l & push_r
    near_is_l = dist_l < dist_r  # reference ordering (PathTrace.cu:835-848)
    # slot at spm: the far child when both, else whichever single child
    first = xp.where(
        both,
        xp.where(near_is_l, node_right, node_left),
        xp.where(push_l, node_left, node_right),
    ).astype(stack.dtype)
    second = xp.where(near_is_l, node_left, node_right).astype(stack.dtype)

    write1 = push_l | push_r
    slot2 = spm + 1
    write2 = both & (slot2 < stack_size)
    if xp is np:
        stack = stack.copy()
    stack = _scatter_set(stack, rows, spm, first, write1, xp)
    stack = _scatter_set(stack, rows, slot2, second, write2, xp)
    n_push = write1.astype(sp.dtype) + write2.astype(sp.dtype)
    sp = xp.where(has, spm + n_push, sp)
    return sp, stack, best_t, best_i


def _init_state(dirs, stack_size, xp):
    # zero / NaN directions (masked wavefront lanes) start with an empty
    # stack: they miss, and a NaN slab test would otherwise accept every
    # node and walk the whole tree
    m = dirs.shape[0]
    live = xp.sum(xp.abs(dirs), axis=-1) > 0
    sp = live.astype(xp.int32)
    stack = xp.zeros((m, stack_size), xp.int32)
    if xp is np:
        stack[:, 0] = 1
    else:
        stack = stack.at[:, 0].set(1)  # root is node 1
    best_t = xp.full((m,), INF, xp.float32)
    best_i = xp.zeros(m, xp.int32)
    return sp, stack, best_t, best_i


def nearest_hit_bvh_np(origins, dirs, exclude, sd, stack_size=64, method="mt"):
    """NumPy traversal (the oracle). Same returns as bruteforce:
    (hit [M] bool, index [M] i32, t [M] f32)."""
    origins = np.asarray(origins, np.float32)
    dirs = vm.normalize(np.asarray(dirs, np.float32), np)
    exclude = np.asarray(exclude, np.int32)
    state = _init_state(dirs, stack_size, np)
    while (state[0] > 0).any():
        state = _step(state, origins, dirs, exclude, sd, stack_size, np, method)
    _, _, best_t, best_i = state
    return best_t < INF, best_i, best_t


@functools.partial(jax.jit, static_argnames=("stack_size", "method", "max_iters"))
def nearest_hit_bvh_jnp(
    origins, dirs, exclude, sd, stack_size=64, method="mt", max_iters=100_000
):
    """JAX traversal under lax.while_loop (jit/device path)."""
    dirs = vm.normalize(dirs, jnp)
    state = _init_state(dirs, stack_size, jnp)
    state = state + (jnp.int32(0),)

    def cond(s):
        return jnp.any(s[0] > 0) & (s[4] < max_iters)

    def body(s):
        sp, stack, bt, bi = _step(s[:4], origins, dirs, exclude, sd,
                                  stack_size, jnp, method)
        return sp, stack, bt, bi, s[4] + 1

    sp, stack, best_t, best_i, _ = jax.lax.while_loop(cond, body, state)
    return best_t < INF, best_i, best_t
