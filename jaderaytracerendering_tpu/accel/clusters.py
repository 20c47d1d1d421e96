"""BVH -> cluster decomposition for the cluster traversals.

The per-node stackful walk (hitBVH, PathTrace.cu:795-859) run as a
lockstep wavefront pays one while-loop step with device-memory gathers
per visited node, and rays wait for the slowest lane. The alternative
cuts the SAH tree into *clusters* — maximal subtrees holding <= K
triangles. Because the builder sorts triangles in place, every
subtree owns a contiguous triangle range, so a cluster is just
(begin, count, AABB) over the sorted arrays and its triangle block can
be fetched as one dense contiguous gather.

Traversal then becomes (ops/cluster_traverse.py):
  1. test all C cluster boxes densely against every ray ([M, C] slab
     tests — no divergence);
  2. visit clusters in increasing entry order (argmin over the masked
     entry row), dense-test the K-triangle block, and stop as soon as
     the nearest remaining cluster starts beyond the current best hit.

Typical visits per ray: 1-5, vs ~50-200 node steps for the stack walk.
The sweep kernel (ops/pallas/cluster_sweep.py) walks the same clusters
block-by-block under a second level of group boxes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import bvh as bvh_mod


@dataclasses.dataclass
class ClusterArrays:
    """[C] SoA clusters over BVH-sorted triangle order."""

    aa: np.ndarray      # [C, 3] float32
    bb: np.ndarray      # [C, 3] float32
    begin: np.ndarray   # [C] int32 first triangle (sorted order)
    count: np.ndarray   # [C] int32

    @property
    def n_clusters(self) -> int:
        return len(self.begin)


def _subtree_ranges(nodes: bvh_mod.BVHArrays) -> tuple[np.ndarray, np.ndarray]:
    """Per-node triangle range [lo, hi) via post-order accumulation."""
    k = nodes.n_nodes
    lo = np.zeros(k, np.int64)
    hi = np.zeros(k, np.int64)
    # iterative post-order from root (node 1)
    order = []
    stack = [1] if k > 1 else []
    while stack:
        i = stack.pop()
        order.append(i)
        if nodes.n[i] <= 0:
            if nodes.left[i] > 0:
                stack.append(int(nodes.left[i]))
            if nodes.right[i] > 0:
                stack.append(int(nodes.right[i]))
    for i in reversed(order):
        if nodes.n[i] > 0:
            lo[i] = nodes.index[i]
            hi[i] = nodes.index[i] + nodes.n[i]
        else:
            children = [c for c in (nodes.left[i], nodes.right[i]) if c > 0]
            lo[i] = min(lo[c] for c in children)
            hi[i] = max(hi[c] for c in children)
    return lo, hi


def build_clusters(nodes: bvh_mod.BVHArrays, n_triangles: int,
                   max_cluster: int = 128) -> ClusterArrays:
    """Cut the tree into maximal subtrees of <= max_cluster triangles."""
    if n_triangles == 0 or nodes.n_nodes <= 1:
        return ClusterArrays(
            aa=np.zeros((0, 3), np.float32), bb=np.zeros((0, 3), np.float32),
            begin=np.zeros(0, np.int32), count=np.zeros(0, np.int32),
        )
    lo, hi = _subtree_ranges(nodes)
    out_aa, out_bb, out_begin, out_count = [], [], [], []
    stack = [1]
    while stack:
        i = stack.pop()
        size = hi[i] - lo[i]
        if size <= max_cluster or nodes.n[i] > 0:
            out_aa.append(nodes.aa[i])
            out_bb.append(nodes.bb[i])
            out_begin.append(lo[i])
            out_count.append(size)
        else:
            if nodes.left[i] > 0:
                stack.append(int(nodes.left[i]))
            if nodes.right[i] > 0:
                stack.append(int(nodes.right[i]))
    # sort clusters by begin so blocks stream HBM in order
    begin = np.asarray(out_begin, np.int64)
    srt = np.argsort(begin, kind="stable")
    clusters = ClusterArrays(
        aa=np.stack(out_aa).astype(np.float32)[srt],
        bb=np.stack(out_bb).astype(np.float32)[srt],
        begin=begin[srt].astype(np.int32),
        count=np.asarray(out_count, np.int32)[srt],
    )
    cover = np.zeros(n_triangles, np.int32)
    for b, c in zip(clusters.begin, clusters.count):
        cover[b : b + c] += 1
    assert (cover == 1).all(), "clusters must partition the triangles"
    return clusters
