"""Scene assembly: objects -> flat SoA device buffers.

Covers the reference's L1/L3 layers (SURVEY §1): triangle concatenation
with per-object segments (Obj_seg, PathTrace.cu:348-353), per-object area
prefix sums for BSSRDF exit sampling (PathTrace.cu:1538-1546), the
original->sorted triangle index mapping (PathTrace.cu:1573-1579), the
emissive-triangle registry (PathTrace.cu:1596-1600), SAH BVH build, and
the encode step — but into JAX SoA arrays instead of CUDA structs /
GL texture buffers. Materials are stored per *object* and gathered via a
per-triangle object id (the reference duplicates materials per triangle,
PathTrace.cu:1588-1594 — same semantics, 1/8th the gather bandwidth).

Static scene facts (counts, which material features are present) live in
pytree metadata so jit can prune unused branches at trace time — e.g. a
scene with no DIR_REFRACT object compiles no refraction march
(the demo scene's case: PathTrace.cpp:981-1037 uses SUB_SURFACE only).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..accel import bvh as bvh_mod
from ..core import vecmath
from ..ops import gemm_intersect
from ..ops.pallas import cluster_sweep
from . import envmap as envmap_mod
from . import material as material_mod
from .objloader import MeshData


@dataclasses.dataclass
class SceneObject:
    mesh: MeshData
    material: material_mod.Material
    name: str = ""
    # provenance for render_args.txt round-trips (may be None for
    # procedural meshes)
    source_path: Optional[str] = None
    transform: Optional[np.ndarray] = None
    normalize: bool = False


# mat_table column offsets
MAT_EMISSIVE = slice(0, 3)
MAT_BRDF = slice(3, 6)
MAT_REFLEX = 6
MAT_REFRACT_MODE = 7
MAT_REFRACT_RATE = slice(8, 11)
MAT_REFRACT_ALBEDO = slice(11, 14)
MAT_REFRACT_INDEX = 14

# tri_table column offsets
TRI_P1 = slice(0, 3)
TRI_P2 = slice(3, 6)
TRI_P3 = slice(6, 9)
TRI_NORM = slice(9, 12)
TRI_OBJ = 12


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flat device-side scene. Triangles are in BVH-sorted order."""

    # geometry [T, 3]
    tri_p1: jax.Array
    tri_p2: jax.Array
    tri_p3: jax.Array
    tri_norm: jax.Array
    tri_obj: jax.Array            # [T] int32 object id
    # per-object materials [O, ...]
    mat_emissive: jax.Array
    mat_brdf: jax.Array
    mat_reflex: jax.Array         # [O] int32
    mat_refract: jax.Array        # [O] int32
    mat_refract_rate: jax.Array
    mat_refract_albedo: jax.Array
    mat_refract_index: jax.Array  # [O] float32
    # light + BSSRDF support tables
    emit_idx: jax.Array           # [E] int32, sorted-space triangle ids
    prefix_area: jax.Array        # [T] float32, load-order space
    obj_total_area: jax.Array     # [O] float32 = prefix_area[seg_end]
    mapping: jax.Array            # [T] int32 load-order -> sorted
    seg_begin: jax.Array          # [O] int32 load-order segment begin
    seg_end: jax.Array            # [O] int32 load-order segment end (incl.)
    # BVH (node 0 sentinel, root 1)
    bvh_left: jax.Array
    bvh_right: jax.Array
    bvh_n: jax.Array
    bvh_index: jax.Array
    bvh_aa: jax.Array
    bvh_bb: jax.Array
    # cluster decomposition (accel.clusters): maximal BVH subtrees of
    # <= cluster_k triangles, in ascending triangle order
    cluster_aa: jax.Array         # [C, 3]
    cluster_bb: jax.Array         # [C, 3]
    cluster_begin: jax.Array      # [C] int32 (sorted-order triangle base)
    cluster_count: jax.Array      # [C] int32
    # per-cluster triangle blocks [C, 12, K]: component planes (p1xyz,
    # p2xyz, p3xyz, pad) x K slots, K = cluster_k (a power of two);
    # slots past the cluster's count hold degenerate (0,0,0) triangles
    cluster_tris: jax.Array
    # level-1 boxes of the cluster sweep (ops.pallas.cluster_sweep): the
    # union AABB of each run of cluster_group consecutive clusters
    cluster_group_aa: jax.Array   # [ceil(C / cluster_group), 3]
    cluster_group_bb: jax.Array
    # matrix-product intersection coefficients [10, 4*T] (ops.gemm_intersect)
    tri_gemm: jax.Array
    # wide per-triangle table [T, 16] = (p1, p2, p3, norm, obj_as_f32, pad3)
    tri_table: jax.Array
    # packed material table [O, 16] (see MAT_* offsets)
    mat_table: jax.Array
    # combined [T, 32] = tri_table row ++ mat_table[obj] row: shading
    # fetches triangle and material in one row gather
    tri_mat_table: jax.Array
    # environment
    env_map: jax.Array            # [He, We, 3] float32
    # pre-packed 2x2 bilinear rows [(He+1)*(We+1), 16] (envmap.pack_bilinear):
    # one wide-row gather per sample instead of four scattered ones
    env_pack: jax.Array
    # hoisted per-light tables [E, ...] (rows of the sorted tri arrays at
    # emit_idx), precomputed at assembly instead of gathered per bounce
    light_p1: jax.Array
    light_p2: jax.Array
    light_p3: jax.Array
    light_norm: jax.Array
    light_emis: jax.Array
    light_area: jax.Array
    # table-driven BSSRDF exit sampling (sampling.build_area_cdf_tables):
    # per-object u-bucket brackets [O*NB, 2] i32 + sliding windows [T, 32]
    # (prefix values | precomputed mapping[F(j)] answers); empty when the
    # scene has no SSS material or the distribution defeated bucketing
    sss_bucket: jax.Array
    sss_window: jax.Array
    # per-object bucket count + flat base offset into sss_bucket (bucket
    # counts are per object — a 400k-tri object needs 2^22 buckets while
    # a quad needs 2^7; see sampling.build_area_cdf_tables)
    sss_bnb: jax.Array
    sss_bbase: jax.Array

    # ---- static metadata (compile-time specialization) ----
    n_triangles: int = dataclasses.field(metadata=dict(static=True))
    n_objects: int = dataclasses.field(metadata=dict(static=True))
    n_emit: int = dataclasses.field(metadata=dict(static=True))
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    leaf_size: int = dataclasses.field(metadata=dict(static=True))
    has_sss: bool = dataclasses.field(metadata=dict(static=True))
    has_refract: bool = dataclasses.field(metadata=dict(static=True))
    has_mirror: bool = dataclasses.field(metadata=dict(static=True))
    max_leaf_items: int = dataclasses.field(metadata=dict(static=True))
    n_clusters: int = dataclasses.field(metadata=dict(static=True))
    cluster_k: int = dataclasses.field(metadata=dict(static=True))
    cluster_group: int = dataclasses.field(metadata=dict(static=True))
    sss_nb: int = dataclasses.field(metadata=dict(static=True))
    # max BVH levels from the root; stackful traversal needs
    # bvh_stack_size >= bvh_depth + 1 (validated in make_nearest)
    bvh_depth: int = dataclasses.field(metadata=dict(static=True), default=0)


def assemble(
    objects: List[SceneObject],
    env_map: np.ndarray,
    leaf_size: int = 8,
    bvh_method: str = "sah",
    bvh_backend: str = "auto",
    max_cluster: int = 64,
    cluster_group: int = cluster_sweep.GROUP,
    xp=jnp,
) -> SceneData:
    """Build device buffers from scene objects.

    ``xp=jnp`` produces JAX arrays (device upload); ``xp=np`` keeps NumPy
    (for the CPU oracle).
    """
    assert objects, "scene needs at least one object"
    p1 = np.concatenate([o.mesh.p1 for o in objects])
    p2 = np.concatenate([o.mesh.p2 for o in objects])
    p3 = np.concatenate([o.mesh.p3 for o in objects])
    norm = np.concatenate([o.mesh.norm for o in objects])
    t = len(p1)
    obj_idx = np.concatenate(
        [np.full(o.mesh.n_triangles, i, np.int32) for i, o in enumerate(objects)]
    )

    # per-object load-order segments (Obj_seg, PathTrace.cu:435-436)
    counts = np.array([o.mesh.n_triangles for o in objects], np.int64)
    seg_end = np.cumsum(counts) - 1
    seg_begin = seg_end - counts + 1

    # area prefix sums in load order (PathTrace.cu:1538-1546)
    areas = vecmath.triangle_area(
        p1.astype(np.float64), p2.astype(np.float64), p3.astype(np.float64), np
    )
    prefix_area = np.empty(t, np.float32)
    for b, e in zip(seg_begin, seg_end):
        prefix_area[b : e + 1] = np.cumsum(areas[b : e + 1])
    obj_total_area = prefix_area[seg_end].astype(np.float32)

    # BVH build reorders triangles (PathTrace.cu:1565)
    if bvh_backend in ("auto", "native"):
        from ..accel import native as native_mod

        nodes, perm = native_mod.build(
            p1, p2, p3, leaf_size=leaf_size, method=bvh_method,
            required=(bvh_backend == "native"),
        )
    else:
        nodes, perm = bvh_mod.build(p1, p2, p3, leaf_size=leaf_size, method=bvh_method)
    p1, p2, p3, norm, obj_idx = (a[perm] for a in (p1, p2, p3, norm, obj_idx))
    # mapping: load-order id -> sorted position (PathTrace.cu:1579)
    mapping = np.empty(t, np.int32)
    mapping[perm] = np.arange(t, dtype=np.int32)

    # emissive registry in sorted space (PathTrace.cu:1596-1600)
    mats = [o.material for o in objects]
    emissive_per_obj = np.array([m.emissive for m in mats], np.float32)
    is_emissive_obj = (emissive_per_obj > material_mod.EMISSIVE_THRESHOLD).any(axis=1)
    emit_idx = np.nonzero(is_emissive_obj[obj_idx])[0].astype(np.int32)

    refract_modes = np.array([m.refract_mode for m in mats], np.int32)
    reflex_modes = np.array([m.reflex_mode for m in mats], np.int32)

    tri_table = np.zeros((t, 16), np.float32)
    tri_table[:, TRI_P1] = p1
    tri_table[:, TRI_P2] = p2
    tri_table[:, TRI_P3] = p3
    tri_table[:, TRI_NORM] = norm
    tri_table[:, TRI_OBJ] = obj_idx.astype(np.float32)

    mat_table = np.zeros((len(mats), 16), np.float32)
    mat_table[:, MAT_EMISSIVE] = emissive_per_obj
    mat_table[:, MAT_BRDF] = [m.brdf for m in mats]
    mat_table[:, MAT_REFLEX] = reflex_modes
    mat_table[:, MAT_REFRACT_MODE] = refract_modes
    mat_table[:, MAT_REFRACT_RATE] = [m.refract_rate for m in mats]
    mat_table[:, MAT_REFRACT_ALBEDO] = [m.refract_albedo for m in mats]
    mat_table[:, MAT_REFRACT_INDEX] = [m.refract_index for m in mats]

    from ..accel import clusters as clusters_mod

    cl = clusters_mod.build_clusters(nodes, t, max_cluster=max_cluster)
    # K is a power of two: the sweep kernel's block shapes must be
    cluster_k = max(16, 1 << (int(cl.count.max()) - 1).bit_length()) \
        if cl.n_clusters else 16
    ctris = np.zeros((cl.n_clusters, 12, cluster_k), np.float32)
    for ci, (b, c) in enumerate(zip(cl.begin, cl.count)):
        ctris[ci, 0:3, :c] = p1[b : b + c].T
        ctris[ci, 3:6, :c] = p2[b : b + c].T
        ctris[ci, 6:9, :c] = p3[b : b + c].T
    gaa, gbb = cluster_sweep.group_boxes(cl.aa, cl.bb, cluster_group)

    has_sss = bool((refract_modes == material_mod.SUB_SURFACE).any())
    sss_bucket = np.zeros((0, 2), np.int32)
    sss_window = np.zeros((0, 32), np.float32)
    sss_bnb = np.zeros((len(objects),), np.int32)
    sss_bbase = np.zeros((len(objects),), np.int32)
    sss_nb = 0
    if has_sss:
        from ..integrator import sampling as sampling_mod

        bkt, win, nbs, bases = sampling_mod.build_area_cdf_tables(
            prefix_area, obj_total_area, seg_begin, seg_end, mapping
        )
        if bkt is not None:
            sss_bucket, sss_window = bkt, win
            sss_bnb, sss_bbase = nbs, bases
            sss_nb = int(nbs.max())  # static flag: tables built

    to = (lambda a, dt=np.float32: xp.asarray(np.ascontiguousarray(a), dt))
    return SceneData(
        tri_p1=to(p1), tri_p2=to(p2), tri_p3=to(p3), tri_norm=to(norm),
        tri_obj=to(obj_idx, np.int32),
        mat_emissive=to(emissive_per_obj),
        mat_brdf=to(np.array([m.brdf for m in mats], np.float32)),
        mat_reflex=to(reflex_modes, np.int32),
        mat_refract=to(refract_modes, np.int32),
        mat_refract_rate=to(np.array([m.refract_rate for m in mats], np.float32)),
        mat_refract_albedo=to(np.array([m.refract_albedo for m in mats], np.float32)),
        mat_refract_index=to(np.array([m.refract_index for m in mats], np.float32)),
        emit_idx=to(emit_idx, np.int32),
        prefix_area=to(prefix_area),
        obj_total_area=to(obj_total_area),
        mapping=to(mapping, np.int32),
        seg_begin=to(seg_begin, np.int32),
        seg_end=to(seg_end, np.int32),
        bvh_left=to(nodes.left, np.int32),
        bvh_right=to(nodes.right, np.int32),
        bvh_n=to(nodes.n, np.int32),
        bvh_index=to(nodes.index, np.int32),
        bvh_aa=to(nodes.aa),
        bvh_bb=to(nodes.bb),
        cluster_aa=to(cl.aa),
        cluster_bb=to(cl.bb),
        cluster_begin=to(cl.begin, np.int32),
        cluster_count=to(cl.count, np.int32),
        cluster_tris=to(ctris),
        cluster_group_aa=to(gaa),
        cluster_group_bb=to(gbb),
        tri_gemm=to(gemm_intersect.pack_coefficients(p1, p2, p3)),
        tri_table=to(tri_table),
        mat_table=to(mat_table),
        tri_mat_table=to(np.concatenate(
            [tri_table, mat_table[obj_idx]], axis=1)),
        env_map=to(env_map),
        env_pack=to(envmap_mod.pack_bilinear(np.asarray(env_map, np.float32), np)),
        light_p1=to(p1[emit_idx]),
        light_p2=to(p2[emit_idx]),
        light_p3=to(p3[emit_idx]),
        light_norm=to(norm[emit_idx]),
        light_emis=to(emissive_per_obj[obj_idx[emit_idx]]),
        # f32 area via the same function the integrator used to call, so
        # the hoisted values are bit-identical to the old per-bounce ones
        light_area=to(vecmath.triangle_area(
            p1[emit_idx].astype(np.float32), p2[emit_idx].astype(np.float32),
            p3[emit_idx].astype(np.float32), np)),
        sss_bucket=to(sss_bucket, np.int32),
        sss_window=to(sss_window),
        sss_bnb=to(sss_bnb, np.int32),
        sss_bbase=to(sss_bbase, np.int32),
        n_triangles=t,
        n_objects=len(objects),
        n_emit=int(len(emit_idx)),
        n_nodes=nodes.n_nodes,
        leaf_size=leaf_size,
        has_sss=has_sss,
        has_refract=bool((refract_modes == material_mod.DIR_REFRACT).any()),
        has_mirror=bool((reflex_modes == material_mod.MIRROR).any()),
        max_leaf_items=int(nodes.n.max()) if nodes.n_nodes else 0,
        n_clusters=cl.n_clusters,
        cluster_k=cluster_k,
        cluster_group=cluster_group,
        sss_nb=sss_nb,
        bvh_depth=bvh_mod.tree_depth(nodes),
    )
