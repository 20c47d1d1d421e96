"""Multi-GPU rendering over a jax.sharding Mesh.

The reference has no multi-device capability (SURVEY §2.3): its
parallelism is one CUDA grid on one GPU. This build's scaling axes are

- **film tiles (data parallel)**: pixel ids sharded over the mesh's
  'tile' axis; each GPU renders its film shard with the replicated scene
  and no communication (the tile-accumulation analogue of DP);
- **spp (sample parallel)**: every GPU renders the *same* pixels at a
  different sample offset and radiance sums are psum-reduced (NCCL over
  NVLink) — the renderer's analogue of sequence/batch-split axes.

Both compose in one 2D mesh ('tile', 'spp'). Scene buffers are
replicated; the film is sharded on 'tile'. The GPUs of one host are
joined all to all, so the mesh shape follows the work split alone.

Several hosts layer jax.distributed.initialize on top of the SAME render
code path: ``init_distributed()`` starts the multi-process runtime,
``make_multihost_mesh()`` lays the 'tile' axis within a host (NVLink)
and the 'spp' axis ACROSS hosts — the spp-axis psum moves one [P, 3]
radiance block per batch, the only traffic light enough for the
inter-host network. ``host_local_to_global`` lifts each process's
host-local inputs into global arrays for the sharded entry points.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core import camera as camera_mod
from ..core.film import Film
from ..integrator import render as render_mod, wavefront
from ..utils.config import RenderConfig


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("tile", "spp")) -> Mesh:
    """Build a device mesh. Default: all devices on the 'tile' axis."""
    devices = np.asarray(jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    shape = tuple(shape)
    if len(shape) < len(axis_names):
        shape = shape + (1,) * (len(axis_names) - len(shape))
    return Mesh(devices[: int(np.prod(shape))].reshape(shape), axis_names)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None) -> bool:
    """Start JAX's multi-process runtime — the reference's
    'communication backend' row (SURVEY §2.3): after this, jax.devices()
    is GLOBAL across all hosts/processes and the sharded render entry
    points run unchanged over a multi-host mesh.

    Pass the coordinator address (``host:port``), process count and
    process id explicitly: nothing in a plain GPU host's environment
    describes a cluster. Returns True if this call initialized the
    runtime, False if it already was (safe to call more than once)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id,
            local_device_ids=local_device_ids)
        return True
    except RuntimeError as e:
        if "already" in str(e).lower():
            return False
        raise


def make_multihost_mesh(tile: Optional[int] = None,
                        spp_per_slice: int = 1,
                        axis_names: Sequence[str] = ("tile", "spp")) -> Mesh:
    """Global mesh for multi-host rendering: 'tile' runs WITHIN a host
    (film-shard collectives ride NVLink), 'spp' runs ACROSS hosts (times
    spp_per_slice within), so the only inter-host traffic is the one
    [P, 3] radiance psum per batch. Requires init_distributed() first
    (or a single process, where it degenerates to make_mesh).

    tile defaults to all of a host's devices divided by spp_per_slice."""
    devs = jax.devices()
    n_proc = max(d.process_index for d in devs) + 1
    by_slice = [[d for d in devs if d.process_index == s]
                for s in range(n_proc)]
    per = len(by_slice[0])
    assert all(len(b) == per for b in by_slice), "uneven hosts"
    assert per % spp_per_slice == 0, "spp_per_slice must divide host size"
    if tile is None:
        tile = per // spp_per_slice
    assert tile * spp_per_slice == per, "tile*spp_per_slice != host size"
    # [tile, spp]: column-major spp within a host, hosts concatenated
    # along 'spp' — psum('spp') reduces within a host first, then one
    # inter-host hop
    cols = []
    for b in by_slice:
        arr = np.asarray(b, dtype=object).reshape(tile, spp_per_slice)
        cols.append(arr)
    return Mesh(np.concatenate(cols, axis=1), axis_names)


def host_local_to_global(mesh: Mesh, spec, x):
    """Lift one process's host-local (replicated-content) array into a
    global jax.Array on ``mesh`` with PartitionSpec ``spec``. Every
    process must hold the FULL logical array (true for scene buffers,
    camera and pixel-id tables); each contributes only its addressable
    shards."""
    from jax.sharding import NamedSharding

    x = np.asarray(x)
    s = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])


def scene_to_global(mesh: Mesh, sd):
    """Replicate a SceneData pytree onto a (possibly multi-process)
    mesh."""
    return jax.tree_util.tree_map(
        lambda a: host_local_to_global(mesh, P(), a), sd)


@functools.partial(
    jax.jit, static_argnames=("cfg", "sppb", "mesh"), donate_argnums=()
)
def render_batch_sharded(sd, eye, cam_rot, pixel_ids, sample_base,
                         cfg: RenderConfig, sppb: int, mesh: Mesh):
    """Sharded render step: pixel_ids split over 'tile', samples over 'spp'.

    Returns radiance sums [P, 3] sharded on 'tile' (each GPU holds its
    film shard; the 'spp' axis is psum-reduced).

    pixel_ids length must be divisible by mesh.shape['tile'].
    """
    n_spp_shards = mesh.shape["spp"]

    def shard_fn(sd_, eye_, rot_, ids_, base_):
        spp_rank = jax.lax.axis_index("spp")
        local_base = base_ + spp_rank.astype(jnp.uint32) * jnp.uint32(sppb)
        p = ids_.shape[0]
        pid = jnp.tile(ids_, sppb)
        sid = (jnp.repeat(jnp.arange(sppb, dtype=jnp.uint32), p) + local_base)
        o, d = camera_mod.generate_rays(
            jnp, eye_, rot_, cfg.width, cfg.height, pid, sid, cfg.seed,
            cfg.jitter,
        )
        nearest = render_mod.make_nearest(sd_, cfg, jnp)
        rad = wavefront.trace_radiance(o, d, pid, sid, sd_, cfg, jnp, nearest)
        out = rad.reshape(sppb, p, 3).sum(axis=0)
        return jax.lax.psum(out, "spp")  # reduction over the spp axis

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("tile"), P()),
        out_specs=P("tile"),
        check_vma=False,
    )
    out = fn(sd, eye, cam_rot, pixel_ids, jnp.asarray(sample_base, jnp.uint32))
    del n_spp_shards
    return out


@functools.partial(jax.jit, static_argnames=("mesh",))
def gather_film(tile_shards, mesh: Mesh):
    """Assemble the full film from tile shards with an explicit
    all_gather (the pass2-style tile accumulation step when a
    replicated copy is needed, e.g. before host-side post or saving)."""

    def fn(local):
        return jax.lax.all_gather(local, "tile", axis=0, tiled=True)

    return jax.shard_map(
        fn, mesh=mesh, in_specs=P("tile"), out_specs=P(), check_vma=False
    )(tile_shards)


@functools.partial(jax.jit, static_argnames=("cfg", "pool_m", "mesh"))
def _pool_render_sharded(sd, eye, cam_rot, pixel_ids, sample_base,
                         cfg: RenderConfig, pool_m: int, mesh: Mesh):
    """Pool engine over the mesh: each 'tile' shard pools its own pixel
    subset with a private sample queue; the 'spp' axis renders disjoint
    sample-id ranges of the same pixels and psum-reduces."""
    from ..integrator import pool as pool_mod

    n_spp = mesh.shape["spp"]
    spp_local = cfg.spp // n_spp

    def shard_fn(sd_, eye_, rot_, ids_):
        spp_rank = jax.lax.axis_index("spp")
        base = (jnp.asarray(sample_base, jnp.uint32)
                + spp_rank.astype(jnp.uint32) * jnp.uint32(spp_local))
        total = ids_.shape[0] * spp_local
        accum, done, _, _ = pool_mod._pool_render_impl(
            sd_, eye_, rot_, total, cfg.replace(spp=spp_local),
            min(pool_m, total), base, pixel_ids=ids_,
        )
        return jax.lax.psum(accum, "spp")

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P("tile")),
        out_specs=P("tile"),
        check_vma=False,
    )(sd, eye, cam_rot, pixel_ids)


def render_film_distributed(sd, cam, cfg: RenderConfig, mesh: Mesh,
                            film: Optional[Film] = None) -> Film:
    """Full-film distributed render: film tiles over 'tile', spp over 'spp'.

    cfg.engine='pool' runs the respawn-compacted pool per shard (cfg.spp
    must divide by the spp axis); 'scan' accumulates in passes of
    mesh.shape['spp'] * sppb samples."""
    npix = cfg.width * cfg.height
    n_tile_ = mesh.shape["tile"]
    if cfg.engine == "pool" and cfg.integrator == "full":
        assert cfg.spp % mesh.shape["spp"] == 0, "spp must divide spp axis"
        if film is None:
            film = Film.create(cfg.height, cfg.width)
        pad = (-npix) % n_tile_
        pixel_ids = jnp.asarray(
            np.concatenate([np.arange(npix), np.zeros(pad)]).astype(np.uint32)
        )
        pool_m = int(min(cfg.rays_per_launch, npix * cfg.spp))
        accum = _pool_render_sharded(
            sd, jnp.asarray(cam.eye, jnp.float32),
            jnp.asarray(cam.camera_rotate, jnp.float32),
            pixel_ids, film.count, cfg, pool_m, mesh,
        )
        return Film(
            accum=film.accum + accum[:npix].reshape(cfg.height, cfg.width, 3),
            count=film.count + jnp.int32(cfg.spp),
        )
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    if film is None:
        film = Film.create(cfg.height, cfg.width)

    pad = (-npix) % n_tile
    pixel_ids = jnp.asarray(
        np.concatenate([np.arange(npix), np.zeros(pad)]).astype(np.uint32)
    )
    eye = jnp.asarray(cam.eye, jnp.float32)
    rot = jnp.asarray(cam.camera_rotate, jnp.float32)

    assert cfg.spp % n_spp == 0, "spp must divide the mesh spp axis"
    sppb = max(1, min(cfg.spp_batch, cfg.spp // n_spp))
    accum = film.accum.reshape(-1, 3)
    done = 0
    while done < cfg.spp:
        # clamp the last pass so exactly cfg.spp samples are rendered
        # (remaining stays a multiple of n_spp by induction)
        step = min(sppb, (cfg.spp - done) // n_spp)
        out = render_batch_sharded(
            sd, eye, rot, pixel_ids, film.count + done, cfg, step, mesh
        )
        accum = accum + out[:npix]
        done += step * n_spp
    return Film(accum=accum.reshape(cfg.height, cfg.width, 3),
                count=film.count + done)
