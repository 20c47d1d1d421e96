"""Preview integrator: the cheap 2-bounce path tracer.

Mirrors pathTracing_ in the interactive preview shader
(fshader_preview.fsh:332-375): uniform-hemisphere bounces with pdf 1/2pi,
multiplicative ``history`` throughput, emissive + sky accumulation, and
*no* NEE shadow rays — the cost profile that gives the reference its
interactive FPS. Used by the preview CLI per progressive frame; the full
wavefront integrator (wavefront.py) is the offline/'R-key' path.

Runs on SoA planes like the main integrator (wavefront.py module
docstring): dense [M] planes, V3 triples, transposed row tables.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rng, vecmath as vm
from ..core.vecmath import V3, vdot, vwhere
from ..scene import envmap
from . import sampling
from .sampling import PI
from .wavefront import _nearest_planes, _tri_mat_rows_t, _unit_p

S = rng.DrawSites


def trace_preview_p(origins: V3, dirs: V3, pixel_id, sample_id, sd, cfg, xp,
                    nearest_fn, max_bounce: int = 2) -> V3:
    """Primary rays (SoA planes) -> radiance V3 at preview quality."""
    m = origins.x.shape[0]
    d_unit = _unit_p(dirs, xp)
    ex0 = xp.full((m,), -1, xp.int32)
    hit0, idx0, t0 = _nearest_planes(nearest_fn, origins, d_unit, ex0, xp)
    sky0 = envmap.sample_env_sd_p(sd, d_unit, xp, clamp=cfg.hdr_clamp)

    row0, mrow0 = _tri_mat_rows_t(sd, xp.where(hit0, idx0, 0), xp)
    le0 = vm.v3rows(mrow0, 0)

    zero = xp.zeros((m,), xp.float32)
    one = xp.ones((m,), xp.float32)
    lo = V3(zero, zero, zero)
    history = V3(one, one, one)
    active = hit0
    point = origins + d_unit * t0
    view_dir = d_unit  # incoming direction (toward the surface)
    tri = xp.where(hit0, idx0, 0)

    for b in range(max_bounce):
        trow, mrow = _tri_mat_rows_t(sd, tri, xp)
        normal = vm.v3rows(trow, 9)                     # TRI_NORM
        brdf = vm.v3rows(mrow, 3)                       # MAT_BRDF
        u1 = rng.uniform(xp, pixel_id, sample_id, b + 1, S.CONT_COS, cfg.seed)
        u2 = rng.uniform(xp, pixel_id, sample_id, b + 1, S.CONT_PHI, cfg.seed)
        wi = sampling.uniform_sphere_p(u1, u2, xp)
        # fold away from the view direction (fshader_preview.fsh:343-345)
        flip = vdot(wi, normal) * vdot(view_dir, normal) > 0
        wi = vwhere(flip, -wi, wi, xp)
        wi = vwhere(active, wi, 0.0, xp)

        hit, idx, t = _nearest_planes(
            nearest_fn, point, wi, xp.where(active, tri, -2), xp)
        _, nmrow = _tri_mat_rows_t(sd, xp.where(hit, idx, 0), xp)
        n_emis = vm.v3rows(nmrow, 0)
        cos_i = xp.abs(vdot(wi, normal))
        f_r = brdf * (1.0 / PI)
        weight = f_r * cos_i * (2.0 * PI)  # / pdf = * 2pi

        wi_u = _unit_p(wi, xp)
        sky = envmap.sample_env_sd_p(sd, wi_u, xp, clamp=cfg.hdr_clamp)
        miss = active & ~hit
        lo = lo + vwhere(miss, history * sky * weight, 0.0, xp)
        lo = lo + vwhere(active & hit, history * n_emis * weight, 0.0, xp)

        cont = active & hit
        history = vwhere(cont, history * weight, history, xp)
        point = vwhere(cont, point + wi_u * t, point, xp)
        view_dir = vwhere(cont, wi_u, view_dir, xp)
        tri = xp.where(cont, idx, tri)
        active = cont

    return vwhere(hit0, le0 + lo, sky0, xp)


def trace_preview(origins, dirs, pixel_id, sample_id, sd, cfg, xp, nearest_fn,
                  max_bounce: int = 2):
    """Row-vector wrapper -> radiance [M, 3] (tests / legacy callers)."""
    out = trace_preview_p(
        vm.v3unstack(origins), vm.v3unstack(dirs), pixel_id, sample_id, sd,
        cfg, xp, nearest_fn, max_bounce=max_bounce,
    )
    return vm.v3stack(out, xp)
