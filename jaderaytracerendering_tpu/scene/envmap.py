"""Equirectangular environment-map sampling.

Replaces the reference's HDR texture path: direction -> equirect uv
(SampleSphericalMap, PathTrace.cu:686-694 / fshader_render.fsh:101-107),
bilinear filtering with mirror addressing like the CUDA texture refs
(PathTrace.cu:1652-1665), and the radiance clamp to 10.0
(PathTrace.cu:700, fshader_render.fsh:113). The GL path instead uses
nearest/clamp-to-edge textures (PathTrace.cpp:283-287) — available via
``filtering='nearest_clamp'``.

xp-agnostic: the same code drives the NumPy oracle and the jit'd
integrator (gathers become XLA gathers).
"""

from __future__ import annotations


def spherical_uv(v, xp):
    """Unit direction [..., 3] -> equirect uv in [0,1]^2 (v=0 at top)."""
    u = xp.arctan2(v[..., 2], v[..., 0]) / (2.0 * 3.1415926) + 0.5
    w = 1.0 - (xp.arcsin(xp.clip(v[..., 1], -1.0, 1.0)) / 3.1415926 + 0.5)
    return u, w


def _mirror_index(i, n, xp):
    """Mirror (reflect) addressing: ... 2 1 0 0 1 2 ... n-1 n-1 n-2 ..."""
    period = 2 * n
    i = i % period  # floored mod: negatives reflect correctly (-1 -> 0)
    return xp.where(i >= n, period - 1 - i, i)


def sample_env(img, dirs, xp, clamp: float = 10.0, filtering: str = "bilinear_mirror"):
    """Sample env map [H, W, 3] at unit directions [..., 3] -> [..., 3].

    ``clamp``: per-channel radiance limit (10.0 in the reference).
    """
    h, w = img.shape[0], img.shape[1]
    u, v = spherical_uv(dirs, xp)
    if filtering == "bilinear_mirror":
        fx = u * w - 0.5
        fy = v * h - 0.5
        x0 = xp.floor(fx)
        y0 = xp.floor(fy)
        tx = (fx - x0)[..., None]
        ty = (fy - y0)[..., None]
        x0i = x0.astype(xp.int32)
        y0i = y0.astype(xp.int32)
        x1i = _mirror_index(x0i + 1, w, xp)
        y1i = _mirror_index(y0i + 1, h, xp)
        x0i = _mirror_index(x0i, w, xp)
        y0i = _mirror_index(y0i, h, xp)
        c00 = img[y0i, x0i]
        c01 = img[y0i, x1i]
        c10 = img[y1i, x0i]
        c11 = img[y1i, x1i]
        color = (
            c00 * (1 - tx) * (1 - ty)
            + c01 * tx * (1 - ty)
            + c10 * (1 - tx) * ty
            + c11 * tx * ty
        )
    elif filtering == "nearest_clamp":
        xi = xp.clip((u * w).astype(xp.int32), 0, w - 1)
        yi = xp.clip((v * h).astype(xp.int32), 0, h - 1)
        color = img[yi, xi]
    else:
        raise ValueError(f"unknown filtering {filtering!r}")
    return xp.minimum(color, clamp)


def pack_bilinear(img, xp):
    """Pre-pack the 2x2 bilinear neighborhood: [H, W, 3] -> rows
    [(H+1)*(W+1), 16] indexed by the RAW (pre-mirror) floor coordinates
    (y0+1, x0+1), y0 in [-1, H-1], x0 in [-1, W-1].

    One 64-byte-row gather replaces four scattered [M]-row gathers per
    sample. Each row
    holds (c00, c01, c10, c11, pad) with the mirror addressing of the
    CUDA texture refs (PathTrace.cu:1652-1665) baked in from the raw
    index — raw -1 and 0 mirror to the same base texel but different
    neighbors, so the table is indexed pre-mirror to reproduce
    sample_env bitwise.
    """
    h, w = img.shape[0], img.shape[1]
    ys = xp.arange(-1, h)                      # raw y0 range
    xs = xp.arange(-1, w)                      # raw x0 range
    y0 = _mirror_index(ys, h, xp)
    x0 = _mirror_index(xs, w, xp)
    y1 = _mirror_index(ys + 1, h, xp)
    x1 = _mirror_index(xs + 1, w, xp)
    pack = xp.zeros((h + 1, w + 1, 16), img.dtype)
    if xp.__name__ == "numpy":
        pack[:, :, 0:3] = img[y0][:, x0]
        pack[:, :, 3:6] = img[y0][:, x1]
        pack[:, :, 6:9] = img[y1][:, x0]
        pack[:, :, 9:12] = img[y1][:, x1]
    else:
        pack = pack.at[:, :, 0:3].set(img[y0][:, x0])
        pack = pack.at[:, :, 3:6].set(img[y0][:, x1])
        pack = pack.at[:, :, 6:9].set(img[y1][:, x0])
        pack = pack.at[:, :, 9:12].set(img[y1][:, x1])
    return pack.reshape((h + 1) * (w + 1), 16)


def sample_env_packed(pack, shape, dirs, xp, clamp: float = 10.0):
    """Bilinear-mirror env sample from pack_bilinear rows.

    ``shape`` = (H, W) of the original image. Identical math (and f32
    rounding) to sample_env's bilinear_mirror path; only the fetch
    pattern differs (one wide row gather instead of four scattered)."""
    h, w = shape
    u, v = spherical_uv(dirs, xp)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = xp.floor(fx)
    y0 = xp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = xp.clip(x0.astype(xp.int32), -1, w - 1)
    y0i = xp.clip(y0.astype(xp.int32), -1, h - 1)
    row = pack[(y0i + 1) * (w + 1) + (x0i + 1)]
    c00 = row[..., 0:3]
    c01 = row[..., 3:6]
    c10 = row[..., 6:9]
    c11 = row[..., 9:12]
    color = (
        c00 * (1 - tx) * (1 - ty)
        + c01 * tx * (1 - ty)
        + c10 * (1 - tx) * ty
        + c11 * tx * ty
    )
    return xp.minimum(color, clamp)


def sample_env_packed_p(pack, shape, d, xp, clamp: float = 10.0):
    """Plane (SoA) form of sample_env_packed: ``d`` is a vecmath.V3 of
    unit-direction planes; returns a V3. One wide row gather, transposed
    to [16, M] so the 2x2 texel reads are contiguous rows. Identical
    math and rounding order to sample_env_packed."""
    from ..core.vecmath import V3, v3rows

    h, w = shape
    u = xp.arctan2(d.z, d.x) / (2.0 * 3.1415926) + 0.5
    v = 1.0 - (xp.arcsin(xp.clip(d.y, -1.0, 1.0)) / 3.1415926 + 0.5)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = xp.floor(fx)
    y0 = xp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = xp.clip(x0.astype(xp.int32), -1, w - 1)
    y0i = xp.clip(y0.astype(xp.int32), -1, h - 1)
    rowt = xp.transpose(pack[(y0i + 1) * (w + 1) + (x0i + 1)])  # [16, M]
    c00 = v3rows(rowt, 0)
    c01 = v3rows(rowt, 3)
    c10 = v3rows(rowt, 6)
    c11 = v3rows(rowt, 9)
    color = (
        c00 * (1 - tx) * (1 - ty)
        + c01 * tx * (1 - ty)
        + c10 * (1 - tx) * ty
        + c11 * tx * ty
    )
    return V3(xp.minimum(color.x, clamp), xp.minimum(color.y, clamp),
              xp.minimum(color.z, clamp))


def sample_env_sd_p(sd, d, xp, clamp: float = 10.0):
    """Scene-aware plane-form env sample (V3 in -> V3 out)."""
    from ..core.vecmath import v3stack, v3unstack

    if getattr(sd, "env_pack", None) is not None and sd.env_pack.shape[0]:
        return sample_env_packed_p(
            sd.env_pack, (sd.env_map.shape[0], sd.env_map.shape[1]), d, xp,
            clamp)
    return v3unstack(sample_env(sd.env_map, v3stack(d, xp), xp, clamp))


def sample_env_sd(sd, dirs, xp, clamp: float = 10.0):
    """Scene-aware env sample: packed fast path when the scene carries
    env_pack (assemble always builds it), else the plain bilinear path."""
    if getattr(sd, "env_pack", None) is not None and sd.env_pack.shape[0]:
        return sample_env_packed(sd.env_pack,
                                 (sd.env_map.shape[0], sd.env_map.shape[1]),
                                 dirs, xp, clamp)
    return sample_env(sd.env_map, dirs, xp, clamp)
