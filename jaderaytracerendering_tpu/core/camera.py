"""Orbit camera and primary-ray generation.

Replicates the reference camera exactly:

- eye orbits the *origin* on a sphere of radius ``r`` while looking at a
  movable ``eye_center`` (PathTrace.cpp:684-687);
- the ray-rotation matrix is ``inverse(lookAt(eye, eye_center, +Y))``;
- a primary ray direction is ``cameraRotate * (ndc_x, ndc_y, -1.5, 0)``
  (focal length 1.5, square film; fshader_render.fsh:464,
  PathTrace.cu:1434-1435).

Matrices are stored GLM-style as ``m[col, row]`` so that
``core.vecmath.transform_*`` reproduces the reference's multiply
(PathTrace.cu:268-276) and render_args.txt round-trips element-for-element
(PathTrace.cpp:887-891 / PathTrace.cu:1489-1493).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import rng, vecmath

FOCAL_Z = -1.5  # film plane depth (fshader_render.fsh:464, PathTrace.cu:1434)


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """GLM-compatible right-handed lookAt, returned as m[col, row]."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    # m[col, row]: columns 0..2 carry the basis row-vectors.
    m[0, 0], m[1, 0], m[2, 0] = s
    m[0, 1], m[1, 1], m[2, 1] = u
    m[0, 2], m[1, 2], m[2, 2] = -f
    m[3, 0] = -np.dot(s, eye)
    m[3, 1] = -np.dot(u, eye)
    m[3, 2] = np.dot(f, eye)
    return m


def invert(m: np.ndarray) -> np.ndarray:
    """Inverse of a m[col, row]-layout matrix, same layout out."""
    return np.linalg.inv(m.T).T


@dataclasses.dataclass
class FixedCamera:
    """A deserialized camera: explicit eye + rotation (render_args.txt
    carries exactly these two; PathTrace.cu:1486-1493)."""

    eye_point: np.ndarray
    rotate: np.ndarray

    @property
    def eye(self) -> np.ndarray:
        return np.asarray(self.eye_point, np.float64)

    @property
    def camera_rotate(self) -> np.ndarray:
        return np.asarray(self.rotate, np.float64)


@dataclasses.dataclass
class OrbitCamera:
    """Mutable orbit-camera state (PathTrace.cpp:209-211, 671-673).

    Angles in degrees; ``move_*`` mirror the keyboard controls
    (PathTrace.cpp:737-801) so the preview CLI behaves identically.
    """

    up_angle: float = 0.0
    rotate_angle: float = 0.0
    r: float = 4.0
    eye_center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64)
    )

    @property
    def eye(self) -> np.ndarray:
        ra, ua = math.radians(self.rotate_angle), math.radians(self.up_angle)
        return self.r * np.array(
            [-math.sin(ra) * math.cos(ua), math.sin(ua), math.cos(ra) * math.cos(ua)]
        )

    @property
    def camera_rotate(self) -> np.ndarray:
        """inverse(lookAt(eye, eye_center, +Y)) as m[col, row] float32."""
        return invert(look_at(self.eye, self.eye_center, np.array([0.0, 1.0, 0.0])))

    def orbit(self, d_up: float = 0.0, d_rotate: float = 0.0) -> None:
        self.up_angle += d_up
        self.rotate_angle += d_rotate

    def move_center(self, dx: float = 0.0, dy: float = 0.0) -> None:
        self.eye_center[0] += dx
        self.eye_center[1] += dy

    def dolly(self, dr: float) -> None:
        self.r += dr


def generate_rays(
    xp,
    eye,
    camera_rotate,
    width: int,
    height: int,
    pixel_id,
    sample_id,
    seed=0,
    jitter: str = "cuda",
):
    """Jittered primary rays for flat pixel ids -> (origins, dirs), [N, 3].

    ``jitter='cuda'`` uses the batch renderer's mapping
    ``ndc = -1 + 2/W * (px + u - 0.5)`` (PathTrace.cu:1430-1431);
    ``jitter='gl'`` uses the GLSL fragment mapping: pixel-center NDC plus
    ``(u - 0.5)/W`` (fshader_render.fsh:463).
    """
    px = (pixel_id % width).astype(xp.float32)
    py = (pixel_id // width).astype(xp.float32)
    u1 = rng.uniform(xp, pixel_id, sample_id, 0, rng.DrawSites.JITTER_X, seed)
    u2 = rng.uniform(xp, pixel_id, sample_id, 0, rng.DrawSites.JITTER_Y, seed)
    if jitter == "cuda":
        ndc_x = -1.0 + 2.0 / width * (px + u1 - 0.5)
        ndc_y = -1.0 + 2.0 / height * (py + u2 - 0.5)
    elif jitter == "gl":
        ndc_x = -1.0 + 2.0 * (px + 0.5) / width + (u1 - 0.5) / width
        ndc_y = -1.0 + 2.0 * (py + 0.5) / height + (u2 - 0.5) / height
    else:
        raise ValueError(f"unknown jitter mode {jitter!r}")

    d = xp.stack([ndc_x, ndc_y, xp.full_like(ndc_x, FOCAL_Z)], axis=-1)
    m = xp.asarray(camera_rotate, xp.float32)
    dirs = vecmath.normalize(vecmath.transform_dir(m, d, xp), xp)
    origins = xp.broadcast_to(
        xp.asarray(eye, xp.float32)[None, :], dirs.shape
    ).astype(xp.float32)
    return origins, dirs


def generate_rays_p(
    xp,
    eye,
    camera_rotate,
    width: int,
    height: int,
    pixel_id,
    sample_id,
    seed=0,
    jitter: str = "cuda",
):
    """Plane (SoA) form of generate_rays -> (origins V3, dirs V3).

    Identical math per component (vecmath.vtransform mirrors _transform's
    m[col, row] products), on dense [N] planes — the integrator's hot
    path never materializes [N, 3] buffers."""
    px = (pixel_id % width).astype(xp.float32)
    py = (pixel_id // width).astype(xp.float32)
    u1 = rng.uniform(xp, pixel_id, sample_id, 0, rng.DrawSites.JITTER_X, seed)
    u2 = rng.uniform(xp, pixel_id, sample_id, 0, rng.DrawSites.JITTER_Y, seed)
    if jitter == "cuda":
        ndc_x = -1.0 + 2.0 / width * (px + u1 - 0.5)
        ndc_y = -1.0 + 2.0 / height * (py + u2 - 0.5)
    elif jitter == "gl":
        ndc_x = -1.0 + 2.0 * (px + 0.5) / width + (u1 - 0.5) / width
        ndc_y = -1.0 + 2.0 * (py + 0.5) / height + (u2 - 0.5) / height
    else:
        raise ValueError(f"unknown jitter mode {jitter!r}")

    d = vecmath.V3(ndc_x, ndc_y, xp.full_like(ndc_x, FOCAL_Z))
    m = xp.asarray(camera_rotate, xp.float32)
    dirs = vecmath.vnormalize(vecmath.vtransform(m, d, 0.0), xp)
    e = xp.asarray(eye, xp.float32)
    origins = vecmath.V3(
        xp.broadcast_to(e[0], px.shape).astype(xp.float32),
        xp.broadcast_to(e[1], px.shape).astype(xp.float32),
        xp.broadcast_to(e[2], px.shape).astype(xp.float32),
    )
    return origins, dirs
