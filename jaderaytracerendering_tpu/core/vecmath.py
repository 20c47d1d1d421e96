"""Batched 3-vector math shared by the JAX integrator and the NumPy oracle.

The reference carries its own float3 wrappers (vec3_hs / vec3_dv,
PathTrace.cu:110-289). Here vectors are arrays of shape [..., 3] and every
helper takes an ``xp`` array module (numpy or jax.numpy) so the exact same
code path produces the CPU oracle and the device integrator — uint/float
op sequences are identical, which is what makes CPU-vs-GPU RMSE checks
tight.
"""

from __future__ import annotations


def dot(a, b, xp):
    """Row-wise dot product of [..., 3] vectors -> [..., 1] (keepdims)."""
    return xp.sum(a * b, axis=-1, keepdims=True)


def dot_s(a, b, xp):
    """Row-wise dot product -> [...] (no kept dim)."""
    return xp.sum(a * b, axis=-1)


def cross(a, b, xp):
    """Row-wise cross product of [..., 3] vectors (PathTrace.cu:283-289)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return xp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def mixed_product(a, b, c, xp):
    """Scalar triple product a . (b x c) -> [...] (PathTrace.cu:261-266)."""
    return dot_s(a, cross(b, c, xp), xp)


def norm(v, xp):
    """Euclidean length of [..., 3] vectors -> [...]."""
    return xp.sqrt(dot_s(v, v, xp))


def _np_quiet(xp):
    """errstate guard for the NumPy backend: masked dead lanes carry
    zero directions by design, and their 1/0 -> inf/NaN results are
    select-discarded — silence the (expected) FP warnings so real ones
    stand out. JAX has no FP warnings; use a no-op there."""
    if xp.__name__ == "numpy":
        import numpy as _np

        return _np.errstate(divide="ignore", invalid="ignore")
    import contextlib

    return contextlib.nullcontext()


def normalize(v, xp, eps=0.0):
    """Unit vector; matches the reference's 1/sqrt form (PathTrace.cu:278-281).

    ``eps`` guards zero-length input lanes (masked-out wavefront lanes may
    carry zero directions; the reference never normalizes a zero vector).
    """
    n2 = dot(v, v, xp)
    if eps:
        n2 = xp.maximum(n2, eps)
    with _np_quiet(xp):
        return v * (1.0 / xp.sqrt(n2))


def transform_point(m, v, xp):
    """Apply a 4x4 matrix (w=1) to [..., 3] points.

    The reference stores matrices in GLM column-major layout and computes
    ``out = M^T-style`` products (PathTrace.cu:268-276): element [col][row]
    indexing means ``out_x = m[0][0]x + m[1][0]y + m[2][0]z + m[3][0]w``.
    ``m`` here is a [4, 4] array in that same storage order (m[c, r]).
    """
    return _transform(m, v, 1.0, xp)


def transform_dir(m, v, xp):
    """Apply a 4x4 matrix with w=0 (directions; PathTrace.cu:1434-1435)."""
    return _transform(m, v, 0.0, xp)


def _transform(m, v, w, xp):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    ox = m[0, 0] * x + m[1, 0] * y + m[2, 0] * z + m[3, 0] * w
    oy = m[0, 1] * x + m[1, 1] * y + m[2, 1] * z + m[3, 1] * w
    oz = m[0, 2] * x + m[1, 2] * y + m[2, 2] * z + m[3, 2] * w
    return xp.stack([ox, oy, oz], axis=-1)


def reflect(d, n, xp):
    """Mirror reflection d' = d - 2(d.n)n.

    The reference writes the mirror continuation as
    ``n*(2 dot(out,n)) - out`` for the reversed direction convention
    (PathTrace.cu:1378) and ``r - n*2(r.n)`` inside refraction
    (PathTrace.cu:1217); both reduce to this with consistent signs.
    """
    return d - n * (2.0 * dot(d, n, xp))


# ---- lane-dense SoA ("plane") vectors --------------------------------------
#
# V3 keeps each component of a 3-vector as its own dense [M] plane; all arithmetic is elementwise on
# same-shaped 1-D arrays, which XLA fuses without any layout conversion.
# V3 is a NamedTuple, hence a pytree: it can live in lax.scan /
# while_loop carries directly.

import typing as _t


class V3(_t.NamedTuple):
    """A 3-vector of same-shaped component planes (SoA layout)."""

    x: _t.Any
    y: _t.Any
    z: _t.Any

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return V3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def v3stack(v: V3, xp):
    """V3 of [M] planes -> [M, 3] row-vector array."""
    return xp.stack([v.x, v.y, v.z], axis=-1)


def v3unstack(a) -> V3:
    """[..., 3] row-vector array -> V3 of planes."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def v3rows(rows_t, start: int) -> V3:
    """Three consecutive rows of a transposed [K, M] table -> V3."""
    return V3(rows_t[start], rows_t[start + 1], rows_t[start + 2])


def vdot(a: V3, b: V3):
    """Dot product -> plane. Same association order as dot_s on [M, 3]."""
    return (a.x * b.x + a.y * b.y) + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def vnorm(v: V3, xp):
    return xp.sqrt(vdot(v, v))


def vnormalize(v: V3, xp, eps=0.0) -> V3:
    n2 = vdot(v, v)
    if eps:
        n2 = xp.maximum(n2, eps)
    with _np_quiet(xp):
        return v * (1.0 / xp.sqrt(n2))


def vwhere(mask, a, b, xp) -> V3:
    """Componentwise where; ``mask`` is a plane, ``a``/``b`` V3 or scalar."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(xp.where(mask, ax, bx), xp.where(mask, ay, by),
              xp.where(mask, az, bz))


def vfull(shape, val, xp, dtype=None) -> V3:
    z = xp.full(shape, val, dtype) if dtype is not None else xp.full(shape, val)
    return V3(z, z, z)


def vreflect(d: V3, n: V3) -> V3:
    """d - 2 (d.n) n on planes (see reflect above for reference cites)."""
    k = 2.0 * vdot(d, n)
    return V3(d.x - n.x * k, d.y - n.y * k, d.z - n.z * k)


def vtransform(m, v: V3, w) -> V3:
    """4x4 GLM-layout (m[col, row]) transform on planes (see _transform)."""
    ox = m[0, 0] * v.x + m[1, 0] * v.y + m[2, 0] * v.z + m[3, 0] * w
    oy = m[0, 1] * v.x + m[1, 1] * v.y + m[2, 1] * v.z + m[3, 1] * w
    oz = m[0, 2] * v.x + m[1, 2] * v.y + m[2, 2] * v.z + m[3, 2] * w
    return V3(ox, oy, oz)


def triangle_area(p1, p2, p3, xp):
    """0.5 * |(p2-p1) x (p3-p1)| (PathTrace.cu:897-903)."""
    c = cross(p2 - p1, p3 - p1, xp)
    return 0.5 * xp.sqrt(dot_s(c, c, xp))


def face_normal(p1, p2, p3, xp):
    """Flat-shaded face normal normalize(cross(p2-p1, p3-p1)) (PathTrace.cu:448)."""
    return normalize(cross(p2 - p1, p3 - p1, xp), xp)
