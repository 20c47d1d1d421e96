"""Counter-based RNG for wavefront path tracing.

The reference uses two incompatible, stateful RNGs: a per-pixel wang_hash
stream in GLSL (fshader_render.fsh:82-98, seeded from pixel coords and
frameCounter with constants 1973/9277/26699) and 31 cuRAND XORWOW states
*shared* by all CUDA threads via ``(tx + 7*ty) % 31`` — a deliberate data
race (PathTrace.cu:38, 664-667, 1430). Neither is reproducible.

Here every random draw is a pure function of a counter tuple
``(pixel_id, sample_id, bounce, site, lane)`` hashed with a PCG-style
mixer on uint32. Properties:

- stateless: any lane of any wavefront can be recomputed independently,
  which is what lets the film be sharded across a device mesh with no RNG
  state exchange, and lets checkpoint/resume be bitwise exact;
- backend-exact: uint32 arithmetic is identical in NumPy and XLA, so the
  CPU oracle (cpuref/) consumes bit-identical streams to the device
  integrator — the RMSE gate compares real float math, not RNG noise.

Sites are small static integers enumerating draw call sites inside one
bounce of the integrator (see integrator/sampling.py).
"""

from __future__ import annotations

# Distinct large odd constants decorrelate the counter dimensions before
# mixing (in the spirit of the reference's 1973/9277/26699 seed combine,
# fshader_render.fsh:82-85, but full-width).
_K_PIXEL = 0x9E3779B9
_K_SAMPLE = 0x85EBCA6B
_K_BOUNCE = 0xC2B2AE35
_K_SITE = 0x27D4EB2F
_K_SEED = 0x165667B1


def _u32(x, xp):
    if isinstance(x, int):  # jax rejects implicit >int32 Python ints
        import numpy as _np

        return xp.asarray(_np.uint32(x & 0xFFFFFFFF))
    return xp.asarray(x).astype(xp.uint32)


def pcg_hash(x, xp):
    """PCG output permutation on a uint32 state (O'Neill, pcg-random.org)."""
    import contextlib

    import numpy as _np

    guard = _np.errstate(over="ignore") if xp is _np else contextlib.nullcontext()
    with guard:
        x = x * _u32(747796405, xp) + _u32(2891336453, xp)
        word = ((x >> ((x >> _u32(28, xp)) + _u32(4, xp))) ^ x) * _u32(277803737, xp)
        return (word >> _u32(22, xp)) ^ word


def hash_counters(xp, pixel_id, sample_id, bounce, site, seed=0):
    """Mix a counter tuple into one uint32. Arguments broadcast.

    uint32 wraparound is the point; silence NumPy's scalar-overflow
    warnings (JAX wraps silently)."""
    import contextlib

    import numpy as _np

    guard = _np.errstate(over="ignore") if xp is _np else contextlib.nullcontext()
    with guard:
        h = _u32(pixel_id, xp) * _u32(_K_PIXEL, xp)
        h = h + _u32(sample_id, xp) * _u32(_K_SAMPLE, xp)
        h = pcg_hash(h, xp)
        h = h + _u32(bounce, xp) * _u32(_K_BOUNCE, xp)
        h = h + _u32(site, xp) * _u32(_K_SITE, xp)
        h = h + _u32(seed, xp) * _u32(_K_SEED, xp)
        return pcg_hash(h, xp)


def uniform(xp, pixel_id, sample_id, bounce, site, seed=0):
    """U[0, 1) float32 draw, one per broadcast element.

    Replaces curand_uniform (PathTrace.cu:924 etc.) and rand()
    (fshader_render.fsh:96-98). Top 24 bits -> exact float32 in [0, 1).
    """
    bits = hash_counters(xp, pixel_id, sample_id, bounce, site, seed)
    # cast via int32 (exact: top-24-bit values < 2^24)
    return (bits >> _u32(8, xp)).astype(xp.int32).astype(xp.float32) \
        * xp.float32(1.0 / 16777216.0)


def wang_hash(seed, xp):
    """The reference's GLSL hash, verbatim (fshader_render.fsh:87-94).

    Provided for behavioral-parity studies; the framework's own streams
    use pcg_hash (see module docstring for why)."""
    import contextlib

    import numpy as _np

    guard = _np.errstate(over="ignore") if xp is _np else contextlib.nullcontext()
    with guard:
        seed = _u32(seed, xp)
        seed = (seed ^ _u32(61, xp)) ^ (seed >> _u32(16, xp))
        seed = seed * _u32(9, xp)
        seed = seed ^ (seed >> _u32(4, xp))
        seed = seed * _u32(0x27D4EB2D, xp)
        seed = seed ^ (seed >> _u32(15, xp))
        return seed


def glsl_seed(px_norm_x, px_norm_y, width, height, frame_counter, xp):
    """The GLSL per-pixel seed (fshader_render.fsh:82-85):
    (x*1973 + y*9277 + frame*26699) | 1 over pixel integer coords."""
    import contextlib

    import numpy as _np

    guard = _np.errstate(over="ignore") if xp is _np else contextlib.nullcontext()
    with guard:
        x = _u32((px_norm_x * 0.5 + 0.5) * width, xp)
        y = _u32((px_norm_y * 0.5 + 0.5) * height, xp)
        s = (x * _u32(1973, xp) + y * _u32(9277, xp)
             + _u32(frame_counter, xp) * _u32(26699, xp))
        return s | _u32(1, xp)


class DrawSites:
    """Static site ids for every distinct random draw in one bounce.

    The integrator and the CPU oracle index draws with the same ids so
    their streams match. Per-light draws use LIGHT_BASE + 2*i {+1}.
    """

    JITTER_X = 0          # primary-ray film jitter (PathTrace.cu:1430)
    JITTER_Y = 1          # (PathTrace.cu:1431)
    SELECT_REFRACT = 2    # reflect-vs-refract lobe pick (PathTrace.cu:924)
    SELECT_SSS = 3        # SSS entry-vs-exit pick (PathTrace.cu:930)
    HDR_COS = 4           # env NEE direction (PathTrace.cu:968-970)
    HDR_PHI = 5
    RR = 6                # Russian roulette (PathTrace.cu:988)
    CONT_COS = 7          # continuation direction (PathTrace.cu:992-994)
    CONT_PHI = 8
    AREA_CDF = 9          # BSSRDF exit-triangle pick (PathTrace.cu:1031)
    EXIT_U = 10           # exit-point barycentrics (PathTrace.cu:1051-1052)
    EXIT_V = 11
    REFRACT_BASE = 16     # internal-reflection picks, + march step i
    # REFRACT_BASE..REFRACT_BASE+31 reserved (PathTrace.cu:1214)
    LIGHT_BASE = 64       # per-emissive-triangle point draws, + 2*i, +2*i+1
