"""jaderaytracerendering_tpu — a GPU path-tracing framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
MaxMorning/JadeRayTraceRendering (PathTrace.cpp, PathTrace.cu,
shaders/*): a progressive-preview + batch path tracer with a SAH BVH,
NEE against area lights and an HDR environment, and the "jade" material
stack (diffuse / mirror / subsurface random-walk BSSRDF / direct
refraction with Beer-Lambert absorption).

Architecture:

- ``core``       vector math conventions, counter-based RNG (replaces the
                 reference's wang_hash / 31 aliased cuRAND states), orbit
                 camera, film (progressive accumulation buffers).
- ``scene``      OBJ loader, materials, transforms, Radiance .hdr loader,
                 equirect environment sampling, scene assembly into SoA
                 device buffers, render_args.txt / JSON serialization.
- ``accel``      SAH BVH builder (NumPy + native C++), cluster cut of the
                 tree for the sweep traversal.
- ``ops``        batched ray-triangle / ray-AABB math, brute-force, BVH
                 and cluster nearest-hit over ray wavefronts (jnp), and
                 the Pallas-Triton cluster sweep kernel.
- ``integrator`` wavefront path integrator: masked material lanes instead
                 of the CUDA megakernel's divergent branches; scan and
                 respawn-compacted ray-pool engines.
- ``cpuref``     NumPy oracle implementing the same math + RNG streams.
- ``post``       accumulation, ACES/Reinhard tonemaps, gamma, BMP/PNG IO.
- ``parallel``   jax.sharding mesh: film-tile data parallelism and
                 spp-axis sharding with psum accumulation.
- ``models``     demo scenes (jade Buddha stand-in) and procedural meshes.
- ``cli``        preview (progressive) and render (batch) entry points.
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR
# itself; only when it is unset does the cache go to a fixed directory
# inside the checkout (<checkout>/.jax_cache, listed in .gitignore) — a
# fixed path, because the path is part of what a later process matches.
# Opt out with JADE_COMPILE_CACHE=0.
#
# Never for CPU-targeted processes: serializing CPU executables
# segfaulted the test suite (jax compilation_cache.put_executable_and_time;
# CPU AOT artifacts embed host machine features and crash across host
# types), so the cache is skipped under JAX_PLATFORMS=cpu, tests/
# conftest.py exports JADE_COMPILE_CACHE=0, and every --cpu entry point
# turns jax_enable_compilation_cache off after selecting the CPU backend.
import os as _os


def _default_cache_dir() -> str:
    here = _os.path.dirname(_os.path.abspath(__file__))
    return _os.path.join(_os.path.dirname(here), ".jax_cache")


if (_os.environ.get("JADE_COMPILE_CACHE", "1") != "0"
        and _os.environ.get("JAX_PLATFORMS", "") != "cpu"):
    import jax as _jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", _default_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
