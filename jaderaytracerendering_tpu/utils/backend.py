"""The capability switch: how this process runs the Pallas kernels.

- ``gpu``: compiled kernels (Pallas' Triton route);
- ``cpu``: the Pallas interpreter (tests and CPU rehearsals only);
- any other platform: an error; the kernels are written for NVIDIA GPUs.

``compiled_kernels()`` forces compiled kernels on any host, so a CPU
test can lower the GPU program for ``cuda`` exactly as the card will
compile it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import jax

_forced: Optional[bool] = None


def kernel_interpret(platform: Optional[str] = None) -> bool:
    """True when Pallas kernels must run in interpret mode.

    ``platform`` defaults to JAX's default backend."""
    if _forced:
        return False
    if platform is None:
        platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no kernel route for JAX platform {platform!r}: this renderer's "
        "kernels compile for NVIDIA GPUs (platform 'gpu'); the CPU runs "
        "them interpreted")


@contextlib.contextmanager
def compiled_kernels():
    """Trace kernels in compiled mode whatever the backend (for lowering
    the GPU program on a CPU host). Clears JAX's trace caches on entry
    and exit so no trace made under the other mode is reused."""
    global _forced
    prev = _forced
    _forced = True
    jax.clear_caches()
    try:
        yield
    finally:
        _forced = prev
        jax.clear_caches()
