"""Test harness: the JAX CPU backend with 8 virtual devices.

Multi-device sharding tests run against a fake 8-device mesh
(xla_force_host_platform_device_count) so the suite is deterministic and
needs no GPUs (SURVEY §4 multi-chip test row); Pallas kernels run in
interpret mode (utils/backend.py). XLA_FLAGS must be set before the
first jax import. Tests that need the card carry the ``gpu`` marker and
skip here; ``python chip_smoke.py`` runs the same checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# No persistent compile cache under tests: serializing CPU executables
# segfaulted the suite (package __init__ docs; the crash is native, in
# jax compilation_cache.put_executable_and_time)
os.environ["JADE_COMPILE_CACHE"] = "0"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """The XLA:CPU backend segfaulted natively (backend_compile_and_load)
    deep into the --runslow suite — hundreds of accumulated compiled
    executables in one process; every module ran clean in isolation.
    Dropping the in-process executable caches between modules keeps the
    compiler state small. (Not a fix for the jaxlib bug, but it moves
    the suite out of the crash regime.)"""
    yield
    jax.clear_caches()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (long interpret-mode parity runs, "
             "multi-process rigs) — the full CI-style suite")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: opt in with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is an NVIDIA GPU
    (decided per test, never at import: xdist workers must collect the
    same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs this "
                    "check on the card)")
