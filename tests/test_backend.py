"""Capability switch, compile-cache placement, config compatibility and
the device guards of the entry scripts."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from jaderaytracerendering_tpu.utils import backend
from jaderaytracerendering_tpu.utils.config import RenderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,interpret", [("gpu", False),
                                                ("cpu", True)])
def test_kernel_switch(platform, interpret):
    assert backend.kernel_interpret(platform) is interpret


@pytest.mark.parametrize("platform", ["metal", "rocm"])
def test_kernel_switch_rejects_other_platforms(platform):
    with pytest.raises(RuntimeError, match="NVIDIA"):
        backend.kernel_interpret(platform)


def test_kernel_switch_defaults_to_this_backend():
    assert backend.kernel_interpret() is True  # the suite runs on the CPU


def test_compiled_kernels_forces_and_restores():
    with backend.compiled_kernels():
        assert backend.kernel_interpret() is False
        assert backend.kernel_interpret("cpu") is False
    assert backend.kernel_interpret() is True


def _cache_dir_in_child(env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JADE_COMPILE_CACHE",
                        "JAX_PLATFORMS")}
    env.update(env_over)
    code = ("import jax, jaderaytracerendering_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    return out.strip().splitlines()[-1]


def test_compile_cache_honours_env_var(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_compile_cache_default_is_fixed_in_checkout():
    got = _cache_dir_in_child({})
    assert got == os.path.join(REPO, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_compile_cache_off_for_cpu_processes():
    assert _cache_dir_in_child({"JAX_PLATFORMS": "cpu"}) == "None"


@pytest.mark.parametrize("field,value", [
    ("mega_tile", 512), ("mega_gather", "auto"), ("fused_tail", True),
    ("front_kernel", True), ("spawn_kernel", True),
    ("pallas_shading", True)])
def test_archived_json_with_removed_fields_loads(field, value):
    data = json.loads(RenderConfig(spp=3).to_json())
    data[field] = value
    cfg = RenderConfig.from_json(json.dumps(data))
    assert cfg == RenderConfig(spp=3)


def test_unknown_engine_is_an_error_not_a_fallback():
    from jaderaytracerendering_tpu.integrator import render as R

    with pytest.raises(ValueError, match="unknown engine"):
        R.render_film(None, None, RenderConfig(engine="mega"))


def _run_script(args, cwd, **env_over):
    env = dict(os.environ)
    env.update(env_over)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_on_cpu_fails_without_ok_line():
    p = _run_script(["chip_smoke.py"], REPO, JAX_PLATFORMS="cpu")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "not 'gpu'" in p.stdout


def test_chip_smoke_alone_fails_without_ok_line(tmp_path):
    # --rehearse passes the device check on the CPU, so this reaches the
    # check that the renderer package sits next to the script
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_script(["chip_smoke.py", "--rehearse"], str(tmp_path),
                    JAX_PLATFORMS="cpu")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "not next to this script" in p.stdout


def test_bench_without_gpu_fails():
    p = _run_script(["bench.py"], REPO, JAX_PLATFORMS="cpu")
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert p.stdout.strip() == ""
