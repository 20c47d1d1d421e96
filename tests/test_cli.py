"""CLI end-to-end tests (CPU backend, tiny configs)."""

import os

import numpy as np
import pytest

from jaderaytracerendering_tpu.cli import render as render_cli, preview as preview_cli
from jaderaytracerendering_tpu.post import image_io


def test_render_cli_bmp(tmp_path):
    out = str(tmp_path / "out.bmp")
    render_cli.main([
        "--cpu", "--scene", "tiny", "--width", "12", "--height", "12", "--spp", "2",
        "--max-depth", "2", "--traversal", "bvh", "--out", out,
    ])
    img = image_io.read_bmp(out)
    assert img.shape == (12, 12, 3)
    assert img.max() > 0


def test_render_cli_film_checkpoint_resume(tmp_path):
    film = str(tmp_path / "film.npz")
    out1 = str(tmp_path / "a.bmp")
    out2 = str(tmp_path / "b.bmp")
    args = ["--cpu", "--scene", "tiny", "--width", "8", "--height", "8",
            "--spp", "2", "--max-depth", "2", "--traversal", "bvh"]
    render_cli.main(args + ["--out", out1, "--save-film", film])
    assert os.path.exists(film)
    # resume doubles the sample count and still writes a valid image
    render_cli.main(args + ["--out", out2, "--resume-film", film])
    img = image_io.read_bmp(out2)
    assert img.shape == (8, 8, 3)


def test_render_cli_render_args_input(tmp_path):
    # write render_args.txt from the demo scene, then consume it
    from jaderaytracerendering_tpu.models import demo
    from jaderaytracerendering_tpu.scene import serialization

    spec = demo.to_spec(demo.tiny_scene())
    ra = str(tmp_path / "render_args.txt")
    serialization.write_render_args(ra, spec)
    out = str(tmp_path / "out.png")
    render_cli.main([
        "--cpu", "--render-args", ra, "--width", "8", "--height", "8", "--spp", "1",
        "--max-depth", "2", "--traversal", "bvh", "--out", out,
    ])
    assert os.path.exists(out)


def test_preview_cli_headless_frames(tmp_path):
    out = str(tmp_path / "prev.png")
    preview_cli.main([
        "--cpu", "--scene", "tiny", "--width", "8", "--height", "8",
        "--traversal", "bvh", "--frames", "2", "--out", out,
    ])
    assert os.path.exists(out)


def test_render_cli_mesh(tmp_path):
    out = str(tmp_path / "mesh.bmp")
    render_cli.main([
        "--cpu", "--scene", "tiny", "--width", "8", "--height", "8", "--spp", "2",
        "--max-depth", "2", "--traversal", "bvh", "--mesh", "4x2",
        "--out", out,
    ])
    img = image_io.read_bmp(out)
    assert img.shape == (8, 8, 3)


def test_render_cli_custom_hdr(tmp_path):
    import numpy as np
    from jaderaytracerendering_tpu.scene import hdr

    p = str(tmp_path / "bg.hdr")
    hdr.write_hdr(p, hdr.procedural_sky(16, 32, sun_intensity=5.0))
    out = str(tmp_path / "h.png")
    render_cli.main([
        "--cpu", "--scene", "tiny", "--hdr", p, "--width", "8", "--height", "8",
        "--spp", "1", "--max-depth", "2", "--traversal", "bvh", "--out", out,
    ])
    assert os.path.exists(out)


def test_render_cli_config_json(tmp_path):
    from jaderaytracerendering_tpu.utils.config import RenderConfig

    cfgp = str(tmp_path / "cfg.json")
    with open(cfgp, "w") as f:
        f.write(RenderConfig(width=8, height=8, spp=1, max_depth=2,
                             traversal="bvh").to_json())
    out = str(tmp_path / "c.bmp")
    render_cli.main(["--cpu", "--scene", "tiny", "--config", cfgp,
                     "--out", out])
    img = image_io.read_bmp(out)
    assert img.shape == (8, 8, 3)


def test_cli_without_gpu_needs_cpu_flag(tmp_path):
    """No silent CPU fallback: on a host without a GPU the CLIs refuse
    to run unless --cpu asks for the CPU."""
    for cli in (render_cli, preview_cli):
        with pytest.raises(SystemExit, match="--cpu"):
            cli.main(["--scene", "tiny", "--width", "8", "--height", "8",
                      "--out", str(tmp_path / "x.bmp")])
