"""Multi-host smoke: two REAL processes over jax.distributed.

The reference is single-GPU (SURVEY §2.3); this build's multi-host story
is init_distributed() + make_multihost_mesh() + the unchanged sharded
render entry points. This test launches two OS processes that form a
jax.distributed cluster on the CPU backend (4 virtual devices each),
build the (tile=4, spp=2) multi-host mesh — the 'spp' axis spanning the
two processes, as it spans hosts — render one batch of the tiny demo
scene, and check the gathered film against a single-process render of
the same mesh shape bit-exactly.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())  # repo root (the test sets cwd)
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]

from jaderaytracerendering_tpu.parallel import sharding as sh

fresh = sh.init_distributed(coordinator_address=f"localhost:{port}",
                            num_processes=2, process_id=pid)
assert fresh, "runtime was already initialized in a fresh process?"
assert jax.process_count() == 2
assert len(jax.devices()) == 8, len(jax.devices())

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.utils.config import RenderConfig

ds = demo.jade_scene(n_buddha_tris=200, env_shape=(16, 32))
sd = assemble(ds.objects, ds.env_map, xp=jnp)
cfg = RenderConfig(width=8, height=8, spp=2, spp_batch=1, max_depth=2,
                   traversal="clusters")

mesh = sh.make_multihost_mesh(spp_per_slice=1)
assert mesh.shape == {"tile": 4, "spp": 2}, mesh.shape
# the 'spp' axis must span the two processes (the DCN axis)
spp_procs = {d.process_index for d in mesh.devices[0, :]}
assert spp_procs == {0, 1}, spp_procs
tile_procs = {d.process_index for d in mesh.devices[:, 0]}
assert len(tile_procs) == 1, tile_procs

sd_g = sh.scene_to_global(mesh, sd)
eye = sh.host_local_to_global(mesh, P(), np.asarray(ds.camera.eye,
                                                    np.float32))
rot = sh.host_local_to_global(mesh, P(),
                              np.asarray(ds.camera.camera_rotate,
                                         np.float32))
pixel_ids = sh.host_local_to_global(
    mesh, P("tile"), np.arange(cfg.width * cfg.height, dtype=np.uint32))

out = sh.render_batch_sharded(sd_g, eye, rot, pixel_ids, 0, cfg, 1, mesh)
# all-gather the tile shards so every process can report the full film
full = sh.gather_film(out, mesh)
print("RESULT" + json.dumps({
    "pid": pid,
    "sum": float(np.asarray(full.addressable_shards[0].data).sum()),
    "film": np.asarray(full.addressable_shards[0].data).reshape(-1)
            .tolist()[:48],
}))
"""


@pytest.mark.slow
def test_two_process_multislice_render(tmp_path):
    # find a free port for the coordinator
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__))))
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                d = json.loads(line[len("RESULT"):])
                results[d["pid"]] = d
    assert set(results) == {0, 1}
    # both processes must observe the identical gathered film
    np.testing.assert_array_equal(results[0]["film"], results[1]["film"])
    assert np.isfinite(results[0]["sum"]) and results[0]["sum"] > 0

    # single-process reference: same mesh SHAPE on 8 local devices
    ref = _single_process_reference()
    np.testing.assert_allclose(
        np.asarray(results[0]["film"], np.float32), ref, rtol=0, atol=0)


def _single_process_reference():
    code = r"""
import json
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jaderaytracerendering_tpu.parallel import sharding as sh
from jaderaytracerendering_tpu.models import demo
from jaderaytracerendering_tpu.scene.scene import assemble
from jaderaytracerendering_tpu.utils.config import RenderConfig

ds = demo.jade_scene(n_buddha_tris=200, env_shape=(16, 32))
sd = assemble(ds.objects, ds.env_map, xp=jnp)
cfg = RenderConfig(width=8, height=8, spp=2, spp_batch=1, max_depth=2,
                   traversal="clusters")
mesh = sh.make_mesh((4, 2))
pixel_ids = jnp.arange(cfg.width * cfg.height, dtype=jnp.uint32)
out = sh.render_batch_sharded(
    sd, jnp.asarray(ds.camera.eye, jnp.float32),
    jnp.asarray(ds.camera.camera_rotate, jnp.float32), pixel_ids, 0,
    cfg, 1, mesh)
print("RESULT" + json.dumps(
    np.asarray(out).reshape(-1).tolist()[:48]))
"""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=420, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT"):
            return np.asarray(json.loads(line[len("RESULT"):]), np.float32)
    raise AssertionError("no RESULT line")
