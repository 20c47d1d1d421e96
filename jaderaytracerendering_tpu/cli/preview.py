"""Progressive preview CLI — the PathTrace.cpp interactive app equivalent.

Runs a progressive accumulation loop (one spp batch per frame, blended
into the film like the reference's lastFrame mix, fshader_preview.fsh:402)
and accepts the reference's keyboard commands, line-buffered:

    up/down/left/right (or u/j/k/l)  orbit camera      (20 deg steps)
    w/s/a/d                          move look-center  (0.4 steps)
    h/n                              dolly in/out
    c                                save current frame to BMP
    r <spp>                          offline render at spp -> BMP
    f                                dump render_args.txt and quit
    q                                quit

Any camera command resets the accumulation (frameCounter=0 semantics,
PathTrace.cpp:743-800). ``--frames N`` runs N headless frames and exits
(for scripted use and tests).
"""

from __future__ import annotations

import argparse
import sys
import time

from . import common

ROTATE_DELTA = 20.0  # deg per keypress (PathTrace.cpp:730 at 1s)
MOVE_DELTA = 0.4


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="jade-preview")
    common.add_common_args(ap)
    ap.add_argument("--frames", type=int, default=0,
                    help="headless: render N progressive frames then exit")
    ap.add_argument("--out", default="RenderResult.bmp")
    ap.add_argument("--save-every", type=int, default=0,
                    help="write a preview frame every N frames")
    ap.add_argument("--bands", type=int, default=1,
                    help="progressive pixel bands: each displayed frame "
                         "samples one of B bands (B must divide the "
                         "pixel count; 1 = every pixel every frame)")
    args = ap.parse_args(argv)
    common.select_backend(args)

    import jax.numpy as jnp
    import numpy as np

    from ..core.camera import OrbitCamera
    from ..core.film import Film
    from ..integrator import render as R
    from ..models import demo as demo_mod
    from ..post import image_io, tonemap
    from ..scene import serialization
    from ..scene.scene import assemble, SceneObject
    from ..utils.logging import stage

    objects, env, cam = common.load_scene(args)
    if not isinstance(cam, OrbitCamera):
        stage("note: serialized camera loaded; orbit controls start from default")
        cam = OrbitCamera()
    cfg = common.config_from_args(args)
    # preview frames use the cheap 2-bounce no-NEE integrator
    # (fshader_preview.fsh:332-375); 'r' offline renders use the full one
    cfg = cfg.replace(integrator="preview")
    if args.spp is None:
        cfg = cfg.replace(spp=1, spp_batch=1)
    if args.rays_per_launch is None:
        # the 2-bounce no-NEE preview compiles far smaller than the full
        # integrator, so a frame takes bigger launches
        cfg = cfg.replace(rays_per_launch=1 << 18)
    if args.bands > 1:
        if (cfg.width * cfg.height) % args.bands:
            raise SystemExit(f"--bands {args.bands} must divide the "
                             f"{cfg.width}x{cfg.height} pixel count")
        cfg = cfg.replace(preview_bands=args.bands)
    sd = assemble(objects, env, leaf_size=cfg.bvh_leaf_size, xp=jnp)
    stage(f"scene: {sd.n_triangles} tris, {sd.n_nodes} nodes, {sd.n_emit} lights")

    film = Film.create(cfg.height, cfg.width)
    frame = 0
    bframe = 0  # band rotation counter; resets with the film
    t_last = time.perf_counter()

    def save(path, the_film, tmap):
        rad = np.asarray(the_film.mean())[::-1]
        image_io.save(path, np.asarray(tonemap.finalize(rad, np, tmap)))
        stage(f"wrote {path}")

    pending = None  # previous frame's device-side u8 display image

    def step():
        nonlocal film, frame, bframe, t_last, pending
        film, disp = R.render_film_preview(
            sd, cam, cfg.replace(spp=cfg.spp_batch), film=film,
            display=True, frame_idx=bframe)
        bframe += 1
        # pipelined display (the GL loop's implicit double buffering,
        # PathTrace.cpp:1180-1187): the dispatch above is async, so
        # transferring the PREVIOUS frame's u8 image overlaps this
        # frame's compute; each printed FPS interval holds one whole
        # displayed frame.
        np.asarray(pending if pending is not None else disp)
        pending = disp
        frame += 1
        now = time.perf_counter()
        # the reference's per-frame FPS line (PathTrace.cpp:677-680)
        print(f"FPS : {1.0 / max(now - t_last, 1e-9):.2f}    "
              f"Iter time: {frame}", flush=True)
        t_last = now

    if args.frames > 0:
        for _ in range(args.frames):
            step()
            if args.save_every and frame % args.save_every == 0:
                save(args.out, film, cfg.tonemap)
        save(args.out, film, cfg.tonemap)
        return

    stage("interactive preview: commands = arrows(u/j/k/l) wasd h n c r f q")
    # raw-tty mode: single keypresses at frame rate — the reference's
    # GLFW key_status polling with held-key orbiting
    # (PathTrace.cpp:729-851). Holding a key autorepeats at terminal
    # rate, so orbit/move steps stream in per frame exactly like the
    # reference's move_camera(delta_time) loop. Piped stdin (tests,
    # scripting) keeps the line-buffered protocol.
    tty_fd = None
    saved_termios = None
    if sys.stdin.isatty():
        try:
            import termios
            import tty as tty_mod

            tty_fd = sys.stdin.fileno()
            saved_termios = termios.tcgetattr(tty_fd)
            tty_mod.setcbreak(tty_fd)
        except Exception:
            tty_fd = saved_termios = None
    is_tty = tty_fd is not None
    try:
        while True:
            step()
            if is_tty:
                key = _read_tty_command()
                if key is None:
                    continue
                tok = [key]
            else:
                tok = _read_line_command()
                if tok is None:
                    continue
            cmd = tok[0].lower()
            moved = True
            if cmd in ("q", "esc"):
                break
            elif cmd in ("up", "u"):
                cam.orbit(d_up=ROTATE_DELTA)
            elif cmd in ("down", "j"):
                cam.orbit(d_up=-ROTATE_DELTA)
            elif cmd in ("left", "k"):
                cam.orbit(d_rotate=ROTATE_DELTA)
            elif cmd in ("right", "l"):
                cam.orbit(d_rotate=-ROTATE_DELTA)
            elif cmd == "w":
                cam.move_center(dy=MOVE_DELTA)
            elif cmd == "s":
                cam.move_center(dy=-MOVE_DELTA)
            elif cmd == "a":
                cam.move_center(dx=-MOVE_DELTA)
            elif cmd == "d":
                cam.move_center(dx=MOVE_DELTA)
            elif cmd == "h":
                cam.dolly(-MOVE_DELTA)
            elif cmd == "n":
                cam.dolly(MOVE_DELTA)
            elif cmd == "c":
                save(args.out, film, cfg.tonemap)
                moved = False
            elif cmd == "r":
                spp = int(tok[1]) if len(tok) > 1 else 64
                stage(f"offline render at {spp}spp...")
                # the preview's big launches are for the 2-bounce
                # integrator only; the full integrator must stay at the
                # 16k lane cap (larger graphs crash the remote compiler)
                off = R.render_film(
                    sd, cam, cfg.replace(
                        spp=spp, max_depth=16, integrator="full",
                        rays_per_launch=min(cfg.rays_per_launch, 1 << 14),
                    )
                )
                save(args.out, off, cfg.tonemap)
                moved = False
            elif cmd == "f":
                spec = serialization.SceneSpec(
                    eye=cam.eye, camera_rotate=cam.camera_rotate,
                    objects=demo_mod.to_spec(
                        demo_mod.DemoScene(objects=objects, env_map=env,
                                           camera=cam)
                    ).objects,
                )
                serialization.write_render_args("render_args.txt", spec)
                stage("Saving Cuda Render Args")  # PathTrace.cpp:840
                break
            else:
                stage(f"unknown command {cmd!r}")
                moved = False
            if moved:
                film = film.reset()  # frameCounter = 0
                bframe = 0  # restart the band rotation with the film
                pending = None  # don't display a pre-move frame
    finally:
        if saved_termios is not None:
            import termios

            termios.tcsetattr(tty_fd, termios.TCSADRAIN, saved_termios)


def _read_tty_command():
    """One cbreak keypress -> command token (arrow escape sequences map
    to the orbit keys); None when no input is pending."""
    import os
    import select
    import sys

    if not select.select([sys.stdin], [], [], 0)[0]:
        return None
    ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
    if ch == "\x1b":  # arrow keys: ESC [ A/B/C/D
        seq = ""
        for _ in range(2):
            if select.select([sys.stdin], [], [], 0.01)[0]:
                seq += os.read(sys.stdin.fileno(), 1).decode(
                    errors="ignore")
        return {"[A": "up", "[B": "down", "[D": "left",
                "[C": "right"}.get(seq, "esc")
    return ch.lower() if ch.strip() else None


def _read_line_command():
    import select
    import sys

    if not select.select([sys.stdin], [], [], 0)[0]:
        return None
    line = sys.stdin.readline()
    if not line:
        return None
    tok = line.strip().split()
    return tok if tok else None


if __name__ == "__main__":
    main()
