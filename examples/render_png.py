"""Offline render example — the examples/png analog (examples/png/main.rs).

Renders the Cornell box (or the reflection room with --scene room) through
the full pipeline with 16 warm-up frames and writes a PNG.

Usage: python examples/render_png.py [--scene cornell|room] [--size WxH]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass


import argparse
import sys
import time

import numpy as np

from sunray_tpu.camera import Camera
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.renderer import Renderer
from sunray_tpu.scene import cornell_box, reflection_room
from sunray_tpu.utils.png import write_png


REFERENCE_GLB = "/root/reference/examples/assets/ReflectionRoom.glb"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "room", "glb"])
    ap.add_argument(
        "--gltf", default=REFERENCE_GLB,
        help="GLB/glTF path for --scene glb (default: the reference's "
             "ReflectionRoom.glb, rendered with the exact camera of "
             "examples/png/main.rs:45-57)",
    )
    ap.add_argument("--size", default="800x600")
    ap.add_argument("--out", default="out/render.png")
    ap.add_argument("--lighting", default="restir", choices=["restir", "nee", "brdf"])
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: JAX's default "
                         "device, the GPU where there is one)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.scene == "glb" and "--size" not in sys.argv[1:] \
            and not any(a.startswith("--size=") for a in sys.argv[1:]):
        args.size = "1600x1200"       # examples/png/main.rs:45 image_extent

    w, h = (int(x) for x in args.size.split("x"))
    cfg = RenderConfig(width=w, height=h, lighting=args.lighting)

    if args.scene == "cornell":
        scene = cornell_box()
        camera = Camera(position=(1.0, 1.0, 4.4), target=(1.0, 1.0, 0.0), fov_y=50.0)
    elif args.scene == "room":
        scene = reflection_room()
        camera = Camera(position=(2.0, 2.2, 9.0), target=(2.0, 1.6, 0.0), fov_y=50.0)
    else:
        # The reference's offline golden setup (examples/png/main.rs:45-57):
        # ReflectionRoom.glb, camera (13, 30, 25) -> (0, 13, 0), fov_y 45.
        scene = None
        camera = Camera(position=(13.0, 30.0, 25.0), target=(0.0, 13.0, 0.0),
                        fov_y=45.0)

    r = Renderer(cfg, scene)
    if args.scene == "glb":
        r.load_gltf(args.gltf)
    t0 = time.time()
    img = r.render_to_host_memory(camera, warmup=args.warmup)
    dt = time.time() - t0
    print(f"rendered {w}x{h} ({args.warmup}+1 frames) in {dt:.2f}s", file=sys.stderr)

    import os
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, img)
    print(f"You can find your render here: {args.out}")


if __name__ == "__main__":
    main()
