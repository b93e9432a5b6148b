"""A/B renders for cfg.face_forward_normals (VERDICT r4 item 9).

Views the Cornell box from OUTSIDE/behind so every pixel on the back wall
shades its BACKFACE. With the reference's unflipped normals
(closest_hit.slang:49-50) the stored normal points INTO the enclosed box,
so light-sample shadow rays offset along it start inside the lit interior
and see the ceiling light — the wall glows (the firefly-leak class in
docs/PARITY.md). With face_forward_normals=True the normal flips toward
the viewer, the shadow rays start outside, and the wall goes correctly
dark. Writes docs/renders/face_forward_{off,on}.png.

Usage: python examples/ab_face_forward.py [--size WxH] [--frames N] [--gpu]
Runs on CPU by default (small frame; deterministic); --gpu uses JAX's
default device.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--gpu" not in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np

from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.pipeline import RenderState, render_frame
from sunray_tpu.scene import cornell_box
from sunray_tpu.utils.png import write_png


def render(cfg, frames):
    scene = cornell_box()
    # Outside the box, behind the back wall, looking in (+z): the back
    # wall's backface fills the frame center.
    cam = Camera(position=(1.0, 1.0, -2.5), target=(1.0, 1.0, 0.0),
                 fov_y=50.0)
    mats = camera_matrices(cam, cfg.width, cfg.height)
    state = RenderState.create(cfg)
    step = jax.jit(lambda st: render_frame(scene, cfg, st, mats))
    ldr = None
    for _ in range(frames):
        state, ldr, _ = step(state)
    return np.asarray(ldr)


def main():
    size = "320x240"
    frames = 8
    for i, a in enumerate(sys.argv):
        if a == "--size":
            size = sys.argv[i + 1]
        if a == "--frames":
            frames = int(sys.argv[i + 1])
    w, h = (int(x) for x in size.split("x"))
    base = RenderConfig(width=w, height=h, bounces=4, virtual_bounces=3,
                        ris_candidates=8, di_spatial_samples=3,
                        gi_spatial_samples=2, denoise_passes=2,
                        lighting="restir")
    out = os.path.join(os.path.dirname(__file__), "..", "docs", "renders")
    stats = {}
    for tag, ff in (("off", False), ("on", True)):
        img = render(base.replace(face_forward_normals=ff), frames)
        path = os.path.join(out, f"face_forward_{tag}.png")
        write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        stats[tag] = float(img.mean())
        print(f"face_forward={ff}: mean LDR {img.mean():.4f} -> {path}")
    print(f"leak ratio off/on: {stats['off'] / max(stats['on'], 1e-9):.2f}x")


if __name__ == "__main__":
    main()
