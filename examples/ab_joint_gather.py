"""A/B: cfg.history_joint_gather on the full 1080p frame, bench-style
(direct donated render_frame jit, bench camera, one process). The knob
is default-off (docs/PARITY.md); not measured on the H100."""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import time
import numpy as np, jax
from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.pipeline import render_frame, RenderState
from sunray_tpu.scene import cornell_box

w, h = 1920, 1080
scene = cornell_box()
cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
mats = camera_matrices(cam, w, h)
for joint in (False, True):
    cfg = RenderConfig(width=w, height=h, lighting="restir",
                       history_joint_gather=joint)
    state = RenderState.create(cfg)
    step = jax.jit(lambda st: render_frame(scene, cfg, st, mats),
                   donate_argnums=(0,))
    t0 = time.time()
    ldr = None
    for _ in range(5):
        state, ldr, aux = step(state)
    jax.block_until_ready(ldr)
    print(f"joint={joint} warm {time.time()-t0:.1f}s", flush=True)
    n = 20
    t0 = time.time()
    for _ in range(n):
        state, ldr, aux = step(state)
    jax.block_until_ready(ldr)
    print(f"joint={joint}: {(time.time()-t0)/n*1e3:.2f} ms/frame", flush=True)
