"""A/B frame-time check for the history-gather mode: banded windowed
gathers vs the gather-free shift-select neighborhood (ops/banded.py).

Same-process, same-backend comparison on JAX's default device. Static
camera: the shift mode must be pixel-identical to plain
gathers, so max|diff| vs the banded run reflects only the banded halo
rejection (also zero for a static camera).
"""

import os
import sys
import time

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import jax
import numpy as np

from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.pipeline import RenderState, render_frame
from sunray_tpu.scene import cornell_box


def run(cfg, scene, mats, n_warm=5, n_bench=15):
    state = RenderState.create(cfg)
    step = jax.jit(lambda st: render_frame(scene, cfg, st, mats),
                   donate_argnums=(0,))
    t0 = time.time()
    for _ in range(n_warm):
        state, ldr, aux = step(state)
    jax.block_until_ready(ldr)
    warm = time.time() - t0
    t0 = time.time()
    for _ in range(n_bench):
        state, ldr, aux = step(state)
    jax.block_until_ready(ldr)
    dt = (time.time() - t0) / n_bench
    return dt, warm, np.asarray(ldr)


def main():
    small = "--small" in sys.argv
    w, h = (480, 270) if small else (1920, 1080)
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                 fov_y=45.0)
    mats = camera_matrices(cam, w, h)
    combos = [
        ("banded", dict(history_gather_mode="banded")),
        # shift includes global-motion compensation (one dynamic roll by
        # the mean reprojection offset); "banded flat" is left out.
        ("shift r=1 g", dict(history_gather_mode="shift",
                             history_shift_radius=1)),
        ("shift r=1", dict(history_gather_mode="shift",
                           history_shift_radius=1,
                           history_shift_global=False)),
    ]
    ref = None
    for name, kw in combos:
        cfg = RenderConfig(width=w, height=h, lighting="restir", **kw)
        dt, warm, img = run(cfg, scene, mats)
        finite = np.isfinite(img).all()
        d = 0.0 if ref is None else float(np.abs(img - ref).max())
        if ref is None:
            ref = img
        print(f"{name:12s} {dt * 1e3:8.1f} ms/frame  warm {warm:5.1f} s  "
              f"finite={finite}  max|diff|={d:.3e}", flush=True)


if __name__ == "__main__":
    main()
