"""Print the frame's analytic HBM-traffic floor (utils/roofline.py) and,
unless --static, join it with a live measured frame time on the GPU.

Usage: python examples/roofline.py [--small] [--static] [--measured MS]
       [--device-kind KIND]   (default: JAX's device_kind of device 0)
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import json
import sys
import time

from sunray_tpu.config import RenderConfig
from sunray_tpu.utils.roofline import roofline_report


def main():
    small = "--small" in sys.argv
    w, h = (480, 270) if small else (1920, 1080)
    cfg = RenderConfig(width=w, height=h, lighting="restir")

    measured = None
    rounds = (2, 2)
    if "--measured" in sys.argv:
        measured = float(sys.argv[sys.argv.index("--measured") + 1])
    elif "--static" not in sys.argv:
        import jax

        from sunray_tpu.camera import Camera, camera_matrices
        from sunray_tpu.render.pipeline import RenderState, render_frame
        from sunray_tpu.scene import cornell_box

        scene = cornell_box()
        cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                     fov_y=45.0)
        mats = camera_matrices(cam, w, h)
        state = RenderState.create(cfg)
        step = jax.jit(lambda st: render_frame(scene, cfg, st, mats),
                       donate_argnums=(0,))
        aux = None
        for _ in range(5):
            state, ldr, aux = step(state)
        jax.block_until_ready(ldr)
        n = 15
        t0 = time.time()
        for _ in range(n):
            state, ldr, aux = step(state)
        jax.block_until_ready(ldr)
        measured = (time.time() - t0) / n * 1e3
        rounds = (int(aux["ris_rounds"]), int(aux["final_rounds"]))

    if "--device-kind" in sys.argv:
        kind = sys.argv[sys.argv.index("--device-kind") + 1]
    else:
        import jax

        kind = jax.devices()[0].device_kind
    rep = roofline_report(cfg, kind, measured_ms=measured,
                          ris_rounds=rounds[0], final_rounds=rounds[1])
    for s in rep["stages"]:
        print(f"{s['stage']:12s} {s['mbytes']:8.1f} MB  "
              f"floor {s['floor_ms']:6.2f} ms  {s['note']}")
    print(json.dumps({k: v for k, v in rep.items() if k != "stages"}))


if __name__ == "__main__":
    main()
