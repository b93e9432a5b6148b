"""Compile the 1080p ReSTIR frame and report the HBM breakdown.

Prints XLA's memory_analysis totals, then the largest live buffers from the
compiled module's buffer-assignment dump (no frame execution — compile
only, so it runs even for configs that would OOM at run time).

Usage: python examples/mem_audit.py [--small]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass


import argparse
import re

import jax

from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.pipeline import RenderState, render_frame
from sunray_tpu.scene import cornell_box


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    w, h = (480, 270) if args.small else (1920, 1080)
    cfg = RenderConfig(width=w, height=h, lighting="restir")
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
    mats = camera_matrices(cam, w, h)
    state = RenderState.create(cfg)

    lowered = jax.jit(
        lambda st: render_frame(scene, cfg, st, mats), donate_argnums=(0,)
    ).lower(state)
    compiled = lowered.compile()
    mem = compiled.memory_analysis()
    if mem is not None:
        for k in ("temp_size_in_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "alias_size_in_bytes",
                  "generated_code_size_in_bytes"):
            v = getattr(mem, k, None)
            if v is not None:
                print(f"{k:32s} {v / 2**20:10.1f} MB")

    txt = compiled.as_text() or ""
    # Buffer-assignment style dumps aren't in as_text; instead pull the
    # largest fusion outputs by shape from the HLO as a rough census.
    sizes = {}
    for m in re.finditer(r"(f32|s32|u32|pred|bf16)\[([0-9,]*)\]", txt):
        dt, dims = m.groups()
        if not dims:
            continue
        n = 1
        for d in dims.split(","):
            n *= int(d)
        bytes_ = n * (1 if dt == "pred" else 2 if dt == "bf16" else 4)
        key = f"{dt}[{dims}]"
        cnt, tot = sizes.get(key, (0, 0))
        sizes[key] = (cnt + 1, tot + bytes_)
    top = sorted(sizes.items(), key=lambda kv: -kv[1][1])[:25]
    print("\nlargest shapes by total HLO occurrence (count x one-buffer MB):")
    for k, (cnt, tot) in top:
        one = tot / cnt / 2**20
        print(f"  {k:42s} x{cnt:4d}  {one:8.1f} MB each {tot/2**30:7.2f} GB total")


if __name__ == "__main__":
    main()
