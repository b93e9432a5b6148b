"""Device-profile the 1080p Cornell frame on the GPU: per-kernel and
per-stage device time from one jax.profiler trace.

Usage: python examples/profile_frame.py [--small] [--frames N]
           [--out DIR] [--describe] [--kw k=v ...]
  --out       trace directory (default out/profile)
  --describe  print the trace's planes and a few device events first
  --kw        RenderConfig overrides, e.g. --kw denoise_passes=2
"""

import json
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
from sunray_tpu.utils.compile_cache import enable_compile_cache
from sunray_tpu.utils.device import device_record
from sunray_tpu.utils.profiling import (
    device_events,
    device_trace,
    hlo_stage_map,
    load_trace,
    stage_table,
    summarize_trace,
)


def parse_kw(argv):
    kw = {}
    for i, a in enumerate(argv):
        if a == "--kw" and i + 1 < len(argv):
            k, v = argv[i + 1].split("=", 1)
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    continue
            kw[k] = v
    return kw


def describe(events):
    """Print the trace's process/thread names and sample device events."""
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    threads = sorted({(e["pid"], e["args"]["name"]) for e in events
                      if e.get("ph") == "M" and e.get("name") == "thread_name"})
    print("planes:", json.dumps(procs))
    print("lines:", json.dumps([(procs.get(p, p), t) for p, t in threads]))
    for e in device_events(events)[:12]:
        print("event:", json.dumps({k: e.get(k) for k in ("name", "dur",
                                                          "args")})[:400])


def main():
    small = "--small" in sys.argv
    n = 10
    if "--frames" in sys.argv:
        n = int(sys.argv[sys.argv.index("--frames") + 1])
    out = "out/profile"
    if "--out" in sys.argv:
        out = sys.argv[sys.argv.index("--out") + 1]
    enable_compile_cache()
    w, h = (480, 270) if small else (1920, 1080)
    cfg = RenderConfig(width=w, height=h, lighting="restir",
                       **parse_kw(sys.argv))
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
    mats = camera_matrices(cam, w, h)
    state = RenderState.create(cfg)
    step = jax.jit(lambda st: render_frame(scene, cfg, st, mats),
                   donate_argnums=(0,))
    rec = device_record()
    print(f"device: {json.dumps(rec)}", flush=True)

    t0 = time.time()
    for _ in range(3):
        state, ldr, _ = step(state)
    jax.block_until_ready(ldr)
    print(f"warmup {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    with device_trace(out):
        for _ in range(n):
            state, ldr, _ = step(state)
        jax.block_until_ready(ldr)
    dt = (time.time() - t0) / n
    print(f"traced {dt * 1e3:.3f} ms/frame over {n} frames (profiler on; "
          f"finite={bool(np.isfinite(np.asarray(ldr)).all())})", flush=True)
    events = load_trace(out)
    if "--describe" in sys.argv:
        describe(events)
    rows = summarize_trace(out, top=30, steady_frac=1.0, events=events)
    total = sum(r["total_ms"] for r in rows)
    xs = device_events(events)
    span = (max(e["ts"] + e["dur"] for e in xs)
            - min(e["ts"] for e in xs)) / 1e3
    print(f"device busy {total / n:.3f} ms/frame (sum of kernel time over "
          f"{n} frames; device span {span / n:.3f} ms/frame)")
    hlo = step.lower(RenderState.create(cfg)).compile().as_text() or ""
    with open(os.path.join(out, "frame_compiled_hlo.txt"), "w") as f:
        f.write(hlo)                       # for offline kernel->stage joins
    stages = stage_table(rows, hlo_stage_map(hlo), n)
    print("stage device ms/frame:", json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))


if __name__ == "__main__":
    main()
