"""Interactive-loop example — the examples/window analog.

Renders an orbiting camera over the Cornell box at interactive cadence,
prints an FPS counter (window/main.rs:185-193), composites a stats overlay
onto each frame (the egui-overlay analog), and runs the scripted runtime
instance test: a duplicate mesh instance spawns at frame 24 and despawns at
frame 48 (window/main.rs:222-234 does this at frames 120/240). Frames are
written as a PNG sequence (the swapchain-present analog for a headless
accelerator).

Usage: python examples/orbit.py [--frames 72] [--size 320x240] [--out out/orbit]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass


import argparse
import json
import os
import time
from collections import deque

import numpy as np

from sunray_tpu.camera import Camera
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.renderer import Renderer
from sunray_tpu.render.overlay import stats_overlay  # noqa: F401
from sunray_tpu.render.overlay2d import hud_overlay_np
from sunray_tpu.scene import cornell_box
from sunray_tpu.scene.manager import SceneManager
from sunray_tpu.scene.types import translate
from sunray_tpu.utils.png import write_png


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--out", default="out/orbit")
    ap.add_argument("--no-save", action="store_true",
                    help="skip PNG writes (pure render+overlay loop — the "
                         "honest interactive frame-time measurement; PNG "
                         "encode is host-side and not part of the frame)")
    ap.add_argument("--save-every", type=int, default=1,
                    help="write every Nth frame (keeps the PNG-encode "
                         "host cost out of most frames while still "
                         "producing artifact images)")
    ap.add_argument("--inflight", type=int, default=2,
                    help="frames-in-flight depth: dispatch N frames ahead "
                         "of the blocking present readback (the Vulkan "
                         "frames-in-flight analog, lib.rs MAX_FRAMES_IN_"
                         "FLIGHT; render() is async so this overlaps the "
                         "device frame + readback of frame k with the "
                         "dispatch of k+1..k+N). 0 = fully serial.")
    ap.add_argument("--present", choices=("u8", "f32"), default="u8",
                    help="present-readback format: u8 quantizes on-device "
                         "(swapchain-format analog; 4x less readback "
                         "transfer) and converts back to float on the "
                         "host for the HUD; f32 reads the raw LDR")
    ap.add_argument("--present-workers", type=int, default=1,
                    help=">1 presents frames from a thread pool so the "
                         "blocking device->host readbacks OVERLAP (each "
                         "is a blocking round trip; with one thread they "
                         "serialize even with frames in flight). Steady "
                         "stats are then computed from per-frame "
                         "completion timestamps.")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scene", default="cornell",
                    help="'cornell' (exterior orbit, the round-3 "
                         "artifact) or a .glb/.gltf path — the camera "
                         "then orbits INSIDE the room (the reference's "
                         "window example flies GLB rooms,"
                         " examples/window/main.rs), exercising the "
                         "texture atlas, alpha and SceneManager paths "
                         "in the live loop")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    w, h = (int(x) for x in args.size.split("x"))

    cfg = RenderConfig(width=w, height=h, lighting="restir")
    if args.scene == "cornell":
        scene = cornell_box()
        orbit_center = np.asarray([1.0, 1.0, 1.0])
        orbit_radius, eye_h, fov = 2.6, 1.3, 50.0
    else:
        from sunray_tpu.scene.gltf import load_gltf

        scene = load_gltf(args.scene)
        # Room bounds from concrete host arrays (no eager device ops —
        # each would be a launch and a host sync).
        pos = np.asarray(scene.positions)
        tv = np.asarray(scene.tri_vidx)
        ti = np.asarray(scene.tri_inst)
        xf = np.asarray(scene.inst_transform)
        corners = pos[tv.reshape(-1)]
        xfc = xf[np.repeat(ti, 3)]
        world = np.einsum("nij,nj->ni", xfc[:, :, :3], corners) + xfc[:, :, 3]
        lo, hi = world.min(0), world.max(0)
        orbit_center = (lo + hi) / 2.0
        ext = hi - lo
        # Interior orbit: eye circles INSIDE the room at a third of the
        # half-extent, looking across it.
        orbit_radius = 0.32 * float(min(ext[0], ext[2]))
        eye_h = float(lo[1] + 0.45 * ext[1])
        # Look across and slightly down into the furnished part of the
        # room rather than at the volumetric center of a tall space.
        orbit_center = np.asarray(
            [orbit_center[0], lo[1] + 0.30 * ext[1], orbit_center[2]]
        )
        fov = 60.0
        print(f"scene {args.scene}: bounds {np.round(lo,2)}..{np.round(hi,2)}"
              f" interior orbit r={orbit_radius:.2f} eye_h={eye_h:.2f}",
              flush=True)
    r = Renderer(cfg)
    r._manager = SceneManager.from_scene_buffers(scene)
    base_instances = r._manager.default_instances(scene)
    r.scene = r._manager.build(base_instances)
    r._sync_scene_flags()

    os.makedirs(args.out, exist_ok=True)

    # Pre-warm: run the spawn-frame instance list ONCE before the timed
    # loop. The SceneManager capacity ratchet then pads the base list to
    # the same capacity, so the whole loop (including spawn@24/despawn@48)
    # runs ONE compiled program — the window app's shaders are likewise
    # compiled before its loop (examples/window/main.rs).
    smallest_key = min(
        base_instances,
        key=lambda kt: r._manager._meshes[kt[0]].tri_vidx.shape[0],
    )[0]
    if args.scene == "cornell":
        warm_cam = Camera(position=(1.0, 1.3, 3.6), target=(1.0, 1.0, 1.0),
                          fov_y=50.0)
    else:
        warm_cam = Camera(
            position=(float(orbit_center[0]), eye_h,
                      float(orbit_center[2]) + orbit_radius),
            target=tuple(float(c) for c in orbit_center), fov_y=fov,
        )
    t0 = time.time()
    np.asarray(r.render(warm_cam, instances=list(base_instances)
               + [(smallest_key, translate(0.0, -0.8, 0.0))]))
    warm_ldr = r.render(warm_cam, instances=list(base_instances))
    compile_s = time.time() - t0
    print(f"prewarm (both capacity programs): {compile_s:.1f} s",
          flush=True)

    fps = 0.0
    frame_ms = []          # per-presented-frame walltime (FIFO order)
    churn_frames = []      # frames where the instance list changed
    pending = deque()      # in-flight (frame index, device ldr) FIFO
    t_prev = time.time()

    if args.present == "u8":
        import jax
        import jax.numpy as jnp

        # Device-side swapchain-format quantization: presenting uint8
        # moves 4x fewer bytes device->host than the raw float32 LDR.
        to_present = jax.jit(
            lambda x: (jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
        )
    else:
        to_present = lambda x: x  # noqa: E731
    np.asarray(to_present(warm_ldr))  # warm the present-format program too
    r.reset_history()
    t_prev = time.time()

    def present(entry):
        """Blocking present: device->host readback + HUD + PNG write.

        With --inflight N the readback of frame k overlaps the already-
        dispatched device work of frames k+1..k+N (JAX async dispatch),
        so the present interval measures pipeline THROUGHPUT — the same
        quantity the reference's window FPS title shows
        (examples/window/main.rs:185-193)."""
        nonlocal fps, t_prev
        frame, ldr = entry
        host = np.asarray(ldr).copy()
        if host.dtype == np.uint8:
            host = host.astype(np.float32) / 255.0
        hist = frame_ms[-60:] if len(frame_ms) >= 2 else None
        hud_overlay_np(
            host, [f"FPS {fps:6.2f}", f"FRAME {frame:04d}"], frame_ms=hist,
        )
        t_now = time.time()
        dt = t_now - t_prev
        inst_fps = 1.0 / max(dt, 1e-6)
        fps = inst_fps if fps == 0 else 0.9 * fps + 0.1 * inst_fps
        t_prev = t_now
        frame_ms.append(dt * 1e3)
        if not args.no_save and frame % max(args.save_every, 1) == 0:
            write_png(os.path.join(args.out, f"frame_{frame:04d}.png"), host)
            t_prev = time.time()  # PNG encode is host-side, not frame cost
        if frame % 12 == 0:
            print(f"frame {frame:4d}  fps {fps:6.2f}", flush=True)

    pool = None
    if args.present_workers > 1:
        # Parallel presents: each readback is a blocking round trip; a single present thread serializes them even with frames
        # in flight. A small pool overlaps the transfers (the multi-
        # queue present analog). Steady stats come from per-frame
        # completion timestamps instead of present-call intervals.
        import threading
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=args.present_workers)
        lock = threading.Lock()
        done_ts = {}
        last_done = [t_prev]
        futures = deque()

        def present_mt(entry):
            nonlocal fps
            frame, ldr = entry
            host = np.asarray(ldr).copy()
            if host.dtype == np.uint8:
                host = host.astype(np.float32) / 255.0
            with lock:
                cur = fps
            hud_overlay_np(host, [f"FPS {cur:6.2f}", f"FRAME {frame:04d}"])
            t_now = time.time()
            with lock:
                done_ts[frame] = t_now
                dt = max(t_now - last_done[0], 1e-6)
                last_done[0] = t_now
                inst = 1.0 / dt
                fps = inst if fps == 0 else 0.9 * fps + 0.1 * inst
            if not args.no_save and frame % max(args.save_every, 1) == 0:
                write_png(
                    os.path.join(args.out, f"frame_{frame:04d}.png"), host
                )
            if frame % 12 == 0:
                print(f"frame {frame:4d}  fps {fps:6.2f}", flush=True)

    loop_t0 = time.time()
    for frame in range(args.frames):
        angle = 2.0 * np.pi * frame / args.frames
        eye = (
            float(orbit_center[0]) + orbit_radius * np.sin(angle),
            eye_h,
            float(orbit_center[2]) + orbit_radius * np.cos(angle),
        )
        cam = Camera(position=eye,
                     target=tuple(float(c) for c in orbit_center),
                     fov_y=fov)

        instances = list(base_instances)
        # Scripted runtime churn (window example analog).
        if 24 <= frame < 48:
            smallest = min(
                base_instances,
                key=lambda kt: r._manager._meshes[kt[0]].tri_vidx.shape[0],
            )[0]
            instances.append((smallest, translate(0.0, -0.8, 0.0)))
        if frame in (24, 48):
            churn_frames.append(frame)

        ldr = to_present(r.render(cam, instances=instances))
        try:
            ldr.copy_to_host_async()  # start the D2H transfer early so it
            # overlaps later dispatches, not just the present that reads it
        except (AttributeError, NotImplementedError):
            pass
        pending.append((frame, ldr))
        if len(pending) > max(args.inflight, 0):
            entry = pending.popleft()
            if pool is not None:
                futures.append(pool.submit(present_mt, entry))
                # Bound the device arrays held by unfinished presents.
                while len(futures) > 2 * args.present_workers:
                    futures.popleft().result()
            else:
                present(entry)
    while pending:
        entry = pending.popleft()
        if pool is not None:
            futures.append(pool.submit(present_mt, entry))
        else:
            present(entry)
    if pool is not None:
        for f in futures:
            f.result()
        pool.shutdown(wait=True)
        # Completion times -> per-frame intervals (monotonicized: pool
        # completions can land microscopically out of frame order).
        ts = np.maximum.accumulate(
            np.asarray([done_ts[f] for f in range(args.frames)])
        )
        frame_ms = list(
            np.diff(np.concatenate([[loop_t0], ts])) * 1e3
        )

    steady = frame_ms[1:]
    churn_ms = [frame_ms[f] for f in churn_frames]
    stats = {
        "scene": args.scene,
        "resolution": args.size,
        "frames": args.frames,
        "inflight": args.inflight,
        "present": args.present,
        "present_workers": args.present_workers,
        "device": None,
        "prewarm_s": round(compile_s, 1),
        # Loop-start -> first present. With --inflight N this spans N+1
        # dispatches (prewarm already compiled both programs, so this is
        # NOT a compile cost); renamed from compile_frame_ms (ADVICE r3).
        "first_present_ms": round(frame_ms[0], 1),
        "steady_mean_ms": round(float(np.mean(steady)), 1),
        "steady_p50_ms": round(float(np.median(steady)), 1),
        "steady_max_ms": round(float(np.max(steady)), 1),
        "steady_fps": round(1e3 / float(np.mean(steady)), 2),
        "churn_frames": churn_frames,
        "churn_frame_ms": [round(m, 1) for m in churn_ms],
        # No recompile on churn: a recompile costs SECONDS; with the capacity ratchet +
        # prewarm the spawn/despawn frames must stay within 3x the steady
        # median (scene/manager.py) — floored at 1 s so the check stays a
        # recompile detector when fast present pipelines push the median
        # below the churn frames' genuine extra work (host re-pack).
        "no_recompile_on_churn": bool(
            all(m < max(3 * float(np.median(steady)), 1000.0)
                for m in churn_ms)
        ),
    }
    try:
        import jax

        stats["device"] = str(jax.devices()[0])
    except Exception:
        pass
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats))
    print(f"wrote frames + stats.json to {args.out}/")


if __name__ == "__main__":
    main()
