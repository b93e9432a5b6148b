"""Reference-parity report: reproduce examples/png/main.rs exactly and
compare against a reference render when one is available.

The reference's only offline golden path is examples/png/main.rs:43-61:
ReflectionRoom.glb at 1600x1200, camera (13,30,25)->(0,13,0) fov_y 45,
render_to_host_memory (16 warm-up frames, lib.rs:1927). This script:

  1. renders that EXACT setup through the Renderer facade and writes
     docs/renders/parity_reflectionroom_1600x1200.png;
  2. prints the camera matrices next to values computed from the
     reference's own formulas (nalgebra look_at_rh + Perspective3(0.1,100)
     with proj[1][1] *= -1, camera.rs:34-66) — an independent nalgebra
     re-derivation in numpy, NOT our camera.py code path;
  3. prints aux-channel physical checks (normal unit-length, depth range,
     hit coverage, finite everywhere);
  4. with --ref <png>, computes PSNR / mean-abs-diff / per-channel stats
     against a reference render (the repo mirror ships NO ReflectionRoom
     reference render — /root/reference/docs/render.png is a Lantern
     scene whose GLB is absent — so this arm activates when one exists).

Usage:
  python examples/parity_report.py [--size WxH] [--ref path.png] [--json]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import json
import os
import sys
import time

import numpy as np

REFERENCE_GLB = "/root/reference/examples/assets/ReflectionRoom.glb"


def look_at_rh(eye, target, up):
    """nalgebra Isometry3::look_at_rh, re-derived independently
    (camera.rs:39): right-handed view with -z forward."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective3(aspect, fov_y_rad, znear, zfar):
    """nalgebra Perspective3 (camera.rs:41-46): OpenGL-style [-1,1] z."""
    f = 1.0 / np.tan(fov_y_rad / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = 2.0 * zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10((255.0 ** 2) / mse)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1600x1200",
                    help="render size (reference: 1600x1200)")
    ap.add_argument("--ref", default=None,
                    help="reference render PNG to compare against")
    ap.add_argument("--out",
                    default="docs/renders/parity_reflectionroom_1600x1200.png")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (script validation; the "
                         "artifact is rendered on the GPU)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    w, h = (int(x) for x in args.size.split("x"))

    report = {"setup": {
        "scene": REFERENCE_GLB,
        "camera": {"position": [13.0, 30.0, 25.0], "target": [0.0, 13.0, 0.0],
                   "fov_y": 45.0},
        "size": [w, h], "warmup_frames": 16,
        "reference": "examples/png/main.rs:43-61",
    }}

    # -- 2. camera-matrix parity (independent nalgebra re-derivation) --
    from sunray_tpu.camera import Camera, camera_matrices

    cam = Camera(position=(13.0, 30.0, 25.0), target=(0.0, 13.0, 0.0),
                 fov_y=45.0)
    ours = camera_matrices(cam, w, h)
    view = look_at_rh(cam.position, cam.target, (0.0, 1.0, 0.0))
    proj = perspective3(w / h, np.radians(45.0), 0.1, 100.0)
    proj[1, 1] *= -1.0                      # camera.rs:51 y-flip
    view_proj_ref = proj @ view
    vp_ours = np.asarray(ours["view_proj"], np.float64)
    dv = float(np.abs(vp_ours - view_proj_ref).max())
    report["camera_parity"] = {
        "max_abs_diff_view_proj": dv,
        "view_proj_ref_row0": [round(x, 6) for x in view_proj_ref[0]],
        "view_proj_ours_row0": [round(float(x), 6) for x in vp_ours[0]],
        "pass": bool(dv < 1e-4),
    }

    # -- 1. the exact reference render --
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.render.pipeline import render_frame_with_camera
    from sunray_tpu.render.renderer import Renderer
    from sunray_tpu.utils.png import write_png

    cfg = RenderConfig(width=w, height=h, lighting="restir")
    r = Renderer(cfg)
    r.load_gltf(REFERENCE_GLB)
    t0 = time.time()
    img = r.render_to_host_memory(cam, warmup=16)
    dt = time.time() - t0
    report["render"] = {"seconds": round(dt, 2)}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, img)
    report["render"]["path"] = args.out

    # -- 3. aux-channel physical checks --
    ldr = r.render(cam)
    import jax

    aux_state, _, aux = jax.jit(
        lambda st: render_frame_with_camera(r.scene, cfg, st, cam),
    )(r.state)
    normal = np.asarray(aux["normal"])
    depth = np.asarray(aux["depth"])
    nlen = np.linalg.norm(normal, axis=-1)
    hit = depth < 99999.0
    report["aux_checks"] = {
        "finite_ldr": bool(np.isfinite(np.asarray(ldr)).all()),
        "hit_coverage": round(float(hit.mean()), 4),
        "normal_unit_on_hits": round(
            float(np.abs(nlen[hit & (nlen > 0)] - 1.0).max()), 6
        ) if hit.any() else None,
        "depth_range_on_hits": [
            round(float(depth[hit].min()), 3),
            round(float(depth[hit].max()), 3),
        ] if hit.any() else None,
    }

    # -- 4. PSNR vs a reference render, when provided --
    if args.ref and os.path.exists(args.ref):
        from sunray_tpu.utils.png import read_png

        ref = read_png(args.ref)
        mine = np.asarray(img)[..., :3]
        if ref.shape[:2] != mine.shape[:2]:
            report["psnr_vs_reference"] = {
                "error": f"size mismatch {ref.shape} vs {mine.shape}"
            }
        else:
            ref3 = ref[..., :3]
            report["psnr_vs_reference"] = {
                "psnr_db": round(psnr(mine, ref3), 2),
                "mean_abs_diff": round(
                    float(np.abs(mine.astype(np.float64)
                                 - ref3.astype(np.float64)).mean()), 3
                ),
                "ref": args.ref,
            }
    else:
        report["psnr_vs_reference"] = {
            "status": "no reference render available — the repo mirror's "
                      "only checked-in render (docs/render.png) is a "
                      "Lantern scene whose GLB is absent; pass --ref when "
                      "one exists"
        }

    out = json.dumps(report, indent=None if args.json else 2)
    print(out)


if __name__ == "__main__":
    main()
