"""Image-quality A/B: spatial_taps "shared" vs "perpixel" (VERDICT #6).

The default spatial-reuse mode draws ONE disc offset per reuse iteration
shared by all pixels (taps become whole-image shifts instead of
per-pixel gathers), while the reference draws per-pixel random
offsets (ray_gen_final.slang:164-167, the "perpixel" mode). This script
quantifies what the shared-taps approximation costs, on the raw HDR
estimator output (aux["raw"], pre-TAA/denoise) so post-filters can't mask
estimator differences:

  1. converged ground truth = mean raw over --gt-frames frames of the
     reference-exact "perpixel" mode (fresh temporal run, post-warmup);
  2. per mode (independent temporal runs, identical frame/seed sequence):
       - noise:   mean per-pixel std of raw over the measured frames,
                  normalized by mean GT luminance (lower = less variance);
       - relMSE:  mean over frames of mean((raw - gt)^2 / (gt^2 + eps))
                  (standard rendering error metric; single-frame error);
       - bias:    relMSE of the N-frame MEAN vs gt — a biased estimator
                  plateaus here while an unbiased one keeps falling;
       - psnr_ldr: tonemapped final-frame LDR PSNR vs the tonemapped GT.

Usage:
  python examples/ab_spatial_taps.py [--small] [--cpu] [--json]
        [--size WxH] [--frames N] [--gt-frames N] [--warmup N]

Results land in docs/PARITY.md (the "spatial taps" divergence row).
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import json
import time

import numpy as np


def run_frames(cfg, scene, mats, warmup, frames):
    """Fresh temporal run; returns (raw_frames (N,H,W,3), last_ldr)."""
    import jax

    from sunray_tpu.render.pipeline import RenderState, render_frame

    state = RenderState.create(cfg)
    step = jax.jit(lambda st: render_frame(scene, cfg, st, mats),
                   donate_argnums=(0,))
    for _ in range(warmup):
        state, ldr, aux = step(state)
    raws = []
    for _ in range(frames):
        state, ldr, aux = step(state)
        raws.append(np.asarray(aux["raw"]))
    return np.stack(raws), np.asarray(ldr)


def psnr(a, b, peak=1.0):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def rel_mse(a, gt, eps=1e-3):
    d = (a.astype(np.float64) - gt) ** 2
    return float(np.mean(d / (gt * gt + eps)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="480x270")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--gt-frames", type=int, default=256)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="256x144, 16 frames, 96 GT frames (CPU-friendly)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    if args.small:
        args.size, args.frames, args.gt_frames = "256x144", 16, 96

    from sunray_tpu.camera import Camera, camera_matrices
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.render.postprocess import tonemap
    from sunray_tpu.scene import cornell_box

    w, h = (int(x) for x in args.size.split("x"))
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                 fov_y=45.0)
    mats = camera_matrices(cam, w, h)

    def cfg_for(mode):
        return RenderConfig(width=w, height=h, lighting="restir",
                            spatial_taps=mode)

    # Ground truth: the reference-exact estimator, converged.
    t0 = time.time()
    gt_raws, _ = run_frames(cfg_for("perpixel"), scene, mats,
                            args.warmup, args.gt_frames)
    gt = gt_raws.mean(axis=0).astype(np.float64)
    gt_lum = float(gt.mean())
    gt_ldr = np.asarray(tonemap(gt.astype(np.float32), 1.0, "aces", 2.2))
    t_gt = time.time() - t0

    report = {
        "setup": {"size": [w, h], "frames": args.frames,
                  "gt_frames": args.gt_frames, "warmup": args.warmup,
                  "gt": "mean raw HDR of perpixel mode",
                  "gt_seconds": round(t_gt, 1)},
    }
    for mode in ("perpixel", "shared"):
        raws, ldr = run_frames(cfg_for(mode), scene, mats,
                               args.warmup, args.frames)
        mean_img = raws.mean(axis=0).astype(np.float64)
        ldr_m = np.asarray(
            tonemap(mean_img.astype(np.float32), 1.0, "aces", 2.2)
        )
        report[mode] = {
            "noise_std_over_gt_lum": round(
                float(raws.std(axis=0).mean()) / max(gt_lum, 1e-9), 4
            ),
            "relmse_single_frame": round(
                float(np.mean([rel_mse(r, gt) for r in raws])), 5
            ),
            "relmse_frame_mean": round(rel_mse(mean_img, gt), 5),
            "psnr_ldr_mean_vs_gt_db": round(psnr(ldr_m, gt_ldr), 2),
            "psnr_ldr_last_frame_vs_gt_db": round(
                psnr(np.asarray(ldr), gt_ldr), 2
            ),
        }
    pp, sh = report["perpixel"], report["shared"]
    report["verdict"] = {
        "noise_ratio_shared_over_perpixel": round(
            sh["noise_std_over_gt_lum"]
            / max(pp["noise_std_over_gt_lum"], 1e-9), 3
        ),
        "single_frame_relmse_ratio": round(
            sh["relmse_single_frame"]
            / max(pp["relmse_single_frame"], 1e-9), 3
        ),
        "bias_gap_relmse": round(
            sh["relmse_frame_mean"] - pp["relmse_frame_mean"], 5
        ),
    }
    print(json.dumps(report, indent=None if args.json else 2))


if __name__ == "__main__":
    main()
