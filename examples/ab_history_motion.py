"""History-mode quality A/B under REAL camera motion (VERDICT r2 item 3).

The shift-select history read (`history_gather_mode="shift"`, the round-2
default) was validated for speed and static-camera bit-identity only. This
harness measures what it actually does under rotation + parallax: an
orbiting camera over the Cornell box, at several orbit speeds, comparing

  exact    — plain dynamic gathers (the reference's reprojection semantics,
             temporal_accumulation.slang:42-58; force=False)
  banded   — windowed gathers (halo 16 rows; force=True)
  shift rN — gather-free compare/select neighborhood, with/without
             global-motion compensation (force=True)

per (speed, mode):
  retention — mean fraction of pixels whose TAA history read is VALID
              (the in-band/in-radius mask & on-screen & frame>2); exact
              mode's retention is the on-screen fraction, the upper bound.
  relMSE / PSNR — final LDR vs the exact mode's LDR at the same frame
              index (same RNG seeds, same camera: the diff isolates
              dropped/clamped history, i.e. extra noise + ghosting).

Runs fine on CPU (force=True exercises the forced history ladder; values,
not speed, are measured here — speed A/Bs live in ab_history.py).

Usage: python examples/ab_history_motion.py [--size 256x144] [--frames 36]
           [--speeds 0.5,2,5] [--cpu] [--json out.json]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import json
import sys

import numpy as np


def orbit_cam(frame, deg_per_frame, radius=2.6, height=1.3,
              center=(1.0, 1.0, 1.0)):
    """Orbit around the look-at point: the target-depth plane stays put, so
    per-pixel motion is PARALLAX-dominated (small spread around ~0 mean)."""
    from sunray_tpu.camera import Camera

    a = np.deg2rad(deg_per_frame * frame)
    eye = (center[0] + radius * np.sin(a), height,
           center[2] + radius * np.cos(a))
    return Camera(position=eye, target=center, fov_y=50.0)


def yaw_cam(frame, deg_per_frame, eye=(1.0, 1.0, 3.4)):
    """Fixed position, rotating view direction: a whole-screen PAN — the
    worst case for uncompensated shift mode, the best case for the
    global-motion roll (deviation is only perspective nonuniformity)."""
    from sunray_tpu.camera import Camera

    a = np.deg2rad(deg_per_frame * frame)
    tgt = (eye[0] + np.sin(a) * -3.4, eye[1], eye[2] - np.cos(a) * 3.4)
    return Camera(position=eye, target=tgt, fov_y=50.0)


def truck_cam(frame, units_per_frame, eye0=(1.0, 1.0, 3.4)):
    """Lateral dolly (camera + target translate together): pan whose
    magnitude varies with DEPTH — mean-compensable only partially."""
    from sunray_tpu.camera import Camera

    x = eye0[0] + units_per_frame * frame
    return Camera(position=(x, eye0[1], eye0[2]),
                  target=(x, 1.0, 0.0), fov_y=50.0)


CAMS = {"orbit": orbit_cam, "yaw": yaw_cam, "truck": truck_cam}


def taa_valid_mask(motion, cfg):
    """Recompute TAA's history-validity mask for a frame's motion buffer
    (the `use_history` term of postprocess.temporal_accumulate, minus the
    frame>2 warmup gate, which is mode-independent)."""
    import jax.numpy as jnp

    from sunray_tpu.render.postprocess import bilinear_sample_banded

    h, w = motion.shape[:2]
    xs = (jnp.arange(w) + 0.5) / w
    ys = (jnp.arange(h) + 0.5) / h
    uu, vv = jnp.meshgrid(xs, ys)
    prev_uv = jnp.stack([uu, vv], axis=-1) - motion
    on_screen = ~jnp.any((prev_uv < 0.0) | (prev_uv > 1.0), axis=-1)
    if cfg.history_gather_force is False or cfg.history_gather_band <= 0:
        return np.asarray(on_screen)
    dummy = jnp.zeros((h, w, 3), jnp.float32)
    _, ok = bilinear_sample_banded(
        dummy, prev_uv, cfg.history_gather_band, cfg.history_gather_halo,
        layout=cfg.history_gather_layout, mode=cfg.history_gather_mode,
        radius=cfg.history_shift_radius,
        shift_global=cfg.history_shift_global,
        force=cfg.history_gather_force,
    )
    return np.asarray(on_screen & ok)


def run_mode(cfg, scene, w, h, frames, speed, cam_fn):
    import jax

    from sunray_tpu.camera import camera_matrices
    from sunray_tpu.render.pipeline import RenderState, render_frame

    step = jax.jit(
        lambda st, mats: render_frame(scene, cfg, st, mats),
        donate_argnums=(0,),
    )
    state = RenderState.create(cfg)
    ldrs, retains, mstats = [], [], []
    for f in range(frames):
        mats = camera_matrices(cam_fn(f, speed), w, h)
        state, ldr, aux = step(state, mats)
        if f > 2:  # TAA history active
            ldrs.append(np.asarray(ldr))
            retains.append(float(taa_valid_mask(aux["motion"], cfg).mean()))
            m = np.asarray(aux["motion"])
            px = np.stack([m[..., 0] * w, m[..., 1] * h], -1)
            mag = np.hypot(px[..., 0], px[..., 1])
            ok = mag < min(w, h)  # drop sky-reprojection garbage
            mstats.append((np.median(mag[ok]), np.percentile(mag[ok], 95)))
    med, p95 = np.mean(np.array(mstats), axis=0)
    return np.stack(ldrs), float(np.mean(retains)), float(med), float(p95)


def rel_mse(a, b, eps=1e-3):
    return float(np.mean((a - b) ** 2 / (b * b + eps)))


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse == 0 else -10.0 * np.log10(mse)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="256x144")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--speeds", default="0.5,2,5",
                    help="speeds: degrees/frame (orbit, yaw) or scene "
                         "units/frame * 10 (truck)")
    ap.add_argument("--motion", default="orbit,yaw,truck")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from sunray_tpu.config import RenderConfig
    from sunray_tpu.scene import cornell_box

    w, h = (int(x) for x in args.size.split("x"))
    scene = cornell_box()
    speeds = [float(s) for s in args.speeds.split(",")]

    modes = [
        ("exact", dict(history_gather_force=False)),
        ("banded", dict(history_gather_mode="banded",
                        history_gather_force=True)),
        ("shift r1 g", dict(history_gather_mode="shift",
                            history_shift_radius=1,
                            history_gather_force=True)),
        ("shift r1", dict(history_gather_mode="shift",
                          history_shift_radius=1,
                          history_shift_global=False,
                          history_gather_force=True)),
        ("shift r2 g", dict(history_gather_mode="shift",
                            history_shift_radius=2,
                            history_gather_force=True)),
        ("auto r1", dict(history_gather_mode="auto",
                         history_shift_radius=1,
                         history_gather_force=True)),
    ]

    results = []
    for mname in args.motion.split(","):
        cam_fn = CAMS[mname]
        for speed in speeds:
            sp = speed / 10.0 if mname == "truck" else speed
            ref = None
            print(f"--- {mname} speed {sp} "
                  f"({w}x{h}, {args.frames} frames) ---", flush=True)
            for name, kw in modes:
                cfg = RenderConfig(width=w, height=h, lighting="restir",
                                   **kw)
                ldrs, retention, med, p95 = run_mode(
                    cfg, scene, w, h, args.frames, sp, cam_fn
                )
                if ref is None:
                    ref = ldrs
                    rm, ps = 0.0, 99.0
                else:
                    rm, ps = rel_mse(ldrs, ref), psnr(ldrs, ref)
                row = dict(motion=mname, speed=sp, mode=name,
                           retention=retention, relmse_vs_exact=rm,
                           psnr_vs_exact=ps, motion_med_px=med,
                           motion_p95_px=p95)
                results.append(row)
                print(f"{name:12s} retention={retention:6.3f}  "
                      f"relMSE={rm:9.3e}  PSNR={ps:6.2f} dB  "
                      f"|m| med/p95={med:5.2f}/{p95:5.2f} px", flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    sys.exit(main())
