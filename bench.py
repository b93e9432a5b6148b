"""Benchmark: rays/sec/chip on the 1080p Cornell box (BASELINE.md config).

Runs the full ReSTIR pipeline (RIS pass + final trace + TAA + 4x denoise +
postprocess) on the GPU, measures steady frame time, and converts to rays/s
using the actual per-frame trace count:

  rays/frame = P * (ris_walk_rounds        # closest-hit rounds, pass 1
               + 3                          # DI visibility + GI bounce + GI NEE
               + final_walk_rounds - 1      # closest-hit rounds, pass 2
                                            # (round 0 REUSES pass 1's
                                            # stored primary hit — not a
                                            # cast ray, not counted)
               + 2 + gi_spatial_samples)    # DI winner + GI spatial + GI final

Walk round counts are data-dependent (early-exit while_loops) and are read
back from the frame aux. `vs_baseline` is rays/s divided by 1e8 (100 Mray/s,
an RTX 3060 Ti-class ballpark for this ray budget — the reference publishes
no numbers, BASELINE.md "Reference-published numbers").

Output: one JSON line per metric as each completes —
  1. rays_per_sec_per_chip_cornell_1080p   (headline, printed first)
  2. fwd_bwd_rays_per_sec_per_chip_cornell (720p differentiable frame)
then a FINAL line = the headline metric with the others' values under
detail.extra_metrics. Every line names the device it ran on (platform,
device_kind, device count, and the card's name and power limit).
`--headline-only` skips 2; `--grad` runs only 2; `--small` runs 480x270.

Without a GPU the bench exits non-zero; `--cpu` runs it on the CPU
explicitly (for rehearsals — CPU times are not device numbers).
"""

import json
import os
import sys
import time

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp

from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.pipeline import RenderState, render_frame
from sunray_tpu.scene import cornell_box
from sunray_tpu.utils.compile_cache import enable_compile_cache
from sunray_tpu.utils.device import device_record
from sunray_tpu.utils.provenance import exec_paths


def _grad_bench(small: bool):
    """Forward+backward benchmark (BASELINE.md:38 "forward+backward"):
    jitted value_and_grad of the FULL differentiable ReSTIR frame w.r.t.
    the material table AND the vertex positions (the two heavy reverse
    paths: the light/BRDF terms and the hit-attribute recompute in
    render/shade.py). The differentiable frame runs the walks as
    fixed-trip scans (ops/loops.py), so this measures the true cost of a training step's render, not the
    forward fast path. Resolution 720p by default.
    """
    w, h = (480, 270) if small else (1280, 720)
    cfg = RenderConfig(width=w, height=h, lighting="restir",
                       differentiable=True)
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
    mats = camera_matrices(cam, w, h)
    state = RenderState.create(cfg)

    def loss_fn(bc, pos, st):
        sc = scene.replace(
            materials=scene.materials.replace(base_color=bc), positions=pos
        )
        st2, ldr, aux = render_frame(sc, cfg, st, mats)
        return jnp.mean(ldr), (st2, aux)

    vg = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True),
                 donate_argnums=(2,))
    bc = scene.materials.base_color
    pos = scene.positions
    n_warm, n_bench = 3, 10
    t0 = time.time()
    aux = None
    for _ in range(n_warm):
        (val, (state, aux)), grads = vg(bc, pos, state)
    jax.block_until_ready(grads)
    compile_and_warm = time.time() - t0

    t0 = time.time()
    for _ in range(n_bench):
        (val, (state, aux)), grads = vg(bc, pos, state)
    jax.block_until_ready(grads)
    dt = (time.time() - t0) / n_bench

    ris_rounds = int(aux["ris_rounds"])
    final_rounds = int(aux["final_rounds"])
    p = w * h
    rays_per_frame = p * (
        ris_rounds + 3 + max(final_rounds - 1, 0) + 2
        + cfg.gi_spatial_samples
    )
    dev = device_record()
    result = {
        "metric": "fwd_bwd_rays_per_sec_per_chip_cornell",
        "value": round(rays_per_frame / dt / 1e6, 3),
        "unit": "Mray/s (fwd+bwd)",
        "vs_baseline": round(rays_per_frame / dt / 1e8, 4),
        "detail": {
            "frame_ms": round(dt * 1e3, 2),
            "loss": float(val),
            "grad_norm_base_color": round(
                float(jnp.linalg.norm(grads[0])), 6),
            "grad_norm_positions": round(
                float(jnp.linalg.norm(grads[1])), 6),
            "rays_per_frame": rays_per_frame,
            "ris_rounds": ris_rounds,
            "final_rounds": final_rounds,
            "resolution": f"{w}x{h}",
            **dev,
            "warmup_s": round(compile_and_warm, 1),
            "exec_paths": exec_paths(cfg, scene, dev["platform"]),
        },
    }
    return result


def main():
    small = "--small" in sys.argv
    if "--cpu" not in sys.argv and jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform "
                 f"{jax.devices()[0].platform!r}); pass --cpu to run on "
                 "the CPU explicitly")
    enable_compile_cache()
    if "--grad" in sys.argv:
        print(json.dumps(_grad_bench(small)))
        return
    w, h = (480, 270) if small else (1920, 1080)
    cfg = RenderConfig(width=w, height=h, lighting="restir")
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
    mats = camera_matrices(cam, w, h)
    state = RenderState.create(cfg)

    step = jax.jit(
        lambda st: render_frame(scene, cfg, st, mats), donate_argnums=(0,)
    )

    # Warm-up: compile + fill temporal history.
    n_warm = 5
    t0 = time.time()
    aux = None
    for _ in range(n_warm):
        state, ldr, aux = step(state)
    jax.block_until_ready(ldr)
    compile_and_warm = time.time() - t0

    # Timed steady-state frames.
    n_bench = 20
    t0 = time.time()
    for _ in range(n_bench):
        state, ldr, aux = step(state)
    jax.block_until_ready(ldr)
    dt = (time.time() - t0) / n_bench

    ris_rounds = int(aux["ris_rounds"])
    final_rounds = int(aux["final_rounds"])
    p = w * h
    rays_per_frame = p * (
        ris_rounds + 3 + max(final_rounds - 1, 0) + 2
        + cfg.gi_spatial_samples
    )
    rays_per_sec = rays_per_frame / dt
    dev = device_record()

    result = {
        "metric": "rays_per_sec_per_chip_cornell_1080p",
        "value": round(rays_per_sec / 1e6, 3),
        "unit": "Mray/s",
        "vs_baseline": round(rays_per_sec / 1e8, 4),
        "detail": {
            "frame_ms": round(dt * 1e3, 2),
            "rays_per_frame": rays_per_frame,
            "ris_rounds": ris_rounds,
            "final_rounds": final_rounds,
            "resolution": f"{w}x{h}",
            **dev,
            "warmup_s": round(compile_and_warm, 1),
            # Which execution path this number measured (tracer and, on
            # the brute path, the trace kernel).
            "exec_paths": exec_paths(cfg, scene, dev["platform"]),
        },
    }
    print(json.dumps(result), flush=True)

    extras = []
    if "--headline-only" not in sys.argv:
        r = _grad_bench(small)
        print(json.dumps(r), flush=True)
        extras.append(r)

    final = dict(result)
    final["detail"] = dict(result["detail"])
    if extras:
        final["detail"]["extra_metrics"] = [
            {k: e[k] for k in ("metric", "value", "unit")} for e in extras
        ]
    print(json.dumps(final), flush=True)


if __name__ == "__main__":
    main()
