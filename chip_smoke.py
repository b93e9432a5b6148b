"""Smoke run of the renderer's main path on one GPU.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --phases 1,2,3,4
    python chip_smoke.py --measure  # + the jnp-trace frame, 1080p fwd+bwd
    python chip_smoke.py --four     # screen-tile sharding over four cards
    python chip_smoke.py --four --measure  # + the GSPMD jnp-trace frame

Phases (any failure exits non-zero before the last line is printed):
  1. device check: JAX must see a GPU; print the card's name and power
     limit (nvidia-smi), device_kind and the JAX version;
  2. golden parity: the two Cornell goldens of tests/test_golden.py
     rendered on the card, 4x4 box-filtered PSNR > 42.5 dB against the
     CPU-rendered .npy (GOLDEN_BOX_PSNR_DB);
  3. main path: Renderer(RenderConfig(1920x1080, restir)) on cornell_box(),
     render_to_host_memory (16 warm-up frames) then steady render() calls;
  4. trace kernel: the Pallas (Triton) brute-force kernel against the jnp
     Moller-Trumbore oracle at 1080p ray counts, and both timed;
  5. differentiable step: value_and_grad of bench.py's fwd+bwd loss at
     1280x720 (compiling it takes four to nine minutes on the H100 host
     with a cold cache; the whole run about 800 s).

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

CARD = "unknown card"


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def phase_device(jax):
    global CARD
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU: JAX reports platform {devs[0].platform!r}")
    from sunray_tpu.utils.device import card_name_and_power

    name_power = card_name_and_power()
    if name_power is None:
        sys.exit("nvidia-smi not found")
    print(name_power, flush=True)
    CARD = name_power
    say(f"device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__}")
    return devs


# Golden gate on the 4x4 box-filtered PSNR (box4). Per-pixel Monte Carlo
# decisions flip under one-ulp arithmetic differences, so the per-pixel
# PSNR of a sound frame drifts below 40 dB across backends. On the CPU,
# 24 renders of the two goldens with the camera nudged by 3e-7..2e-6 read
# 43.92-77.19 dB boxed (34.50-64.20 dB per pixel); one a-trous pass fewer
# reads 41.05-41.59 dB boxed, and denoise, TAA or GI spatial reuse off
# 29.66-36.63 dB. The gate sits 1.4 dB below the lowest sound reading.
GOLDEN_BOX_PSNR_DB = 42.5


def phase_golden():
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "golden_cases", os.path.join(here, "tests", "test_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gate = GOLDEN_BOX_PSNR_DB
    for name in ("cornell_nee", "cornell_restir"):
        golden = np.load(os.path.join(mod.GOLDEN_DIR, f"{name}.npy"))
        img = mod.render_case(name)
        p = mod.psnr(img, golden)
        pb = mod.psnr(box4(img), box4(golden))
        say(f"golden {name} 96x64: per-pixel PSNR={p:.2f} dB, "
            f"4x4-box PSNR={pb:.2f} dB (gate: box > {gate})")
        if not pb > gate:
            raise AssertionError(
                f"golden {name}: box PSNR {pb:.2f} dB <= {gate}")


def box4(img):
    """4x4 box-filtered image (the golden gate's scale)."""
    h, w, c = img.shape
    return img[:h // 4 * 4, :w // 4 * 4].reshape(
        h // 4, 4, w // 4, 4, c).mean(axis=(1, 3))


@contextlib.contextmanager
def jnp_trace_planes():
    """Programs traced inside take the jnp Moller-Trumbore planes for
    every brute query, in place of the Triton kernel the frame takes on
    the GPU: the frame-level A/B of the kernel decision (PERF.md)."""
    from sunray_tpu.render import trace

    rule = trace._brute_query
    trace._brute_query = lambda pallas_fn, xla_fn, *args: xla_fn(*args)
    try:
        yield
    finally:
        trace._brute_query = rule


def phase_main(jax, width=1920, height=1080, steady=10, trace="default"):
    from sunray_tpu.camera import Camera, camera_matrices_device
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.render.renderer import Renderer
    from sunray_tpu.scene import cornell_box

    cfg = RenderConfig(width=width, height=height, lighting="restir")
    r = Renderer(cfg, cornell_box())
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                 fov_y=45.0)
    t0 = time.perf_counter()
    r.render(cam).block_until_ready()
    compile_s = time.perf_counter() - t0
    rgba = r.render_to_host_memory(cam)          # 16 warm-up frames
    ldr = None
    t0 = time.perf_counter()
    for _ in range(steady):
        ldr = r.render(cam)
    ldr.block_until_ready()
    ms = (time.perf_counter() - t0) / steady * 1e3
    img = np.asarray(ldr)
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"frame not finite / wrong shape {img.shape}")
    ldr_mean = float(img.mean())
    if not 0.02 < ldr_mean < 0.9:
        raise AssertionError(f"frame ldr_mean {ldr_mean} outside (0.02, 0.9)")
    if rgba.shape != (height, width, 4):
        raise AssertionError(f"render_to_host_memory shape {rgba.shape}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"main {width}x{height} restir cornell trace={trace}: "
        f"first frame (compile) "
        f"{compile_s:.3f} s, steady {ms:.3f} ms/frame over {steady}, "
        f"ldr_mean={ldr_mean:.5f}, "
        f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    mats = camera_matrices_device(cam, width, height)
    compiled = r._frame_jit.lower(
        r.scene, r.state, mats, r._scene_accel()).compile()
    say(f"frame step memory_analysis: {compiled.memory_analysis()}")
    return ms


def trace_cases(width=1920, height=1080):
    """(name, tris, rays) for the trace-kernel check: primary camera rays
    of the 1080p Cornell view against Cornell's 36 triangles and against
    Cornell plus a seeded soup up to 512 and 4096 triangles."""
    import jax.numpy as jnp

    from sunray_tpu.camera import Camera, camera_matrices, generate_rays
    from sunray_tpu.scene import cornell_box
    from sunray_tpu.scene.procedural import triangle_soup

    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                 fov_y=45.0)
    o, d = generate_rays(camera_matrices(cam, width, height), width, height)
    rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    base = [np.asarray(v) for v in cornell_box().world_triangle_vertices()]
    out = []
    for n in (36, 512, 4096):
        if n == 36:
            tris = base
        else:
            soup = triangle_soup(n - 36, seed=n)
            tris = [np.concatenate([b, s_]) for b, s_ in zip(base, soup)]
        out.append((f"{n} tris", tuple(jnp.asarray(t) for t in tris), rays))
    return out


def timed(fn, *args, reps=5):
    """Median wall ms of jitted fn(*args) after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def compare_hits(ref, got):
    """Agreement of a kernel closest-hit result with the oracle's: share
    of rays with the same hit flag and triangle, and per field (t, u, v)
    on those rays the largest absolute difference and whether all agree
    to 1e-5: relative for t, and relative to the barycentrics' unit range
    for u, v (a barycentric near 0 is the difference of two O(1)
    products scaled by 1/det, so its float32 noise is absolute)."""
    hit_r, hit_g = np.asarray(ref.hit), np.asarray(got.hit)
    tri_r, tri_g = np.asarray(ref.tri), np.asarray(got.tri)
    same = (hit_r == hit_g) & (~hit_r | (tri_r == tri_g))
    both = same & hit_r
    diff, close = {}, True
    for f in ("t", "u", "v"):
        a = np.asarray(getattr(ref, f))[both]
        b = np.asarray(getattr(got, f))[both]
        diff[f] = float(np.max(np.abs(a - b), initial=0.0))
        tol = dict(rtol=1e-5, atol=0.0) if f == "t" else dict(rtol=0.0,
                                                              atol=1e-5)
        close = close and bool(np.allclose(b, a, **tol))
    return float(same.mean()), diff, close


def phase_trace_kernel(jax):
    """The Triton brute-force kernel vs the jnp oracle at 1080p ray counts.
    Agreement: >= 99.99% of rays (the rest only on exact-t ties or grazing
    edges, where an FMA-contracted product can resolve either way; there
    is no matrix product, so TF32 never enters); t/u/v within rtol 1e-5
    on agreeing hits. Occlusion of shadow segments from the primary hits
    to random light points, with the light triangle excluded."""
    import jax.numpy as jnp

    from sunray_tpu.config import RenderConfig
    from sunray_tpu.ops import intersect, pallas_trace
    from sunray_tpu.scene import cornell_box

    block = RenderConfig().trace_block_rays
    lights = np.asarray(cornell_box().light_world_tri)
    for name, tris, (o, d) in trace_cases():
        n = o.shape[0]
        xla_c = jax.jit(lambda o, d: intersect.trace_closest_brute(
            tris, o, d, block=block))
        ker_c = jax.jit(lambda o, d: pallas_trace.trace_closest_pallas(
            tris, o, d))
        ref, got = xla_c(o, d), ker_c(o, d)
        share, diff, close = compare_hits(ref, got)
        ms_x, ms_k = timed(xla_c, o, d), timed(ker_c, o, d)
        say(f"trace_closest {name} x {n} rays: agree={share:.6f} "
            f"max|d| t={diff['t']:.2e} u={diff['u']:.2e} "
            f"v={diff['v']:.2e} close={close}; "
            f"xla {ms_x:.3f} ms, triton kernel {ms_k:.3f} ms")
        if share < 0.9999 or not close:
            raise AssertionError(f"closest-hit kernel disagrees on {name}")
        # Shadow segments: primary hit -> random point near a light
        # triangle's centroid; exclude that light triangle.
        rng = np.random.default_rng(7)
        lt = lights[rng.integers(0, lights.size, n)]
        v0, v1, v2 = (np.asarray(t) for t in tris)
        cen = (v0[lt] + v1[lt] + v2[lt]) / 3.0
        p = np.asarray(o) + np.asarray(d) * np.minimum(
            np.asarray(ref.t), 10.0)[:, None]
        seg = cen - p
        tmax = jnp.asarray(np.linalg.norm(seg, axis=1))
        sd = jnp.asarray(seg / np.maximum(np.asarray(tmax), 1e-6)[:, None])
        po, ex = jnp.asarray(p), jnp.asarray(lt.astype(np.int32))
        xla_o = jax.jit(lambda o, d, t, e: intersect.trace_occluded_brute(
            tris, o, d, t, block=block, exclude=e))
        ker_o = jax.jit(lambda o, d, t, e: pallas_trace.trace_occluded_pallas(
            tris, o, d, t, exclude=e))
        a = np.asarray(xla_o(po, sd, tmax, ex))
        b = np.asarray(ker_o(po, sd, tmax, ex))
        share_o = float((a == b).mean())
        ms_xo = timed(xla_o, po, sd, tmax, ex)
        ms_ko = timed(ker_o, po, sd, tmax, ex)
        say(f"trace_occluded {name} x {n} rays: agree={share_o:.6f} "
            f"(occluded {a.mean():.4f}); xla {ms_xo:.3f} ms, "
            f"triton kernel {ms_ko:.3f} ms")
        if share_o < 0.9999:
            raise AssertionError(f"occlusion kernel disagrees on {name}")


def phase_four(jax, width=1920, height=1080, frames=2, measure=False):
    """Screen-tile sharding over four cards: the explicit shard_map halo
    frame (parallel/spmd) on a 1-D ("sp",) mesh and the GSPMD frame
    (parallel/sharding) on make_mesh(4, dp=1), each for `frames` frames,
    against the one-device Renderer frame on GPU 0 under
    tests/test_spmd.py's rule (allclose rtol/atol 2e-4 on >= 99.5% of
    pixels).

    The GSPMD program is partitioned and fused differently from the
    one-device program, so from frame 2 on (temporal reuse) one-ulp
    differences flip reservoir decisions on isolated pixels. Its later
    frames are therefore gated against the same frame rendered on one
    device with the camera moved by 1e-6: no worse than that, less 1%.
    measure: also the GSPMD frame with the jnp trace planes, gated and
    timed the same way."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import Mesh

    from sunray_tpu.camera import Camera, camera_matrices_device
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.parallel.sharding import (make_mesh, place_frame_args,
                                              render_frame_sharded)
    from sunray_tpu.parallel.spmd import make_spmd_step, shard_state
    from sunray_tpu.render.pipeline import RenderState, render_frame
    from sunray_tpu.render.renderer import Renderer
    from sunray_tpu.scene import cornell_box

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    cfg = RenderConfig(width=width, height=height, lighting="restir")
    scene = cornell_box()

    def cam(eps=0.0):
        return Camera(position=(1.0 + eps, 1.0, 3.4),
                      target=(1.0, 1.0, 0.0), fov_y=45.0)

    mats = camera_matrices_device(cam(), width, height)

    def run(step, state, n):
        ldrs, t = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            state, ldr = step(state)
            ldr.block_until_ready()
            t.append((time.perf_counter() - t0) * 1e3)
            ldrs.append(np.asarray(ldr))
        return ldrs[:frames], t

    def renderer_frames(c, n):
        r = Renderer(cfg, scene)
        return run(lambda _: (None, r.render(c)), None, n)

    def shares(ref, got):
        for b in got:
            if not np.isfinite(b).all():
                raise AssertionError("non-finite frame")
        return [float(np.isclose(b, a, rtol=2e-4, atol=2e-4)
                      .all(axis=-1).mean()) for a, b in zip(ref, got)]

    mesh_sp = Mesh(np.asarray(devs[:4]), ("sp",))
    sstep = make_spmd_step(scene, cfg, mesh_sp)
    spmd_state = lambda: shard_state(RenderState.create(cfg), cfg, mesh_sp)
    mesh = make_mesh(4, dp=1)
    gspmd_state = lambda: RenderState.create(cfg)
    variants = {
        "spmd halo (sp=4)": (lambda st: sstep(scene, st, mats)[:2],
                             spmd_state),
        "gspmd (1x4)": (lambda st: render_frame_sharded(
            scene, cfg, st, mats, mesh)[:2], gspmd_state),
    }
    jobs = [lambda s=s, init=init: jax.block_until_ready(s(init()))
            for s, init in variants.values()]
    if measure:
        # The GSPMD frame with the jnp planes in place of the trace
        # kernel: lowered here (the swap must not reach the other
        # programs, traced in the pool), compiled in the pool.
        frame = jax.jit(lambda sc, st, m: render_frame(sc, cfg, st, m))
        with jnp_trace_planes(), mesh:
            lowered = frame.lower(*place_frame_args(
                scene, cfg, gspmd_state(), mats, mesh))
        compiled = []
        jobs.append(lambda: compiled.append(lowered.compile()))
        variants["gspmd (1x4) jnp trace planes"] = (
            lambda st: compiled[0](*place_frame_args(
                scene, cfg, st, mats, mesh))[:2], gspmd_state)
    # Compile the sharded programs at once (XLA compiles off the GIL),
    # with one throwaway frame each, while the one-device frames run.
    with ThreadPoolExecutor(len(jobs)) as ex:
        warm = [ex.submit(job) for job in jobs]
        with jax.default_device(devs[0]):
            ref, t_ref = renderer_frames(cam(), frames + 2)
            nudged, _ = renderer_frames(cam(1e-6), frames)
        for f in warm:
            f.result()
    floor = shares(ref, nudged)
    say(f"four-card baseline: one-device {width}x{height} vs camera +1e-6 "
        f"match per frame={floor}")
    gspmd_gate = [0.995] + [min(0.995, f - 0.01) for f in floor[1:]]
    for name, (step, init) in variants.items():
        got, t = run(step, init(), frames + 4)
        got_shares = shares(ref, got)
        gate = gspmd_gate if name.startswith("gspmd") else [0.995] * frames
        say(f"four-card {name} {width}x{height}: match per frame="
            f"{got_shares} (gate {gate}), frame ms="
            f"{[round(x, 3) for x in t]} (one-device Renderer ms="
            f"{[round(x, 3) for x in t_ref]})")
        if any(g < b for g, b in zip(got_shares, gate)):
            raise AssertionError(f"{name} disagrees with the one-device frame")


def phase_grad(jax, width, height, optional=False):
    import jax.numpy as jnp

    from sunray_tpu.camera import Camera, camera_matrices
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.render.pipeline import RenderState, render_frame
    from sunray_tpu.scene import cornell_box

    cfg = RenderConfig(width=width, height=height, lighting="restir",
                       differentiable=True)
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                 fov_y=45.0)
    mats = camera_matrices(cam, width, height)
    state = RenderState.create(cfg)

    def loss_fn(bc, pos, st):
        sc = scene.replace(
            materials=scene.materials.replace(base_color=bc), positions=pos)
        st2, ldr, aux = render_frame(sc, cfg, st, mats)
        return jnp.mean(ldr), st2

    vg = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True),
                 donate_argnums=(2,))
    bc, pos = scene.materials.base_color, scene.positions
    t0 = time.perf_counter()
    step = vg.lower(bc, pos, state).compile()
    compile_s = time.perf_counter() - t0
    ma = step.memory_analysis()
    need = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
            + ma.output_size_in_bytes - ma.alias_size_in_bytes)
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    say(f"fwd+bwd {width}x{height} restir: compile {compile_s:.3f} s; "
        f"compiled step needs {need} bytes (temp {ma.temp_size_in_bytes}); "
        f"device bytes_limit {limit}")
    if optional and limit is not None and need > limit:
        say(f"fwd+bwd {width}x{height}: not run, needs more than the card")
        return
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        (val, state), grads = step(bc, pos, state)
        jax.block_until_ready(grads)
        times.append((time.perf_counter() - t0) * 1e3)
    g0, g1 = (np.asarray(g) for g in grads)
    ok = (np.isfinite(float(val)) and np.isfinite(g0).all()
          and np.isfinite(g1).all())
    say(f"fwd+bwd {width}x{height} restir: step ms={[round(t, 3) for t in times]} "
        f"(first is warm-up), "
        f"loss={float(val):.6f}, |g_base_color|={np.linalg.norm(g0):.6g}, "
        f"|g_positions|={np.linalg.norm(g1):.6g}")
    if not ok:
        raise AssertionError("non-finite loss or gradients")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated phases to run (1 always runs)")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded-frame phase")
    ap.add_argument("--measure", action="store_true",
                    help="also time the 1080p frame with the jnp trace "
                         "planes (phase 3) and the 1080p fwd+bwd step "
                         "(phase 5), or with --four the GSPMD frame with "
                         "the jnp trace planes; on a cold compile cache "
                         "the one-card run exceeds 1200 s")
    args = ap.parse_args()

    import jax

    from sunray_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = phase_device(jax)
    phases = {int(p) for p in args.phases.split(",") if p}
    if args.four:
        phase_four(jax, measure=args.measure)
        count = len(devs)
    else:
        if 2 in phases:
            phase_golden()
        if 3 in phases:
            phase_main(jax)
            if args.measure:
                with jnp_trace_planes():
                    phase_main(jax, trace="jnp planes")
        if 4 in phases:
            phase_trace_kernel(jax)
        if 5 in phases:
            phase_grad(jax, 1280, 720)
            if args.measure:
                phase_grad(jax, 1920, 1080, optional=True)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
