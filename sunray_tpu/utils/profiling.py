"""Observability: per-stage timing, HLO dumps, device profiler traces.

The analogs of the reference's tracing/observability surface
(SURVEY.md section 5.1/5.5):

  - per-pass debug-utils labels (graph.rs:1062-1118) -> named jax.profiler
    TraceAnnotations inside the frame (already implicit in op names) +
    stage_timings() wall-clock breakdown;
  - SUNRAY_GRAPH_DUMP_DIR graph dumps (graph_debug.rs) -> dump_hlo():
    the frame program's optimized HLO text + a pass/resource summary;
  - Nsight/Aftermath captures -> jax.profiler.trace() xplane traces
    viewable in TensorBoard/xprof.

Trace reduction: summarize_trace() reads the device lanes of a
jax.profiler trace (GPU planes only; a trace without one raises), and
hlo_stage_map() joins kernel names to the frame's named stages.
"""

from __future__ import annotations

import contextlib
import os
import re
import time

import jax

# Named stages of the frame (jax.named_scope in render/), innermost wins:
# a trace query inside the RIS pass counts as "trace".
STAGES = ("trace", "ris_audition", "di_temporal", "gi_temporal",
          "spatial_reuse", "ris_pass", "final_pass", "taa", "denoise",
          "postprocess")
GPU_PLANE_PREFIX = "/device:GPU:"


def dump_hlo(fn, args, path: str, name: str = "frame") -> str:
    """Save lowered + compiled HLO for fn(*args) under path. Returns the
    compiled-text file path."""
    os.makedirs(path, exist_ok=True)
    lowered = jax.jit(fn).lower(*args)
    with open(os.path.join(path, f"{name}_lowered.txt"), "w") as f:
        f.write(lowered.as_text())
    compiled = lowered.compile()
    out = os.path.join(path, f"{name}_compiled.txt")
    with open(out, "w") as f:
        f.write(compiled.as_text() or "")
    with open(os.path.join(path, f"{name}_memory.txt"), "w") as f:
        try:
            mem = compiled.memory_analysis()
            f.write(str(mem))
        except Exception as e:  # pragma: no cover - backend-dependent
            f.write(f"memory analysis unavailable: {e}")
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (TensorBoard/xprof-compatible)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def load_trace(log_dir: str) -> list:
    """traceEvents of the newest *.trace.json.gz under a device_trace()
    log dir."""
    import glob
    import gzip
    import json

    paths = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                  recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(paths[-1], "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_events(events, prefix: str = GPU_PLANE_PREFIX) -> list:
    """Complete events on device lanes: processes whose name starts with
    `prefix` (the GPU planes, "/device:GPU:<n>"). Raises if the trace has
    no such process — host-only traces must not pass for device time."""
    pids = {
        e["pid"] for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and e.get("args", {}).get("name", "").startswith(prefix)
    }
    if not pids:
        names = sorted({e.get("args", {}).get("name", "") for e in events
                        if e.get("name") == "process_name"})
        raise ValueError(f"trace has no {prefix}* plane (planes: {names})")
    return [e for e in events
            if e.get("ph") == "X" and e.get("dur") and e.get("pid") in pids]


def summarize_trace(log_dir: str, top: int = 25, steady_frac: float = 0.5,
                    events=None):
    """Per-kernel device-time table of a device_trace() log dir.

    Groups the GPU planes' complete events by name, keeping only the
    steady tail of the trace (`steady_frac` of the device span — skips
    warm-up at the front). Returns a list of {"name", "total_ms", "count",
    "pct"} sorted by total time desc; prints the top `top` rows. `events`
    overrides reading the trace from log_dir."""
    xs = device_events(load_trace(log_dir) if events is None else events)
    if not xs:
        raise ValueError("trace has no complete events on device lanes")
    t0 = min(e["ts"] for e in xs)
    t1 = max(e["ts"] + e["dur"] for e in xs)
    cut = t1 - (t1 - t0) * steady_frac
    agg: dict = {}
    for e in xs:
        if e["ts"] < cut:
            continue
        tot, cnt = agg.get(e["name"], (0.0, 0))
        agg[e["name"]] = (tot + e["dur"], cnt + 1)
    total = sum(t for t, _ in agg.values())
    rows = [
        {"name": n, "total_ms": t / 1e3, "count": c,
         "pct": 100.0 * t / total}
        for n, (t, c) in agg.items()
    ]
    rows.sort(key=lambda r: -r["total_ms"])
    for r in rows[:top]:
        print(f"{r['total_ms']:9.2f} ms {r['pct']:5.1f}% x{r['count']:<5d} "
              f"{r['name'][:110]}")
    return rows


# Pallas kernels appear in the trace under their `name=`; they belong to
# the stage that issues them.
KERNEL_STAGES = {"trace_closest": "trace", "trace_occluded": "trace"}


def kernel_name(hlo_name: str) -> str:
    """The GPU kernel name XLA gives an HLO instruction: "." and "-"
    become "_" (loop_add_fusion.3 -> loop_add_fusion_3)."""
    return re.sub(r"[^A-Za-z0-9_]", "_", hlo_name)


def hlo_stage_map(hlo_text: str, stages=STAGES) -> dict:
    """{kernel name: innermost named stage} from compiled-HLO text (each
    instruction's metadata op_name is its jax.named_scope path)."""
    pat = re.compile(r"%?([\w\-.]+)\s*=.*?op_name=\"([^\"]+)\"")
    out = {}
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        parts = [p for p in m.group(2).split("/") if p in stages]
        out[kernel_name(m.group(1))] = parts[-1] if parts else "<other>"
    return out


def stage_table(rows, stage_of: dict, frames: int) -> dict:
    """{stage: device ms per frame} from summarize_trace rows, joining
    kernel names to hlo_stage_map; Pallas kernels by KERNEL_STAGES."""
    out: dict = {}
    for r in rows:
        name = r["name"]
        st = stage_of.get(name) or next(
            (v for k, v in KERNEL_STAGES.items() if name.startswith(k)),
            "<unmapped>")
        out[st] = out.get(st, 0.0) + r["total_ms"] / frames
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def stage_timings(scene, cfg, state, mats, accel=None, repeats: int = 3):
    """Wall-clock per-stage breakdown of one frame, by running incremental
    prefixes of the pipeline (XLA fuses aggressively, so 'time inside one
    jitted program per pass' is not observable; prefix deltas are the
    honest proxy). Returns {stage: seconds}."""
    import jax.numpy as jnp

    from sunray_tpu.render import restir
    from sunray_tpu.render.gbuffer import ris_pass
    from sunray_tpu.render.pathtrace import final_pass
    from sunray_tpu.render.postprocess import (
        atrous_denoise,
        temporal_accumulate,
        tonemap,
    )
    from sunray_tpu.render.trace import make_tracer

    w, h = cfg.width, cfg.height

    def upto_ris(state):
        tracer = make_tracer(scene, cfg, accel)
        lights = restir.Lights(scene) if scene.num_lights > 0 else None
        return ris_pass(
            scene, cfg, tracer, lights, mats, state.prev_view_proj,
            state.res_di, state.res_gi, state.frame_count,
        )[:3]

    def upto_final(state):
        tracer = make_tracer(scene, cfg, accel)
        lights = restir.Lights(scene) if scene.num_lights > 0 else None
        gbuf, r_di, r_gi, _, _ = ris_pass(
            scene, cfg, tracer, lights, mats, state.prev_view_proj,
            state.res_di, state.res_gi, state.frame_count,
        )
        raw, _ = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
            state.frame_count,
        )
        return raw

    def upto_post(state):
        tracer = make_tracer(scene, cfg, accel)
        lights = restir.Lights(scene) if scene.num_lights > 0 else None
        gbuf, r_di, r_gi, _, _ = ris_pass(
            scene, cfg, tracer, lights, mats, state.prev_view_proj,
            state.res_di, state.res_gi, state.frame_count,
        )
        raw, _ = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
            state.frame_count,
        )
        raw_img = raw.reshape(h, w, 3)
        accum = temporal_accumulate(
            raw_img, gbuf.motion.reshape(h, w, 2), state.accum,
            state.frame_count, cfg.accumulation_factor,
        )
        den = atrous_denoise(
            accum, gbuf.depth.reshape(h, w), gbuf.normal.reshape(h, w, 3),
            gbuf.roughness.reshape(h, w), gbuf.diffuse.reshape(h, w, 3),
            cfg.denoise_passes,
        )
        return tonemap(den, cfg.exposure, cfg.tonemap, cfg.gamma)

    def timed(fn):
        jfn = jax.jit(fn)
        out = jfn(state)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(repeats):
            out = jfn(state)
        jax.block_until_ready(out)
        return (time.time() - t0) / repeats

    t_ris = timed(upto_ris)
    t_final = timed(upto_final)
    t_post = timed(upto_post)
    return {
        "ris_pass": t_ris,
        "final_pass": max(t_final - t_ris, 0.0),
        "post_pipeline": max(t_post - t_final, 0.0),
        "frame_total": t_post,
    }
