"""The per-frame pipeline: one pure function from (scene, camera, state) to
(state', image).

This is the XLA-dataflow replacement for the reference's per-frame-rebuilt
RenderGraph (render_graph/graph.rs:268-1277): pass ordering, hazards, and
resource lifetimes are implied by data dependencies; "temporal resources"
(graph.rs:235-266) are the explicit RenderState pytree threaded through; the
pipeline cache is jax.jit's compilation cache; transient aliasing is XLA
buffer assignment + donation.

Pass order matches build_unified_graph (src/lib.rs:1347-1619):
  RIS/G-buffer -> final trace -> temporal accumulation -> denoise xN ->
  postprocess.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from sunray_tpu.utils import struct

from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.render import restir
from sunray_tpu.render.gbuffer import ris_pass
from sunray_tpu.render.pathtrace import final_pass
from sunray_tpu.render.postprocess import (
    atrous_denoise,
    temporal_accumulate,
    tonemap,
)
from sunray_tpu.render.trace import make_tracer


@struct.dataclass
class RenderState:
    """Cross-frame renderer state — the temporal-resource set
    (src/lib.rs:320-331: accumulation image, DI/GI reservoir ping-pongs)
    plus the frame counter and previous view-proj. Being an explicit pytree
    makes it trivially checkpointable (SURVEY.md section 5.4)."""

    accum: jnp.ndarray               # (H, W, 3) TAA history
    res_di: restir.ReservoirDI      # previous frame's DI reservoirs
    res_gi: restir.ReservoirGI      # previous frame's GI reservoirs
    prev_view_proj: jnp.ndarray      # (4, 4)
    frame_count: jnp.ndarray         # () int32 — relative_frame_count

    @staticmethod
    def create(cfg) -> "RenderState":
        p = cfg.width * cfg.height
        return RenderState(
            accum=jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
            res_di=restir.ReservoirDI.empty(p),
            res_gi=restir.ReservoirGI.empty(p),
            prev_view_proj=jnp.zeros((4, 4), jnp.float32),
            frame_count=jnp.int32(0),
        )


def render_frame(scene, cfg, state: RenderState, mats, accel=None):
    """One frame. mats: camera matrices dict from camera_matrices().

    accel: optional prebuilt BVH topology (refit inside, see
    trace.make_tracer). Returns (new_state, ldr (H, W, 3) in [0,1], aux).
    """
    w, h = cfg.width, cfg.height
    frame_count = state.frame_count

    tracer = make_tracer(scene, cfg, accel)
    lights = restir.Lights(scene) if scene.num_lights > 0 else None

    with jax.named_scope("ris_pass"):
        gbuf, r_di, r_gi, _hit, ris_rounds = ris_pass(
            scene, cfg, tracer, lights, mats, state.prev_view_proj,
            state.res_di, state.res_gi, frame_count,
        )
    # cfg.samples > 1: average `samples` independently-seeded final passes
    # (in-frame spp — the reference is fixed 1 spp, ray_gen_final.slang:40).
    first_hit = (_hit.first_tri, _hit.first_t)
    with jax.named_scope("final_pass"):
        raw, final_rounds = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi, frame_count,
            first_hit=first_hit,
        )
    for s in range(1, cfg.samples):
        raw_s, rounds_s = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi, frame_count,
            sample_idx=s, first_hit=first_hit,
        )
        raw = raw + raw_s
        final_rounds = final_rounds + rounds_s
    if cfg.samples > 1:
        raw = raw / cfg.samples

    raw_img = raw.reshape(h, w, 3)
    if cfg.edge_antialias:
        from sunray_tpu.render.antialias import primary_edge_aa

        raw_img = primary_edge_aa(
            scene, cfg, tracer, mats, raw_img,
            tri=_hit.first_tri, t_hit=_hit.first_t,
        )
    motion_img = gbuf.motion.reshape(h, w, 2)

    if cfg.enable_taa:
      with jax.named_scope("taa"):
        accum = temporal_accumulate(
            raw_img, motion_img, state.accum, frame_count,
            cfg.accumulation_factor,
            history_band=cfg.history_gather_band,
            history_halo=cfg.history_gather_halo,
            history_layout=cfg.history_gather_layout,
            history_mode=cfg.history_gather_mode,
            history_radius=cfg.history_shift_radius,
            history_shift_global=cfg.history_shift_global,
            history_force=cfg.history_gather_force,
            history_auto_min_retention=cfg.history_auto_min_retention,
        )
    else:
        accum = raw_img

    if cfg.denoise_passes > 0:
      with jax.named_scope("denoise"):
        den = atrous_denoise(
            accum,
            gbuf.depth.reshape(h, w),
            gbuf.normal.reshape(h, w, 3),
            gbuf.roughness.reshape(h, w),
            gbuf.diffuse.reshape(h, w, 3),
            cfg.denoise_passes,
        )
    else:
        den = accum

    with jax.named_scope("postprocess"):
        ldr = tonemap(den, cfg.exposure, cfg.tonemap, cfg.gamma)

    new_state = RenderState(
        accum=accum,
        res_di=r_di,
        res_gi=r_gi,
        prev_view_proj=mats["view_proj"],
        frame_count=frame_count + 1,
    )
    aux = {
        "raw": raw_img,
        "depth": gbuf.depth.reshape(h, w),
        "normal": gbuf.normal.reshape(h, w, 3),
        "diffuse": gbuf.diffuse.reshape(h, w, 3),
        "motion": motion_img,
        # Full-batch trace rounds actually executed by the two walks
        # (data-dependent; used by bench.py for honest rays/s accounting).
        "ris_rounds": ris_rounds,
        "final_rounds": final_rounds,
    }
    return new_state, ldr, aux


def render_frame_with_camera(scene, cfg, state: RenderState, camera: Camera):
    """Convenience wrapper computing camera matrices inside."""
    mats = camera_matrices(camera, cfg.width, cfg.height)
    return render_frame(scene, cfg, state, mats)
