"""Explicit-SPMD render path: the full frame inside one shard_map.

`parallel/sharding.py` scales by annotating shardings and letting GSPMD
insert collectives. This module is the hand-written version (SURVEY.md
section 7 M8 "explicit halo exchange"): image rows shard over the mesh's
"sp" axis, every per-pixel stage runs locally, and the frame's five
cross-pixel reads ride explicit `lax.ppermute` halo exchanges
(parallel/halo.py):

  1. ReSTIR DI/GI temporal history gathers  (halo_t rows)
  2. ReSTIR DI/GI spatial-reuse taps        (halo_s = max tap radius)
  3. TAA 3x3 neighborhood clamp             (1 row, edge-replicated)
  4. TAA bilinear history fetch             (halo_t rows)
  5. a-trous denoise taps                   (2*step rows per pass)

Semantics vs the single-device frame: identical except that temporal
history whose reprojection crosses more than halo_t rows of shard
boundary is rejected like off-screen history — the same policy the
forced banded history gathers apply on one device (ops/banded.py). With motion below the halo the two paths agree to
float-reassociation noise (tests/test_spmd.py asserts it).

Collectives are neighbor ppermutes of halo rows — O(halo * W) bytes per
step over the interconnect, independent of shard count: the weak-scaling shape the
scaling-book recipe wants (compute ∝ 1/n, comm constant).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sunray_tpu.parallel.halo import ShardGrid, make_grid
from sunray_tpu.render import restir
from sunray_tpu.render.gbuffer import ris_pass
from sunray_tpu.render.pathtrace import final_pass
from sunray_tpu.render.pipeline import RenderState
from sunray_tpu.render.postprocess import (
    atrous_denoise_grid,
    temporal_accumulate,
    tonemap,
)
from sunray_tpu.render.trace import make_tracer


def _frame_local(scene, cfg, state, mats, nshards, axis):
    """The per-shard frame body. Mirrors pipeline.render_frame with every
    cross-pixel seam routed through the grid halo exchanges."""
    grid = make_grid(cfg, axis, nshards)
    w, hl = cfg.width, grid.hl
    frame_count = state.frame_count

    tracer = make_tracer(scene, cfg, None)
    lights = restir.Lights(scene) if scene.num_lights > 0 else None

    gbuf, r_di, r_gi, _hit, ris_rounds = ris_pass(
        scene, cfg, tracer, lights, mats, state.prev_view_proj,
        state.res_di, state.res_gi, frame_count, grid=grid,
    )
    raw, final_rounds = final_pass(
        scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi, frame_count,
        grid=grid,
    )
    for s in range(1, cfg.samples):
        raw_s, rounds_s = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi, frame_count,
            grid=grid, sample_idx=s,
        )
        raw = raw + raw_s
        final_rounds = final_rounds + rounds_s
    if cfg.samples > 1:
        raw = raw / cfg.samples

    raw_img = raw.reshape(hl, w, 3)
    motion_img = gbuf.motion.reshape(hl, w, 2)

    if cfg.enable_taa:
        accum = temporal_accumulate(
            raw_img, motion_img, state.accum, frame_count,
            cfg.accumulation_factor, grid=grid,
        )
    else:
        accum = raw_img

    if cfg.denoise_passes > 0:
        den = atrous_denoise_grid(
            accum,
            gbuf.depth.reshape(hl, w),
            gbuf.normal.reshape(hl, w, 3),
            gbuf.roughness.reshape(hl, w),
            gbuf.diffuse.reshape(hl, w, 3),
            cfg.denoise_passes,
            grid,
        )
    else:
        den = accum

    ldr = tonemap(den, cfg.exposure, cfg.tonemap, cfg.gamma)

    new_state = RenderState(
        accum=accum,
        res_di=r_di,
        res_gi=r_gi,
        prev_view_proj=mats["view_proj"],
        frame_count=frame_count + 1,
    )
    # Per-shard walk counts differ (each shard exits its while_loops when
    # its own lanes settle); report the mesh max so the output is
    # replicated (out_spec P()).
    rounds = (
        lax.pmax(ris_rounds, axis),
        lax.pmax(final_rounds, axis),
    )
    return new_state, ldr, rounds


def state_specs(cfg) -> RenderState:
    """PartitionSpec pytree for RenderState: pixel arrays row-sharded on
    "sp", scalars/matrices replicated."""

    def spec(x):
        if x.ndim >= 2 and x.shape[0] == cfg.height:
            return P("sp")
        if x.ndim >= 1 and x.shape[0] == cfg.height * cfg.width:
            return P("sp")
        return P()

    return jax.tree_util.tree_map(spec, RenderState.create(cfg))


def make_spmd_step(scene, cfg, mesh: Mesh, axis: str = "sp"):
    """Build a jitted one-frame step running the whole pipeline inside
    shard_map over `axis`. Returns step(state, mats) -> (state', ldr,
    (ris_rounds, final_rounds)). State must be sharded with
    `shard_state` (or any layout matching state_specs)."""
    nshards = mesh.shape[axis]
    st_specs = state_specs(cfg)

    body = functools.partial(
        _frame_local, nshards=nshards, axis=axis
    )

    def frame(scene_, state, mats):
        return body(scene_, cfg, state, mats)

    mapped = shard_map(
        frame,
        mesh=mesh,
        in_specs=(
            jax.tree_util.tree_map(lambda _: P(), scene),
            st_specs,
            jax.tree_util.tree_map(lambda _: P(), mats_placeholder()),
        ),
        out_specs=(st_specs, P("sp"), (P(), P())),
        check_vma=False,
    )
    return jax.jit(mapped)


def mats_placeholder():
    return {"view_inverse": 0, "proj_inverse": 0, "view_proj": 0}


def shard_state(state: RenderState, cfg, mesh: Mesh) -> RenderState:
    """Place a RenderState according to state_specs."""
    specs = state_specs(cfg)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


def render_frame_spmd(scene, cfg, state: RenderState, mats, mesh: Mesh,
                      axis: str = "sp"):
    """One frame through the explicit shard_map path. Convenience wrapper;
    for frame loops build the step once with make_spmd_step."""
    step = make_spmd_step(scene, cfg, mesh, axis)
    state = shard_state(state, cfg, mesh)
    new_state, ldr, rounds = step(scene, state, mats)
    return new_state, ldr, rounds
