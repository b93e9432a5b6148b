"""Configuration tree for the renderer.

Replaces the reference's env-flag + compile-time-constant config surface
(reference: src/lib.rs:42-67, src/utils.rs:5-13, SURVEY.md section 5.6) with
an explicit dataclass so every knob is visible, hashable (jit-static), and
serializable.

Default values mirror the reference's shader constants:
  - bounces=10, shadow_bounces=5  (shaders/ray_gen_final.slang:41-42)
  - virtual_bounces=20            (shaders/ray_gen_ris.slang:69)
  - ris_candidates=16             (shaders/ray_gen_ris.slang:187)
  - di spatial 5 / 30px           (shaders/ray_gen_final.slang:160-161)
  - gi spatial 3 / 20px           (shaders/ray_gen_final.slang:228-229)
  - accumulation_factor=0.14      (shaders/temporal_accumulation.slang:30)
  - denoise_passes=4              (src/lib.rs:42)
  - exposure=1.0                  (src/lib.rs:44)
  - gi_radiance_clamp=5.0         (shaders/ray_gen_ris.slang:394)
  - warmup_frames=16              (src/lib.rs:1927)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (jit-compile-time) render settings.

    Frozen + hashable so it can be closed over by jitted functions; changing
    any field triggers a recompile, mirroring how the reference's pipeline
    cache keys on shader bytes (render_graph/graph.rs:53-120).
    """

    width: int = 1600
    height: int = 1200

    # Path tracing (ray_gen_final.slang:40-42). samples > 1 averages N
    # independently-seeded final passes per frame (in-frame spp — an
    # extension; the reference is fixed 1 spp, ray_gen_final.slang:40).
    samples: int = 1
    bounces: int = 10
    virtual_bounces: int = 20          # mirror/glass passthrough rounds (RIS pass)
    russian_roulette_start: int = 2    # RR applies for bounce > 2 (ray_gen_final.slang:422)

    # Lighting mode:
    #   "restir" — full ReSTIR DI + GI (reference default path)
    #   "nee"    — plain next-event estimation every rough bounce
    #              (the reference's ray_gen_final.slang:328-382 branch)
    #   "brdf"   — BRDF sampling only (emission pickup), for bring-up/oracles
    lighting: str = "restir"
    # Storage dtype for the ReSTIR p_hat/target-function ATTRIBUTE reads
    # (normal, albedo, view, roughness, metallic — never positions or
    # distances): "bf16" halves the device-memory bytes of the reuse
    # evaluations' inputs. p_hat is a resampling target function — any
    # consistent function keeps the estimator valid — so this trades
    # ~0.4%/term weight noise for bandwidth; quality bounded by the
    # converged-truth pins (tests/test_quality.py). "f32" (default) is
    # exact reference arithmetic.
    shading_dtype: str = "f32"

    # ReSTIR DI (ray_gen_ris.slang / ray_gen_final.slang)
    ris_candidates: int = 16
    di_temporal_m_clamp: float = 10.0
    di_temporal_w_clamp: float = 20.0
    di_spatial_samples: int = 5
    di_spatial_radius: float = 30.0
    di_spatial_w_clamp: float = 50.0

    # ReSTIR GI (Ouyang 2021 variant, constants from the reference shaders)
    gi_temporal_m_clamp: float = 12.0
    gi_temporal_w_clamp: float = 10.0
    # Spatial-neighbor M clamp (ray_gen_final.slang:251 uses the same 10.0
    # literal as the DI temporal clamp; a separate knob so tuning either
    # doesn't silently cross-couple DI and GI reuse).
    gi_spatial_m_clamp: float = 10.0
    gi_spatial_samples: int = 3
    gi_spatial_radius: float = 20.0
    gi_spatial_w_clamp: float = 20.0
    gi_radiance_clamp: float = 5.0
    gi_jacobian_clamp: float = 10.0

    # Post pipeline
    enable_taa: bool = True
    accumulation_factor: float = 0.14
    denoise_passes: int = 4            # a-trous, step widths 1,2,4,8
    exposure: float = 1.0
    tonemap: str = "aces"              # "aces" | "aces_srgb" | "none"
    gamma: float = 2.2
    # Primary-silhouette edge antialiasing (render/antialias.py): blends
    # adjacent pixels across silhouettes by the projected edge crossing —
    # analytic edge AA in forward, and the boundary (visibility) gradient
    # term for vertices/camera in reverse (nvdiffrast-antialias analog).
    # Off by default: costs one extra primary trace per frame.
    edge_antialias: bool = False

    # Contribution clamps (ray_gen_final.slang:378,431)
    nee_contrib_clamp: float = 5.0
    radiance_clamp: float = 10.0

    # Offline-render warm-up (lib.rs:1927): ReSTIR temporal reuse + TAA need
    # history before the output is meaningful.
    warmup_frames: int = 16

    # Tracing backend. "auto": brute force (every ray against every
    # triangle) up to brute_force_max_tris, then a scalable backend
    # chosen from the scene's shape by Renderer._auto_big_mode: the
    # two-level backend (ops/bvh2.py: per-mesh object-space BLASes built
    # once and shared across instances + a per-frame in-jit instance TLAS)
    # when >= 2 instances all have BLASes <= bvh2_blas_max_tris, else the
    # binned cluster-culled stream tracer (ops/binned_trace.py: Morton
    # clusters of cluster_k triangles + conservative per-ray-block
    # culling). Both need the load-time structure passed as `accel` — the
    # Renderer manages that; `make_tracer` without an accel falls back to
    # a unified in-jit LBVH. "bvh" forces the unified world BVH (one tree
    # over all world triangles, host SAH + in-jit refit);
    # "bvh2"/"binned"/"brute" force those paths. The crossovers were
    # tuned on an earlier accelerator and are not yet re-derived on the
    # H100 (ROADMAP).
    tracer: str = "auto"       # "auto" | "brute" | "bvh" | "bvh2" | "binned"
    brute_force_max_tris: int = 512
    bvh_leaf_size: int = 4
    cluster_k: int = 128               # triangles per binned-tracer cluster
    # Largest per-mesh BLAS the auto policy will hand to the two-level
    # stack-walk backend; bigger meshes go to the binned stream tracer.
    bvh2_blas_max_tris: int = 8192
    # Rays per trace block of the jnp brute path (lax.map step). Too small
    # serializes the frame into thousands of micro-kernels; large blocks
    # amortize launch overhead while keeping (B, T) intermediates bounded.
    trace_block_rays: int = 1 << 18

    # Spatial-reuse neighbor taps:
    #   "shared"   — one disc offset per reuse iteration, shared by all
    #                pixels (drawn from a frame-seeded scalar stream). Taps
    #                become whole-image shifts instead of per-pixel random
    #                gathers (chosen for an earlier accelerator's slow
    #                gathers; the H100 cost of "perpixel" is not measured
    #                yet — ROADMAP).
    #   "perpixel" — the reference's per-pixel random disc offsets
    #                (ray_gen_final.slang:164-167), exact parity, slower.
    spatial_taps: str = "shared"

    # Banded history gathers (ops/banded.py): the temporal-reuse and TAA
    # history reads gather from a [band +/- halo]-row window around each
    # destination row band. Only taken when history_gather_force=True
    # (plain full-table gathers otherwise). History farther than `halo`
    # rows vertically is rejected exactly like off-screen history. Also the
    # temporal halo of the SPMD row-sharded frame (parallel/spmd.py).
    history_gather_band: int = 16
    history_gather_halo: int = 16
    # "rows": gather rows of the packed (P, C) history table; "lanes":
    # gather on the transposed (C, P) table; "flat": 1-D window slices +
    # contiguous-C gathers; "out_t": (C, P) output. Forced banded path
    # only.
    history_gather_layout: str = "rows"
    # Forced-path strategy (history_gather_force=True): "banded" =
    # windowed dynamic gathers (above); "shift" = no gather at all — one
    # compare+select per offset in a (2r+1)^2 neighborhood over
    # flat-rolled tables (ops/banded.shift_row_gather), with global-motion
    # compensation (one dynamic roll by the mean reprojection offset);
    # per-pixel deviation beyond `shift_radius` px is rejected like
    # off-screen history. Static cameras are bit-identical to plain
    # gathers. "auto": one lax.cond per history read on the fraction of
    # lanes whose residual motion fits the shift radius (shift branch) vs
    # banded (docs/PARITY.md).
    history_gather_mode: str = "auto"
    history_shift_radius: int = 1
    # "auto" falls back to banded when the predicted shift-history
    # retention (fraction of on-screen lanes within the radius of the
    # mean motion) would drop below this.
    history_auto_min_retention: float = 0.98
    # Shift mode: compensate uniform camera motion with one dynamic roll
    # by the mean reprojection offset (ops/banded.shift_row_gather) so
    # arbitrary-speed pans keep history; residual deviation beyond the
    # radius is still rejected.
    history_shift_global: bool = True
    # True takes the banded/shift history-read ladder above; None/False
    # (default) read history with plain gathers. The ladder's H100 cost is
    # not measured yet (ROADMAP design 3.2).
    history_gather_force: "bool | None" = None
    # Joint DI+GI temporal-history gather: one shared jittered
    # reprojection + ONE packed (P, C_di+C_gi) banded row gather instead
    # of two independent gathers with independent jitters (the reference
    # draws per-pass jitters, ray_gen_ris.slang:233/:408; the shared draw
    # correlates only that half-pixel jitter — quality pinned by
    # tests/test_quality.py converged-truth bounds). Halves the
    # history-gather fixed cost in the frame program.
    history_joint_gather: bool = False

    # Face-forward normals (OPT-IN divergence from the reference):
    # closest_hit.slang:49-50 stores the interpolated normal UNFLIPPED, so
    # single-sided surfaces seen from their backface offset shadow rays
    # INTO the geometry and leak light as firefly speckle (docs/PARITY.md
    # "Observed artifact"). When True, shading and geometric normals are
    # flipped to face the incoming ray (sign of geo_normal . ray_dir),
    # suppressing that leak class for every backface pixel. Default False =
    # exact reference behavior (parity goldens unchanged). A/B pair:
    # docs/renders/face_forward_{off,on}.png.
    face_forward_normals: bool = False

    # Any-hit alpha cutout (any_hit.slang): jit-static because the scene is
    # traced inside the frame; the Renderer auto-sets it from the concrete
    # scene (scenes without MASK materials keep the tight opaque-only path,
    # matching the reference's OPAQUE-flagged geometry, blas.rs:276).
    alpha_mask_tracing: bool = False

    # Differentiability: when True the frame function avoids non-differentiable
    # packing in hot paths and stops gradients only through discrete choices.
    differentiable: bool = False
    # Shadow-boundary (visibility) gradients for first-bounce NEE: adds
    # the silhouette-edge boundary integral as a zero-forward term
    # (render/boundary.py — the missing term behind the measured AD=0 vs
    # FD+0.67 occlusion envelope). Requires differentiable=True, the
    # "nee" OR "restir" lighting path (restir: injected at the frozen
    # first-rough hits — the frame estimates the same NEE area integral),
    # and scene edge topology (boundary.with_edge_topology).
    shadow_boundary_grads: bool = False
    # Per-pixel silhouette-candidate pruning (VERDICT r4 item 6): 0 runs
    # the dense O(P*E*L*S) quadrature over EVERY edge (exact; CI scenes);
    # K > 0 scores edges per pixel (silhouette class + margin-expanded
    # projected-inside test) and integrates only the top K — matches the
    # dense gradient to float precision when no pixel has more than K
    # active silhouette edges (pinned in tests/test_grads.py; Cornell
    # needs K >= 8), and drops overflow edges' contribution beyond that.
    shadow_boundary_candidates: int = 0

    # Numerics
    dtype: str = "float32"

    def with_size(self, width: int, height: int) -> "RenderConfig":
        return dataclasses.replace(self, width=width, height=height)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def shadow_bounces(self) -> int:
        # SHADOW_BOUNCES = BOUNCES / 2 (ray_gen_final.slang:42)
        return self.bounces // 2


# A small config for tests / CPU smoke runs.
TEST_CONFIG = RenderConfig(
    width=64,
    height=48,
    bounces=4,
    virtual_bounces=4,
    ris_candidates=4,
    di_spatial_samples=2,
    gi_spatial_samples=1,
    denoise_passes=2,
    warmup_frames=2,
)
