"""Tracer dispatch: one interface over the brute-force and BVH backends,
plus any-hit alpha cutout.

The structural analog of the reference's TLAS handle + TraceRay: passes ask
for closest-hit or occlusion queries and don't care how traversal happens
(accel.rs builds the structure; shaders just call TraceRay). `make_tracer`
plays the role of the BLAS/TLAS build step — it is called inside the jitted
frame function, so acceleration data is rebuilt from the (differentiable)
world geometry every frame; XLA CSEs it across passes within the frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sunray_tpu.ops import intersect
from sunray_tpu.ops import bvh as bvh_mod
from sunray_tpu.ops import pallas_trace


def big_scene_mode(tri_inst, n_inst: int, bvh2_blas_max_tris: int) -> str:
    """Scalable backend for tracer="auto" above the brute crossover:
    "bvh2" when >= 2 instances all have small BLASes (shallow stack walks,
    shared meshes); "binned" when a big mesh dominates or the scene is one
    instance (stack walks collapse on big trees). tri_inst: host (T,)
    instance id per world triangle."""
    largest = int(np.bincount(np.asarray(tri_inst), minlength=1).max())
    return ("bvh2" if n_inst >= 2 and largest <= bvh2_blas_max_tris
            else "binned")


def resolve_tracer(cfg, scene) -> str:
    """The tracer a Renderer frame uses for `scene`: cfg.tracer, or for
    "auto" brute force up to cfg.brute_force_max_tris and
    big_scene_mode above it."""
    if cfg.tracer != "auto":
        return cfg.tracer
    if scene.num_tris <= cfg.brute_force_max_tris:
        return "brute"
    return big_scene_mode(scene.tri_inst, int(scene.inst_prim.shape[0]),
                          cfg.bvh2_blas_max_tris)


class TracerCtx(NamedTuple):
    tris: tuple                      # (v0, v1, v2) world-space, each (T, 3)
    bvh: Optional[object]            # ops.bvh.Bvh or None for brute force
    block: int                       # ray block size
    # Two-level backend (ops/bvh2.py): per-frame Tlas2 built from a
    # load-time BlasSet passed as `accel`. Mutually exclusive with `bvh`.
    bvh2: Optional[object] = None
    # Binned backend (ops/binned_trace.py): load-time ClusterSet passed as
    # `accel`, refit in-jit per frame. Mutually exclusive with bvh/bvh2.
    binned: Optional[object] = None
    # Alpha-cutout support (any_hit.slang:11-43): None when the scene has no
    # MASK materials (the common case — reference marks geometry OPAQUE,
    # blas.rs:276 — so the fast path stays tight), else the scene pytree for
    # per-hit alpha evaluation.
    alpha_scene: Optional[object] = None
    alpha_rounds: int = 4            # max cutout skips per query


def make_tracer(scene, cfg, accel=None) -> TracerCtx:
    """Build the per-frame tracer context.

    accel: optional prebuilt BVH topology (e.g. the native binned-SAH
    builder's output, or a cached LBVH). When provided, its boxes are
    refit against the current (differentiable) world triangles — the AS
    UPDATE path — so instance-transform animation needs no rebuild.

    Alpha-masked traversal is a jit-static decision (cfg.alpha_mask_tracing,
    auto-set by the Renderer from the concrete scene) because the scene is
    traced inside the frame function.
    """
    # The whole tracer context is non-differentiable BY CONSTRUCTION:
    # traversal is a discrete oracle (Pallas kernels with no AD rules;
    # topology/refit math whose gradients are meaningless), and gradients
    # flow through the hit-attribute recompute in render/shade.py
    # instead. stop_gradient here keeps reverse-mode AD from ever
    # descending into the trace kernels — without it, a differentiable
    # frame dies in pallas_call's jvp rule (the tangents of
    # scene.positions reach the kernel operands through the refit).
    sg = jax.lax.stop_gradient
    tris = jax.tree_util.tree_map(sg, scene.world_triangle_vertices())
    n_tris = scene.num_tris
    alpha_scene = (
        jax.tree_util.tree_map(sg, scene)
        if getattr(cfg, "alpha_mask_tracing", False) else None
    )
    scene = jax.tree_util.tree_map(sg, scene)
    if accel is not None:
        from sunray_tpu.ops import binned_trace as binned_mod
        from sunray_tpu.ops import bvh2 as bvh2_mod

        if isinstance(accel, binned_mod.ClusterSet):
            # Binned path: cluster assignment is load-time topology; the
            # pack + AABBs refit here from the current world geometry.
            return TracerCtx(
                tris=tris,
                bvh=None,
                block=cfg.trace_block_rays,
                binned=binned_mod.refit_cluster_set(accel, tris),
                alpha_scene=alpha_scene,
            )
        if isinstance(accel, bvh2_mod.BlasSet):
            # Two-level path: object-space BLASes are static; only the tiny
            # instance TLAS is (re)built here, every frame (the
            # tlas.rs:155-191 per-frame queue_build analog).
            return TracerCtx(
                tris=tris,
                bvh=None,
                block=cfg.trace_block_rays,
                bvh2=bvh2_mod.build_frame_tlas(accel, scene),
                alpha_scene=alpha_scene,
            )
        return TracerCtx(
            tris=tris,
            bvh=bvh_mod.refit_bvh(accel, tris),
            block=cfg.trace_block_rays,
            alpha_scene=alpha_scene,
        )
    use_bvh = cfg.tracer == "bvh" or (
        cfg.tracer == "auto" and n_tris > cfg.brute_force_max_tris
    )
    bvh = bvh_mod.build_bvh(tris, leaf_size=cfg.bvh_leaf_size) if use_bvh else None
    return TracerCtx(
        tris=tris, bvh=bvh, block=cfg.trace_block_rays,
        alpha_scene=alpha_scene,
    )


def ctx_block(cfg) -> int:
    return cfg.trace_block_rays


def _alpha_accepts(scene, tri, u, v):
    """Any-hit alpha test (any_hit.slang:11-43): True = hit accepted.

    OPAQUE materials accept immediately; MASK materials sample base color
    alpha at the interpolated base-color UV and reject below the cutoff.
    """
    import jax.numpy as jnp_  # local alias to avoid shadowing

    from sunray_tpu.ops.linalg import gather_vec
    from sunray_tpu.ops.texture import sample_texture
    from sunray_tpu.scene.types import ALPHA_MASK, TEX_BASE_COLOR

    inst = gather_vec(scene.tri_inst, tri)
    prim = gather_vec(scene.inst_prim, inst)
    mats = scene.materials
    mode = gather_vec(mats.alpha_mode, prim)
    is_mask = mode == ALPHA_MASK

    vidx = gather_vec(scene.tri_vidx, tri)            # (N, 3)
    # Per-corner (N, 2) gathers + weighted sum: no (N, 3, 2) intermediate
    # (see render/shade.py).
    uv_table = scene.uvs[:, TEX_BASE_COLOR, :]
    weights = [1.0 - u - v, u, v]
    uv = sum(
        wk[:, None] * gather_vec(uv_table, vidx[:, k])
        for k, wk in enumerate(weights)
    )

    base_f = gather_vec(mats.base_color, prim)
    tex = gather_vec(mats.tex_index[:, TEX_BASE_COLOR], prim)
    color = sample_texture(scene.textures, tex, uv, base_f)
    cutoff = gather_vec(mats.alpha_cutoff, prim)
    return ~is_mask | (color[..., 3] >= cutoff)


def _raw_closest(ctx, orig, d, tmin, tmax, coherent=True):
    if ctx.binned is not None:
        from sunray_tpu.ops import binned_trace as binned_mod

        # Incoherent batches take the PAIR-STREAM path (per-ray cluster
        # scan + pair work list, exact vs the block path); coherent batches
        # keep the block-culled path with the coherence reorder (camera
        # blocks are already tight, and the pair expansion's sorts
        # dominate). The split was chosen on an earlier accelerator; not
        # measured on the H100.
        if not coherent:
            return binned_mod.trace_closest_pairs(
                ctx.binned, orig, d, tmin, tmax
            )
        return binned_mod.trace_closest_binned(
            ctx.binned, orig, d, tmin, tmax, reorder=True
        )
    if ctx.bvh2 is not None:
        from sunray_tpu.ops import bvh2 as bvh2_mod

        return bvh2_mod.trace_closest_bvh2(
            ctx.bvh2, orig, d, tmin, tmax,
            block=min(ctx.block, bvh_mod.TRAVERSE_BLOCK),
        )
    if ctx.bvh is not None:
        return bvh_mod.trace_closest_bvh(
            ctx.bvh, ctx.tris, orig, d, tmin, tmax,
            block=min(ctx.block, bvh_mod.TRAVERSE_BLOCK),
        )
    return intersect.Hit(*_brute_query(
        lambda *a: tuple(pallas_trace.trace_closest_pallas(ctx.tris, *a)),
        lambda *a: tuple(intersect.trace_closest_brute(ctx.tris, *a,
                                                       block=ctx.block)),
        orig, d, tmin, tmax,
    ))


def _brute_query(pallas_fn, xla_fn, *args):
    """Run a brute-force query as the Triton kernel (ops/pallas_trace.py)
    in programs compiled for CUDA and as the jnp Moller-Trumbore planes
    (ops/intersect.py) for any other target. A lowering rule
    (lax.platform_dependent), decided per compiled program by its target
    platform; a process default backend plays no part. Kernel-vs-XLA
    times on the H100 are in PERF.md ("Kernel decisions")."""
    return jax.lax.platform_dependent(*args, cuda=pallas_fn, default=xla_fn)


@jax.named_scope("trace")
def trace_closest(ctx: TracerCtx, orig, d, tmin=intersect.T_MIN,
                  tmax=intersect.T_MAX, coherent=True):
    """coherent=False: the caller knows the batch is incoherent
    (bounce/GI rays) — the binned backend coherence-sorts it first
    (ops/binned_trace._coherence_keys); other backends ignore the hint
    (the brute kernel and per-ray walks are order-independent)."""
    # The tracer is a discrete oracle: gradients flow through the
    # differentiable hit-attribute recompute in render/shade.py, never
    # through traversal itself (which may run as a Pallas kernel with no
    # AD rule). Ray INPUTS are stopped too — differentiable ray origins
    # (camera/vertex tangents) must not drag AD into the kernel call.
    sg = jax.lax.stop_gradient
    orig, d, tmin, tmax = sg(orig), sg(d), sg(tmin), sg(tmax)
    hit = _raw_closest(ctx, orig, d, tmin, tmax, coherent=coherent)
    hit = jax.tree_util.tree_map(sg, hit)
    if ctx.alpha_scene is None:
        return hit
    # Alpha cutout: re-trace past rejected MASK hits (IgnoreHit analog),
    # up to alpha_rounds skips per ray.

    def cond(carry):
        hit, _ = carry
        accepted = ~hit.hit | _alpha_accepts(
            ctx.alpha_scene, hit.tri, hit.u, hit.v
        )
        return jnp.any(~accepted)

    def body(carry):
        hit, rounds = carry
        accepted = ~hit.hit | _alpha_accepts(
            ctx.alpha_scene, hit.tri, hit.u, hit.v
        )
        new_tmin = jnp.where(accepted, tmin, hit.t + 1e-4)
        nxt = _raw_closest(ctx, orig, d, new_tmin, tmax)
        merged = intersect.Hit(
            t=jnp.where(accepted, hit.t, nxt.t),
            tri=jnp.where(accepted, hit.tri, nxt.tri),
            u=jnp.where(accepted, hit.u, nxt.u),
            v=jnp.where(accepted, hit.v, nxt.v),
            hit=jnp.where(accepted, hit.hit, nxt.hit),
        )
        return merged, rounds + 1

    def cond2(carry):
        return cond(carry) & (carry[1] < ctx.alpha_rounds)

    hit, _ = jax.lax.while_loop(cond2, body, (hit, jnp.int32(0)))
    return hit


@jax.named_scope("trace")
def trace_occluded(ctx: TracerCtx, orig, d, tmax, tmin=intersect.T_MIN,
                   exclude=None, coherent=True):
    """Boolean occlusion along segments. Degenerate segments (< 2e-3, the
    reference's TMax<TMin guard, e.g. ray_gen_ris.slang:287) are visible.

    exclude: per-ray triangle id to ignore — the shadow ray's own target
    triangle (a light sample or a reprojected GI surface point lies ON
    geometry; excluding it by id replaces the reference's self-occluding
    absolute TMax epsilon)."""
    # Same AD boundary as trace_closest: occlusion is a step function of
    # discrete traversal — stop the ray-input tangents at the kernel.
    sg = jax.lax.stop_gradient
    orig, d, tmin, tmax = sg(orig), sg(d), sg(tmin), sg(tmax)
    tmax = jnp.asarray(tmax)
    degenerate = tmax - tmin <= intersect.T_MIN
    if ctx.alpha_scene is not None:
        # Alpha-aware occlusion: walk closest hits, skipping cutouts, until
        # an accepted (opaque or alpha-passing) hit or none remain.
        n = orig.reshape(-1, 3).shape[0]
        o2 = orig.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        tmax2 = jnp.broadcast_to(tmax.reshape(-1), (n,)) - 1e-3
        ex = None if exclude is None else jnp.asarray(exclude).reshape(-1)

        def body(carry):
            cur_tmin, occluded, undecided, rounds = carry
            hit = _raw_closest(ctx, o2, d2, cur_tmin, tmax2)
            live = undecided & hit.hit
            if ex is not None:
                not_excluded = hit.tri != ex
            else:
                not_excluded = jnp.ones((n,), bool)
            accepted = live & not_excluded & _alpha_accepts(
                ctx.alpha_scene, hit.tri, hit.u, hit.v
            )
            occluded = occluded | accepted
            undecided = live & ~accepted
            cur_tmin = jnp.where(undecided, hit.t + 1e-4, cur_tmin)
            return cur_tmin, occluded, undecided, rounds + 1

        def cond(carry):
            _, _, undecided, rounds = carry
            return jnp.any(undecided) & (rounds < ctx.alpha_rounds + 1)

        init = (
            jnp.full((n,), tmin, jnp.float32),
            jnp.zeros((n,), bool),
            jnp.ones((n,), bool),
            jnp.int32(0),
        )
        _, occ, _, _ = jax.lax.while_loop(cond, body, init)
        return occ & ~degenerate
    if ctx.binned is not None:
        from sunray_tpu.ops import binned_trace as binned_mod

        if not coherent:
            occ = binned_mod.trace_occluded_pairs(
                ctx.binned, orig, d, tmax - 1e-3, tmin, exclude=exclude,
            )
        else:
            occ = binned_mod.trace_occluded_binned(
                ctx.binned, orig, d, tmax - 1e-3, tmin, exclude=exclude,
                reorder=True,
            )
    elif ctx.bvh2 is not None:
        from sunray_tpu.ops import bvh2 as bvh2_mod

        occ = bvh2_mod.trace_occluded_bvh2(
            ctx.bvh2, orig, d, tmax - 1e-3, tmin, exclude,
            block=min(ctx.block, bvh_mod.TRAVERSE_BLOCK),
        )
    elif ctx.bvh is not None:
        occ = bvh_mod.trace_occluded_bvh(
            ctx.bvh, ctx.tris, orig, d, tmax - 1e-3, tmin, exclude,
            block=min(ctx.block, bvh_mod.TRAVERSE_BLOCK),
        )
    else:
        ex = () if exclude is None else (exclude,)
        occ = _brute_query(
            lambda o, dd, tx, tn, *e: pallas_trace.trace_occluded_pallas(
                ctx.tris, o, dd, tx, tn, *e),
            lambda o, dd, tx, tn, *e: intersect.trace_occluded_brute(
                ctx.tris, o, dd, tx, tn, ctx.block, *e),
            orig, d, tmax - 1e-3, tmin, *ex,
        )
    return occ & ~degenerate
