"""Pass 1 — primary trace + G-buffer + ReSTIR DI audition + GI initial sample.

Wavefront port of shaders/ray_gen_ris.slang:12-440. The per-thread megakernel
becomes staged full-batch computation:

  phase 1: virtual-bounce walk (glass/mirror passthrough to the first diffuse
           surface, <=20 rounds, ray_gen_ris.slang:69-141) as a
           lax.while_loop over full ray batches with an active mask — the
           loop exits as soon as no lane is refractive/reflective, so typical
           scenes pay 1-3 trace rounds, not 20.
  phase 2: RIS audition (16 candidates) + DI temporal reuse + one visibility
           ray for the winner (Bitterli visibility reuse,
           ray_gen_ris.slang:174-302).
  phase 3: GI initial sample: one cosine bounce + NEE at x2 + GI temporal
           reuse (ray_gen_ris.slang:311-439).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sunray_tpu.camera import generate_rays, project_to_prev_uv
from sunray_tpu.ops import rng as rng_mod
from sunray_tpu.ops.brdf import (
    cosine_hemisphere,
    dot,
    gi_target_pdf,
    normalize,
    reflect,
    refract,
    vec_norm,
    PI,
)
from sunray_tpu.ops import intersect
from sunray_tpu.ops.loops import bounded_loop
from sunray_tpu.render import restir
from sunray_tpu.render.shade import shade_hits
from sunray_tpu.render.trace import trace_closest, trace_occluded

SKY_DEPTH = 100000.0  # ray_gen_ris.slang:155 sentinel


class GBuffer(NamedTuple):
    """Flat (P,) G-buffer (depth/normal/diffuse/motion images of the RIS pass)."""

    depth: jnp.ndarray      # (P,)
    normal: jnp.ndarray     # (P, 3)
    roughness: jnp.ndarray  # (P,)  (stored in normal_img.a in the reference)
    diffuse: jnp.ndarray    # (P, 3) demodulation albedo lerp(albedo, 1, metallic)
    motion: jnp.ndarray     # (P, 2)


class PrimaryHit(NamedTuple):
    """First-diffuse-surface data kept for RIS/GI (register state in the
    reference's megakernel)."""

    found: jnp.ndarray              # (P,) bool
    pos: jnp.ndarray                # (P, 3)
    normal: jnp.ndarray             # (P, 3)
    albedo: jnp.ndarray             # (P, 3)
    roughness: jnp.ndarray          # (P,)
    metallic: jnp.ndarray           # (P,)
    v_view: jnp.ndarray             # (P, 3)
    first_tri: jnp.ndarray          # (P,) raw first-hit triangle (-1 miss)
    first_t: jnp.ndarray            # (P,) raw first-hit distance (1e9 miss)
    virtual_distance: jnp.ndarray   # (P,)
    prev_uv: jnp.ndarray            # (P, 2)
    prev_valid: jnp.ndarray         # (P,)


def transmissive_bounce(seed, ray_d, surf_normal, surf_ior, surf_pos):
    """Glass interaction (ray_gen_ris.slang:95-114 == ray_gen_final:106-131
    minus throughput). Returns (seed, new_dir, new_origin, was_refracted,
    is_inside)."""
    is_inside = dot(ray_d, surf_normal) > 0.0
    n = jnp.where(is_inside[:, None], -surf_normal, surf_normal)
    ior = jnp.maximum(surf_ior, 1.0)
    eta = jnp.where(is_inside, ior, 1.0 / ior)
    cos_theta = jnp.minimum(dot(-ray_d, n), 1.0)
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    fresnel = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    refracted = refract(ray_d, n, eta)
    tir = vec_norm(refracted) < 0.01
    fresnel = jnp.where(tir, 1.0, fresnel)
    seed, u = rng_mod.rnd(seed)
    reflects = u < fresnel
    new_d = jnp.where(reflects[:, None], reflect(ray_d, n), refracted)
    new_o = surf_pos + new_d * 1e-3
    return seed, new_d, new_o, ~reflects, is_inside


def primary_walk(scene, cfg, tracer, origins, dirs, seed):
    """Phase 1: walk to the first diffuse surface. Returns (seed, PrimaryHit
    without reprojection fields filled, last surf for debugging)."""
    p = origins.shape[0]
    z3 = jnp.zeros((p, 3), jnp.float32)
    z = jnp.zeros((p,), jnp.float32)

    init = dict(
        i=jnp.int32(0),
        seed=seed,
        ray_o=origins,
        ray_d=dirs,
        active=jnp.ones((p,), bool),
        found=jnp.zeros((p,), bool),
        virtual_distance=z,
        pos=z3,
        normal=z3,
        albedo=z3,
        roughness=jnp.full((p,), 0.5),
        metallic=z,
        v_view=z3,
        first_tri=jnp.full((p,), -1, jnp.int32),
        first_t=jnp.full((p,), 1e9, jnp.float32),
    )

    def cond(c):
        return (c["i"] < cfg.virtual_bounces) & jnp.any(c["active"])

    def body(c, coherent=True, first=False):
        hit = trace_closest(tracer, c["ray_o"], c["ray_d"],
                            coherent=coherent)
        if first:
            # Shade round 0 through the SAME reconstructed-hit
            # expression the final pass's reuse path builds from
            # (first_tri, first_t) — the two shade_hits subgraphs then
            # have identical operands and XLA CSE merges them (one
            # shade of the camera hit per frame instead of two).
            # Bit-identical: shade recomputes u/v differentiably for
            # hit lanes and miss-lane garbage never escapes the masks.
            tri0 = jnp.where(hit.hit, hit.tri, -1)
            t0 = jnp.where(hit.hit, hit.t, jnp.float32(1e9))
            hm = tri0 >= 0
            hit = intersect.Hit(
                t=jnp.where(hm, t0, jnp.inf),
                tri=jnp.maximum(tri0, 0),
                u=jnp.zeros_like(t0),
                v=jnp.zeros_like(t0),
                hit=hm,
            )
        surf = shade_hits(scene, c["ray_o"], c["ray_d"], hit,
                          face_forward=cfg.face_forward_normals)
        live = c["active"] & surf.valid
        miss = c["active"] & ~surf.valid

        roughness = jnp.maximum(surf.roughness, 0.01)
        metallic = jnp.clip(surf.metallic, 0.0, 1.0)
        vd = c["virtual_distance"] + jnp.where(live, surf.dist, 0.0)

        transmissive = live & (surf.transmission > 0.5)
        mirror = live & ~transmissive & (metallic > 0.9) & (roughness < 0.1)
        diffuse = live & ~transmissive & ~mirror

        seed, d_trans, o_trans, _, _ = transmissive_bounce(
            c["seed"], c["ray_d"], surf.normal, surf.ior, surf.pos
        )
        d_mir = reflect(c["ray_d"], surf.normal)
        o_mir = surf.pos + surf.normal * 1e-3

        sel3 = lambda m, a, b: jnp.where(m[:, None], a, b)
        ray_d = sel3(transmissive, d_trans, sel3(mirror, d_mir, c["ray_d"]))
        ray_o = sel3(transmissive, o_trans, sel3(mirror, o_mir, c["ray_o"]))

        rec = diffuse  # lanes recording their first diffuse surface
        is_first = c["i"] == 0
        return dict(
            i=c["i"] + 1,
            seed=seed,
            ray_o=ray_o,
            ray_d=ray_d,
            active=c["active"] & ~miss & ~diffuse,
            found=c["found"] | diffuse,
            virtual_distance=vd,
            pos=sel3(rec, surf.pos, c["pos"]),
            normal=sel3(rec, surf.normal, c["normal"]),
            albedo=sel3(rec, surf.albedo, c["albedo"]),
            roughness=jnp.where(rec, roughness, c["roughness"]),
            metallic=jnp.where(rec, metallic, c["metallic"]),
            v_view=sel3(rec, -c["ray_d"], c["v_view"]),
            # Raw FIRST-hit visibility (pre mirror/glass walk) — reused by
            # the edge-AA pass and the final pass's peeled round (which
            # rebuilds EXACTLY the hit expression shaded above, see the
            # `first` branch) so neither re-traces primary rays.
            first_tri=jnp.where(
                is_first, jnp.where(hit.hit, hit.tri, -1), c["first_tri"]
            ),
            first_t=jnp.where(
                is_first, jnp.where(hit.hit, hit.t, 1e9), c["first_t"]
            ),
        )

    # peel=1: the primary-ray round always runs; fusing it with the frame
    # avoids one while_loop carry materialization (ops/loops.py).
    c = bounded_loop(cond, lambda c: body(c, first=True), init,
                     cfg.virtual_bounces, cfg.differentiable,
                     loop_body=lambda c: body(c, coherent=False),
                     peel=1)
    return c


def ris_pass(scene, cfg, tracer, lights, mats, prev_view_proj,
             res_di_hist: restir.ReservoirDI, res_gi_hist: restir.ReservoirGI,
             frame_count, grid=None):
    """Full pass 1. Returns (GBuffer, ReservoirDI, ReservoirGI).

    grid (parallel/halo.ShardGrid): shard_map row-sharded mode — all per-
    pixel arrays cover this shard's rows only; pixel ids / uv / reprojection
    stay GLOBAL (bit-matching the single-device pass), and the temporal
    history gathers halo-exchange via ppermute."""
    w, h = cfg.width, cfg.height
    if grid is not None:
        hl = grid.hl
        p = w * hl
        origins, dirs = generate_rays(mats, w, h, row0=grid.row0, rows=hl)
        pix0 = grid.row0.astype(jnp.uint32) * jnp.uint32(w)
        iy = grid.row0.astype(jnp.float32) + jnp.arange(hl, dtype=jnp.float32)
    else:
        hl = h
        p = w * h
        origins, dirs = generate_rays(mats, w, h)
        pix0 = jnp.uint32(0)
        iy = jnp.arange(h, dtype=jnp.float32)
    origins = origins.reshape(p, 3)
    dirs = dirs.reshape(p, 3)

    pix = pix0 + jnp.arange(p, dtype=jnp.uint32)
    seed = rng_mod.init_seed(pix, frame_count.astype(jnp.uint32))

    walk = primary_walk(scene, cfg, tracer, origins, dirs, seed)
    seed = walk["seed"]
    found = walk["found"]

    # Reprojection + motion vectors (ray_gen_ris.slang:118-136).
    ix = jnp.arange(w, dtype=jnp.float32)
    uu, vv = jnp.meshgrid((ix + 0.5) / w, (iy + 0.5) / h)
    in_uv = jnp.stack([uu, vv], axis=-1).reshape(p, 2)

    virtual_pos = origins + dirs * walk["virtual_distance"][:, None]
    prev_uv, prev_valid = project_to_prev_uv(prev_view_proj, virtual_pos)
    motion = jnp.where(
        prev_valid[:, None], in_uv - prev_uv, in_uv + 2.0
    )

    gbuf = GBuffer(
        depth=jnp.where(found, walk["virtual_distance"], SKY_DEPTH),
        normal=jnp.where(found[:, None], walk["normal"], 0.0),
        roughness=jnp.where(found, walk["roughness"], 0.0),
        diffuse=jnp.where(
            found[:, None],
            walk["albedo"] * (1.0 - walk["metallic"][:, None])
            + walk["metallic"][:, None],
            0.0,
        ),
        motion=jnp.where(found[:, None], motion, 0.0),
    )

    walk_rounds = walk["i"]
    hitd = PrimaryHit(
        found=found,
        first_tri=walk["first_tri"],
        first_t=walk["first_t"],
        pos=walk["pos"],
        normal=walk["normal"],
        albedo=walk["albedo"],
        roughness=walk["roughness"],
        metallic=walk["metallic"],
        v_view=walk["v_view"],
        virtual_distance=walk["virtual_distance"],
        prev_uv=prev_uv,
        prev_valid=prev_valid,
    )

    if cfg.lighting != "restir" or lights.num == 0:
        return gbuf, restir.ReservoirDI.empty(p), restir.ReservoirGI.empty(p), hitd, walk_rounds

    # --- Phase 2: RIS + temporal + visibility (DI) ---
    # p_hat attribute reads in the storage dtype (cfg.shading_dtype —
    # positions/distances stay f32; see config.py).
    sd = jnp.bfloat16 if cfg.shading_dtype == "bf16" else jnp.float32
    nrm_s = walk["normal"].astype(sd)
    alb_s = walk["albedo"].astype(sd)
    view_s = walk["v_view"].astype(sd)
    rough_s = walk["roughness"].astype(sd)
    metal_s = walk["metallic"].astype(sd)
    enable_di = found & (walk["roughness"] > 0.2)
    seed, r_di = restir.ris_audition(
        lights, seed, walk["pos"], nrm_s, view_s,
        alb_s, rough_s, metal_s,
        cfg.ris_candidates, enable_di,
    )
    if cfg.history_joint_gather:
        # One shared reprojection + one packed banded gather for the DI
        # AND GI histories (restir.gather_temporal_histories); the GI
        # merge below reuses pre_gi instead of re-gathering.
        seed, h_di, h_gi, base_ok = restir.gather_temporal_histories(
            cfg, seed, res_di_hist, res_gi_hist, prev_uv, prev_valid,
            frame_count, found, w, h, grid=grid,
        )
        pre_di, pre_gi = (h_di, base_ok), (h_gi, base_ok)
    else:
        pre_di = pre_gi = None
    seed, r_di = restir.di_temporal_reuse(
        lights, cfg, seed, r_di, res_di_hist, prev_uv, prev_valid, frame_count,
        walk["pos"], nrm_s, view_s, alb_s,
        rough_s, metal_s, walk["virtual_distance"],
        w, h, enable_di, grid=grid, pregathered=pre_di,
    )

    # Visibility reuse (ray_gen_ris.slang:277-302) — the ray is computed
    # here but TRACED together with the GI NEE shadow ray below (the two
    # queries are independent; one 2P-ray kernel call instead of two).
    vis_vec = r_di.light_pos - walk["pos"]
    vis_dist = jnp.maximum(vec_norm(vis_vec), 1e-4)
    vis_dir = vis_vec / vis_dist[:, None]
    facing = dot(walk["normal"], vis_dir) > 0.0
    vis_origin = walk["pos"] + walk["normal"] * 1e-3
    vis_exclude = lights.world_tri[r_di.light_idx]

    # --- Phase 3: GI initial sample (ray_gen_ris.slang:311-406) ---
    seed, g1, g2 = rng_mod.rnd2(seed)
    gi_dir = cosine_hemisphere(walk["normal"], g1, g2)
    gi_ndl = jnp.maximum(dot(walk["normal"], gi_dir), 0.0)
    gi_enable = found & (gi_ndl > 0.0)

    gi_origin = walk["pos"] + walk["normal"] * 1e-3
    gi_hit = trace_closest(tracer, gi_origin, gi_dir, coherent=False)
    gi_surf = shade_hits(scene, gi_origin, gi_dir, gi_hit,
                         face_forward=cfg.face_forward_normals)
    gi_found = gi_enable & gi_surf.valid & (gi_surf.dist > 0.0)

    sample_pos = jnp.where(gi_found[:, None], gi_surf.pos, 0.0)
    sample_normal = jnp.where(gi_found[:, None], gi_surf.normal, 0.0)
    sample_radiance = jnp.where(gi_found[:, None], gi_surf.emission, 0.0)

    # NEE at x2 (ray_gen_ris.slang:344-391).
    seed, u_pick = rng_mod.rnd(seed)
    nee_idx = jnp.minimum(
        (u_pick * lights.num).astype(jnp.int32), lights.num - 1
    )
    seed, n1, n2 = rng_mod.rnd2(seed)
    nee_pos, nee_normal, nee_em, nee_area = lights.sample_point(nee_idx, n1, n2)
    to_light = nee_pos - sample_pos
    nee_dist = jnp.maximum(vec_norm(to_light), 1e-4)
    to_light = to_light / nee_dist[:, None]
    nee_cos_surf = jnp.maximum(dot(sample_normal, to_light), 0.0)
    nee_cos_light = jnp.maximum(dot(nee_normal, -to_light), 0.0)
    nee_try = gi_found & (nee_cos_surf > 0.0) & (nee_cos_light > 0.0)
    occ2 = trace_occluded(
        tracer,
        jnp.concatenate([vis_origin, sample_pos + sample_normal * 1e-3],
                        axis=0),
        jnp.concatenate([vis_dir, to_light], axis=0),
        jnp.concatenate([vis_dist, nee_dist], axis=0),
        exclude=jnp.concatenate(
            [vis_exclude, lights.world_tri[nee_idx]], axis=0
        ),
        coherent=False,
    )
    occluded = occ2[:p]
    nee_occ = occ2[p:]
    keep_w = (r_di.W > 0.0) & facing & ~occluded
    r_di = r_di.replace(
        W=jnp.where(keep_w, r_di.W, 0.0),
        hit_normal=jnp.where(found[:, None], walk["normal"], 0.0),
        depth=walk["virtual_distance"],
    )
    # Sky pixels store an empty reservoir (ray_gen_ris.slang:160-171).
    r_di = jax.tree_util.tree_map(
        lambda x, e: jnp.where(
            found.reshape(found.shape + (1,) * (x.ndim - 1)), x, e
        ),
        r_di,
        restir.ReservoirDI.empty(p),
    )
    nee_ok = nee_try & ~nee_occ
    nee_pdf_sa = (nee_dist * nee_dist) / jnp.maximum(
        nee_cos_light * nee_area * lights.num, 1e-4
    )
    x2_albedo = gi_surf.albedo
    nee_contrib = nee_em * x2_albedo * nee_cos_surf[:, None] / (
        nee_pdf_sa[:, None] * PI
    )
    sample_radiance = sample_radiance + jnp.where(nee_ok[:, None], nee_contrib, 0.0)
    sample_radiance = jnp.minimum(sample_radiance, cfg.gi_radiance_clamp)

    p_hat = gi_target_pdf(
        walk["pos"], nrm_s, alb_s, metal_s,
        sample_pos, sample_radiance,
    )
    pdf = gi_ndl / PI
    w_sum = jnp.where(pdf > 0.0, p_hat / jnp.maximum(pdf, 1e-9), 0.0)
    r_gi = restir.ReservoirGI(
        sample_pos=sample_pos,
        w_sum=jnp.where(gi_enable, w_sum, 0.0),
        sample_radiance=sample_radiance,
        M=jnp.where(gi_enable, 1.0, 0.0),
        sample_normal=sample_normal,
        W=jnp.where(
            gi_enable & (p_hat > 0.0),
            w_sum / jnp.maximum(p_hat, 1e-9),
            0.0,
        ),
        hit_normal=jnp.zeros_like(sample_pos),
        depth=jnp.zeros_like(p_hat),
        sample_tri=jnp.where(gi_found, gi_hit.tri, -1),
    )

    seed, r_gi = restir.gi_temporal_reuse(
        cfg, seed, r_gi, res_gi_hist, prev_uv, prev_valid, frame_count,
        walk["pos"], nrm_s, alb_s, metal_s,
        walk["virtual_distance"], w, h, found, grid=grid,
        pregathered=pre_gi,
    )
    r_gi = r_gi.replace(
        hit_normal=jnp.where(found[:, None], walk["normal"], 0.0),
        depth=walk["virtual_distance"],
    )
    r_gi = jax.tree_util.tree_map(
        lambda x, e: jnp.where(
            found.reshape(found.shape + (1,) * (x.ndim - 1)), x, e
        ),
        r_gi,
        restir.ReservoirGI.empty(p),
    )

    return gbuf, r_di, r_gi, hitd, walk_rounds
