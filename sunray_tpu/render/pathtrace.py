"""Pass 2 — path trace with ReSTIR DI/GI spatial reuse or plain NEE.

Wavefront port of shaders/ray_gen_final.slang:11-436, restructured into
stages (the data-parallel form of the reference's divergent per-thread loop):

  phase A: bounce walk. One closest-hit trace per round over the full batch,
           masked lanes. A lane leaves the walk on miss, emission brightness
           > 1, throughput death, Russian roulette, or on reaching its first
           rough hit within SHADOW_BOUNCES with ReSTIR enabled — in the
           reference that last case runs spatial reuse inline and `break`s
           (ray_gen_final.slang:136-327); here the lane's surface state is
           frozen and handled in phase B so the expensive reuse code runs
           once per frame instead of once per bounce round.
  phase B: ReSTIR DI spatial reuse (5 neighbors / 30 px disc + 1 winner
           shadow ray) and GI spatial reuse (3 neighbors / 20 px disc, one
           visibility ray each + 1 final) over all frozen lanes at once.

In "nee" lighting mode phase A does per-bounce next-event estimation
instead (the ray_gen_final.slang:328-382 branch) and phase B is skipped.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from sunray_tpu.camera import generate_rays
from sunray_tpu.ops import rng as rng_mod
from sunray_tpu.ops.brdf import (
    PI,
    cosine_hemisphere,
    dot,
    eval_p_hat_planar,
    gi_target_pdf,
    gi_target_pdf_planar,
    reflect,
    sample_ggx_vndf,
    smith_g1_ggx,
    vec_norm,
)
from sunray_tpu.ops.linalg import gather_cols
from sunray_tpu.ops.loops import bounded_loop
from sunray_tpu.render import restir
from sunray_tpu.render.gbuffer import transmissive_bounce
from sunray_tpu.render.shade import shade_hits
from sunray_tpu.render.trace import trace_closest, trace_occluded
from sunray_tpu.utils.bluenoise import noise_texture, NOISE_SIZE, _A1, _A2


def _sel3(m, a, b):
    return jnp.where(m[:, None], a, b)


import functools
import numpy as _np


@functools.lru_cache(maxsize=8)
def _blue_noise_tiled(w, h):
    """Host-precomputed tiled noise (the indices are static, so doing the
    tiling in numpy turns two runtime gathers into jit constants).
    Cache holds numpy only — jnp conversion must happen per trace (a cached
    in-trace array would leak a tracer)."""
    noise = noise_texture()
    xs = _np.arange(w) % NOISE_SIZE
    ys = _np.arange(h) % NOISE_SIZE
    bn1 = noise[_np.ix_(ys, xs)].reshape(-1)
    bn2 = noise[
        _np.ix_((_np.arange(h) + 71) % NOISE_SIZE,
                (_np.arange(w) + 47) % NOISE_SIZE)
    ].reshape(-1)
    return bn1, bn2


def _blue_noise_rands(cfg, frame_count, grid=None):
    """Per-pixel first-bounce random pair (ray_gen_final.slang:44-50,393-399).

    grid: shard_map mode — row0 is traced, so instead of numpy-folded
    constants the shard's rows come from a (NOISE_SIZE, W) column-tiled
    table by one small row gather (the table is KBs, cache-resident)."""
    if grid is None:
        bn1_np, bn2_np = _blue_noise_tiled(cfg.width, cfg.height)
        bn1 = jnp.asarray(bn1_np)
        bn2 = jnp.asarray(bn2_np)
    else:
        noise = noise_texture()
        xs = _np.arange(cfg.width) % NOISE_SIZE
        cols1 = jnp.asarray(noise[:, xs])                       # (NS, W)
        cols2 = jnp.asarray(noise[:, (xs + 47) % NOISE_SIZE])
        gy = (grid.global_rows() % NOISE_SIZE).astype(jnp.int32)
        bn1 = cols1[gy].reshape(-1)
        bn2 = cols2[(gy + 71) % NOISE_SIZE].reshape(-1)
    fc = (frame_count % 1024).astype(jnp.float32)
    r1 = jnp.mod(bn1 + fc * _A1, 1.0)
    r2 = jnp.mod(bn2 + fc * _A2, 1.0)
    return r1, r2


def final_pass(scene, cfg, tracer, lights, mats, gbuf,
               r_di: restir.ReservoirDI, r_gi: restir.ReservoirGI,
               frame_count, grid=None, sample_idx: int = 0,
               first_hit=None):
    """-> raw HDR color (P, 3). grid: shard_map row sharding (ris_pass).

    sample_idx: which of cfg.samples per-pixel samples this evaluation is
    (the reference is fixed 1 spp, ray_gen_final.slang:40; cfg.samples > 1
    is a sunray_tpu extension — render_frame averages `samples` salted
    final passes per frame). samples == 1 keeps the round-1 seed stream
    bit-exactly."""
    w, h = cfg.width, cfg.height
    num_lights = lights.num if lights is not None else 0
    use_restir = cfg.lighting == "restir" and num_lights > 0
    use_nee = cfg.lighting == "nee" and num_lights > 0

    if grid is not None:
        p = w * grid.hl
        origins, dirs = generate_rays(mats, w, h, row0=grid.row0,
                                      rows=grid.hl)
        pix0 = grid.row0.astype(jnp.uint32) * jnp.uint32(w)
    else:
        p = w * h
        origins, dirs = generate_rays(mats, w, h)
        pix0 = jnp.uint32(0)
    origins = origins.reshape(p, 3)
    dirs = dirs.reshape(p, 3)
    cam_origin = origins[0]

    pix = pix0 + jnp.arange(p, dtype=jnp.uint32)
    fc = frame_count.astype(jnp.uint32)
    if cfg.samples > 1:
        # Decorrelate the per-sample streams; stride by `samples` so no
        # (frame, sample) pair ever reuses another frame's stream.
        fc = fc * jnp.uint32(cfg.samples) + jnp.uint32(sample_idx)
    seed = rng_mod.init_seed(pix, fc)
    bn_r1, bn_r2 = _blue_noise_rands(cfg, frame_count, grid)

    z3 = jnp.zeros((p, 3), jnp.float32)
    z = jnp.zeros((p,), jnp.float32)
    init = dict(
        i=jnp.int32(0),
        seed=seed,
        ray_o=origins,
        ray_d=dirs,
        throughput=jnp.ones((p, 3), jnp.float32),
        radiance=z3,
        active=jnp.ones((p,), bool),
        prev_did_nee=jnp.zeros((p,), bool),
        # frozen first-rough-hit state for phase B
        pending=jnp.zeros((p,), bool),
        f_pos=z3, f_normal=z3, f_albedo=z3,
        f_rough=z, f_metal=z, f_view=z3, f_throughput=z3,
    )

    def cond(c):
        return (c["i"] < cfg.bounces) & jnp.any(c["active"])

    def body(c, coherent=True, reuse=None, first=False):
        i = c["i"]
        if reuse is not None:
            # The RIS pass already closest-traced these exact camera rays
            # (gbuffer.primary_walk round 0); its stored winner is
            # bit-identical to re-tracing (deterministic tracer), so the
            # final walk's peeled first round reuses it. u/v zeros are
            # fine: shade_hits recomputes them differentiably for hit
            # lanes and never reads them for misses.
            tri0, t0 = reuse
            hm = tri0 >= 0
            from sunray_tpu.ops import intersect as _isect

            hit = _isect.Hit(
                t=jnp.where(hm, t0, jnp.inf),
                tri=jnp.maximum(tri0, 0),
                u=jnp.zeros_like(t0),
                v=jnp.zeros_like(t0),
                hit=hm,
            )
        else:
            hit = trace_closest(tracer, c["ray_o"], c["ray_d"],
                                coherent=coherent)
        surf = shade_hits(scene, c["ray_o"], c["ray_d"], hit,
                          face_forward=cfg.face_forward_normals)
        live = c["active"] & surf.valid
        roughness = jnp.maximum(surf.roughness, 0.01)
        metallic = jnp.clip(surf.metallic, 0.0, 1.0)

        # Emission pickup unless the previous bounce already did NEE
        # (ray_gen_final.slang:99-104).
        add_em = live & ~c["prev_did_nee"]
        radiance = c["radiance"] + jnp.where(
            add_em[:, None], surf.emission * c["throughput"], 0.0
        )
        brightness = jnp.max(surf.emission, axis=-1)
        stop_bright = live & (brightness > 1.0)
        live2 = live & ~stop_bright

        # Transmissive branch (ray_gen_final.slang:106-133).
        trans = live2 & (surf.transmission > 0.5)
        seed2, d_t, o_t, refracted, inside = transmissive_bounce(
            c["seed"], c["ray_d"], surf.normal, surf.ior, surf.pos
        )
        absorb = jnp.exp(-(1.0 - surf.albedo) * surf.dist[:, None] * 5.0)
        tp_refr = jnp.where(inside[:, None], absorb, surf.albedo)
        tp_trans = jnp.where(refracted[:, None], tp_refr, 1.0)
        throughput = jnp.where(
            trans[:, None], c["throughput"] * tp_trans, c["throughput"]
        )

        surface = live2 & ~trans
        rough = surface & (roughness > 0.2)

        # ReSTIR trigger: freeze and leave the walk.
        if use_restir:
            trigger = rough & ~c["pending"] & (i < cfg.shadow_bounces)
        else:
            trigger = jnp.zeros((p,), bool)

        # Plain NEE branch (ray_gen_final.slang:328-382).
        prev_did_nee = jnp.zeros((p,), bool)
        if use_nee:
            nee_lane = rough & (i < cfg.shadow_bounces)
            seed2, u_pick = rng_mod.rnd(seed2)
            lidx = jnp.minimum(
                (u_pick * num_lights).astype(jnp.int32), num_lights - 1
            )
            seed2, n1, n2 = rng_mod.rnd2(seed2)
            lpos, lnrm, lem, larea = lights.sample_point(lidx, n1, n2)
            sdir = lpos - surf.pos
            ldist = jnp.maximum(vec_norm(sdir), 1e-6)
            sdir = sdir / ldist[:, None]
            cos_l = jnp.maximum(dot(lnrm, -sdir), 0.0)
            cos_s = jnp.maximum(dot(surf.normal, sdir), 0.0)
            cand = nee_lane & (cos_l > 0.0) & (cos_s > 0.0)
            occ = trace_occluded(
                tracer, surf.pos, sdir, ldist,
                exclude=lights.world_tri[lidx],
            )
            vis = cand & ~occ
            pdf_sa = (ldist * ldist) / jnp.maximum(
                cos_l * larea * num_lights, 1e-4
            )
            contrib = (
                lem * surf.albedo * throughput * cos_s[:, None]
                / (pdf_sa[:, None] * PI)
            )
            contrib = jnp.minimum(contrib, cfg.nee_contrib_clamp)
            radiance = radiance + jnp.where(vis[:, None], contrib, 0.0)
            prev_did_nee = cand

            if first and cfg.shadow_boundary_grads and cfg.differentiable:
                # Visibility boundary gradients (render/boundary.py):
                # zero in the primal, the silhouette-edge boundary
                # integral of this NEE estimator in reverse mode — the
                # term whose absence the occlusion envelope pins
                # (AD = 0 vs FD, tests/test_grads.py).
                from sunray_tpu.render import boundary

                assert scene.edge_tri is not None, (
                    "cfg.shadow_boundary_grads needs scene edge "
                    "topology — build the scene through "
                    "boundary.with_edge_topology(scene)"
                )
                bterm = boundary.nee_boundary_term(
                    scene, lights, scene.world_triangle_vertices(),
                    surf.pos, surf.normal, surf.albedo, nee_lane,
                    candidates=cfg.shadow_boundary_candidates,
                )
                radiance = radiance + bterm * jax.lax.stop_gradient(
                    throughput
                )

        # BRDF bounce (ray_gen_final.slang:385-427) for surface lanes that
        # didn't trigger restir.
        brdf_lane = surface & ~trigger
        n = surf.normal
        v_view = -c["ray_d"]
        f0 = 0.04 * (1.0 - metallic[:, None]) + surf.albedo * metallic[:, None]
        cos_nv = jnp.maximum(dot(n, v_view), 0.0)
        fres = f0 + (1.0 - f0) * jnp.clip(1.0 - cos_nv, 0.0, 1.0)[:, None] ** 5
        p_spec = jnp.clip(jnp.max(fres, axis=-1), 0.05, 1.0)

        seed2, ur1, ur2 = rng_mod.rnd2(seed2)
        r1 = jnp.where(i == 0, bn_r1, ur1)
        r2 = jnp.where(i == 0, bn_r2, ur2)

        seed2, u_lobe = rng_mod.rnd(seed2)
        pick_spec = u_lobe < p_spec
        hvec = sample_ggx_vndf(n, v_view, roughness, r1, r2)
        d_spec = reflect(-v_view, hvec)
        spec_ok = dot(n, d_spec) > 0.0
        d_diff = cosine_hemisphere(n, r1, r2)

        ndl_b = jnp.maximum(dot(n, d_spec), 0.001)
        alpha_b = roughness * roughness
        g1 = smith_g1_ggx(ndl_b, alpha_b)
        tp_spec = fres * (g1 / p_spec)[:, None]
        # Denominator guard: p_spec clips to 1.0 at grazing/dead lanes
        # (fres -> 1); the diffuse branch is then never selected, but its
        # 1/(1-p_spec) would still poison gradients through `where`.
        tp_diff = (
            surf.albedo * (1.0 - metallic[:, None]) * (1.0 - fres)
            / jnp.maximum(1.0 - p_spec, 1e-4)[:, None]
        )

        use_spec = pick_spec & spec_ok
        new_d = _sel3(use_spec, d_spec, d_diff)
        tp_mult = jnp.where(use_spec[:, None], tp_spec, tp_diff)
        throughput = jnp.where(
            brdf_lane[:, None], throughput * tp_mult, throughput
        )
        pmax = jnp.max(throughput, axis=-1)
        die = brdf_lane & (pmax < 0.001)

        seed2, u_rr = rng_mod.rnd(seed2)
        rr_on = brdf_lane & (i > cfg.russian_roulette_start)
        rr_die = rr_on & (u_rr > pmax)
        rr_scale = jnp.where(
            (rr_on & ~rr_die)[:, None], 1.0 / jnp.maximum(pmax, 1e-6)[:, None], 1.0
        )
        throughput = throughput * rr_scale

        ray_d = _sel3(trans, d_t, _sel3(brdf_lane, new_d, c["ray_d"]))
        ray_o = _sel3(
            trans, o_t,
            _sel3(brdf_lane, surf.pos + surf.normal * 1e-3, c["ray_o"]),
        )

        still = (
            c["active"] & surf.valid & ~stop_bright & ~trigger & ~die & ~rr_die
        )
        frz = trigger
        return dict(
            i=i + 1,
            seed=seed2,
            ray_o=ray_o,
            ray_d=ray_d,
            throughput=throughput,
            radiance=radiance,
            active=still,
            prev_did_nee=prev_did_nee,
            pending=c["pending"] | trigger,
            f_pos=_sel3(frz, surf.pos, c["f_pos"]),
            f_normal=_sel3(frz, surf.normal, c["f_normal"]),
            f_albedo=_sel3(frz, surf.albedo, c["f_albedo"]),
            f_rough=jnp.where(frz, roughness, c["f_rough"]),
            f_metal=jnp.where(frz, metallic, c["f_metal"]),
            f_view=_sel3(frz, -c["ray_d"], c["f_view"]),
            f_throughput=_sel3(frz, throughput, c["f_throughput"]),
        )

    # peel=1: the first bounce round always runs; inlining it fuses the
    # trace/shade/BRDF body with the rest of the frame instead of paying
    # the while_loop carry materialization (ops/loops.py).
    peel_body = (
        (lambda c: body(c, reuse=first_hit, first=True))
        if first_hit is not None else (lambda c: body(c, first=True))
    )
    c = bounded_loop(cond, peel_body, init, cfg.bounces,
                     cfg.differentiable,
                     loop_body=lambda c: body(c, coherent=False),
                     peel=1)
    radiance = c["radiance"]
    seed = c["seed"]

    if use_restir:
        radiance = radiance + _spatial_reuse(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
            seed, c, cam_origin, frame_count, grid=grid,
        )
        if cfg.shadow_boundary_grads and cfg.differentiable and grid is None:
            # Visibility-boundary gradients for the ReSTIR DI estimator
            # (VERDICT r4 item 6): the frame estimates the same NEE area
            # integral the boundary term differentiates, so the zero-
            # forward silhouette-edge injection applies at the frozen
            # first-rough hits with the path throughput (diffuse
            # integrand; the specular share of the boundary remains
            # out of scope, docs/PARITY.md).
            from sunray_tpu.render import boundary

            assert scene.edge_tri is not None, (
                "cfg.shadow_boundary_grads needs scene edge topology — "
                "build the scene through boundary.with_edge_topology"
            )
            bterm = boundary.nee_boundary_term(
                scene, lights, scene.world_triangle_vertices(),
                c["f_pos"], c["f_normal"], c["f_albedo"], c["pending"],
                candidates=cfg.shadow_boundary_candidates,
            )
            radiance = radiance + bterm * jax.lax.stop_gradient(
                c["f_throughput"]
            )

    # total_radiance = min(radiance, 10) (ray_gen_final.slang:430-431).
    return jnp.minimum(radiance, cfg.radiance_clamp), c["i"]


def _shift_flat(x, dx, dy, h, w):
    """Read field at pixel+(dx,dy) for all pixels, via a dynamic roll of the
    image view. Out-of-bounds lanes must be masked by the caller (the roll
    wraps)."""
    img = x.reshape((h, w) + x.shape[1:])
    rolled = jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))
    return rolled.reshape(x.shape)


def _pack_i32(fields):
    """Pack (P,) / (P, n) fields into ONE (P, C) int32 matrix (floats ride
    bitcast — integer ops are bit-exact data movement, immune to the
    denormal flush that corrupts int-bitcast data on float datapaths; see
    ops/banded.shift_row_gather). Returns (packed, spec) for _unpack_i32."""
    cols, spec = [], []
    for f in fields:
        is_int = jnp.issubdtype(f.dtype, jnp.integer)
        g = f if is_int else jax.lax.bitcast_convert_type(f, jnp.int32)
        if g.ndim == 1:
            cols.append(g[:, None])
            spec.append((is_int, 1))
        else:
            cols.append(g)
            spec.append((is_int, g.shape[1]))
    return jnp.concatenate(cols, axis=1), spec


def _unpack_i32(rows, spec):
    out, o = [], 0
    for is_int, n in spec:
        g = rows[:, o:o + n]
        if n == 1:
            g = g[:, 0]
        if not is_int:
            g = jax.lax.bitcast_convert_type(g, jnp.float32)
        out.append(g)
        o += n
    return out


def _shared_taps(cfg, frame_count, count, radius, salt):
    """Per-iteration shared disc offsets (cfg.spatial_taps == 'shared'):
    the same area-uniform disc distribution as the reference's per-pixel
    draws (ray_gen_final.slang:164-167), but drawn once per iteration from
    a frame-seeded scalar stream. Neighbor reads then become whole-image
    shifts instead of per-pixel gathers (chosen for an earlier
    accelerator's slow gathers; the H100 cost of per-pixel taps is not
    measured yet)."""
    s = rng_mod.init_seed(
        jnp.uint32(salt), frame_count.astype(jnp.uint32)
    )
    taps = []
    for _ in range(count):
        s, ua, ur = rng_mod.rnd2(s)
        ang = ua * 2.0 * PI
        r = jnp.sqrt(ur) * radius
        taps.append(
            (
                (jnp.cos(ang) * r).astype(jnp.int32),
                (jnp.sin(ang) * r).astype(jnp.int32),
            )
        )
    return taps


@jax.named_scope("spatial_reuse")
def _spatial_reuse(scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
                   seed, c, cam_origin, frame_count, grid=None):
    """Phase B: ReSTIR DI + GI spatial reuse at frozen first-rough hits
    (ray_gen_final.slang:136-327). Returns radiance to add, (P, 3).

    grid: shard_map row sharding — neighbor taps read halo-exchanged
    copies of the reservoirs and G-buffer guides (parallel/halo.py), one
    exchange per field covering the max tap radius; everything else is
    per-lane and untouched."""
    w, h = cfg.width, cfg.height
    p = w * (grid.hl if grid is not None else h)
    num_lights = lights.num
    shared = cfg.spatial_taps == "shared"

    if grid is not None:
        from sunray_tpu.parallel.halo import exchange_flat, shift_flat_ext
        hs = grid.halo_s
        xc = lambda f: exchange_flat(f, hs, grid)
        gnormal_x = xc(gbuf.normal)
        gdepth_x = xc(gbuf.depth)
        r_di_x = jax.tree_util.tree_map(xc, r_di)
        r_gi_x = jax.tree_util.tree_map(xc, r_gi)

    pending = c["pending"]
    pos = c["f_pos"]
    normal = c["f_normal"]
    albedo = c["f_albedo"]
    rough = c["f_rough"]
    metal = c["f_metal"]
    v_view = c["f_view"]
    throughput = c["f_throughput"]
    # p_hat attribute reads in the storage dtype (cfg.shading_dtype);
    # geometry (pos, ray math, facing tests) stays f32 — see config.py.
    _sd = jnp.bfloat16 if cfg.shading_dtype == "bf16" else jnp.float32
    normal_s = normal.astype(_sd)
    albedo_s = albedo.astype(_sd)
    v_view_s = v_view.astype(_sd)
    rough_s = rough.astype(_sd)
    metal_s = metal.astype(_sd)

    pix0 = grid.row0 * w if grid is not None else 0
    pix = pix0 + jnp.arange(p, dtype=jnp.int32)
    px = pix % w
    py = pix // w
    radiance = jnp.zeros((p, 3), jnp.float32)

    gnormal = gbuf.normal
    gdepth = gbuf.depth
    current_depth = vec_norm(pos - cam_origin)

    def perpixel_neighbor(nx, ny, reservoir):
        """Per-pixel random-disc neighbor fetch (the reference's exact
        taps, ray_gen_final.slang:164-167): reservoir + G-buffer
        normal/depth in ONE packed row gather (amortizes what used to be
        three separate gathers per tap). Deliberately NOT banded: 8 taps
        x 68 bands of gather ops made the 1080p compile take tens of
        minutes; the plain packed gather compiles normally and perpixel
        is the exact-parity mode, not the default hot path
        (spatial_taps='shared' is)."""
        inb = (nx >= 0) & (ny >= 0) & (nx < w) & (ny < h)
        ni = jnp.clip(ny * w + nx, 0, w * h - 1)
        leaves, treedef = jax.tree_util.tree_flatten(reservoir)
        if grid is not None:
            out, in_halo = restir._gather_packed(
                leaves + [gnormal, gdepth], ni, grid=grid,
                grid_halo=grid.halo_s,
            )
        else:
            out, in_halo = restir._gather_packed(
                leaves + [gnormal, gdepth], ni
            )
        nr = jax.tree_util.tree_unflatten(treedef, out[:-2])
        nn, nd = out[-2], out[-1]
        ok = (
            inb
            & (dot(normal, nn) >= 0.9)
            & (jnp.abs(current_depth - nd) <= 0.1 * current_depth)
        )
        if in_halo is not None:
            ok = ok & in_halo
        return nr, nd, ok

    def make_shared_fetch(reservoir_x, gnormal_s, gdepth_s):
        """Build the shared-tap neighbor fetch for one reuse phase:
        fetch(dx, dy) -> (reservoir', gdepth', ok_geom, nx, ny).

        Default: per-leaf two-axis dynamic rolls — XLA fuses the small
        rolls into the merge math well. SUNRAY_TPU_PACKED_TAPS=1 (read at
        trace time) instead packs the reservoir leaves + normal + depth
        ONCE into a (P, C) int32 matrix and does ONE flat roll by dy*w+dx
        per tap; on an earlier accelerator it lost to the per-leaf rolls
        (the wide pack/roll copies cost more than the many small fused
        rolls; images equal to 4.6e-6), so it stays opt-in. Not measured
        on the H100. Flat-roll wraparound (row-crossing
        x, top/bottom y) only reaches lanes whose source pixel is
        off-screen, which `inb` masks. Under a grid the shift is the
        halo-window row slice + lane roll per leaf
        (parallel/halo.shift_flat_ext), unchanged."""
        packed_ok = os.environ.get("SUNRAY_TPU_PACKED_TAPS", "0") == "1"
        if grid is None and packed_ok:
            leaves, treedef = jax.tree_util.tree_flatten(reservoir_x)
            packed, spec = _pack_i32(leaves + [gnormal_s, gdepth_s])

            def fetch(dx, dy):
                nx = px + dx
                ny = py + dy
                inb = (nx >= 0) & (ny >= 0) & (nx < w) & (ny < h)
                rolled = jnp.roll(packed, -(dy * w + dx), axis=0)
                out = _unpack_i32(rolled, spec)
                nn, nd = out[-2], out[-1]
                ok = (
                    inb
                    & (dot(normal, nn) >= 0.9)
                    & (jnp.abs(current_depth - nd) <= 0.1 * current_depth)
                )
                nr = jax.tree_util.tree_unflatten(treedef, out[:-2])
                return nr, nd, ok, nx, ny

            return fetch

        def fetch(dx, dy):
            nx = px + dx
            ny = py + dy
            inb = (nx >= 0) & (ny >= 0) & (nx < w) & (ny < h)
            if grid is not None:
                shift = lambda f: shift_flat_ext(f, dx, dy, hs, grid)
            else:
                shift = lambda f: _shift_flat(f, dx, dy, h, w)
            nn = shift(gnormal_s)
            nd = shift(gdepth_s)
            ok = (
                inb
                & (dot(normal, nn) >= 0.9)
                & (jnp.abs(current_depth - nd) <= 0.1 * current_depth)
            )
            nr = jax.tree_util.tree_map(shift, reservoir_x)
            return nr, nd, ok, nx, ny

        return fetch

    # ---- DI spatial (ray_gen_final.slang:139-222) ----
    seq_taps = os.environ.get("SUNRAY_TPU_SEQ_TAPS", "0") == "1"
    di_taps = (
        _shared_taps(cfg, frame_count, cfg.di_spatial_samples,
                     cfg.di_spatial_radius, 0x51A7D1)
        if shared else None
    )

    di_fetch = (
        make_shared_fetch(
            r_di_x if grid is not None else r_di,
            gnormal_x if grid is not None else gnormal,
            gdepth_x if grid is not None else gdepth,
        )
        if shared else None
    )

    def di_body(carry, k):
        seed, spatial = carry
        if shared:
            dx, dy = di_taps[k]
            nr, _, ok, _, _ = di_fetch(dx, dy)
        else:
            seed, ua, ur = rng_mod.rnd2(seed)
            angle = ua * 2.0 * PI
            radius = jnp.sqrt(ur) * cfg.di_spatial_radius
            nx = px + (jnp.cos(angle) * radius).astype(jnp.int32)
            ny = py + (jnp.sin(angle) * radius).astype(jnp.int32)
            nr, _, ok = perpixel_neighbor(nx, ny, r_di)
        nr = nr.replace(
            W=jnp.minimum(nr.W, cfg.di_temporal_w_clamp),
            M=jnp.minimum(nr.M, cfg.di_temporal_m_clamp),
        )
        use = pending & ok & (nr.W > 0.0) & (nr.light_idx < num_lights)
        nr = nr.replace(light_idx=jnp.minimum(nr.light_idx, num_lights - 1))
        p_hat_n, _ = lights.eval_p_hat(
            nr.light_idx, nr.light_pos, nr.light_normal,
            pos, normal_s, v_view_s, albedo_s, rough_s, metal_s,
        )
        seed, u = rng_mod.rnd(seed)
        spatial = restir.merge_di(spatial, nr, p_hat_n, u, use)
        return seed, spatial

    def _di_spatial_jnp(seed, spatial):
        if not (shared and cfg.di_spatial_samples > 0 and not seq_taps):
            # Per-pixel (reference-exact) taps — and, under
            # SUNRAY_TPU_SEQ_TAPS=1, the sequential shared-tap oracle.
            carry = (seed, spatial)
            for k in range(cfg.di_spatial_samples):
                carry = di_body(carry, k)
            return carry
        # Batched shared taps: the T neighbor fetches stack into (P, T)
        # planes, ONE planar p_hat pass reads the center attributes once
        # (the per-tap evals re-read them — the multiply-reduce wall, see
        # restir.ris_audition), and the merge chain runs order-exact on
        # (P,) slices. Bit-exact with the sequential tap loop
        # (tests/test_pipeline.py::TestBatchedSpatialTaps).
        t_n = cfg.di_spatial_samples
        fetched = [di_fetch(dx, dy) for dx, dy in di_taps]
        # (T, P) planes: taps major, pixels minor — per-tap accesses
        # below are contiguous ROW reads (a (P, T) layout makes every
        # plane[:, i] a strided read of the whole array; restir.py).
        pl = lambda f: jnp.stack(f, axis=0)               # T x (P,) -> (T,P)
        idx_raw = pl([f[0].light_idx for f in fetched])
        w_raw = pl([f[0].W for f in fetched])
        m_raw = pl([f[0].M for f in fetched])
        okp = pl([f[2] for f in fetched])
        lpos = [pl([f[0].light_pos[:, a] for f in fetched]) for a in range(3)]
        lnrm = [pl([f[0].light_normal[:, a] for f in fetched])
                for a in range(3)]
        w_cl = jnp.minimum(w_raw, cfg.di_temporal_w_clamp)
        m_cl = jnp.minimum(m_raw, cfg.di_temporal_m_clamp)
        use_p = (pending[None, :] & okp & (w_cl > 0.0)
                 & (idx_raw < num_lights))
        idx_cl = jnp.minimum(idx_raw, num_lights - 1)
        em = gather_cols(lights.emission, idx_cl)
        p_hat_p, _, _ = eval_p_hat_planar(
            [pos[:, a][None, :] for a in range(3)],
            [normal_s[:, a][None, :] for a in range(3)],
            [v_view_s[:, a][None, :] for a in range(3)],
            [albedo_s[:, a][None, :] for a in range(3)],
            rough_s[None, :], metal_s[None, :], em, lpos, lnrm,
        )
        seed, u_taps = rng_mod.rnd_chain(seed, t_n)
        u_taps = u_taps.T                                 # (T, P)
        w_sum = spatial.w_sum
        m_acc = spatial.M
        slot = jnp.full((p,), -1, jnp.int32)
        for i in range(t_n):
            use_i = use_p[i]
            m_acc = m_acc + jnp.where(use_i, m_cl[i], 0.0)
            weight = jnp.where(use_i, p_hat_p[i] * w_cl[i]
                               * m_cl[i], 0.0)
            w_sum = w_sum + weight
            take = use_i & (u_taps[i]
                            < weight / jnp.maximum(w_sum, 1e-4))
            slot = jnp.where(take, i, slot)

        def sel(plane, base):
            val = base
            for i in range(t_n):
                val = jnp.where(slot == i, plane[i], val)
            return val

        spatial = spatial.replace(
            w_sum=w_sum, M=m_acc,
            light_idx=sel(idx_cl, spatial.light_idx),
            light_pos=jnp.stack(
                [sel(lpos[a], spatial.light_pos[:, a]) for a in range(3)],
                axis=-1,
            ),
            light_normal=jnp.stack(
                [sel(lnrm[a], spatial.light_normal[:, a]) for a in range(3)],
                axis=-1,
            ),
        )
        return seed, spatial

    spatial = restir.ReservoirDI.empty(p)
    center = r_di
    c_ok = pending & (center.W > 0.0) & (center.light_idx < num_lights)
    center = center.replace(
        light_idx=jnp.minimum(center.light_idx, num_lights - 1)
    )
    p_hat_c, _ = lights.eval_p_hat(
        center.light_idx, center.light_pos, center.light_normal,
        pos, normal_s, v_view_s, albedo_s, rough_s, metal_s,
    )
    seed, u_m = rng_mod.rnd(seed)
    spatial = restir.merge_di(spatial, center, p_hat_c, u_m, c_ok)
    seed, spatial = _di_spatial_jnp(seed, spatial)
    has = pending & (spatial.w_sum > 0.0)
    p_hat_w, f_y_w = lights.eval_p_hat(
        spatial.light_idx, spatial.light_pos, spatial.light_normal,
        pos, normal_s, v_view_s, albedo_s, rough_s, metal_s,
    )
    w_spatial = spatial.w_sum / jnp.maximum(
        spatial.M * p_hat_w, 1e-3
    )
    w_spatial = jnp.minimum(w_spatial, cfg.di_spatial_w_clamp)

    # DI winner shadow ray — computed here, TRACED together with the GI
    # final visibility ray below (independent queries; one 2P-ray call).
    sdir = spatial.light_pos - pos
    sdist = jnp.maximum(vec_norm(sdir), 1e-4)
    sdir = sdir / sdist[:, None]
    facing = dot(normal, sdir) > 0.0
    di_exclude = lights.world_tri[spatial.light_idx]

    # ---- GI spatial (ray_gen_final.slang:224-327) ----
    combined = r_gi  # own reservoir (identity gather elided)

    view_inverse = mats["view_inverse"]
    proj_inverse = mats["proj_inverse"]

    gi_taps = (
        _shared_taps(cfg, frame_count, cfg.gi_spatial_samples,
                     cfg.gi_spatial_radius, 0x6E5B2F)
        if shared else None
    )

    gi_fetch = (
        make_shared_fetch(
            r_gi_x if grid is not None else r_gi,
            gnormal_x if grid is not None else gnormal,
            gdepth_x if grid is not None else gdepth,
        )
        if shared else None
    )

    def gi_tap_prep(nr, n_depth, ok, nx, ny, dx, dy, defer_trace=False):
        """Everything of one GI tap except the merge draw: validity
        chain, neighbor-x1 jacobian, visibility ray. No rnd consumed —
        shared by the sequential loop and the batched merge."""
        ok = ok & ~((dx == 0) & (dy == 0))
        ok = ok & (nr.W > 0.0)
        nr = nr.replace(
            W=jnp.minimum(nr.W, cfg.gi_temporal_w_clamp),
            M=jnp.minimum(nr.M, cfg.gi_spatial_m_clamp),
        )

        # Reconstruct neighbor's primary point x1 (ray_gen_final.slang:253-258).
        nuv = jnp.stack(
            [
                (nx.astype(jnp.float32) + 0.5) / w,
                (ny.astype(jnp.float32) + 0.5) / h,
            ],
            axis=-1,
        )
        nd = nuv * 2.0 - 1.0
        # Column contractions with the small matrices: a broadcasted
        # (P, 4, 4) product here tile-pads 4->8 x 4->128 (32x HBM) inside
        # the spatial-reuse loop — see render/shade.py for the measured
        # blow-up from the same pattern.
        one = jnp.ones((p,))
        clip_cols = [nd[:, 0], nd[:, 1], one, one]
        tgt = jnp.stack(
            [
                sum(proj_inverse[i, j] * clip_cols[j] for j in range(4))
                for i in range(3)
            ],
            axis=-1,
        )
        tgt = tgt / vec_norm(tgt)[:, None]
        ndir = jnp.stack(
            [
                sum(view_inverse[i, j] * tgt[:, j] for j in range(3))
                for i in range(3)
            ],
            axis=-1,
        )
        neighbor_x1 = cam_origin + ndir * n_depth[:, None]

        w_new = nr.sample_pos - pos
        w_old = nr.sample_pos - neighbor_x1
        d_new = jnp.maximum(vec_norm(w_new), 1e-4)
        d_old = jnp.maximum(vec_norm(w_old), 1e-4)
        n_x2 = nr.sample_normal
        cos_new = jnp.maximum(dot(n_x2, -w_new / d_new[:, None]), 0.0)
        cos_old = jnp.maximum(dot(n_x2, -w_old / d_old[:, None]), 0.0)
        ok = ok & (cos_new > 0.0) & (cos_old > 0.0)
        jac = (cos_new * d_old * d_old) / jnp.maximum(
            cos_old * d_new * d_new, 1e-4
        )
        jac = jnp.clip(jac, 0.0, cfg.gi_jacobian_clamp)

        gdir = w_new / d_new[:, None]
        ok = ok & (dot(normal, gdir) > 0.0)
        if defer_trace:
            # Batched branch: hand the visibility ray back so all T taps
            # ride ONE trace call (identical per-ray results — the kernel
            # is per-lane; fewer kernel dispatches).
            return nr, pending & ok, jac, (gdir, d_new, nr.sample_tri)
        occ = trace_occluded(tracer, pos, gdir, d_new, exclude=nr.sample_tri)
        ok = pending & ok & ~occ
        return nr, ok, jac

    def gi_body(carry, k):
        seed, combined = carry
        if shared:
            dx, dy = gi_taps[k]
            nr, n_depth, ok, nx, ny = gi_fetch(dx, dy)
        else:
            seed, ua, ur = rng_mod.rnd2(seed)
            angle = ua * 2.0 * PI
            radius = jnp.sqrt(ur) * cfg.gi_spatial_radius
            dx = (jnp.cos(angle) * radius).astype(jnp.int32)
            dy = (jnp.sin(angle) * radius).astype(jnp.int32)
            nx = px + dx
            ny = py + dy
            nr, n_depth, ok = perpixel_neighbor(nx, ny, r_gi)
        nr, ok, jac = gi_tap_prep(nr, n_depth, ok, nx, ny, dx, dy)
        p_hat_n = gi_target_pdf(
            pos, normal_s, albedo_s, metal_s, nr.sample_pos,
            nr.sample_radiance
        )
        seed, u = rng_mod.rnd(seed)
        combined = restir.merge_gi(combined, nr, p_hat_n, jac, u, ok)
        return seed, combined

    if shared and cfg.gi_spatial_samples > 0 and not seq_taps:
        # Batched shared GI taps: per-tap fetch/jacobian/visibility stay
        # per-tap (each has its own trace), but the p_hat evaluations and
        # the merge chain run over (P, T) planes reading the center
        # attributes once (see the DI branch above; merge_gi order
        # preserved exactly).
        t_n = cfg.gi_spatial_samples
        preps = []
        rays = []
        for k in range(t_n):
            dx, dy = gi_taps[k]
            nr, n_depth, ok, nx, ny = gi_fetch(dx, dy)
            nr, ok_pre, jac, ray = gi_tap_prep(nr, n_depth, ok, nx, ny,
                                               dx, dy, defer_trace=True)
            preps.append((nr, ok_pre, jac))
            rays.append(ray)
        # One trace for all T taps' visibility rays (same origin `pos`).
        occ_all = trace_occluded(
            tracer,
            jnp.concatenate([pos] * t_n, axis=0),
            jnp.concatenate([r[0] for r in rays], axis=0),
            jnp.concatenate([r[1] for r in rays], axis=0),
            exclude=jnp.concatenate([r[2] for r in rays], axis=0),
            coherent=False,
        )
        preps = [
            (nr, ok_pre & ~occ_all[k * p : (k + 1) * p], jac)
            for k, (nr, ok_pre, jac) in enumerate(preps)
        ]
        pl = lambda f: jnp.stack(f, axis=0)               # (T, P) rows
        spos = [pl([pr[0].sample_pos[:, a] for pr in preps])
                for a in range(3)]
        snrm = [pl([pr[0].sample_normal[:, a] for pr in preps])
                for a in range(3)]
        srad = [pl([pr[0].sample_radiance[:, a] for pr in preps])
                for a in range(3)]
        stri = pl([pr[0].sample_tri for pr in preps])
        w_p = pl([pr[0].W for pr in preps])
        m_p = pl([pr[0].M for pr in preps])
        ok_p = pl([pr[1] for pr in preps])
        jac_p = pl([pr[2] for pr in preps])
        p_hat_p = gi_target_pdf_planar(
            [pos[:, a][None, :] for a in range(3)],
            [normal_s[:, a][None, :] for a in range(3)],
            [albedo_s[:, a][None, :] for a in range(3)],
            metal_s[None, :], spos, srad,
        )
        seed, u_taps = rng_mod.rnd_chain(seed, t_n)
        u_taps = u_taps.T                                 # (T, P)
        w_sum = combined.w_sum
        m_acc = combined.M
        slot = jnp.full((p,), -1, jnp.int32)
        for i in range(t_n):
            ok_i = ok_p[i]
            m_acc = m_acc + jnp.where(ok_i, m_p[i], 0.0)
            weight = jnp.where(
                ok_i, p_hat_p[i] * w_p[i] * m_p[i] * jac_p[i],
                0.0,
            )
            w_sum = w_sum + weight
            take = ok_i & (u_taps[i]
                           < weight / jnp.maximum(w_sum, 1e-4))
            slot = jnp.where(take, i, slot)

        def gsel(plane, base):
            val = base
            for i in range(t_n):
                val = jnp.where(slot == i, plane[i], val)
            return val

        combined = combined.replace(
            w_sum=w_sum, M=m_acc,
            sample_pos=jnp.stack(
                [gsel(spos[a], combined.sample_pos[:, a]) for a in range(3)],
                axis=-1,
            ),
            sample_normal=jnp.stack(
                [gsel(snrm[a], combined.sample_normal[:, a])
                 for a in range(3)],
                axis=-1,
            ),
            sample_radiance=jnp.stack(
                [gsel(srad[a], combined.sample_radiance[:, a])
                 for a in range(3)],
                axis=-1,
            ),
            sample_tri=gsel(stri, combined.sample_tri),
        )
    else:
        carry = (seed, combined)
        for k in range(cfg.gi_spatial_samples):
            carry = gi_body(carry, k)
        seed, combined = carry

    p_hat_f = gi_target_pdf(
        pos, normal_s, albedo_s, metal_s, combined.sample_pos,
        combined.sample_radiance
    )
    w_gi = jnp.where(
        p_hat_f > 1e-3,
        combined.w_sum / jnp.maximum(combined.M, 1.0) / jnp.maximum(p_hat_f, 1e-9),
        0.0,
    )
    w_gi = jnp.minimum(w_gi, cfg.gi_spatial_w_clamp)

    gvec = combined.sample_pos - pos
    gdist = jnp.maximum(vec_norm(gvec), 1e-4)
    gdir = gvec / gdist[:, None]
    gndl = jnp.maximum(dot(normal, gdir), 0.0)
    try_gi = pending & (w_gi > 0.0) & (gndl > 0.0)
    f_diffuse = albedo * (1.0 - metal[:, None]) / PI
    gi_contrib_pre = (
        combined.sample_radiance * f_diffuse * (gndl * w_gi)[:, None]
    )
    return _gi_radiance_add(
        radiance, tracer, pos, sdir, sdist, di_exclude, has, facing,
        f_y_w, w_spatial, throughput, gdir, gdist, combined.sample_tri,
        try_gi, gi_contrib_pre, p,
    )


def _gi_radiance_add(radiance, tracer, pos, sdir, sdist, di_exclude, has,
                     facing, f_y_w, w_spatial, throughput, gdir, gdist,
                     gi_tri, try_gi, gi_contrib_pre, p):
    """Shared phase-B tail: ONE trace for the DI winner shadow ray + the
    GI final visibility ray, then the radiance adds in the reference's
    order (DI then GI, ray_gen_final.slang:203-222, 305-327)."""
    occ2 = trace_occluded(
        tracer,
        jnp.concatenate([pos, pos], axis=0),
        jnp.concatenate([sdir, gdir], axis=0),
        jnp.concatenate([sdist, gdist], axis=0),
        exclude=jnp.concatenate([di_exclude, gi_tri], axis=0),
        coherent=False,
    )
    lit = has & facing & ~occ2[:p]
    radiance = radiance + jnp.where(
        lit[:, None], f_y_w * throughput * w_spatial[:, None], 0.0
    )
    ok_gi = try_gi & ~occ2[p:]
    radiance = radiance + jnp.where(
        ok_gi[:, None], gi_contrib_pre * throughput, 0.0
    )
    return radiance
