"""ReSTIR DI / GI reservoirs and resampling operations.

Batched-SoA port of the reservoir algorithms in the reference shaders:
  - Reservoir layouts: rt_types.slang:123-143 / resources/reservoir.rs:1-54
    (normals kept as float3 instead of octahedral-packed uint — packing
    would break gradients).
  - merge_reservoirs / merge_reservoirs_gi: rt_utils.slang:244-274
  - RIS audition (16 candidates, area-uniform): ray_gen_ris.slang:189-231
  - DI temporal reuse with confidence: ray_gen_ris.slang:233-267
  - GI temporal reuse: ray_gen_ris.slang:408-432
  - DI/GI spatial reuse: ray_gen_final.slang:136-327 (lives in pathtrace.py,
    built on the merge primitives here)

Everything is per-pixel-parallel over flat (P,) arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from sunray_tpu.utils import struct

from sunray_tpu.ops import rng as rng_mod
from sunray_tpu.ops.banded import (
    auto_row_gather,
    banded_row_gather,
    shift_row_gather,
)
from sunray_tpu.ops.linalg import gather_cols, gather_vec
from sunray_tpu.ops.brdf import (
    PI,
    eval_p_hat_planar,
    eval_unshadowed_light,
    gi_target_pdf,
    luminance_max,
    normalize,
    safe_sqrt,
    vec_norm,
)


@struct.dataclass
class ReservoirDI:
    light_pos: jnp.ndarray      # (P, 3)
    w_sum: jnp.ndarray          # (P,)
    light_normal: jnp.ndarray   # (P, 3)
    M: jnp.ndarray              # (P,)
    light_idx: jnp.ndarray      # (P,) int32
    W: jnp.ndarray              # (P,)
    hit_normal: jnp.ndarray     # (P, 3)
    depth: jnp.ndarray          # (P,)

    @staticmethod
    def empty(p: int) -> "ReservoirDI":
        # Fresh buffer per field: shared buffers break jit donation
        # ("attempt to donate the same buffer twice").
        z = lambda: jnp.zeros((p,), jnp.float32)
        z3 = lambda: jnp.zeros((p, 3), jnp.float32)
        return ReservoirDI(
            light_pos=z3(), w_sum=z(), light_normal=z3(), M=z(),
            light_idx=jnp.zeros((p,), jnp.int32), W=z(), hit_normal=z3(),
            depth=z(),
        )


@struct.dataclass
class ReservoirGI:
    sample_pos: jnp.ndarray       # (P, 3)
    w_sum: jnp.ndarray            # (P,)
    sample_radiance: jnp.ndarray  # (P, 3)
    M: jnp.ndarray                # (P,)
    sample_normal: jnp.ndarray    # (P, 3)
    W: jnp.ndarray                # (P,)
    hit_normal: jnp.ndarray       # (P, 3)
    depth: jnp.ndarray            # (P,)
    # World-triangle id of the sample point (extra vs. the reference's
    # 48-byte layout): lets visibility rays toward the sample exclude its
    # own surface triangle instead of using a self-occluding TMax epsilon.
    sample_tri: jnp.ndarray       # (P,) int32, -1 = none

    @staticmethod
    def empty(p: int) -> "ReservoirGI":
        z = lambda: jnp.zeros((p,), jnp.float32)
        z3 = lambda: jnp.zeros((p, 3), jnp.float32)
        return ReservoirGI(
            sample_pos=z3(), w_sum=z(), sample_radiance=z3(), M=z(),
            sample_normal=z3(), W=z(), hit_normal=z3(), depth=z(),
            sample_tri=jnp.full((p,), -1, jnp.int32),
        )


def merge_di(r: ReservoirDI, new_r: ReservoirDI, p_hat_new, u, enable):
    """rt_utils.slang:244-253, masked by `enable` per lane."""
    m = r.M + jnp.where(enable, new_r.M, 0.0)
    weight = jnp.where(enable, p_hat_new * new_r.W * new_r.M, 0.0)
    w_sum = r.w_sum + weight
    take = enable & (u < weight / jnp.maximum(w_sum, 1e-4))
    t3 = take[:, None]
    return r.replace(
        M=m,
        w_sum=w_sum,
        light_idx=jnp.where(take, new_r.light_idx, r.light_idx),
        light_pos=jnp.where(t3, new_r.light_pos, r.light_pos),
        light_normal=jnp.where(t3, new_r.light_normal, r.light_normal),
    )


def merge_gi(r: ReservoirGI, new_r: ReservoirGI, p_hat_new, jacobian, u, enable):
    """rt_utils.slang:265-274, masked."""
    m = r.M + jnp.where(enable, new_r.M, 0.0)
    weight = jnp.where(enable, p_hat_new * new_r.W * new_r.M * jacobian, 0.0)
    w_sum = r.w_sum + weight
    take = enable & (u < weight / jnp.maximum(w_sum, 1e-4))
    t3 = take[:, None]
    return r.replace(
        M=m,
        w_sum=w_sum,
        sample_pos=jnp.where(t3, new_r.sample_pos, r.sample_pos),
        sample_normal=jnp.where(t3, new_r.sample_normal, r.sample_normal),
        sample_radiance=jnp.where(t3, new_r.sample_radiance, r.sample_radiance),
        sample_tri=jnp.where(take, new_r.sample_tri, r.sample_tri),
    )


class Lights:
    """Per-frame world-space light table (the EmissiveIndirection resolve)."""

    def __init__(self, scene):
        lv, le = scene.light_world_triangles()   # (L,3,3), (L,3)
        self.v0 = lv[:, 0]
        self.v1 = lv[:, 1]
        self.v2 = lv[:, 2]
        self.emission = le
        self.num = lv.shape[0]
        # World-triangle id per light, for occlusion-query exclusion.
        self.world_tri = scene.light_world_tri

    def gather(self, idx):
        """Light triangles by index: (v0, v1, v2, emission), idx (N,)."""
        return (
            gather_vec(self.v0, idx),
            gather_vec(self.v1, idx),
            gather_vec(self.v2, idx),
            gather_vec(self.emission, idx),
        )

    def sample_point(self, idx, u1, u2):
        """Area-uniform point on light idx (ray_gen_ris.slang:196-210).

        Returns (pos, normal, emission, area).
        """
        v0, v1, v2, em = self.gather(idx)
        e1 = v1 - v0
        e2 = v2 - v0
        cr = jnp.cross(e1, e2)
        area = 0.5 * vec_norm(cr)
        nrm = normalize(cr, eps=1e-12)
        sqr1 = jnp.sqrt(u1)
        u = 1.0 - sqr1
        v = u2 * sqr1
        w = 1.0 - u - v
        pos = v0 * u[:, None] + v1 * v[:, None] + v2 * w[:, None]
        return pos, nrm, em, area

    def eval_p_hat(self, idx, light_pos, light_normal, surf_pos, surf_normal,
                   v_view, albedo, roughness, metallic):
        """p_hat = max-channel of the unshadowed contribution of a stored
        reservoir sample (used everywhere a reservoir is re-evaluated)."""
        _, _, _, em = self.gather(idx)
        f_y = eval_unshadowed_light(
            surf_pos, surf_normal, v_view, albedo, roughness, metallic,
            em, light_pos, light_normal,
        )
        return luminance_max(f_y), f_y


@jax.named_scope("ris_audition")
def ris_audition(lights: Lights, seed, hit_pos, hit_normal, v_view, albedo,
                 roughness, metallic, candidates: int, enable):
    """RIS candidate audition (ray_gen_ris.slang:189-231), batched.

    All `candidates` rounds of weighted reservoir sampling run as (P, K)
    planes: the LCG seed chain is value-independent (rng.rnd_chain), so
    every draw is known up front, the K light samples and p_hat
    evaluations become K-wide lanes that read the surface attributes ONCE
    (the sequential form re-read pos/normal/view/albedo per candidate —
    measured as the round-3 frame's multiply-reduce wall), and the
    sequential reservoir update collapses to a running-sum + last-take
    select. Bit-exact with the K-round sequential reference
    (_ris_audition_sequential, kept for the equivalence test).

    Returns (seed, ReservoirDI) with W resolved.
    """
    p = hit_pos.shape[0]
    k = candidates
    num_lights = lights.num

    # Candidate planes run (K, P) — candidates major, pixels minor — so
    # the per-candidate reservoir chain and winner selects below read
    # contiguous ROWS; with (P, K) each plane[:, i] column slice is a
    # strided read of the whole array.
    seed, draws = rng_mod.rnd_chain(seed, 4 * k)       # (P, 4K)
    draws = draws.T                                    # one relayout
    u_pick = draws[0::4]
    u1 = draws[1::4]
    u2 = draws[2::4]
    u_keep = draws[3::4]

    idx = jnp.minimum(
        (u_pick * num_lights).astype(jnp.int32), num_lights - 1
    )                                                   # (K, P)

    # sample_point, planar (component planes — a (K, P, 3) array would
    # tile-pad its trailing dim; CLAUDE.md memory rule).
    v0 = gather_cols(lights.v0, idx)                    # 3 x (K, P)
    v1 = gather_cols(lights.v1, idx)
    v2 = gather_cols(lights.v2, idx)
    em = gather_cols(lights.emission, idx)
    e1 = [v1[a] - v0[a] for a in range(3)]
    e2 = [v2[a] - v0[a] for a in range(3)]
    cr = [
        e1[1] * e2[2] - e1[2] * e2[1],
        e1[2] * e2[0] - e1[0] * e2[2],
        e1[0] * e2[1] - e1[1] * e2[0],
    ]
    cr_n = safe_sqrt(cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2])
    area = 0.5 * cr_n
    nn = jnp.maximum(cr_n, 1e-12)
    nrm = [cr[a] / nn for a in range(3)]
    sqr1 = jnp.sqrt(u1)
    bu = 1.0 - sqr1
    bv = u2 * sqr1
    bw = 1.0 - bu - bv
    pos = [v0[a] * bu + v1[a] * bv + v2[a] * bw for a in range(3)]

    # eval_unshadowed_light, planar; hit attributes broadcast (1, P).
    px = [hit_pos[:, a][None, :] for a in range(3)]
    nx = [hit_normal[:, a][None, :] for a in range(3)]
    vx = [v_view[:, a][None, :] for a in range(3)]
    al = [albedo[:, a][None, :] for a in range(3)]
    p_hat, _, _ = eval_p_hat_planar(
        px, nx, vx, al, roughness[None, :], metallic[None, :],
        em, pos, nrm,
    )

    p_y = 1.0 / jnp.maximum(num_lights * area, 1e-4)
    wi = jnp.where(enable[None, :], p_hat / p_y, 0.0)   # (K, P)

    # Sequential reservoir chain, unrolled on contiguous (P,) rows (adds
    # in the exact order of the sequential reference — cumsum would
    # reassociate).
    w_sum = jnp.zeros((p,), jnp.float32)
    slot = jnp.full((p,), -1, jnp.int32)
    for i in range(k):
        wi_i = wi[i]
        w_sum = w_sum + wi_i
        take = enable & (u_keep[i] < wi_i / jnp.maximum(w_sum, 1e-4))
        slot = jnp.where(take, i, slot)
    m = jnp.where(enable, float(k), 0.0)

    # Winner extraction: select chain over the K row planes (zeros when
    # no candidate was ever taken — ReservoirDI.empty's values).
    def pick_plane(plane):
        val = jnp.zeros((p,), plane.dtype)
        for i in range(k):
            val = jnp.where(slot == i, plane[i], val)
        return val

    r = ReservoirDI.empty(p).replace(
        w_sum=w_sum,
        M=m,
        light_idx=pick_plane(idx),
        light_pos=jnp.stack([pick_plane(pl) for pl in pos], axis=-1),
        light_normal=jnp.stack([pick_plane(pl) for pl in nrm], axis=-1),
    )

    # Resolve W for the winner (ray_gen_ris.slang:225-231).
    p_hat_w, _ = lights.eval_p_hat(
        r.light_idx, r.light_pos, r.light_normal,
        hit_pos, hit_normal, v_view, albedo, roughness, metallic,
    )
    w = r.w_sum / jnp.maximum(r.M * p_hat_w, 1e-4)
    r = r.replace(W=jnp.where(enable & (r.w_sum > 0.0), w, 0.0))
    return seed, r


def _ris_audition_sequential(lights: Lights, seed, hit_pos, hit_normal,
                             v_view, albedo, roughness, metallic,
                             candidates: int, enable):
    """The K-round sequential audition (reference form of ris_audition;
    kept as the bit-exactness oracle — tests/test_restir_math.py)."""
    p = hit_pos.shape[0]
    r = ReservoirDI.empty(p)
    num_lights = lights.num

    def body(carry):
        seed, r = carry
        seed, u_pick = rng_mod.rnd(seed)
        idx = jnp.minimum(
            (u_pick * num_lights).astype(jnp.int32), num_lights - 1
        )
        seed, u1, u2 = rng_mod.rnd2(seed)
        pos, nrm, em, area = lights.sample_point(idx, u1, u2)
        f_y = eval_unshadowed_light(
            hit_pos, hit_normal, v_view, albedo, roughness, metallic,
            em, pos, nrm,
        )
        p_hat = luminance_max(f_y)
        p_y = 1.0 / jnp.maximum(num_lights * area, 1e-4)
        wi = jnp.where(enable, p_hat / p_y, 0.0)
        w_sum = r.w_sum + wi
        m = r.M + jnp.where(enable, 1.0, 0.0)
        seed, u_keep = rng_mod.rnd(seed)
        take = enable & (u_keep < wi / jnp.maximum(w_sum, 1e-4))
        t3 = take[:, None]
        r = r.replace(
            w_sum=w_sum, M=m,
            light_idx=jnp.where(take, idx, r.light_idx),
            light_pos=jnp.where(t3, pos, r.light_pos),
            light_normal=jnp.where(t3, nrm, r.light_normal),
        )
        return seed, r

    # Unrolled: a fori_loop boundary materializes the carry and blocks
    # cross-iteration fusion.
    carry = (seed, r)
    for _ in range(candidates):
        carry = body(carry)
    seed, r = carry

    # Resolve W for the winner (ray_gen_ris.slang:225-231).
    p_hat_w, _ = lights.eval_p_hat(
        r.light_idx, r.light_pos, r.light_normal,
        hit_pos, hit_normal, v_view, albedo, roughness, metallic,
    )
    w = r.w_sum / jnp.maximum(r.M * p_hat_w, 1e-4)
    r = r.replace(W=jnp.where(enable & (r.w_sum > 0.0), w, 0.0))
    return seed, r


def _gather_packed(fields, idx, width=0, band=0, halo=0, layout="rows",
                   mode="banded", radius=3, grid=None, grid_halo=0,
                   valid=None, shift_global=True, force=None,
                   auto_min_retention=0.98):
    """Gather many same-length (P,) / (P,3) fields at the same indices with
    ONE row gather of a packed (P, C) matrix: a packed row moves C scalars
    per index in one op instead of C separate 1-D gathers. int32 fields
    ride along bitcast to f32.

    With band > 0 the gather additionally runs banded (ops/banded.py: each
    destination row band reads only a window of source rows) and
    the last return value is the in-band validity mask; otherwise it is
    None (meaning all-valid).

    grid (parallel/halo.ShardGrid): shard_map mode — fields hold this
    shard's rows only, idx is GLOBAL; the packed matrix is halo-exchanged
    by `grid_halo` rows (one ppermute pair for all C columns) and sources
    outside the exchanged window come back invalid, the multi-chip analog
    of the banded gather's out-of-band lanes."""
    cols = []
    spec = []  # (is_int, ncomp)
    for f in fields:
        is_int = jnp.issubdtype(f.dtype, jnp.integer)
        g = jax.lax.bitcast_convert_type(f, jnp.float32) if is_int else f
        if g.ndim == 1:
            cols.append(g[:, None])
            spec.append((is_int, 1))
        else:
            cols.append(g)
            spec.append((is_int, g.shape[1]))
    packed = jnp.concatenate(cols, axis=1)           # (P, C)
    if grid is not None:
        from sunray_tpu.parallel.halo import exchange_flat, gather_flat_ext

        ext = exchange_flat(packed, grid_halo, grid)
        rows, in_band = gather_flat_ext(ext, idx, grid_halo, grid)
    elif band > 0 and width > 0 and mode == "auto":
        rows, in_band = auto_row_gather(packed, idx, width, band, halo,
                                        radius=radius,
                                        min_retention=auto_min_retention,
                                        valid=valid,
                                        global_motion=shift_global,
                                        force=force)
    elif band > 0 and width > 0 and mode == "shift":
        rows, in_band = shift_row_gather(packed, idx, width, radius, radius,
                                         valid=valid,
                                         global_motion=shift_global,
                                         force=force)
    elif band > 0 and width > 0:
        rows, in_band = banded_row_gather(packed, idx, width, band, halo,
                                          layout=layout, force=force)
    else:
        rows = packed[idx]                            # one gather
        in_band = None
    out = []
    o = 0
    for is_int, n in spec:
        if (layout == "out_t" and band > 0 and width > 0 and mode == "banded"
                and grid is None):
            # rows is (C, P): per-component slices are lane-major 1-D.
            g = rows[o] if n == 1 else rows[o : o + n].T
        else:
            g = rows[:, o : o + n]
            if n == 1:
                g = g[:, 0]
        if is_int:
            g = jax.lax.bitcast_convert_type(g, jnp.int32)
        out.append(g)
        o += n
    return out, in_band


def gather_reservoir_di(r: ReservoirDI, idx) -> ReservoirDI:
    """Gather reservoir lanes at pixel indices idx (history/neighbor reads)
    with a single packed-row gather (13 scalars per lane)."""
    leaves, treedef = jax.tree_util.tree_flatten(r)
    out, _ = _gather_packed(leaves, idx)
    return jax.tree_util.tree_unflatten(treedef, out)


def gather_reservoir_gi(r: ReservoirGI, idx) -> ReservoirGI:
    leaves, treedef = jax.tree_util.tree_flatten(r)
    out, _ = _gather_packed(leaves, idx)
    return jax.tree_util.tree_unflatten(treedef, out)


def _gather_reservoir_banded(r, idx, width, cfg, grid=None, valid=None):
    """History gather for temporal reuse: banded or shift-select per
    cfg.history_gather_mode when cfg.history_gather_force (ops/banded.py),
    plain otherwise; halo-exchanged under a shard grid (parallel/halo.py).
    valid: reprojection in-bounds mask (shift mode's mean-motion hint).
    Returns (reservoir, validity-mask-or-None)."""
    leaves, treedef = jax.tree_util.tree_flatten(r)
    # w_sum (leaf 1 in both reservoir dataclasses' field order) is the
    # merge DESTINATION's accumulator — never read from gathered history
    # (merge_di/merge_gi consume only M, W and the sample fields). Skip
    # gathering that column and return zeros; the pipeline tests +
    # goldens pin that nothing downstream reads it.
    wsum_leaf = leaves[1]
    leaves = leaves[:1] + leaves[2:]
    out, in_band = _gather_packed(
        leaves, idx, width, cfg.history_gather_band, cfg.history_gather_halo,
        cfg.history_gather_layout, cfg.history_gather_mode,
        cfg.history_shift_radius,
        grid=grid, grid_halo=(grid.halo_t if grid is not None else 0),
        valid=valid, shift_global=cfg.history_shift_global,
        force=cfg.history_gather_force,
        auto_min_retention=cfg.history_auto_min_retention,
    )
    out = out[:1] + [jnp.zeros_like(wsum_leaf)] + out[1:]
    return jax.tree_util.tree_unflatten(treedef, out), in_band


def gather_temporal_histories(cfg, seed, hist_di: ReservoirDI,
                              hist_gi: ReservoirGI, prev_uv, prev_valid,
                              frame_count, enable_hint, width, height,
                              grid=None):
    """ONE jittered reprojection + ONE packed banded gather for BOTH the
    DI and GI temporal histories (cfg.history_joint_gather).

    The reference draws an independent half-pixel jitter per pass
    (ray_gen_ris.slang:233-267 DI, :408-432 GI); sharing one draw
    correlates only that reprojection jitter between the two history
    reads (quality pinned by the converged-truth CI bounds,
    tests/test_quality.py) and halves the banded-gather fixed cost: one
    (P, C_di+C_gi) row gather + one retention cond instead of two.
    Returns (seed, h_di, h_gi, base_ok) with both w_sum columns zeroed
    as in _gather_reservoir_banded."""
    seed, j1, j2 = rng_mod.rnd2(seed)
    px = jnp.floor(prev_uv[:, 0] * width + (j1 - 0.5)).astype(jnp.int32)
    py = jnp.floor(prev_uv[:, 1] * height + (j2 - 0.5)).astype(jnp.int32)
    in_bounds = (px >= 0) & (py >= 0) & (px < width) & (py < height)
    base_ok = prev_valid & in_bounds & (frame_count > 0)
    pi = jnp.clip(py * width + px, 0, width * height - 1)
    leaves_di, treedef_di = jax.tree_util.tree_flatten(hist_di)
    leaves_gi, treedef_gi = jax.tree_util.tree_flatten(hist_gi)
    wsum_di, wsum_gi = leaves_di[1], leaves_gi[1]
    lv = leaves_di[:1] + leaves_di[2:] + leaves_gi[:1] + leaves_gi[2:]
    out, in_band = _gather_packed(
        lv, pi, width, cfg.history_gather_band, cfg.history_gather_halo,
        cfg.history_gather_layout, cfg.history_gather_mode,
        cfg.history_shift_radius,
        grid=grid, grid_halo=(grid.halo_t if grid is not None else 0),
        valid=base_ok & enable_hint, shift_global=cfg.history_shift_global,
        force=cfg.history_gather_force,
        auto_min_retention=cfg.history_auto_min_retention,
    )
    n_di = len(leaves_di) - 1
    out_di = out[:1] + [jnp.zeros_like(wsum_di)] + out[1:n_di]
    out_gi = (out[n_di:n_di + 1] + [jnp.zeros_like(wsum_gi)]
              + out[n_di + 1:])
    if in_band is not None:
        base_ok = base_ok & in_band
    return (seed,
            jax.tree_util.tree_unflatten(treedef_di, out_di),
            jax.tree_util.tree_unflatten(treedef_gi, out_gi),
            base_ok)


@jax.named_scope("di_temporal")
def di_temporal_reuse(lights: Lights, cfg, seed, r: ReservoirDI,
                      history: ReservoirDI, prev_uv, prev_valid, frame_count,
                      hit_pos, hit_normal, v_view, albedo, roughness, metallic,
                      virtual_distance, width, height, enable, grid=None,
                      pregathered=None):
    """DI temporal reuse with jittered reprojection + normal/depth confidence
    (ray_gen_ris.slang:233-267). pregathered: optional (history, base_ok)
    from gather_temporal_histories (the joint DI+GI gather path)."""
    if pregathered is not None:
        h, base_ok = pregathered
        ok = enable & base_ok
    else:
        seed, j1, j2 = rng_mod.rnd2(seed)
        # int2(prev_pixel + jitter) with jitter in [-0.5, 0.5) — for
        # non-negative coords HLSL int() truncation == floor.
        px = jnp.floor(prev_uv[:, 0] * width + (j1 - 0.5)).astype(jnp.int32)
        py = jnp.floor(prev_uv[:, 1] * height + (j2 - 0.5)).astype(jnp.int32)
        in_bounds = (px >= 0) & (py >= 0) & (px < width) & (py < height)
        ok = enable & prev_valid & in_bounds & (frame_count > 0)

        pi = jnp.clip(py * width + px, 0, width * height - 1)
        h, in_band = _gather_reservoir_banded(history, pi, width, cfg, grid,
                                              valid=ok)
        if in_band is not None:
            ok = ok & in_band
    h = h.replace(
        M=jnp.minimum(h.M, cfg.di_temporal_m_clamp),
        W=jnp.minimum(h.W, cfg.di_temporal_w_clamp),
    )

    ndot = jnp.sum(hit_normal * h.hit_normal, axis=-1)
    normal_conf = smoothstep(0.9, 0.99, ndot)
    depth_diff = jnp.abs(virtual_distance - h.depth) / jnp.maximum(
        virtual_distance, 1e-4
    )
    depth_conf = 1.0 - smoothstep(0.05, 0.20, depth_diff)
    conf = normal_conf * depth_conf
    h = h.replace(M=h.M * conf)

    use = ok & (h.W > 0.0)
    h = h.replace(light_idx=jnp.minimum(h.light_idx, lights.num - 1))
    p_hat_hist, _ = lights.eval_p_hat(
        h.light_idx, h.light_pos, h.light_normal,
        hit_pos, hit_normal, v_view, albedo, roughness, metallic,
    )
    seed, u_m = rng_mod.rnd(seed)
    r = merge_di(r, h, p_hat_hist, u_m, use)

    p_hat_merged, _ = lights.eval_p_hat(
        r.light_idx, r.light_pos, r.light_normal,
        hit_pos, hit_normal, v_view, albedo, roughness, metallic,
    )
    w_new = r.w_sum / jnp.maximum(r.M * p_hat_merged, 1e-4)
    r = r.replace(W=jnp.where(use, w_new, r.W))
    return seed, r


@jax.named_scope("gi_temporal")
def gi_temporal_reuse(cfg, seed, r: ReservoirGI, history: ReservoirGI,
                      prev_uv, prev_valid, frame_count,
                      hit_pos, hit_normal, albedo, metallic,
                      virtual_distance, width, height, enable, grid=None,
                      pregathered=None):
    """GI temporal reuse (ray_gen_ris.slang:408-432). pregathered: optional
    (history, base_ok) from gather_temporal_histories."""
    if pregathered is not None:
        h, base_ok = pregathered
        ok = enable & base_ok
    else:
        seed, j1, j2 = rng_mod.rnd2(seed)
        px = jnp.floor(prev_uv[:, 0] * width + (j1 - 0.5)).astype(jnp.int32)
        py = jnp.floor(prev_uv[:, 1] * height + (j2 - 0.5)).astype(jnp.int32)
        in_bounds = (px >= 0) & (py >= 0) & (px < width) & (py < height)
        ok = enable & prev_valid & in_bounds & (frame_count > 0)
        pi = jnp.clip(py * width + px, 0, width * height - 1)
        h, in_band = _gather_reservoir_banded(history, pi, width, cfg, grid,
                                              valid=ok)
        if in_band is not None:
            ok = ok & in_band

    ndot = jnp.sum(hit_normal * h.hit_normal, axis=-1)
    normal_conf = smoothstep(0.8, 0.95, ndot)
    depth_diff = jnp.abs(virtual_distance - h.depth) / jnp.maximum(
        virtual_distance, 1e-4
    )
    depth_conf = 1.0 - smoothstep(0.05, 0.20, depth_diff)
    conf = normal_conf * depth_conf

    h = h.replace(
        M=jnp.minimum(h.M, cfg.gi_temporal_m_clamp) * conf,
        W=jnp.minimum(h.W, cfg.gi_temporal_w_clamp),
    )
    use = ok & (h.W > 0.0) & (h.M > 0.0)
    p_hat_hist = gi_target_pdf(
        hit_pos, hit_normal, albedo, metallic, h.sample_pos, h.sample_radiance
    )
    seed, u_m = rng_mod.rnd(seed)
    r = merge_gi(r, h, p_hat_hist, 1.0, u_m, use)
    p_hat_merged = gi_target_pdf(
        hit_pos, hit_normal, albedo, metallic, r.sample_pos, r.sample_radiance
    )
    w_new = jnp.where(
        p_hat_merged > 1e-6, r.w_sum / jnp.maximum(r.M * p_hat_merged, 1e-9), 0.0
    )
    r = r.replace(W=jnp.where(use, w_new, r.W))
    return seed, r


def smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
