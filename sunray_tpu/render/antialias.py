"""Primary-visibility silhouette gradients: screen-space edge antialiasing.

The pipeline's gradients flow through the differentiable hit-attribute
recompute (render/shade.py) — shading terms only. Visibility itself (which
triangle wins a pixel) is a step function of geometry and camera, so
silhouette motion produces NO gradient: an occluder can slide across the
image without the loss noticing until a pixel flips.

This pass adds the missing boundary term for PRIMARY visibility the way
nvdiffrast's antialias operator does: for each adjacent pixel pair that
straddles a silhouette (different winning triangles + a depth gap), find
where the closer triangle's projected edge crosses the segment between the
pixel centers and blend the two pixel colors by the crossed fraction. The
blend factor is a differentiable function of the projected vertices, so
d(image)/d(vertices, camera) picks up exactly the silhouette term — and
forward rendering gets analytic edge antialiasing for free.

Scope (documented in docs/PARITY.md): primary hits only (the pass runs on
its own camera-ray trace); secondary-bounce visibility (shadows, GI
occlusion) remains shading-gradient-only. Interior shared edges are
suppressed by the depth-gap test, not mesh adjacency. The explicit
shard_map path (parallel/spmd.py) has its own frame body and does not run
this pass (GSPMD sharding of render_frame handles it transparently).

Layout: everything is pad+slice shifts and elementwise math on (H, W)
planes; the only gather is one packed row gather of the winning
triangles' vertices. All intermediates stay 2-D (H, W) per-component
(see render/shade.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A pair of adjacent pixels counts as a silhouette when the winning
# triangles differ AND the hit distances differ by this relative gap —
# interior edges of a connected surface have continuous depth.
DEPTH_GAP = 0.02
_EPS = 1e-12


def _project_px(view_proj, x, y, z, width, height):
    """World point -> screen pixel coords (matching camera.generate_rays:
    a pixel's primary hit projects to its center (ix+0.5, iy+0.5)).
    Inputs/outputs are flat (P,) component arrays."""
    cols = [
        view_proj[i, 0] * x + view_proj[i, 1] * y + view_proj[i, 2] * z
        + view_proj[i, 3]
        for i in (0, 1, 3)
    ]
    w = jnp.where(jnp.abs(cols[2]) > _EPS, cols[2], _EPS)
    sx = (cols[0] / w * 0.5 + 0.5) * width
    sy = (cols[1] / w * 0.5 + 0.5) * height
    behind = cols[2] <= 0.0
    return sx, sy, behind


def _edge_crossing(ax, ay, bx, by, ccx, ccy, horizontal):
    """Crossing parameter e of screen edge (A, B) with the unit segment
    from pair-center (ccx, ccy) toward +x (horizontal) or +y: e in [0, 1]
    measures the crossing position from the first pixel's center.
    Returns (e, valid)."""
    if horizontal:
        pa, pb, qa, qb, c0, cq = ay, by, ax, bx, ccy, ccx
    else:
        pa, pb, qa, qb, c0, cq = ax, bx, ay, by, ccx, ccy
    # The edge spans the scanline through the pair centers.
    crosses = (pa - c0) * (pb - c0) <= 0.0
    denom = pb - pa
    denom = jnp.where(jnp.abs(denom) > _EPS, denom, _EPS)
    t = (c0 - pa) / denom
    e = qa + (qb - qa) * t - cq
    valid = crosses & (e >= 0.0) & (e <= 1.0)
    return jnp.where(valid, e, 0.5), valid


def _pair_blend(img, delta, sv, tri, t_hit, axis):
    """One pass over adjacent pixel pairs along `axis` (1 = horizontal
    neighbors, 0 = vertical). Accumulates color adjustments into delta."""
    h, w = tri.shape

    def nxt(a):
        if axis == 1:
            return a[:, 1:], a[:, :-1]
        return a[1:, :], a[:-1, :]

    tri_q, tri_p = nxt(tri)
    t_q, t_p = nxt(t_hit)
    sil = (tri_p != tri_q) & (
        jnp.abs(t_p - t_q) > DEPTH_GAP * jnp.minimum(jnp.abs(t_p), jnp.abs(t_q))
    )

    # Closer pixel owns the silhouette edge.
    p_closer = t_p <= t_q
    edge = []
    for comp in sv:  # 12 planes: sx0, sy0, bh0, sx1, ... per corner
        cq, cp = nxt(comp)
        edge.append(jnp.where(p_closer, cp, cq))
    # Pair-center of the FIRST pixel (p) in pair coordinates.
    if axis == 1:
        ccx = jnp.arange(w - 1, dtype=jnp.float32)[None, :] + 0.5
        ccy = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
        ccx = jnp.broadcast_to(ccx, (h, w - 1))
        ccy = jnp.broadcast_to(ccy, (h, w - 1))
    else:
        ccx = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
        ccy = jnp.arange(h - 1, dtype=jnp.float32)[:, None] + 0.5
        ccx = jnp.broadcast_to(ccx, (h - 1, w))
        ccy = jnp.broadcast_to(ccy, (h - 1, w))

    best_e = jnp.full_like(ccx, 0.5)
    best_valid = jnp.zeros(ccx.shape, bool)
    any_behind = jnp.zeros(ccx.shape, bool)
    for k in range(3):
        ax_, ay_, bh_a = edge[3 * k], edge[3 * k + 1], edge[3 * k + 2]
        k2 = (k + 1) % 3
        bx_, by_, bh_b = edge[3 * k2], edge[3 * k2 + 1], edge[3 * k2 + 2]
        e, valid = _edge_crossing(ax_, ay_, bx_, by_, ccx, ccy,
                                  horizontal=(axis == 1))
        any_behind = any_behind | (bh_a > 0.5) | (bh_b > 0.5)
        # Prefer the crossing with the strongest blend effect.
        take = valid & (~best_valid | (jnp.abs(e - 0.5) > jnp.abs(best_e - 0.5)))
        best_e = jnp.where(take, e, best_e)
        best_valid = best_valid | valid

    active = sil & best_valid & ~any_behind
    e = jnp.where(active, best_e, 0.5)

    # e > 0.5: the near surface leaks into the second pixel (q);
    # e < 0.5: the first pixel (p) loses coverage to q's surface.
    alpha_q = jnp.maximum(e - 0.5, 0.0)
    alpha_p = jnp.maximum(0.5 - e, 0.0)
    # Leaked color: the OTHER pixel's color.
    for ch in range(3):
        cq, cp = nxt(img[..., ch])
        dq = alpha_q * (cp - cq)
        dp = alpha_p * (cq - cp)
        if axis == 1:
            delta = delta.at[:, 1:, ch].add(dq)
            delta = delta.at[:, :-1, ch].add(dp)
        else:
            delta = delta.at[1:, :, ch].add(dq)
            delta = delta.at[:-1, :, ch].add(dp)
    return delta


def primary_edge_aa(scene, cfg, tracer, mats, img, tri=None, t_hit=None):
    """Antialias `img` (H, W, 3 linear) along primary silhouettes and make
    it differentiable w.r.t. silhouette motion. Visibility ids are
    stop-gradient; the blend factors differentiate through vertex
    projection.

    tri/t_hit: the raw primary-hit (P,) triangle ids (-1 = miss) and
    distances, normally taken from the RIS pass's first walk round
    (gbuffer.PrimaryHit.first_tri/first_t) so no extra trace runs; traced
    here only if absent."""
    h, w = cfg.height, cfg.width
    if (tri is None) != (t_hit is None):
        raise ValueError("pass tri and t_hit together (or neither)")
    if tri is None:
        from sunray_tpu.camera import generate_rays
        from sunray_tpu.render.trace import trace_closest

        orig, dirs = generate_rays(mats, w, h)
        hit = trace_closest(tracer, orig.reshape(-1, 3), dirs.reshape(-1, 3))
        tri = jnp.where(hit.hit, hit.tri, -1)
        t_hit = jnp.where(hit.hit, hit.t, 1e9)

    # Winning triangles' world vertices: one packed row gather, then
    # projection per corner (differentiable through verts + camera).
    v0, v1, v2 = scene.world_triangle_vertices()
    vcat = jnp.concatenate([v0, v1, v2], axis=1)         # (T, 9)
    rows = vcat[jnp.maximum(tri, 0)]                     # (P, 9)
    vp = mats["view_proj"]
    sv = []
    for k in range(3):
        sx, sy, behind = _project_px(
            vp, rows[:, 3 * k], rows[:, 3 * k + 1], rows[:, 3 * k + 2], w, h
        )
        sv += [sx.reshape(h, w), sy.reshape(h, w),
               behind.astype(jnp.float32).reshape(h, w)]

    tri_im = tri.reshape(h, w)
    t_im = t_hit.reshape(h, w)
    delta = jnp.zeros_like(img)
    delta = _pair_blend(img, delta, sv, tri_im, t_im, axis=1)
    delta = _pair_blend(img, delta, sv, tri_im, t_im, axis=0)
    return img + delta
