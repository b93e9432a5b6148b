"""Shadow-boundary (visibility) gradients for first-bounce NEE.

The NEE estimator's visibility V(x, y) is a step function of scene
parameters: a silhouette edge sweeping its shadow across a receiver
produces NO reverse-mode gradient (the measured envelope: AD = 0 vs
central FD +0.67 on the occluder-translation case,
tests/test_grads.py::TestOcclusionBoundaryEnvelope, docs/PARITY.md).
The reference renderer has no gradients at all — this is the repo's own
differentiability axis (BASELINE.md:40).

This module adds the missing BOUNDARY term of

    I(x) = sum_lights integral_light f(x, y) V(x, y) dA(y)

via deterministic silhouette-edge integration (the secondary-
discontinuity boundary integral of Li et al. 2018, "Differentiable
Monte Carlo Ray Tracing through Edge Sampling", specialized to
triangle area lights and evaluated with fixed quadrature instead of
edge sampling — data-parallel: a dense (P, E, S) batch instead of
data-dependent edge selection):

  d I/d theta += sum_{silhouette edges e} int_{y on proj_x(e) ∩ light}
                   f(x, y) <dy/dtheta, n_dark(y)> dl(y)

where proj_x(e) is the edge projected from x onto the light's plane and
n_dark is the in-plane curve normal pointing into the occluded region.
The term is injected as a ZERO-FORWARD expression: every coefficient
(f, n_dark, dl, masks) is stop_gradient'd, y(theta) keeps its autodiff
dependence on (x, edge endpoints, light plane), and the caller adds
`term - stop_gradient(term)` — exact zeros in the primal, exactly the
boundary integral in reverse mode (first-order linearization at the
current parameters, which is all a gradient is).

Scope and documented limitations (docs/PARITY.md):
  - first rough bounce, plain-NEE lighting path only (the diffuse NEE
    integrand of render/pathtrace.py's nee branch);
  - the projected edge segment is assumed unoccluded between x and the
    edge, and the edge itself visible from x (no tertiary occlusion);
  - O(P * E * L * S) work — dense quadrature over EVERY scene edge; fine
    for CI scenes (Cornell: ~60 edges), gate behind
    cfg.shadow_boundary_grads for production scenes;
  - GI/multi-bounce occlusion boundaries remain out of scope.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

sg = jax.lax.stop_gradient


def build_edge_topology(scene):
    """Host-side unique-edge extraction from CONCRETE scene arrays.

    Edges are deduplicated by quantized world-space endpoint positions
    per instance (flat-shaded meshes duplicate vertices per face, so
    vertex-id matching would miss adjacency). Returns
    (edge_tri (E, 2) int32, edge_k (E,) int32): edge e is local edge k
    of world triangle edge_tri[e, 0] (corners k, (k+1)%3), and
    edge_tri[e, 1] is the other face sharing it (-1 = open boundary).
    """
    tri_vidx = np.asarray(scene.tri_vidx)
    tri_inst = np.asarray(scene.tri_inst)
    pos = np.asarray(scene.positions)
    xf = np.asarray(scene.inst_transform)          # (I, 3, 4)

    world = (
        np.einsum("tij,tkj->tki", xf[tri_inst][:, :, :3], pos[tri_vidx])
        + xf[tri_inst][:, None, :, 3]
    )                                               # (T, 3, 3)
    q = np.round(world / 1e-5).astype(np.int64)     # quantized corners

    seen: dict = {}
    edge_tri = []
    edge_k = []
    for t in range(q.shape[0]):
        for k in range(3):
            a = tuple(q[t, k]) + (int(tri_inst[t]),)
            b = tuple(q[t, (k + 1) % 3]) + (int(tri_inst[t]),)
            key = (a, b) if a <= b else (b, a)
            if key in seen:
                e = seen[key]
                if edge_tri[e][1] == -1:
                    edge_tri[e] = (edge_tri[e][0], t)
                # >2 faces on one edge (non-manifold): keep first two.
            else:
                seen[key] = len(edge_tri)
                edge_tri.append((t, -1))
                edge_k.append(k)
    return (
        jnp.asarray(np.asarray(edge_tri, np.int32)),
        jnp.asarray(np.asarray(edge_k, np.int32)),
    )


def with_edge_topology(scene):
    """Returns scene with edge_tri/edge_k populated (host-side; call
    OUTSIDE jit, at scene build time)."""
    et, ek = build_edge_topology(scene)
    return scene.replace(edge_tri=et, edge_k=ek)


def _tri_corner(w0, w1, w2, tri, k):
    """World corner k of triangles `tri`: (N,) indices -> (N, 3)."""
    c0 = jnp.take(w0, tri, axis=0)
    c1 = jnp.take(w1, tri, axis=0)
    c2 = jnp.take(w2, tri, axis=0)
    return jnp.where(
        (k == 0)[:, None], c0, jnp.where((k == 1)[:, None], c1, c2)
    )


def nee_boundary_term(scene, lights, tris_w, x, normal, albedo,
                      nee_mask, quadrature: int = 4,
                      candidates: int = 0):
    """The zero-forward boundary-gradient injection for first-bounce NEE.

    scene: SceneBuffers WITH edge topology (with_edge_topology).
    lights: restir.Lights (world light triangles).
    tris_w: (w0, w1, w2) DIFFERENTIABLE world triangle corners
            (scene.world_triangle_vertices() — do NOT pass the tracer's
            stop_gradient'd copy).
    x: (P, 3) shading points (differentiable); normal/albedo: shading
    attrs of the NEE lanes; nee_mask: (P,) lanes running the NEE
    estimator this round.

    Returns (P, 3): exactly zero in the primal; its reverse-mode
    gradient w.r.t. (vertices, transforms, camera-through-x) is the
    visibility boundary term of the diffuse NEE integrand
    f = em * albedo/pi * cos_s * cos_l / d^2 (the estimator's integrand,
    render/pathtrace.py nee branch).
    """
    w0, w1, w2 = tris_w
    e_t = scene.edge_tri                                  # (E, 2)
    e_k = scene.edge_k                                    # (E,)
    e_n = e_t.shape[0]
    p = x.shape[0]

    # Edge endpoints (E, 3), differentiable through verts/transforms.
    t1 = e_t[:, 0]
    a = _tri_corner(w0, w1, w2, t1, e_k)
    b = _tri_corner(w0, w1, w2, t1, (e_k + 1) % 3)

    # Adjacent face geometric normals (E, 3) + a point on each face.
    def face_geom(tri):
        tric = jnp.maximum(tri, 0)
        v0 = jnp.take(w0, tric, axis=0)
        v1 = jnp.take(w1, tric, axis=0)
        v2 = jnp.take(w2, tric, axis=0)
        n = jnp.cross(v1 - v0, v2 - v0)
        n = n / jnp.maximum(
            jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12
        )
        return n, v0

    n1, c1 = face_geom(t1)
    n2, c2 = face_geom(e_t[:, 1])
    has2 = e_t[:, 1] >= 0

    # --- Broadcast: pixels x edges. All classification is stop-grad. ---
    xs = sg(x)                                            # (P, 3)
    d1 = jnp.sum(
        (xs[:, None, :] - sg(c1)[None, :, :]) * sg(n1)[None, :, :], -1
    )                                                     # (P, E)
    d2 = jnp.sum(
        (xs[:, None, :] - sg(c2)[None, :, :]) * sg(n2)[None, :, :], -1
    )
    front1 = d1 > 0.0
    front2 = d2 > 0.0
    silhouette = jnp.where(
        has2[None, :], front1 ^ front2, jnp.ones_like(front1)
    )
    # The occluded side of the projected curve is decided by which side
    # of the EDGE PLANE (the plane through x containing the edge) the
    # blocking face's body lies on — NOT by the face normal (which
    # degenerates when the occluder is parallel to the light plane).
    # The face body's side is read off its opposite corner; at a true
    # silhouette both adjacent faces fold onto the same side, so the
    # front face's corner is representative (computed per pixel below).
    # c_opp via position arithmetic (v0+v1+v2 - a - b) — index-free, so
    # it works for the second face whose corner ordering is unknown.
    def opp_corner(tri):
        tric = jnp.maximum(tri, 0)
        return (
            jnp.take(w0, tric, axis=0) + jnp.take(w1, tric, axis=0)
            + jnp.take(w2, tric, axis=0)
        )

    c_opp1 = sg(opp_corner(t1) - a - b)                   # (E, 3)
    c_opp2 = sg(opp_corner(e_t[:, 1]) - a - b)
    c_opp_pe = jnp.where(
        front1[:, :, None], c_opp1[None, :, :],
        jnp.where((has2[None, :] & front2)[:, :, None],
                  c_opp2[None, :, :], c_opp1[None, :, :]),
    )                                                     # (P, E, 3)

    out = jnp.zeros((p, 3), jnp.float32)

    lv0 = lights.v0
    lv1 = lights.v1
    lv2 = lights.v2
    l_em = lights.emission
    l_n = lights.num

    for li in range(l_n):
        light = (lv0[li], lv1[li], lv2[li], l_em[li])
        if candidates and candidates < e_n:
            # Per-pixel top-K candidate pruning (VERDICT r4 item 6): a
            # cheap (P, E) viability score — silhouette class, the edge
            # heading toward the light plane with the plane beyond it,
            # and a margin-expanded projected-inside test at the edge's
            # endpoints/midpoint — then K argmax extractions. Selected
            # edges run the SAME quadrature as the dense path through
            # per-pixel gathered endpoints (tables are E rows — tiny).
            # Truncation (a pixel with more than K active silhouette
            # edges) drops the overflow edges' contribution; equality
            # with the dense path is pinned for the CI scenes in
            # tests/test_grads.py::TestBoundaryPruning.
            score = _candidate_score(
                xs, a, b, silhouette, light, nee_mask
            )                                             # (P, E)
            live = score > 0.0
            idxs = []
            for _ in range(candidates):
                k_idx = jnp.argmax(score, axis=1)         # (P,)
                idxs.append(k_idx)
                score = jnp.where(
                    jax.nn.one_hot(k_idx, e_n, dtype=bool), -1.0, score
                )
            n_live = jnp.sum(live, axis=1)                # (P,)
            for rank, k_idx in enumerate(idxs):
                sel_ok = nee_mask & (n_live > rank)
                a_k = jnp.take(a, k_idx, axis=0)          # (P, 3) diff
                b_k = jnp.take(b, k_idx, axis=0)
                c_opp_k = jnp.take_along_axis(
                    c_opp_pe, k_idx[:, None, None], axis=1
                )[:, 0, :]
                sil_k = jnp.take_along_axis(
                    silhouette, k_idx[:, None], axis=1
                )[:, 0]
                out = out + _edge_light_quadrature(
                    x, xs, normal, albedo, (sel_ok & sil_k)[:, None],
                    a_k[:, None, :], b_k[:, None, :],
                    c_opp_k[:, None, :], light, quadrature,
                )
        else:
            out = out + _edge_light_quadrature(
                x, xs, normal, albedo,
                nee_mask[:, None] & silhouette,
                jnp.broadcast_to(a[None], (p,) + a.shape),
                jnp.broadcast_to(b[None], (p,) + b.shape),
                c_opp_pe, light, quadrature,
            )

    return out - sg(out)


def _candidate_score(xs, a, b, silhouette, light, nee_mask):
    """(P, E) pruning score: positive iff the edge plausibly crosses the
    light from x. Conservative-leaning: the projected-inside test is
    evaluated at the edge endpoints and midpoint with a light-scale
    margin, so near misses stay candidates; magnitude ranks candidates
    by projected length / distance (bigger shadows first)."""
    p0, p1, p2, _ = light
    nl = jnp.cross(p1 - p0, p2 - p0)
    nl_u = sg(nl / jnp.maximum(jnp.linalg.norm(nl), 1e-12))
    scale = sg(jnp.maximum(
        jnp.maximum(jnp.linalg.norm(p1 - p0), jnp.linalg.norm(p2 - p1)),
        jnp.linalg.norm(p0 - p2),
    ))
    cnum = jnp.sum((sg(p0)[None, :] - xs) * nl_u[None, :], -1)   # (P,)

    def project_ok(pt):                                   # pt (E, 3)
        d = sg(pt)[None, :, :] - xs[:, None, :]           # (P, E, 3)
        denom = jnp.sum(d * nl_u[None, None, :], -1)
        heading = denom * cnum[:, None] > 0.0
        t_hit = cnum[:, None] / jnp.where(
            jnp.abs(denom) > 1e-9, denom, 1e-9)
        between = t_hit > 1.0 + 1e-6
        y = xs[:, None, :] + t_hit[..., None] * d
        # Distance from y to the light triangle's plane-projected AABB,
        # with a `scale` margin.
        lo = sg(jnp.minimum(jnp.minimum(p0, p1), p2))[None, None, :]
        hi = sg(jnp.maximum(jnp.maximum(p0, p1), p2))[None, None, :]
        near = jnp.all(
            (y > lo - scale * 0.6) & (y < hi + scale * 0.6), axis=-1
        )
        return heading & between & near

    mid = sg(0.5 * (a + b))
    ok = project_ok(sg(a)) | project_ok(sg(b)) | project_ok(mid)
    dist = jnp.maximum(
        jnp.linalg.norm(mid[None, :, :] - xs[:, None, :], axis=-1), 1e-3
    )
    elen = sg(jnp.linalg.norm(b - a, axis=-1))
    score = (elen[None, :] / dist) * 1.0
    return jnp.where(
        ok & silhouette & nee_mask[:, None], score, 0.0
    )


def _edge_light_quadrature(x, xs, normal, albedo, valid_pe, a_pe, b_pe,
                           c_opp_pe, light, quadrature):
    """The boundary-integral quadrature for per-pixel edge sets.

    a_pe/b_pe: (P, E', 3) DIFFERENTIABLE edge endpoints (E' = all edges
    broadcast, or K pruned candidates); c_opp_pe (P, E', 3) stop-grad
    side reference; valid_pe (P, E') classification mask. Returns (P, 3)
    (zero-forward injection happens in the caller)."""
    p0, p1, p2, em = light
    nl = jnp.cross(p1 - p0, p2 - p0)
    nl_u = nl / jnp.maximum(jnp.linalg.norm(nl), 1e-12)
    s_q = (jnp.arange(quadrature, dtype=jnp.float32) + 0.5) / quadrature

    a = a_pe
    b = b_pe
    # Quadrature points on every edge: (P, E', S, 3), differentiable.
    e_pt = a[:, :, None, :] + s_q[None, None, :, None] * (
        (b - a)[:, :, None, :])
    d = e_pt - x[:, None, None, :]                        # (P, E', S, 3)
    denom = jnp.sum(d * nl_u[None, None, None, :], -1)
    cnum = jnp.sum(
        (p0[None, :] - x)[:, None, None, :] * nl_u[None, None, None, :],
        -1,
    )
    t_hit = cnum / jnp.where(jnp.abs(denom) > 1e-9, denom, 1e-9)
    behind = sg(t_hit) <= 1.0 + 1e-6       # edge not between x and plane
    y = x[:, None, None, :] + t_hit[..., None] * d        # (P, E', S, 3)

    # Inside-light test (stop-grad).
    ys = sg(y)

    def edge_fn(q0, q1, pt):
        return jnp.sum(
            jnp.cross(q1 - q0, pt - q0) * nl_u[None, None, None, :], -1
        )

    s0 = edge_fn(sg(p0), sg(p1), ys)
    s1 = edge_fn(sg(p1), sg(p2), ys)
    s2 = edge_fn(sg(p2), sg(p0), ys)
    inside = (
        ((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
        | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0))
    )

    # Curve tangent dy/ds and in-plane dark-side normal (stop-grad).
    ab = sg(b - a)[:, :, None, :]
    dts = (
        -sg(cnum)[..., None]
        * jnp.sum(ab * nl_u[None, None, None, :], -1, keepdims=True)
        / jnp.where(jnp.abs(sg(denom))[..., None] > 1e-9,
                    sg(denom)[..., None] ** 2, 1e-9)
    )
    dy_ds = dts * sg(d) + sg(t_hit)[..., None] * ab       # (P, E', S, 3)
    n0 = jnp.cross(jnp.broadcast_to(nl_u, dy_ds.shape), dy_ds)
    n0 = n0 / jnp.maximum(
        jnp.linalg.norm(n0, axis=-1, keepdims=True), 1e-12
    )
    # Edge-plane normal (through x, containing the edge) and the
    # dark-side orientation (see the caller's c_opp note).
    np_ = jnp.cross(
        sg(b - a), xs[:, None, :] - sg(a)
    )                                                     # (P, E', 3)
    face_side = jnp.sum((c_opp_pe - sg(a)) * np_, -1)     # (P, E')
    y_side = jnp.sum(n0 * np_[:, :, None, :], -1)         # (P, E', S)
    orient = jnp.sign(face_side[:, :, None] * y_side)
    n_dark = orient[..., None] * n0

    # Diffuse NEE integrand density at y (stop-grad coefficient).
    dist = jnp.maximum(
        jnp.linalg.norm(sg(y) - xs[:, None, None, :], axis=-1), 1e-4)
    ldir = (sg(y) - xs[:, None, None, :]) / dist[..., None]
    cos_s = jnp.maximum(
        jnp.sum(sg(normal)[:, None, None, :] * ldir, -1), 0.0)
    cos_l = jnp.maximum(
        jnp.sum(-ldir * sg(nl_u)[None, None, None, :], -1), 0.0)
    f_rgb = (
        sg(em)[None, None, None, :]
        * sg(albedo)[:, None, None, :] / np.pi
        * (cos_s * cos_l / (dist * dist))[..., None]
    )                                                     # (P, E', S, 3)

    dl = jnp.linalg.norm(sg(dy_ds), axis=-1) / quadrature

    valid = (
        valid_pe[:, :, None]
        & inside & ~behind
        & (sg(denom) * sg(cnum) > 0.0)
        & (cos_s > 0.0) & (cos_l > 0.0)
    )
    w_q = jnp.where(valid, dl, 0.0)[..., None] * f_rgb    # (P, E', S, 3)
    # The ONLY non-stop-grad factor: <y(theta), n_dark>.
    lin = jnp.sum(y * n_dark, -1, keepdims=True)          # (P, E', S, 1)
    return jnp.sum(w_q * lin, axis=(1, 2))
