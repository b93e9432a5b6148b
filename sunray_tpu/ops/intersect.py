"""Ray-triangle intersection and the brute-force tracer (the oracle).

Möller-Trumbore over dense triangle blocks — the data-parallel formulation
of what `VK_KHR_acceleration_structure` + `TraceRay` do in hardware on the
reference (shaders call TraceRay; the driver owns traversal). Two query
types mirror the reference's two ray flags:

  - closest-hit (`TraceRay(..., RAY_FLAG_NONE)`): min-t hit over all
    triangles, returning (t, tri_id, u, v).
  - occlusion (`RAY_FLAG_ACCEPT_FIRST_HIT_AND_END_SEARCH |
    SKIP_CLOSEST_HIT`): boolean any-hit in (tmin, tmax), used by every
    shadow/visibility ray.

No backface culling (the reference traces with RAY_FLAG_NONE and no cull
flags). The brute tracer is exact, differentiable-friendly (hit *attributes*
are recomputed from the winning triangle id via `hit_attributes`, so
gradients flow through the intersection equations while the discrete
winner index is a constant), and serves as the oracle for the BVH tracer.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Default ray-block size for lax.map blocking (keeps (B, T) intermediates
# in the tens of MB for brute-force scenes; T is capped by
# RenderConfig.brute_force_max_tris).
RAY_BLOCK = 4096

T_MIN = 1e-3      # ray.TMin = 0.001 everywhere in the reference shaders
T_MAX = 1e4       # ray.TMax = 10000.0
DET_EPS = 1e-9


class Hit(NamedTuple):
    """Closest-hit result for a ray batch. All (N,)."""

    t: jnp.ndarray        # hit distance; >= tmax means miss
    tri: jnp.ndarray      # winning triangle id (undefined on miss)
    u: jnp.ndarray        # barycentric of vertex 1
    v: jnp.ndarray        # barycentric of vertex 2
    hit: jnp.ndarray      # bool


def moller_trumbore(orig, d, v0, v1, v2, tmin, tmax):
    """Batched ray-vs-triangle-set test.

    orig, d: (B, 3); v0, v1, v2: (T, 3); tmin/tmax scalar or (B,).
    Returns (t, u, v, valid), each (B, T).
    """
    e1 = v1 - v0                                   # (T, 3)
    e2 = v2 - v0
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])          # (B, T, 3)
    det = jnp.sum(e1[None] * pvec, axis=-1)                  # (B, T)
    # Grad-safe reciprocal: 1/det with det ~ 0 in the masked branch would
    # produce inf whose cotangent is NaN through `where`.
    det_safe = jnp.where(jnp.abs(det) > DET_EPS, det, 1.0)
    inv_det = jnp.where(jnp.abs(det) > DET_EPS, 1.0 / det_safe, 0.0)
    tvec = orig[:, None, :] - v0[None]                        # (B, T, 3)
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None] * qvec, axis=-1) * inv_det
    tmin = jnp.asarray(tmin)
    tmax = jnp.asarray(tmax)
    if tmin.ndim:
        tmin = tmin[:, None]
    if tmax.ndim:
        tmax = tmax[:, None]
    valid = (
        (jnp.abs(det) > DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= tmin)
        & (t <= tmax)
    )
    return t, u, v, valid


def _closest_block(orig, d, tris, tmin, tmax):
    v0, v1, v2 = tris
    t, u, v, valid = moller_trumbore(orig, d, v0, v1, v2, tmin, tmax)
    t = jnp.where(valid, t, jnp.inf)
    idx = jnp.argmin(t, axis=-1)                              # (B,)
    rows = jnp.arange(t.shape[0])
    best_t = t[rows, idx]
    return Hit(
        t=best_t,
        tri=idx.astype(jnp.int32),
        u=u[rows, idx],
        v=v[rows, idx],
        hit=jnp.isfinite(best_t),
    )


def _any_block(orig, d, tris, tmin, tmax, exclude=None):
    v0, v1, v2 = tris
    _, _, _, valid = moller_trumbore(orig, d, v0, v1, v2, tmin, tmax)
    if exclude is not None:
        t_ids = jnp.arange(v0.shape[0], dtype=jnp.int32)
        valid = valid & (t_ids[None, :] != exclude[:, None])
    return jnp.any(valid, axis=-1)


def _blocked(fn, orig, d, extra, block):
    """Apply fn over ray blocks with lax.map; pads N to a block multiple."""
    n = orig.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        orig = jnp.pad(orig, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        extra = jax.tree_util.tree_map(
            lambda x: jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)) if x.ndim else x,
            extra,
        )
    orig = orig.reshape(nb, block, 3)
    d = d.reshape(nb, block, 3)
    extra = jax.tree_util.tree_map(
        lambda x: x.reshape(nb, block, *x.shape[1:]) if x.ndim else x, extra
    )
    out = jax.lax.map(fn, (orig, d, extra))
    out = jax.tree_util.tree_map(lambda x: x.reshape(nb * block, *x.shape[2:]), out)
    if pad:
        out = jax.tree_util.tree_map(lambda x: x[:n], out)
    return out


def trace_closest_brute(tris, orig, d, tmin=T_MIN, tmax=T_MAX, block=RAY_BLOCK) -> Hit:
    """Closest hit over all triangles. tris: (v0, v1, v2) each (T, 3)."""
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    tmin_a = jnp.broadcast_to(jnp.asarray(tmin, orig.dtype), orig.shape[:1])
    tmax_a = jnp.broadcast_to(jnp.asarray(tmax, orig.dtype), orig.shape[:1])

    def fn(args):
        o, dd, (tn, tx) = args
        return _closest_block(o, dd, tris, tn, tx)

    return _blocked(fn, orig, d, (tmin_a, tmax_a), block)


def trace_occluded_brute(tris, orig, d, tmax, tmin=T_MIN, block=RAY_BLOCK,
                         exclude=None):
    """Any-hit in (tmin, tmax): True = occluded. tmax: (N,) segment length.

    exclude: optional (N,) int32 triangle id ignored per ray (the shadow
    ray's own target light/surface triangle); -1 = none.
    """
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    tmin_a = jnp.broadcast_to(jnp.asarray(tmin, orig.dtype), orig.shape[:1])
    tmax_a = jnp.asarray(tmax).reshape(-1)

    if exclude is None:
        def fn(args):
            o, dd, (tn, tx) = args
            return _any_block(o, dd, tris, tn, tx)

        return _blocked(fn, orig, d, (tmin_a, tmax_a), block)

    exclude = jnp.asarray(exclude, jnp.int32).reshape(-1)

    def fn(args):
        o, dd, (tn, tx, ex) = args
        return _any_block(o, dd, tris, tn, tx, ex)

    return _blocked(fn, orig, d, (tmin_a, tmax_a, exclude), block)


def hit_attributes(tris, orig, d, tri_id):
    """Recompute (t, u, v) for known winning triangles — differentiably.

    The winner index is discrete (from the tracer, treated as constant);
    the intersection equations re-evaluated here carry gradients to the
    triangle vertices, ray origin, and direction.
    """
    v0 = tris[0][tri_id]
    v1 = tris[1][tri_id]
    v2 = tris[2][tri_id]
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > DET_EPS, det, jnp.float32(DET_EPS))
    tvec = orig - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v
