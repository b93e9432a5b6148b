"""Binned (cluster-culled) ray tracing for big single meshes.

Why not a per-ray BVH walk: the vmapped stack walk is gather-bound (two
dynamic row gathers per iteration). Why not plain brute force: linear in
triangles, hopeless past a few thousand.

This module keeps brute force's dense Moller-Trumbore tile but only runs it
where geometry can actually be hit (the ray-stream / binning literature,
restructured for XLA's static shapes), all in plain jnp/lax:

1. Triangles are packed into fixed-size spatial CLUSTERS (Morton order,
   K tris each) at load time — the "leaves" of a one-level hierarchy.
2. Rays (raster order) are cut into BLOCKS of RB lanes. A conservative
   interval-arithmetic slab test culls (block, cluster) pairs: it bounds
   every per-ray slab test of the block at once from the block's (origin,
   direction) box, so it can only over-include (unit-tested property).
3. Surviving pairs are stream-compacted into a flat work list (one sort),
   sorted block-major. Each round gathers every work item's ray block and
   triangle cluster, runs the Moller-Trumbore tile, and segment-reduces
   the per-item results into their ray blocks (min-t for closest hit, OR
   for occlusion); a "touched" plane marks blocks that received work.
4. The work list is consumed in fixed-size ROUNDS inside a while_loop
   (static shapes, dynamic trip count), merging per-round results — so
   capacity never truncates work, and typical traces take one round.

Expected cost vs brute: (hit pairs / total pairs) of the brute tile's
compute plus a ~log^2 sort of NB*C bits. Reference analog: the RT
hardware's AS traversal (accel.rs / tlas.rs). A traversal designed for the
GPU is ROADMAP Reach (a).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sunray_tpu.ops import intersect

CLUSTER_K = 128        # triangles per cluster
BLOCK_RAYS = 512       # rays per block
WORK_CHUNK = 4096      # (block, cluster) pairs consumed per round
TILE_ELEMS = 1 << 20   # (item x tri x ray) elements per lax.map step
DET_EPS = intersect.DET_EPS


class ClusterSet(NamedTuple):
    """Triangle clustering (pytree; shapes static per scene topology).

    tri_ids: (C*K,) i32 — global triangle id per pack slot (-1 padding).
        The cluster ASSIGNMENT is load-time topology (like a BVH's tree
        shape); geometry is refit in-jit per frame (refit_cluster_set).
    tri_pack: (C, 16, K) f32 — SoA rows per cluster:
        0-2 v0.xyz, 3-5 v1.xyz, 6-8 v2.xyz, 9 tri id (bitcast i32,
        -1 padding), 10-15 zero padding.
    aabb_lo/aabb_hi: (C, 3) cluster bounds (padding tris anchored inside).
    """

    tri_ids: jnp.ndarray
    tri_pack: jnp.ndarray
    aabb_lo: jnp.ndarray
    aabb_hi: jnp.ndarray

    @property
    def num_clusters(self) -> int:
        return self.tri_pack.shape[0]


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (N, 3) points in [0, 1)."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


def build_cluster_set(tris, k: int = CLUSTER_K) -> ClusterSet:
    """Host-side clustering: Morton-sort triangle centroids, chunk into
    clusters of k. tris: (v0, v1, v2) arrays (T, 3) (numpy or jax)."""
    v0, v1, v2 = (np.asarray(v, np.float32) for v in tris)
    t = v0.shape[0]
    cent = (v0 + v1 + v2) / 3.0
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-9)
    order = np.argsort(_morton3((cent - lo) / span), kind="stable")

    c = max(1, -(-t // k))
    pad = c * k - t
    # Padding slots repeat the last real triangle (degenerate at its v0
    # would also work, but repeating keeps refit branch-free): id -1 marks
    # them invalid; their geometry stays inside the cluster AABB.
    ids = np.concatenate([order, np.full(pad, -1, np.int64)]).astype(np.int32)
    pack, aabb_lo, aabb_hi = _pack_clusters(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
        jnp.asarray(ids), c, k,
    )
    return ClusterSet(
        tri_ids=jnp.asarray(ids),
        tri_pack=pack,
        aabb_lo=aabb_lo,
        aabb_hi=aabb_hi,
    )


def _pack_clusters(v0, v1, v2, ids, c, k):
    """(C, 16, K) pack + (C, 3) AABBs from world triangles and slot ids.
    jit-traceable; all intermediates 2-D (tile-padding rule)."""
    gid = jnp.maximum(ids, 0)
    # Padding slots anchor to the LAST VALID slot's triangle (the
    # Morton-last one, which lives in the padded cluster) — anchoring to
    # the globally max id would balloon the last cluster's AABB and
    # defeat its culling.
    slot = jnp.arange(ids.shape[0], dtype=jnp.int32)
    last_valid = jnp.max(jnp.where(ids >= 0, slot, -1))
    anchor = gid[jnp.maximum(last_valid, 0)]
    gid = jnp.where(ids >= 0, gid, anchor)
    vcat = jnp.concatenate([v0, v1, v2], axis=1)           # (T, 9)
    rows = vcat[gid]                                       # ONE row gather
    cols = [rows[:, a] for a in range(9)]
    comp = [x.reshape(c, k) for x in cols]                 # 9 x (C, K)
    # DENORMAL-SAFE pack assembly: small int ids bitcast to f32 are
    # denormals, and in-jit float assembly may flush them to zero (the
    # class that silently blacked out the bvh2 TLAS) — stack everything as
    # int32 bit patterns and reinterpret ONCE.
    def f2i(x):
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    comp_i = [f2i(x) for x in comp] + [ids.reshape(c, k)]
    zero_i = jnp.zeros((c, k), jnp.int32)
    pack = jax.lax.bitcast_convert_type(
        jnp.stack(comp_i + [zero_i] * 6, axis=1), jnp.float32
    )                                                      # (C, 16, K)
    lo = [jnp.min(jnp.minimum(jnp.minimum(comp[a], comp[3 + a]),
                              comp[6 + a]), axis=1) for a in range(3)]
    hi = [jnp.max(jnp.maximum(jnp.maximum(comp[a], comp[3 + a]),
                              comp[6 + a]), axis=1) for a in range(3)]
    return pack, jnp.stack(lo, axis=-1), jnp.stack(hi, axis=-1)


def refit_cluster_set(cs: ClusterSet, tris) -> ClusterSet:
    """Recompute pack + AABBs from current (differentiable) world triangles,
    keeping the load-time cluster assignment — the AS UPDATE analog
    (acceleration_structure/mod.rs refit vs rebuild)."""
    v0, v1, v2 = tris
    c, _, k = cs.tri_pack.shape
    pack, lo, hi = _pack_clusters(v0, v1, v2, cs.tri_ids, c, k)
    return ClusterSet(tri_ids=cs.tri_ids, tri_pack=pack, aabb_lo=lo,
                      aabb_hi=hi)


# ---------------------------------------------------------------------------
# Conservative (block x cluster) culling
# ---------------------------------------------------------------------------


def _interval_cull(o_t, d_t, tn, tx, aabb_lo, aabb_hi, nb, rb):
    """((NB, C) bool, (NB, C) f32 entry lower bound): hit is False only
    when NO ray in the block can hit the cluster AABB within [tmin, tmax];
    entry is a sound lower bound on any block ray's AABB entry t (used to
    order work near-to-far for closest-hit early termination).

    Soundness: for a ray r in block b, slab a gives entry tn_a(r) and exit
    tf_a(r). With interval bounds q_a = [(b- - o)/d] over the block's
    (o, d) box: tn_a(r) >= q_a.lo and tf_a(r) <= q_a.hi. A hit needs
    max_a tn_a(r) <= min_a tf_a(r), so max_a q_a.lo <= min_a q_a.hi is
    necessary. Direction intervals spanning zero make the axis
    unconstrained (quotient unbounded) — still conservative.
    """
    entry = jnp.full((nb, aabb_lo.shape[0]), -jnp.inf)
    exit_ = jnp.full((nb, aabb_lo.shape[0]), jnp.inf)
    reach = jnp.ones((nb, aabb_lo.shape[0]), bool)
    o_b = o_t[:, : nb * rb].reshape(3, nb, rb)
    d_b = d_t[:, : nb * rb].reshape(3, nb, rb)
    # Finite clamp: tmax=+inf would make the reachability products
    # inf * 0 = NaN below and silently cull everything.
    tx_b_ = jnp.minimum(
        jnp.max(tx[0, : nb * rb].reshape(nb, rb), axis=1), 3e37
    )[:, None]
    for a in range(3):
        olo = jnp.min(o_b[a], axis=1)[:, None]             # (NB, 1)
        ohi = jnp.max(o_b[a], axis=1)[:, None]
        dlo = jnp.min(d_b[a], axis=1)[:, None]
        dhi = jnp.max(d_b[a], axis=1)[:, None]
        spans0 = (dlo <= 0.0) & (dhi >= 0.0)
        # inverse-direction interval (valid only when not spans0)
        safe_dlo = jnp.where(spans0, 1.0, dlo)
        safe_dhi = jnp.where(spans0, 1.0, dhi)
        ilo = jnp.minimum(1.0 / safe_dlo, 1.0 / safe_dhi)
        ihi = jnp.maximum(1.0 / safe_dlo, 1.0 / safe_dhi)
        # numerator interval (b - o) for both slab planes together
        nlo = aabb_lo[None, :, a] - ohi                    # (NB, C)
        nhi = aabb_hi[None, :, a] - olo
        p1 = nlo * ilo
        p2 = nlo * ihi
        p3 = nhi * ilo
        p4 = nhi * ihi
        qlo = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
        qhi = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
        qlo = jnp.where(spans0, -jnp.inf, qlo)
        qhi = jnp.where(spans0, jnp.inf, qhi)
        entry = jnp.maximum(entry, qlo)
        exit_ = jnp.minimum(exit_, qhi)
        # Coordinate reachability: over t in [0, tmax] the block's rays
        # cover o + t*d in [olo + tmax*min(dlo,0), ohi + tmax*max(dhi,0)];
        # the slab must overlap it. This is the only constraint left when
        # the direction interval spans zero (near-parallel rays), and a
        # sound extra cull otherwise.
        clo = olo + tx_b_ * jnp.minimum(dlo, 0.0)
        chi = ohi + tx_b_ * jnp.maximum(dhi, 0.0)
        reach = reach & (chi >= aabb_lo[None, :, a]) & (clo <= aabb_hi[None, :, a])

    tn_b = jnp.min(tn[0, : nb * rb].reshape(nb, rb), axis=1)[:, None]
    tx_b = jnp.max(tx[0, : nb * rb].reshape(nb, rb), axis=1)[:, None]
    hit = (entry <= exit_) & (exit_ >= tn_b) & (entry <= tx_b) & reach
    return hit, entry


# ---------------------------------------------------------------------------
# Work-list rounds
# ---------------------------------------------------------------------------
#
# One work item = one (ray block, cluster) pair. Work is sorted block-major
# (then near-to-far within a block). A round evaluates `work` items in
# lax.map steps of TILE_ELEMS elements and folds each item's per-ray result
# into its ray block with a segment reduction; ties between items go to the
# earlier item, as a sequential walk of the list would resolve them.


def _tile_hits(rows, o, d, tn, tx, ex):
    """Moller-Trumbore of I items' triangle tiles against their ray blocks.
    rows: (I, 16, K) cluster pack rows; o, d: (I, 3, RB); tn, tx, ex:
    (I, RB). Returns (tt (I, K, RB) inf-where-invalid, uu, vv, valid,
    ids (I, K, 1))."""
    v0x, v0y, v0z = (rows[:, a, :, None] for a in range(3))
    e1x, e1y, e1z = (rows[:, 3 + a, :, None] - rows[:, a, :, None]
                     for a in range(3))
    e2x, e2y, e2z = (rows[:, 6 + a, :, None] - rows[:, a, :, None]
                     for a in range(3))
    ids = jax.lax.bitcast_convert_type(rows[:, 9], jnp.int32)[:, :, None]
    ox, oy, oz = (o[:, a, None, :] for a in range(3))
    dx, dy, dz = (d[:, a, None, :] for a in range(3))

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = jnp.abs(det) > DET_EPS
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)

    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det

    valid = (
        det_ok
        & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
        & (tt >= tn[:, None, :]) & (tt <= tx[:, None, :])
        & (ids >= 0)
        & (ids != ex[:, None, :])
    )
    return jnp.where(valid, tt, jnp.inf), uu, vv, valid, ids


def _item_closest(tt, uu, vv, valid, ids):
    """Per-item closest hit over the tile's triangle axis (first minimum):
    (t, tri (-1 = none), u, v), each (I, RB)."""
    k = jnp.argmin(tt, axis=1)[:, None, :]
    pick = lambda x: jnp.take_along_axis(x, k, axis=1)[:, 0, :]
    ok = pick(valid)
    ids_b = jnp.broadcast_to(ids, tt.shape)
    return (pick(tt), jnp.where(ok, pick(ids_b), -1), pick(uu), pick(vv))


def _map_items(fn, n_items, tile_elems_per_item, *xs):
    """lax.map `fn` over item chunks sized to TILE_ELEMS; xs lead with the
    item axis (n_items)."""
    step = max(1, min(n_items, TILE_ELEMS // max(tile_elems_per_item, 1)))
    n_steps = -(-n_items // step)
    pad = n_steps * step - n_items
    xs = [jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)])
          if pad else x for x in xs]
    xs = [x.reshape((n_steps, step) + x.shape[1:]) for x in xs]
    out = jax.lax.map(lambda a: fn(*a), xs)
    return jax.tree_util.tree_map(
        lambda y: y.reshape((n_steps * step,) + y.shape[2:])[:n_items], out)


def _fold_blocks(closest, outs, bids, nb):
    """Segment-reduce per-item (I, RB) results into (1, nb*RB) ray-block
    planes plus the touched plane (the merge format of _rounds)."""
    work = bids.shape[0]
    rb = outs[0].shape[1]
    touched = jax.ops.segment_max(jnp.ones((work,), jnp.float32), bids,
                                  num_segments=nb)
    touched = jnp.broadcast_to(jnp.maximum(touched, 0.0)[:, None], (nb, rb))
    flat = lambda x: x.reshape(1, nb * rb)
    if not closest:
        occ = jax.ops.segment_max(outs[0].astype(jnp.float32), bids,
                                  num_segments=nb)
        return [flat(jnp.maximum(occ, 0.0)), flat(touched)]
    t, tri, u, v = outs
    t_min = jax.ops.segment_min(t, bids, num_segments=nb)     # (nb, RB)
    item = jnp.broadcast_to(jnp.arange(work, dtype=jnp.int32)[:, None],
                            t.shape)
    first = jax.ops.segment_min(
        jnp.where(t == t_min[bids], item, work), bids, num_segments=nb)
    first = jnp.clip(first, 0, work - 1)
    lane = jnp.arange(rb)[None, :]
    return [flat(t_min), flat(tri[first, lane]), flat(u[first, lane]),
            flat(v[first, lane]), flat(touched)]


def _ray_items(bids, o_t, d_t, tn, tx, ex):
    """Gather each item's ray block: o, d (I, 3, RB); tn, tx, ex (I, RB)."""
    rb = BLOCK_RAYS
    blk3 = lambda x: jnp.moveaxis(x.reshape(3, -1, rb), 1, 0)[bids]
    blk1 = lambda x: x.reshape(-1, rb)[bids]
    return blk3(o_t), blk3(d_t), blk1(tn), blk1(tx), blk1(ex)


_OUT_SPECS_CLOSEST = 5   # t, tri, u, v, touched
_OUT_SPECS_ANYHIT = 2    # occ, touched


def _round_call(n_out, bids, cids, o_t, d_t, tn, tx, ex, tri_pack, nb):
    """One round of (block, cluster) items -> merge-format planes."""
    closest = n_out == _OUT_SPECS_CLOSEST
    k = tri_pack.shape[2]

    def fn(b, c):
        o, d, tn_i, tx_i, ex_i = _ray_items(b, o_t, d_t, tn, tx, ex)
        tt, uu, vv, valid, ids = _tile_hits(tri_pack[c], o, d, tn_i, tx_i,
                                            ex_i)
        if closest:
            return _item_closest(tt, uu, vv, valid, ids)
        return (jnp.any(valid, axis=1),)

    outs = _map_items(fn, bids.shape[0], k * BLOCK_RAYS, bids, cids)
    return _fold_blocks(closest, outs, bids, nb)


def _prep(orig, d, tmin, tmax, exclude):
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = orig.shape[0]
    nb = -(-n // BLOCK_RAYS)
    npad = nb * BLOCK_RAYS - n
    o_t = jnp.pad(orig, ((0, npad), (0, 0))).T
    d_t = jnp.pad(d, ((0, npad), (0, 0)), constant_values=1.0).T
    tn = jnp.pad(
        jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,)), (0, npad)
    )[None]
    # Padded lanes get tmax = -inf: they can never hit.
    tx = jnp.pad(
        jnp.broadcast_to(jnp.asarray(tmax, jnp.float32).reshape(-1), (n,)),
        (0, npad), constant_values=-jnp.inf,
    )[None]
    ex = (
        jnp.pad(jnp.asarray(exclude, jnp.int32).reshape(-1), (0, npad),
                constant_values=-2)[None]
        if exclude is not None
        else jnp.full((1, nb * BLOCK_RAYS), -2, jnp.int32)
    )
    return o_t, d_t, tn, tx, ex, n, nb


def _work_list(hit, entry, nb, c, work_chunk):
    """Sorted work list from the cull mask: (flat ids, nnz, chunk size).
    Sort keys (miss, block, entry): hits first, block-major, near-to-far
    within a block."""
    flat = hit.reshape(-1)
    nnz = jnp.sum(flat.astype(jnp.int32))
    idx = jnp.arange(nb * c, dtype=jnp.int32)
    ent_flat = entry.reshape(-1)
    # float -> order-preserving uint32 key
    b = jax.lax.bitcast_convert_type(ent_flat, jnp.uint32)
    ent_key = jnp.where(
        (b & jnp.uint32(0x80000000)) != 0, ~b, b | jnp.uint32(0x80000000)
    )
    miss = (~flat).astype(jnp.int32)
    bid = idx // c
    _, _, _, order = jax.lax.sort((miss, bid, ent_key, idx), num_keys=3)
    work = min(work_chunk, nb * c)
    # Padding keeps the final round's dynamic_slice from clamping its
    # start (which would desynchronize `pos` from the sliced items).
    order = jnp.concatenate([order, jnp.zeros((work,), jnp.int32)])
    return order, nnz, work


def _rounds(n_out, merge, init, order, nnz, work, c,
            o_t, d_t, tn, tx, ex, tri_pack, nb):
    """Consume the work list in fixed-size rounds inside a while_loop;
    `merge(state, outs)` folds one round's outputs."""

    def round_body(state):
        off = state[0]
        ids = jax.lax.dynamic_slice(order, (off,), (work,))
        pos = off + jnp.arange(work, dtype=jnp.int32)
        # Duplicate the last valid work item into the tail: merging is
        # idempotent, so repeats are free of special-casing.
        last = jnp.minimum(jnp.maximum(nnz - 1 - off, 0), work - 1)
        last_id = jax.lax.dynamic_index_in_dim(ids, last, keepdims=False)
        ids = jnp.where(pos < nnz, ids, last_id)
        outs = _round_call(
            n_out, ids // c, ids % c, o_t, d_t, tn, tx, ex, tri_pack, nb,
        )
        return (off + work,) + merge(state[1:], outs)

    out = jax.lax.while_loop(lambda s: s[0] < nnz, round_body,
                             (jnp.int32(0),) + init)
    return out[1:]


def _spread9(v):
    """Interleave a 9-bit uint32 lane to every 3rd bit (Morton spread)."""
    v = (v | (v << jnp.uint32(16))) & jnp.uint32(0x030000FF)
    v = (v | (v << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
    v = (v | (v << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
    v = (v | (v << jnp.uint32(2))) & jnp.uint32(0x09249249)
    return v


def _coherence_keys(orig, d, lo, hi):
    """Per-ray sort key that groups rays into cullable blocks: direction
    octant in the 3 HIGH bits (the interval cull's slab quotients blow up
    to (-inf, inf) whenever a block's direction interval spans zero, so
    sign-coherence comes first), then a 9-bit/axis origin Morton code.

    Incoherent bounce/GI rays hit the binned tracer's worst case — raster-
    order blocks have unbounded (o, d) boxes and the cull rate is 1.0.
    Sorting by these keys rebuilds coherent blocks at the cost of two
    multi-operand XLA sorts."""
    span = jnp.maximum(hi - lo, 1e-9)
    q = jnp.clip((orig - lo) / span * 512.0, 0.0, 511.0).astype(jnp.uint32)
    morton = (
        (_spread9(q[:, 0]) << jnp.uint32(2))
        | (_spread9(q[:, 1]) << jnp.uint32(1))
        | _spread9(q[:, 2])
    )
    octant = (
        (d[:, 0] >= 0.0).astype(jnp.uint32) * jnp.uint32(4)
        + (d[:, 1] >= 0.0).astype(jnp.uint32) * jnp.uint32(2)
        + (d[:, 2] >= 0.0).astype(jnp.uint32)
    )
    return (octant << jnp.uint32(27)) | morton


def _reorder_rays(cs, orig, d, tmax, exclude):
    """Coherence-sort rays (one multi-operand lax.sort — payload rides the
    sort network instead of a post-hoc 2M-row permutation gather).
    Returns (orig, d, tmax, exclude, lane) sorted by key."""
    n = orig.shape[0]
    lo = jnp.min(cs.aabb_lo, axis=0)
    hi = jnp.max(cs.aabb_hi, axis=0)
    key = _coherence_keys(orig, d, lo, hi)
    lane = jnp.arange(n, dtype=jnp.int32)
    tmax_a = jnp.broadcast_to(
        jnp.asarray(tmax, jnp.float32).reshape(-1), (n,)
    ) if jnp.ndim(tmax) <= 1 else tmax
    # Dead lanes (tmax = -inf, e.g. the pair-stream overflow fallback's
    # masked rays) sort LAST so their blocks are fully dead and the
    # interval cull removes them outright.
    key = jnp.where(tmax_a == -jnp.inf, jnp.uint32(0xFFFFFFFF), key)
    ex = (jnp.asarray(exclude, jnp.int32).reshape(-1)
          if exclude is not None else jnp.full((n,), -2, jnp.int32))
    (_, ox, oy, oz, dx, dy, dz, tx_s, ex_s, lane_s) = jax.lax.sort(
        (key, orig[:, 0], orig[:, 1], orig[:, 2], d[:, 0], d[:, 1], d[:, 2],
         tmax_a, ex, lane),
        num_keys=1,
    )
    return (jnp.stack([ox, oy, oz], axis=-1),
            jnp.stack([dx, dy, dz], axis=-1), tx_s, ex_s, lane_s)


def trace_closest_binned(cs: ClusterSet, orig, d, tmin=intersect.T_MIN,
                         tmax=intersect.T_MAX, exclude=None,
                         work_chunk=WORK_CHUNK, reorder=False):
    """Closest hit over a ClusterSet. orig/d: (N, 3). Returns intersect.Hit.

    reorder=True: coherence-sort the rays first (incoherent bounce/GI
    batches; see _coherence_keys) and un-sort the results."""
    if reorder:
        orig = orig.reshape(-1, 3)
        d = d.reshape(-1, 3)
        orig, d, tmax, exclude, lane = _reorder_rays(cs, orig, d, tmax,
                                                     exclude)
        hit = trace_closest_binned(cs, orig, d, tmin, tmax, exclude,
                                   work_chunk, reorder=False)
        _, t_o, tri_o, u_o, v_o, hit_o = jax.lax.sort(
            (lane, hit.t, hit.tri, hit.u, hit.v,
             hit.hit.astype(jnp.int32)),
            num_keys=1,
        )
        return intersect.Hit(t=t_o, tri=tri_o, u=u_o, v=v_o,
                             hit=hit_o > 0)
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, exclude)
    c = cs.num_clusters
    hit, entry = _interval_cull(o_t, d_t, tn, tx, cs.aabb_lo, cs.aabb_hi,
                                nb, BLOCK_RAYS)
    order, nnz, work = _work_list(hit, entry, nb, c, work_chunk)
    n_lanes = nb * BLOCK_RAYS

    def merge(state, outs):
        best_t, best_tri, best_u, best_v = state
        t_r, tri_r, u_r, v_r, touched = outs
        tm = (touched[0] > 0.0) & (t_r[0] < best_t) & (tri_r[0] >= 0)
        return (
            jnp.where(tm, t_r[0], best_t),
            jnp.where(tm, tri_r[0], best_tri),
            jnp.where(tm, u_r[0], best_u),
            jnp.where(tm, v_r[0], best_v),
        )

    init = (
        jnp.full((n_lanes,), jnp.inf),
        jnp.full((n_lanes,), -1, jnp.int32),
        jnp.zeros((n_lanes,)),
        jnp.zeros((n_lanes,)),
    )
    best_t, best_tri, best_u, best_v = _rounds(
        _OUT_SPECS_CLOSEST, merge, init,
        order, nnz, work, c, o_t, d_t, tn, tx, ex, cs.tri_pack, nb,
    )

    return intersect.Hit(
        t=jnp.where(best_tri[:n] >= 0, best_t[:n], jnp.inf),
        tri=jnp.maximum(best_tri[:n], 0),
        u=best_u[:n],
        v=best_v[:n],
        hit=best_tri[:n] >= 0,
    )


def trace_occluded_binned(cs: ClusterSet, orig, d, tmax,
                          tmin=intersect.T_MIN, exclude=None,
                          work_chunk=WORK_CHUNK, reorder=False):
    """Any-hit occlusion query: True where something blocks [tmin, tmax]
    (OR over the culled clusters; no argmin/attribute outputs)."""
    if reorder:
        orig = orig.reshape(-1, 3)
        d = d.reshape(-1, 3)
        orig, d, tmax, exclude, lane = _reorder_rays(cs, orig, d, tmax,
                                                     exclude)
        occ = trace_occluded_binned(cs, orig, d, tmax, tmin, exclude,
                                    work_chunk, reorder=False)
        _, occ_o = jax.lax.sort((lane, occ.astype(jnp.int32)), num_keys=1)
        return occ_o > 0
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, exclude)
    c = cs.num_clusters
    hit, entry = _interval_cull(o_t, d_t, tn, tx, cs.aabb_lo, cs.aabb_hi,
                                nb, BLOCK_RAYS)
    order, nnz, work = _work_list(hit, entry, nb, c, work_chunk)
    n_lanes = nb * BLOCK_RAYS

    def merge(state, outs):
        occ_acc, = state
        occ, touched = outs
        return (occ_acc | ((touched[0] > 0.0) & (occ[0] > 0.0)),)

    (occ,) = _rounds(
        _OUT_SPECS_ANYHIT, merge,
        (jnp.zeros((n_lanes,), bool),),
        order, nnz, work, c, o_t, d_t, tn, tx, ex, cs.tri_pack, nb,
    )
    return occ[:n]


# ---------------------------------------------------------------------------
# Pair-stream tracing: per-RAY culling for incoherent batches
# ---------------------------------------------------------------------------
#
# The block-cull pipeline above is bounded by BLOCK diversity: a 512-ray
# block of coherence-sorted bounce rays still touches ~19% of all clusters
# while each RAY individually passes ~2.3 clusters (0.4%) — a gap no sort
# key can close. The fix is to assign work per (ray, cluster) PAIR:
#
#   1. A scan slab-tests every ray against every supercluster AABB and
#      records its first L_SLOTS hit superclusters + the exact hit count
#      (rays with more go to a masked fallback through the block path).
#   2. Pairs (ray x slot) are payload-sorted by cluster id, cut into
#      512-pair blocks, and a work item is emitted per (block,
#      distinct-cid run).
#   3. The tile math runs as in the block path — one supercluster per
#      item — with lanes masked to the item's cid, folded per pair block.
#   4. Results unsort by pair position and reduce over slots per ray
#      (min for closest, OR for any-hit), merged with the fallback.
#
# Tile work drops from (surviving block pairs) x 512 rays to ~(hit pairs),
# i.e. toward the per-ray floor the cull-rate analysis identified.

L_SLOTS = 8            # recorded superclusters per ray (overflow -> fallback)
SC_K = 4               # clusters per supercluster (scan/pair granularity:
                       # grazing-tangent rays touch many cluster AABBs and
                       # blew the slot budget at cluster granularity;
                       # Morton-consecutive groups of 4 collapse that tail
                       # while each pair expands back to its 4 clusters)


def _scan_rays(ray, ab, n_real, l_slots):
    """Slab test of R rays against every supercluster AABB; records each
    ray's first l_slots hit ids (ascending) and its exact hit count.
    ray: (R, 8) rows [ox, oy, oz, dx, dy, dz, tn, tx]; ab: (C, 6)
    [lo3, hi3]. Returns (slots (R, l_slots) int32 or -1, count (R,))."""
    o, dd = ray[:, 0:3], ray[:, 3:6]
    tn, tx = ray[:, 6:7], ray[:, 7:8]
    tiny = jnp.where(dd >= 0.0, 1e-12, -1e-12)
    inv = 1.0 / jnp.where(jnp.abs(dd) < 1e-12, tiny, dd)          # (R, 3)
    t1 = [(ab[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
          for a in range(3)]
    t2 = [(ab[None, :, 3 + a] - o[:, a:a + 1]) * inv[:, a:a + 1]
          for a in range(3)]
    tnc = jnp.maximum(jnp.maximum(jnp.minimum(t1[0], t2[0]),
                                  jnp.minimum(t1[1], t2[1])),
                      jnp.minimum(t1[2], t2[2]))
    tfc = jnp.minimum(jnp.minimum(jnp.maximum(t1[0], t2[0]),
                                  jnp.maximum(t1[1], t2[1])),
                      jnp.maximum(t1[2], t2[2]))
    cid = jnp.arange(ab.shape[0], dtype=jnp.int32)[None, :]
    # Small slack guards f32 rounding at AABB faces (overcull-safe: extra
    # pairs are merged idempotently; missing one loses hits).
    hit = ((tnc <= tfc + 1e-4) & (tfc >= tn - 1e-4)
           & (tnc <= tx + 1e-4) & (cid < n_real))                  # (R, C)
    total = jnp.cumsum(hit.astype(jnp.int32), axis=1)
    slots = jnp.stack(
        [jnp.max(jnp.where(hit & (total == l + 1), cid, -1), axis=1)
         for l in range(l_slots)], axis=1)
    return slots, total[:, -1]


def _cluster_scan(cs: ClusterSet, o_t, d_t, tn, tx, nb, l_slots=L_SLOTS):
    """Returns (slots (L, N) int32 SUPERCLUSTER ids or -1, count (N,)
    int32 — exact supercluster hit count per ray)."""
    c = -(-cs.num_clusters // SC_K)             # superclusters
    # Supercluster AABBs: union of each SC_K consecutive cluster boxes
    # (pad with empty boxes: lo=+inf/hi=-inf never slab-hit).
    cpad = c * SC_K - cs.num_clusters
    lo_p = jnp.pad(cs.aabb_lo, ((0, cpad), (0, 0)),
                   constant_values=jnp.inf)
    hi_p = jnp.pad(cs.aabb_hi, ((0, cpad), (0, 0)),
                   constant_values=-jnp.inf)
    sc_lo = jnp.min(lo_p.reshape(c, SC_K, 3), axis=1)
    sc_hi = jnp.max(hi_p.reshape(c, SC_K, 3), axis=1)
    ab = jnp.concatenate([sc_lo, sc_hi], axis=1)                 # (C, 6)
    ray = jnp.concatenate([o_t, d_t, tn, tx], axis=0).T          # (N, 8)
    slots, cnt = _map_items(
        lambda r: _scan_rays(r, ab, c, l_slots), ray.shape[0], c, ray)
    return slots.T, cnt

def _pair_round_call(n_out, bids, cids, o_t, d_t, tn, tx, ex, pc,
                     tri_pack):
    """One round of (pair block, supercluster) items: each item tests its
    SC_K clusters (in order) against the pair lanes whose cid matches."""
    closest = n_out == _OUT_SPECS_CLOSEST
    nb = pc.shape[1] // BLOCK_RAYS
    k = tri_pack.shape[2]
    # Pad the pack to an SC_K multiple: zero rows decode to degenerate
    # triangles (det = 0 -> never valid).
    cpad = -(-tri_pack.shape[0] // SC_K) * SC_K - tri_pack.shape[0]
    if cpad:
        tri_pack = jnp.pad(tri_pack, ((0, cpad), (0, 0), (0, 0)))
    sc_pack = tri_pack.reshape(-1, SC_K, 16, k)
    sc_pack = jnp.moveaxis(sc_pack, 1, 2).reshape(-1, 16, SC_K * k)

    def fn(b, c):
        o, d, tn_i, tx_i, ex_i = _ray_items(b, o_t, d_t, tn, tx, ex)
        mine = (pc.reshape(-1, BLOCK_RAYS)[b] == c[:, None])[:, None, :]
        tt, uu, vv, valid, ids = _tile_hits(sc_pack[c], o, d, tn_i, tx_i,
                                            ex_i)
        valid = valid & mine
        if closest:
            tt = jnp.where(valid, tt, jnp.inf)
            return _item_closest(tt, uu, vv, valid, ids)
        return (jnp.any(valid, axis=1),)

    outs = _map_items(fn, bids.shape[0], SC_K * k * BLOCK_RAYS, bids, cids)
    return _fold_blocks(closest, outs, bids, nb)


def _pair_work(cid_sorted, np_, c):
    """Work items from cid-sorted pair lanes: one per (512-pair block,
    distinct-cid run). Returns (bids, cids, nnz) sorted block-major."""
    nbp = np_ // BLOCK_RAYS
    pos = jnp.arange(np_, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.full((1,), -9, jnp.int32), cid_sorted[:-1]])
    first = ((pos % BLOCK_RAYS) == 0) | (cid_sorted != prev)
    valid = first & (cid_sorted < c)
    miss = (~valid).astype(jnp.int32)
    _, order = jax.lax.sort((miss, pos), num_keys=1)
    nnz = jnp.sum(valid.astype(jnp.int32))
    bids = order // BLOCK_RAYS
    cids = cid_sorted[order]
    return bids, cids, nnz, nbp


def _pair_stream_prep(cs, o_t, d_t, tn, tx, ex, nb):
    """Scan + pair expansion + cid sort. Returns pair-sorted ray planes,
    pair cid plane, unsort positions, work list, and the overflow mask."""
    c = -(-cs.num_clusters // SC_K)             # superclusters
    n_lanes = nb * BLOCK_RAYS
    slots, cnt = _cluster_scan(cs, o_t, d_t, tn, tx, nb)
    overflow = cnt > L_SLOTS
    # Dead sentinel c sorts live pairs first; overflow rays contribute NO
    # pairs (they are fully handled by the fallback pass).
    pair_ok = (slots >= 0) & ~overflow[None, :]
    cid = jnp.where(pair_ok, slots, c).reshape(-1)           # (L*N,)
    tile = lambda v: jnp.broadcast_to(v[0][None, :],
                                      (L_SLOTS, n_lanes)).reshape(-1)
    pospair = jnp.arange(L_SLOTS * n_lanes, dtype=jnp.int32)
    (cid_s, o0, o1, o2, d0, d1, d2, tx_s, ex_s, pos_s) = jax.lax.sort(
        (cid, tile(o_t[0:1]), tile(o_t[1:2]), tile(o_t[2:3]),
         tile(d_t[0:1]), tile(d_t[1:2]), tile(d_t[2:3]),
         tile(tx), ex_pair := tile(ex), pospair),
        num_keys=1,
    )
    bids, cids, nnz, nbp = _pair_work(cid_s, L_SLOTS * n_lanes, c)
    o_p = jnp.stack([o0, o1, o2])
    d_p = jnp.stack([d0, d1, d2])
    tn_p = jnp.broadcast_to(tn[0, :1], (L_SLOTS * n_lanes,))[None]
    # Dead-sentinel lanes must never hit (their block may still be
    # visited by a work item for a live cid run in the same block).
    tx_p = jnp.where(cid_s < c, tx_s, -jnp.inf)[None]
    return (o_p, d_p, tn_p, tx_p, ex_s[None], cid_s[None], pos_s,
            bids, cids, nnz, nbp, overflow)


def trace_closest_pairs(cs: ClusterSet, orig, d, tmin=intersect.T_MIN,
                        tmax=intersect.T_MAX, exclude=None):
    """Closest hit via the pair stream (incoherent-ray path). Exact same
    results as trace_closest_binned (any slab-reachable triangle is
    tested; overflow rays ride the block path)."""
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, exclude)
    (o_p, d_p, tn_p, tx_p, ex_p, pc, pos_s, bids, cids, nnz, nbp,
     overflow) = _pair_stream_prep(cs, o_t, d_t, tn, tx, ex, nb)
    np_ = o_p.shape[1]

    outs = _pair_rounds(
        _OUT_SPECS_CLOSEST, bids, cids, nnz,
        o_p, d_p, tn_p, tx_p, ex_p, pc, cs.tri_pack, np_,
    )
    t_r, tri_r, u_r, v_r, touched = outs
    hitm = (touched[0] > 0.0) & (tri_r[0] >= 0)
    # Unsort by pair position, reduce over slots.
    (_, t_o, tri_o, u_o, v_o, hit_o) = jax.lax.sort(
        (pos_s, jnp.where(hitm, t_r[0], jnp.inf), tri_r[0], u_r[0],
         v_r[0], hitm.astype(jnp.int32)),
        num_keys=1,
    )
    n_lanes = nb * BLOCK_RAYS
    t_l = t_o.reshape(L_SLOTS, n_lanes)
    tri_l = tri_o.reshape(L_SLOTS, n_lanes)
    u_l = u_o.reshape(L_SLOTS, n_lanes)
    v_l = v_o.reshape(L_SLOTS, n_lanes)
    hit_l = hit_o.reshape(L_SLOTS, n_lanes) > 0
    k = jnp.argmin(jnp.where(hit_l, t_l, jnp.inf), axis=0)
    sel = jax.lax.broadcasted_iota(jnp.int32, t_l.shape, 0) == k[None, :]
    any_hit = jnp.any(hit_l, axis=0)
    pick = lambda x: jnp.max(jnp.where(sel, x, -jnp.inf), axis=0)
    best_t = jnp.where(any_hit, pick(jnp.where(hit_l, t_l, jnp.inf)),
                       jnp.inf)
    best_tri = jnp.max(jnp.where(sel & hit_l, tri_l, -1), axis=0)
    best_u = pick(u_l)
    best_v = pick(v_l)

    # Fallback: overflow rays through the block-cull path (masked).
    tx_f = jnp.where(overflow, tx[0], -jnp.inf)
    fb = trace_closest_binned(
        cs, jnp.moveaxis(o_t, 0, 1), jnp.moveaxis(d_t, 0, 1),
        tmin, tx_f, exclude=ex[0], reorder=True,
    )
    use_fb = overflow
    t_fin = jnp.where(use_fb, jnp.where(fb.hit, fb.t, jnp.inf), best_t)
    tri_fin = jnp.where(use_fb, jnp.where(fb.hit, fb.tri, -1), best_tri)
    u_fin = jnp.where(use_fb, fb.u, best_u)
    v_fin = jnp.where(use_fb, fb.v, best_v)
    return intersect.Hit(
        t=jnp.where(tri_fin[:n] >= 0, t_fin[:n], jnp.inf),
        tri=jnp.maximum(tri_fin[:n], 0),
        u=jnp.where(tri_fin[:n] >= 0, u_fin[:n], 0.0),
        v=jnp.where(tri_fin[:n] >= 0, v_fin[:n], 0.0),
        hit=tri_fin[:n] >= 0,
    )


def trace_occluded_pairs(cs: ClusterSet, orig, d, tmax,
                         tmin=intersect.T_MIN, exclude=None):
    """Any-hit occlusion via the pair stream."""
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, exclude)
    (o_p, d_p, tn_p, tx_p, ex_p, pc, pos_s, bids, cids, nnz, nbp,
     overflow) = _pair_stream_prep(cs, o_t, d_t, tn, tx, ex, nb)
    np_ = o_p.shape[1]

    occ_r, touched = _pair_rounds(
        _OUT_SPECS_ANYHIT, bids, cids, nnz,
        o_p, d_p, tn_p, tx_p, ex_p, pc, cs.tri_pack, np_,
    )
    occ_pair = (touched[0] > 0.0) & (occ_r[0] > 0.0)
    _, occ_o = jax.lax.sort((pos_s, occ_pair.astype(jnp.int32)), num_keys=1)
    n_lanes = nb * BLOCK_RAYS
    occ = jnp.any(occ_o.reshape(L_SLOTS, n_lanes) > 0, axis=0)

    tx_f = jnp.where(overflow, tx[0], -jnp.inf)
    fb = trace_occluded_binned(
        cs, jnp.moveaxis(o_t, 0, 1), jnp.moveaxis(d_t, 0, 1),
        tx_f, tmin, exclude=ex[0], reorder=True,
    )
    occ = jnp.where(overflow, fb, occ)
    return occ[:n]


def _pair_rounds(n_out, bids, cids, nnz, o_p, d_p, tn_p, tx_p,
                 ex_p, pc, tri_pack, np_, work_chunk=WORK_CHUNK):
    """Consume the pair work list in fixed-size rounds (mirrors _rounds:
    padding repeats the last valid item; merges are idempotent)."""
    work = min(work_chunk, np_ // BLOCK_RAYS + tri_pack.shape[0] + 1)
    bids_p = jnp.concatenate([bids, jnp.zeros((work,), jnp.int32)])
    cids_p = jnp.concatenate([cids, jnp.zeros((work,), jnp.int32)])
    n_lanes = np_

    if n_out == _OUT_SPECS_CLOSEST:
        init = (
            jnp.full((n_lanes,), jnp.inf),
            jnp.full((n_lanes,), -1, jnp.int32),
            jnp.zeros((n_lanes,)),
            jnp.zeros((n_lanes,)),
            jnp.zeros((n_lanes,)),
        )

        def merge(state, outs):
            best_t, best_tri, best_u, best_v, touch = state
            t_r, tri_r, u_r, v_r, touched = outs
            tm = (touched[0] > 0.0) & (t_r[0] < best_t) & (tri_r[0] >= 0)
            return (
                jnp.where(tm, t_r[0], best_t),
                jnp.where(tm, tri_r[0], best_tri),
                jnp.where(tm, u_r[0], best_u),
                jnp.where(tm, v_r[0], best_v),
                jnp.maximum(touch, touched[0]),
            )
    else:
        init = (jnp.zeros((n_lanes,)), jnp.zeros((n_lanes,)))

        def merge(state, outs):
            occ_acc, touch = state
            occ, touched = outs
            return (
                jnp.maximum(occ_acc,
                            jnp.where(touched[0] > 0.0, occ[0], 0.0)),
                jnp.maximum(touch, touched[0]),
            )

    def round_body(state):
        off = state[0]
        ids_b = jax.lax.dynamic_slice(bids_p, (off,), (work,))
        ids_c = jax.lax.dynamic_slice(cids_p, (off,), (work,))
        posw = off + jnp.arange(work, dtype=jnp.int32)
        last = jnp.minimum(jnp.maximum(nnz - 1 - off, 0), work - 1)
        last_b = jax.lax.dynamic_index_in_dim(ids_b, last, keepdims=False)
        last_c = jax.lax.dynamic_index_in_dim(ids_c, last, keepdims=False)
        ids_b = jnp.where(posw < nnz, ids_b, last_b)
        ids_c = jnp.where(posw < nnz, ids_c, last_c)
        outs = _pair_round_call(
            n_out, ids_b, ids_c, o_p, d_p, tn_p, tx_p, ex_p, pc, tri_pack,
        )
        return (off + work,) + merge(state[1:], outs)

    out = jax.lax.while_loop(lambda s: s[0] < nnz, round_body,
                             (jnp.int32(0),) + init)
    state = out[1:]
    if n_out == _OUT_SPECS_CLOSEST:
        best_t, best_tri, best_u, best_v, touch = state
        return ([best_t], [best_tri], [best_u], [best_v], [touch])
    occ_acc, touch = state
    return ([occ_acc], [touch])
