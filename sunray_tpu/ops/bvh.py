"""LBVH build + traversal — the VK_KHR_acceleration_structure replacement.

The reference delegates BVH build/refit/traversal to the Vulkan driver
(acceleration_structure/accel.rs builds; shaders TraceRay). Here we own
the whole thing, built from data-parallel XLA operations:

Build (fully parallel, no sequential propagation — everything is sorts,
scans, and fixed-depth binary searches that XLA vectorizes):
  1. 30-bit Morton codes of triangle-centroid positions in the scene AABB.
  2. Sort leaves by code (`jnp.argsort`). Leaves hold `leaf_size`
     consecutive sorted triangles (K-wide leaves vectorize the leaf test).
  3. Karras 2012 linear topology: each internal node's range/split found
     with fixed-trip binary searches over common-prefix lengths
     (delta via popcount bit-smearing; index tiebreak for duplicate codes).
  4. Node AABBs: a Karras node covers a CONTIGUOUS sorted-leaf range
     [first, last], so its box is a range-min/max query — answered with a
     sparse table (log N levels of pairwise min/max) instead of the
     GPU-style atomic bottom-up refit. O(N log N), no atomics, no
     data-dependent depth.

Traversal: per-ray stack walk (`lax.while_loop`) vmapped over ray blocks —
the wavefront formulation: all lanes advance in lock step with masks, the
loop ends when every lane's stack is empty. Closest-hit and early-exit
occlusion variants; occlusion supports per-ray triangle exclusion (see
render/trace.py docstring).

Topology is non-differentiable by construction (int ops); intersection
attributes recomputed differentiably by the caller via
intersect.hit_attributes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from sunray_tpu.utils import struct

from sunray_tpu.ops import intersect

STACK_DEPTH = 64
# Rays per vmapped block. Stack memory = block * STACK_DEPTH * 4B. Chosen
# on an earlier accelerator; untuned on the H100 (ROADMAP: re-derive with
# the traversal redesign).
TRAVERSE_BLOCK = 8192


@struct.dataclass
class Bvh:
    # Topology: N_leaves leaves, N_leaves-1 internal nodes.
    # Node ids: [0, NL-2] internal, [NL-1, 2*NL-2] leaves (leaf k at NL-1+k).
    child_l: jnp.ndarray     # (NL-1,) int32 node id
    child_r: jnp.ndarray     # (NL-1,) int32 node id
    node_min: jnp.ndarray    # (2*NL-1, 3)
    node_max: jnp.ndarray    # (2*NL-1, 3)
    leaf_tri: jnp.ndarray    # (NL, K) int32 original triangle ids, -1 pad
    # Contiguous leaf range [first, last] covered by each internal node
    # (both Karras and DFS-ordered SAH trees have this property) — lets
    # refit_bvh recompute all node boxes from moved vertices without
    # rebuilding topology (the AS UPDATE op, accel.rs:213-277 analog).
    range_first: jnp.ndarray  # (NL-1,) int32
    range_last: jnp.ndarray   # (NL-1,) int32
    # Static (non-pytree) so jit treats traversal structure as compile-time.
    num_leaves: int = struct.field(pytree_node=False)


def _morton3(x, y, z):
    """Interleave 10-bit ints -> 30-bit Morton code (uint32)."""

    def spread(v):
        v = v.astype(jnp.uint32) & jnp.uint32(0x3FF)
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    return (spread(x) << 2) | (spread(y) << 1) | spread(z)


def _clz32(x):
    """Count leading zeros of uint32 via bit smear + popcount."""
    x = x.astype(jnp.uint32)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return 32 - jax.lax.population_count(x).astype(jnp.int32)


def karras_topology(leaf_codes):
    """Karras 2012 linear-BVH topology over n >= 2 sorted leaf codes.

    Returns (child_l, child_r, first, last), each (n-1,): child ids in
    [0, n-2] are internal, leaf k is id n-1+k; [first, last] is the
    contiguous sorted-leaf range each internal node covers. Fully
    parallel — fixed-trip binary searches, no sequential propagation.
    Shared by the triangle LBVH below and the instance TLAS (ops/bvh2.py).
    """
    n = leaf_codes.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    def delta(i, j):
        """Common-prefix length between leaf keys i and j; -1 out of range.
        Duplicate codes tie-broken by index (Karras sec. 4)."""
        valid = (j >= 0) & (j < n)
        jj = jnp.clip(j, 0, n - 1)
        ci = leaf_codes[i]
        cj = leaf_codes[jj]
        x = ci ^ cj
        d_code = _clz32(x)
        d_idx = 32 + _clz32((i ^ jj).astype(jnp.uint32))
        d = jnp.where(x == 0, d_idx, d_code)
        return jnp.where(valid, d, -1)

    i = idx[: n - 1]
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Upper bound for the range length: doubling search, 30 fixed steps.
    def lmax_body(_, lmax):
        cond = delta(i, i + lmax * d) > delta_min
        return jnp.where(cond, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(0, 31, lmax_body, jnp.full(n - 1, 2, jnp.int32))

    # Binary search the exact other end j = i + l*d.
    def l_body(s, carry):
        l, step = carry
        step = jnp.maximum(step // 2, 1)
        cand = l + step
        ok = delta(i, i + cand * d) > delta_min
        l = jnp.where(ok, cand, l)
        return l, step

    l, _ = jax.lax.fori_loop(
        0, 32, l_body, (jnp.zeros(n - 1, jnp.int32), lmax)
    )
    j = i + l * d
    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    delta_node = delta(i, j)

    # Binary search the split gamma in [first, last).
    def s_body(sstep, carry):
        gamma, step = carry
        step = (step + 1) // 2
        cand = gamma + step * d
        ok = delta(i, cand) > delta_node
        gamma = jnp.where(ok & (step > 0), cand, gamma)
        return gamma, jnp.where(step > 1, step, 0)

    gamma, _ = jax.lax.fori_loop(0, 32, s_body, (i, l))
    gamma = jnp.where(d > 0, gamma, gamma - 1)
    # gamma is now the last index of the left child range.

    leaf_base = n - 1
    left_is_leaf = first == gamma
    right_is_leaf = last == gamma + 1
    child_l = jnp.where(left_is_leaf, leaf_base + gamma, gamma)
    child_r = jnp.where(right_is_leaf, leaf_base + gamma + 1, gamma + 1)
    return (
        child_l.astype(jnp.int32),
        child_r.astype(jnp.int32),
        first.astype(jnp.int32),
        last.astype(jnp.int32),
    )


def build_bvh(tris, leaf_size: int = 4) -> Bvh:
    """Build an LBVH over world triangles. tris: (v0, v1, v2) each (T, 3)."""
    v0, v1, v2 = tris
    # Topology must not carry gradients (discrete structure).
    v0s = jax.lax.stop_gradient(v0)
    v1s = jax.lax.stop_gradient(v1)
    v2s = jax.lax.stop_gradient(v2)
    t = v0.shape[0]
    k = leaf_size

    centroid = (v0s + v1s + v2s) / 3.0
    smin = jnp.min(jnp.minimum(jnp.minimum(v0s, v1s), v2s), axis=0)
    smax = jnp.max(jnp.maximum(jnp.maximum(v0s, v1s), v2s), axis=0)
    extent = jnp.maximum(smax - smin, 1e-6)
    q = jnp.clip(((centroid - smin) / extent) * 1023.0, 0.0, 1023.0)
    q = q.astype(jnp.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])

    order = jnp.argsort(codes).astype(jnp.int32)
    sorted_codes = codes[order]

    # Group K consecutive sorted triangles per leaf.
    nl = -(-t // k)
    pad = nl * k - t
    tri_ids = jnp.pad(order, (0, pad), constant_values=-1).reshape(nl, k)
    pad_codes = jnp.pad(sorted_codes, (0, pad), mode="edge")
    leaf_codes = pad_codes.reshape(nl, k)[:, 0]

    # Leaf AABBs (over valid triangles only).
    def tri_box(ids):
        valid = (ids >= 0)[:, :, None]
        gids = jnp.maximum(ids, 0)
        a = v0s[gids]
        b = v1s[gids]
        c = v2s[gids]
        tmin = jnp.minimum(jnp.minimum(a, b), c)
        tmax = jnp.maximum(jnp.maximum(a, b), c)
        tmin = jnp.where(valid, tmin, jnp.inf)
        tmax = jnp.where(valid, tmax, -jnp.inf)
        return jnp.min(tmin, axis=1), jnp.max(tmax, axis=1)

    leaf_min, leaf_max = tri_box(tri_ids)     # (NL, 3)

    if nl == 1:
        return Bvh(
            child_l=jnp.zeros((0,), jnp.int32),
            child_r=jnp.zeros((0,), jnp.int32),
            node_min=leaf_min,
            node_max=leaf_max,
            leaf_tri=tri_ids,
            range_first=jnp.zeros((0,), jnp.int32),
            range_last=jnp.zeros((0,), jnp.int32),
            num_leaves=1,
        )

    child_l, child_r, first, last = karras_topology(leaf_codes)
    node_min, node_max = _range_boxes(leaf_min, leaf_max, first, last)

    return Bvh(
        child_l=child_l.astype(jnp.int32),
        child_r=child_r.astype(jnp.int32),
        node_min=node_min,
        node_max=node_max,
        leaf_tri=tri_ids,
        range_first=first.astype(jnp.int32),
        range_last=last.astype(jnp.int32),
        num_leaves=nl,
    )


def _range_boxes(leaf_min, leaf_max, first, last):
    """All node AABBs from leaf AABBs + internal [first, last] leaf ranges,
    via a sparse table of pairwise min/max (O(N log N), no propagation)."""
    n = leaf_min.shape[0]
    levels = max(1, (n - 1).bit_length())
    mins = [leaf_min]
    maxs = [leaf_max]
    for lev in range(1, levels + 1):
        half = 1 << (lev - 1)
        prev_min, prev_max = mins[-1], maxs[-1]
        shifted_idx = jnp.minimum(jnp.arange(n) + half, n - 1)
        mins.append(jnp.minimum(prev_min, prev_min[shifted_idx]))
        maxs.append(jnp.maximum(prev_max, prev_max[shifted_idx]))
    mins = jnp.stack(mins)   # (levels+1, NL, 3)
    maxs = jnp.stack(maxs)

    length = last - first + 1
    flev = (31 - _clz32(length.astype(jnp.uint32))).astype(jnp.int32)
    span = (1 << flev).astype(jnp.int32)
    a0 = first
    a1 = last - span + 1
    node_min_i = jnp.minimum(mins[flev, a0], mins[flev, a1])
    node_max_i = jnp.maximum(maxs[flev, a0], maxs[flev, a1])

    node_min = jnp.concatenate([node_min_i, leaf_min], axis=0)
    node_max = jnp.concatenate([node_max_i, leaf_max], axis=0)
    return node_min, node_max


def refit_bvh(bvh: Bvh, tris) -> Bvh:
    """Recompute all node AABBs for moved vertices with fixed topology —
    the AS UPDATE op (accel.rs:213-277): leaf boxes from the (new) world
    triangles, internal boxes via the range sparse table."""
    v0, v1, v2 = (jax.lax.stop_gradient(v) for v in tris)
    ids = bvh.leaf_tri
    valid = (ids >= 0)[:, :, None]
    gids = jnp.maximum(ids, 0)
    a = v0[gids]
    b = v1[gids]
    c = v2[gids]
    tmin = jnp.where(valid, jnp.minimum(jnp.minimum(a, b), c), jnp.inf)
    tmax = jnp.where(valid, jnp.maximum(jnp.maximum(a, b), c), -jnp.inf)
    leaf_min = jnp.min(tmin, axis=1)
    leaf_max = jnp.max(tmax, axis=1)
    if bvh.num_leaves == 1:
        return bvh.replace(node_min=leaf_min, node_max=leaf_max)
    node_min, node_max = _range_boxes(
        leaf_min, leaf_max, bvh.range_first, bvh.range_last
    )
    return bvh.replace(node_min=node_min, node_max=node_max)


def _aabb_hit(o, inv_d, bmin, bmax, tmin, tmax):
    """Slab test. Returns (hit, tnear). All per-lane scalars/vec3."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tn = jnp.max(jnp.minimum(t1, t2))
    tf = jnp.min(jnp.maximum(t1, t2))
    hit = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
    return hit, tn


def _tri_hit_one(o, d, a, b, c, tmin, tmax):
    """Scalar-ray Moller-Trumbore vs K triangles. a/b/c: (K, 3)."""
    e1 = b - a
    e2 = c - a
    pvec = jnp.cross(d[None, :], e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    det_ok = jnp.abs(det) > intersect.DET_EPS
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = o[None, :] - a
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d[None, :] * qvec, axis=-1) * inv_det
    tt = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    ok = ok & (tt >= tmin) & (tt <= tmax)
    return tt, u, v, ok


def _pack_tables(bvh: Bvh, tris):
    """Pack per-node and per-leaf data into row matrices so each traversal
    iteration costs TWO row gathers instead of ~25 scalar gathers (C
    scalars ride one index — same trick as render/restir._gather_packed).

    node_pack: (max(NL-1,1), 16): [child_l, child_r (bitcast), lmin3, lmax3,
               rmin3, rmax3, pad2]
    leaf_pack: (NL, K*10): per triangle [v0(3), v1(3), v2(3), id (bitcast)]
    """
    v0, v1, v2 = tris
    nl = bvh.num_leaves
    f32 = jnp.float32
    # DENORMAL-SAFE assembly (the bvh2-TLAS silent-black class): int ids
    # bitcast to f32 are denormals that in-jit float assembly may flush to
    # zero — build the tables as int32 bit patterns and reinterpret ONCE.
    def f2i(x):
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    if nl > 1:
        cl = bvh.child_l
        cr = bvh.child_r
        node_pack = jax.lax.bitcast_convert_type(
            jnp.concatenate(
                [
                    cl[:, None], cr[:, None],
                    f2i(bvh.node_min[cl]), f2i(bvh.node_max[cl]),
                    f2i(bvh.node_min[cr]), f2i(bvh.node_max[cr]),
                    jnp.zeros((cl.shape[0], 2), jnp.int32),
                ],
                axis=1,
            ),
            f32,
        )
    else:
        node_pack = jnp.zeros((1, 16), f32)

    ids = bvh.leaf_tri                      # (NL, K)
    gids = jnp.maximum(ids, 0)
    lp = jax.lax.bitcast_convert_type(
        jnp.concatenate(
            [
                f2i(v0[gids]), f2i(v1[gids]), f2i(v2[gids]),
                ids[:, :, None],
            ],
            axis=2,
        ),
        f32,
    )                                        # (NL, K, 10)
    leaf_pack = lp.reshape(nl, -1)
    return node_pack, leaf_pack


def _traverse_one(node_pack, leaf_pack, nl, leaf_k, o, d, tmin, tmax,
                  mode: str, exclude):
    """Scalar-ray traversal; vmapped by the callers.

    mode "closest": full closest-hit search.
    mode "any": early exit on first accepted hit.
    """
    leaf_base = nl - 1
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, jnp.float32(1e12))

    stack = jnp.zeros((STACK_DEPTH,), jnp.int32)
    root = jnp.int32(0 if nl > 1 else leaf_base)  # single leaf -> id 0 == leaf
    stack = stack.at[0].set(root)

    state = dict(
        stack=stack,
        sp=jnp.int32(1),
        best_t=jnp.asarray(tmax, jnp.float32),
        best_tri=jnp.int32(-1),
        best_u=jnp.float32(0.0),
        best_v=jnp.float32(0.0),
        found=jnp.asarray(False),
    )

    def cond(s):
        go = s["sp"] > 0
        if mode == "any":
            go = go & ~s["found"]
        return go

    def body(s):
        sp = s["sp"] - 1
        node = s["stack"][sp]
        is_leaf = node >= leaf_base if nl > 1 else jnp.asarray(True)

        # --- leaf: intersect K triangles from ONE packed row ---
        leaf = jnp.clip(node - leaf_base, 0, nl - 1)
        lrow = leaf_pack[leaf].reshape(leaf_k, 10)
        a = lrow[:, 0:3]
        b = lrow[:, 3:6]
        c = lrow[:, 6:9]
        ids = jax.lax.bitcast_convert_type(lrow[:, 9], jnp.int32)
        tt, u, v, ok = _tri_hit_one(o, d, a, b, c, tmin, s["best_t"])
        ok = ok & (ids >= 0) & is_leaf
        if exclude is not None:
            ok = ok & (ids != exclude)
        tt = jnp.where(ok, tt, jnp.inf)
        kbest = jnp.argmin(tt)
        leaf_hit = ok[kbest]
        new_best_t = jnp.where(leaf_hit, tt[kbest], s["best_t"])
        new_best_tri = jnp.where(leaf_hit, ids[kbest], s["best_tri"])
        new_best_u = jnp.where(leaf_hit, u[kbest], s["best_u"])
        new_best_v = jnp.where(leaf_hit, v[kbest], s["best_v"])
        found = s["found"] | leaf_hit

        # --- internal: ONE packed row holds children ids + both AABBs ---
        if nl > 1:
            nrow = node_pack[jnp.minimum(node, leaf_base - 1)]
            l = jax.lax.bitcast_convert_type(nrow[0], jnp.int32)
            r = jax.lax.bitcast_convert_type(nrow[1], jnp.int32)
            hit_l, tn_l = _aabb_hit(
                o, inv_d, nrow[2:5], nrow[5:8], tmin, new_best_t
            )
            hit_r, tn_r = _aabb_hit(
                o, inv_d, nrow[8:11], nrow[11:14], tmin, new_best_t
            )
            hit_l = hit_l & ~is_leaf
            hit_r = hit_r & ~is_leaf
            # Order: push far child first so the near child pops first.
            l_near = tn_l <= tn_r
            first_child = jnp.where(l_near, r, l)     # far
            first_hit = jnp.where(l_near, hit_r, hit_l)
            second_child = jnp.where(l_near, l, r)    # near
            second_hit = jnp.where(l_near, hit_l, hit_r)

            stack = s["stack"]
            stack = stack.at[sp].set(jnp.where(first_hit, first_child, stack[sp]))
            sp1 = sp + first_hit.astype(jnp.int32)
            sp1c = jnp.minimum(sp1, STACK_DEPTH - 1)
            stack = stack.at[sp1c].set(
                jnp.where(second_hit, second_child, stack[sp1c])
            )
            sp2 = jnp.minimum(
                sp1 + second_hit.astype(jnp.int32), STACK_DEPTH - 1
            )
        else:
            stack = s["stack"]
            sp2 = sp

        return dict(
            stack=stack,
            sp=sp2,
            best_t=new_best_t,
            best_tri=new_best_tri,
            best_u=new_best_u,
            best_v=new_best_v,
            found=found,
        )

    out = jax.lax.while_loop(cond, body, state)
    return out


def _blocked_rays(fn, orig, d, extras, block):
    """lax.map over ray blocks (same pattern as intersect._blocked)."""
    n = orig.shape[0]
    nb = -(-n // block)
    pad = nb * block - n

    def padx(x):
        if x.ndim == 0:
            return x
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    if pad:
        orig = jnp.pad(orig, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        extras = jax.tree_util.tree_map(padx, extras)
    orig = orig.reshape(nb, block, 3)
    d = d.reshape(nb, block, 3)
    extras = jax.tree_util.tree_map(
        lambda x: x.reshape(nb, block, *x.shape[1:]) if x.ndim else x, extras
    )
    out = jax.lax.map(fn, (orig, d, extras))
    out = jax.tree_util.tree_map(lambda x: x.reshape(nb * block, *x.shape[2:]), out)
    if pad:
        out = jax.tree_util.tree_map(lambda x: x[:n], out)
    return out


def trace_closest_bvh(bvh: Bvh, tris, orig, d, tmin=intersect.T_MIN,
                      tmax=intersect.T_MAX, block=TRAVERSE_BLOCK):
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    tmin_a = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), orig.shape[:1])
    tmax_a = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), orig.shape[:1])

    node_pack, leaf_pack = _pack_tables(bvh, tris)
    nl = bvh.num_leaves
    leaf_k = bvh.leaf_tri.shape[1]
    trav = jax.vmap(
        lambda o, dd, tn, tx: _traverse_one(
            node_pack, leaf_pack, nl, leaf_k, o, dd, tn, tx, "closest", None
        )
    )

    def fn(args):
        o, dd, (tn, tx) = args
        s = trav(o, dd, tn, tx)
        return intersect.Hit(
            t=jnp.where(s["found"], s["best_t"], jnp.inf),
            tri=s["best_tri"],
            u=s["best_u"],
            v=s["best_v"],
            hit=s["found"],
        )

    return _blocked_rays(fn, orig, d, (tmin_a, tmax_a), block)


def trace_occluded_bvh(bvh: Bvh, tris, orig, d, tmax, tmin=intersect.T_MIN,
                       exclude=None, block=TRAVERSE_BLOCK):
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    tmin_a = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), orig.shape[:1])
    tmax_a = jnp.asarray(tmax, jnp.float32).reshape(-1)

    node_pack, leaf_pack = _pack_tables(bvh, tris)
    nl = bvh.num_leaves
    leaf_k = bvh.leaf_tri.shape[1]
    if exclude is None:
        trav = jax.vmap(
            lambda o, dd, tn, tx: _traverse_one(
                node_pack, leaf_pack, nl, leaf_k, o, dd, tn, tx, "any", None
            )["found"]
        )

        def fn(args):
            o, dd, (tn, tx) = args
            return trav(o, dd, tn, tx)

        return _blocked_rays(fn, orig, d, (tmin_a, tmax_a), block)

    exclude = jnp.asarray(exclude, jnp.int32).reshape(-1)
    trav = jax.vmap(
        lambda o, dd, tn, tx, ex: _traverse_one(
            node_pack, leaf_pack, nl, leaf_k, o, dd, tn, tx, "any", ex
        )["found"]
    )

    def fn(args):
        o, dd, (tn, tx, ex) = args
        return trav(o, dd, tn, tx, ex)

    return _blocked_rays(fn, orig, d, (tmin_a, tmax_a, exclude), block)
