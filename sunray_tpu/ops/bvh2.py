"""Two-level BVH: per-mesh object-space BLAS + per-frame instance TLAS.

The structural twin of the reference's BLAS/TLAS split
(acceleration_structure/blas.rs, tlas.rs): one acceleration structure per
unique primitive, an instance-level structure on top, and per-instance
transforms applied during traversal — so N instances of a mesh share ONE
BLAS instead of N copies of its triangles (the unified world-triangle BVH
in ops/bvh.py expands them; fine at small scale, wasteful for
many-instance scenes).

Designed for XLA's static shapes rather than as a driver-call translation:

  - BLASes are built ONCE at scene load in OBJECT space (host-side numpy
    packing around the existing builders), so instance-transform animation
    never rebuilds or even refits them — the role of the reference's
    static per-primitive BLAS (scene.rs:136-141) with strictly less
    per-frame work than its vkCmdBuildAccelerationStructures path.
  - The TLAS is rebuilt every frame INSIDE the jitted frame function
    (tlas.rs:155-191 queues the same each-frame build): instance world
    AABBs come from transforming the 8 corners of each BLAS root box,
    topology is the same fully-parallel Karras build as the LBVH
    (ops/bvh.karras_topology) over instance-centroid Morton codes — a few
    dozen lanes of work, negligible against the frame.
  - Traversal is the lock-step vmapped stack walk of ops/bvh.py with a
    second stack carrying the instance context: rays are transformed into
    object space ON ENTRY into an instance subtree (gl_ObjectRayOriginEXT
    semantics) by the inverse instance transform. Directions are NOT
    renormalized, so hit t values are identical in object and world space
    (the standard affine-invariance trick) and best-t competition across
    instances needs no conversion.
  - Child pointers encode level transitions in the data, not in control
    flow: every node row stores (child id, child instance-code) pairs
    where code 0 means "inherit" — TLAS internal rows hand rays to BLAS
    roots by storing (blas_root, k+1), and the traversal body is the same
    two-gather lock-step step everywhere (no TLAS/BLAS phase split that
    would double the divergence).

Node-id encoding: ids [0, NL) are leaf rows of `leaf_pack`; ids >= NL are
internal rows of `node_pack` at (id - NL) — BLAS internals first, TLAS
internals appended per frame. All encoded ids and instance codes are
NON-NEGATIVE on purpose: ids ride f32 table columns via bitcast, and
non-negative int32 bit patterns are ordinary positive floats, never NaN
payloads (negative ints bitcast to NaNs, which float data paths are not
guaranteed to round-trip bit-exactly).

Leaf hits return WORLD triangle ids (instance world-triangle offset +
local id), so shading and the differentiable hit-attribute recompute
(render/shade.py) are unchanged: the two-level tracer is a drop-in
backend behind render/trace.make_tracer (cfg.tracer = "bvh2").
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from sunray_tpu.utils import struct

from sunray_tpu.ops import intersect
from sunray_tpu.ops.bvh import (
    STACK_DEPTH,
    TRAVERSE_BLOCK,
    _aabb_hit,
    _blocked_rays,
    _morton3,
    _range_boxes,
    _tri_hit_one,
    build_bvh,
    karras_topology,
)
from sunray_tpu.ops.linalg import gather_vec


@struct.dataclass
class BlasSet:
    """Load-time static half of the two-level structure (host-built)."""

    node_pack: jnp.ndarray       # (n_blas_int, 16) f32 packed internal rows
    leaf_pack: jnp.ndarray       # (NL, K*10) f32 object-space leaf rows
    prim_root: jnp.ndarray       # (P,) int32 encoded root id per primitive
    prim_root_min: jnp.ndarray   # (P, 3) object-space root AABB
    prim_root_max: jnp.ndarray   # (P, 3)
    prim_tri_count: jnp.ndarray  # (P,) int32 triangles per primitive
    leaf_k: int = struct.field(pytree_node=False)
    n_leaf_rows: int = struct.field(pytree_node=False)
    n_blas_int: int = struct.field(pytree_node=False)


@struct.dataclass
class Tlas2:
    """Per-frame runtime structure: BLAS rows + freshly built TLAS rows."""

    node_pack: jnp.ndarray       # (n_blas_int + n_tlas_int, 16)
    leaf_pack: jnp.ndarray       # (NL, K*10)
    inst_inv_ext: jnp.ndarray    # (I+1, 12) world->object rows; row 0 = identity
    inst_world_off: jnp.ndarray  # (I+1,) int32 world-tri offset per inst code
    root: jnp.ndarray            # () int32 encoded root id
    root_icode: jnp.ndarray      # () int32 instance code at the root (0 = TLAS)
    leaf_k: int = struct.field(pytree_node=False)
    n_leaf_rows: int = struct.field(pytree_node=False)


# ---------------------------------------------------------------------------
# Load-time BLAS set build (host, numpy)
# ---------------------------------------------------------------------------


def _instance_runs(tri_inst: np.ndarray, num_inst: int):
    """First contiguous run (offset, count) of each instance id in the
    world triangle list. build_scene concatenates instances in order;
    pad_scene_capacity appends degenerate tri_inst=0 rows at the END —
    a separate second run of 0 (excluded), except when instance 0's run
    is last (single instance) where the merged run's extra padded
    triangles are degenerate (vertex 0 thrice) and can never be hit."""
    t = tri_inst.shape[0]
    off = np.full(num_inst, 0, np.int64)
    cnt = np.zeros(num_inst, np.int64)
    seen = np.zeros(num_inst, bool)
    i = 0
    while i < t:
        v = int(tri_inst[i])
        j = i
        while j < t and tri_inst[j] == v:
            j += 1
        if 0 <= v < num_inst and not seen[v]:
            off[v] = i
            cnt[v] = j - i
            seen[v] = True
        i = j
    return off, cnt


def build_blas_set(scene, leaf_size: int = 4, use_native: bool = True) -> BlasSet:
    """Build one object-space BLAS per primitive (host-side).

    scene: SceneBuffers. Uses the native binned-SAH builder when available
    (the SLOW_BUILD quality path), else the LBVH. Primitives with no
    instance get a dummy empty leaf (never referenced).
    """
    pos = np.asarray(jax.device_get(scene.positions), np.float32)
    tv = np.asarray(jax.device_get(scene.tri_vidx), np.int32)
    ti = np.asarray(jax.device_get(scene.tri_inst), np.int32)
    ip = np.asarray(jax.device_get(scene.inst_prim), np.int32)
    num_prims = int(np.asarray(scene.materials.base_color).shape[0])
    num_inst = ip.shape[0]
    k = leaf_size

    off, cnt = _instance_runs(ti, num_inst)
    # First instance of each primitive (its triangle slice defines the
    # BLAS's local triangle order — identical for every instance of the
    # primitive, build_scene expands the same masked slice per instance).
    prim_first_inst = np.full(num_prims, -1, np.int64)
    for i in range(num_inst):
        p = int(ip[i])
        if 0 <= p < num_prims and prim_first_inst[p] < 0:
            prim_first_inst[p] = i

    builder = None
    if use_native:
        try:
            from sunray_tpu.native import build_sah_bvh

            builder = build_sah_bvh
        except Exception:  # pragma: no cover - toolchain-dependent
            builder = None

    def bitc(a):
        return np.asarray(a, np.int32).view(np.float32)

    # Pass 1: build every primitive's BVH; collect sizes.
    built = []
    for p in range(num_prims):
        fi = prim_first_inst[p]
        if fi < 0 or cnt[fi] == 0:
            built.append(None)
            continue
        s, c = int(off[fi]), int(cnt[fi])
        tri = pos[tv[s : s + c]]                     # (c, 3verts, 3) object space
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        b = builder(v0, v1, v2, leaf_size=k) if builder is not None else None
        if b is None:
            b = build_bvh((jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2)),
                          leaf_size=k)
        built.append((b, v0, v1, v2, c))

    total_leaves = sum(
        (b[0].num_leaves if b is not None else 1) for b in built
    )
    nl_total = total_leaves                          # global leaf-row count

    # Pass 2: pack with the global encoding (leaf row id < nl_total;
    # internal id = nl_total + packed row index).
    node_rows, leaf_rows = [], []
    prim_root = np.zeros(num_prims, np.int32)
    prim_rmin = np.zeros((num_prims, 3), np.float32)
    prim_rmax = np.zeros((num_prims, 3), np.float32)
    prim_cnt = np.zeros(num_prims, np.int32)
    node_off = 0
    leaf_off = 0
    for p in range(num_prims):
        if built[p] is None:
            row = np.zeros((1, k * 10), np.float32)
            row[:, 9::10] = bitc(np.full(k, -1, np.int32))[None, :]
            leaf_rows.append(row)
            prim_root[p] = leaf_off
            leaf_off += 1
            continue
        b, v0, v1, v2, c = built[p]
        prim_cnt[p] = c
        nl = b.num_leaves
        child_l = np.asarray(jax.device_get(b.child_l), np.int64)
        child_r = np.asarray(jax.device_get(b.child_r), np.int64)
        nmin = np.asarray(jax.device_get(b.node_min), np.float32)
        nmax = np.asarray(jax.device_get(b.node_max), np.float32)
        ids = np.asarray(jax.device_get(b.leaf_tri), np.int32)   # (nl, K) local

        gids = np.maximum(ids, 0)
        lrow = np.concatenate(
            [
                v0[gids], v1[gids], v2[gids],
                bitc(ids)[:, :, None],
            ],
            axis=2,
        ).reshape(nl, k * 10).astype(np.float32)
        leaf_rows.append(lrow)

        if nl > 1:
            leaf_base = nl - 1

            def remap(c_ids):
                # Local Bvh encoding: internal < nl-1, leaf at nl-1+k.
                is_leaf = c_ids >= leaf_base
                return np.where(
                    is_leaf,
                    leaf_off + (c_ids - leaf_base),
                    nl_total + node_off + c_ids,
                ).astype(np.int32)

            zeros = np.zeros(child_l.shape[0], np.int32)  # icode 0 = inherit
            rows = np.concatenate(
                [
                    bitc(remap(child_l))[:, None],
                    bitc(remap(child_r))[:, None],
                    bitc(zeros)[:, None],
                    bitc(zeros)[:, None],
                    nmin[child_l], nmax[child_l],
                    nmin[child_r], nmax[child_r],
                ],
                axis=1,
            ).astype(np.float32)
            node_rows.append(rows)
            prim_root[p] = nl_total + node_off
            prim_rmin[p] = nmin[0]
            prim_rmax[p] = nmax[0]
            node_off += child_l.shape[0]
        else:
            prim_root[p] = leaf_off
            prim_rmin[p] = nmin[0]
            prim_rmax[p] = nmax[0]
        leaf_off += nl

    node_pack = (
        np.concatenate(node_rows, axis=0)
        if node_rows else np.zeros((0, 16), np.float32)
    )
    leaf_pack = np.concatenate(leaf_rows, axis=0)
    assert leaf_pack.shape[0] == nl_total
    return BlasSet(
        node_pack=jnp.asarray(node_pack),
        leaf_pack=jnp.asarray(leaf_pack),
        prim_root=jnp.asarray(prim_root),
        prim_root_min=jnp.asarray(prim_rmin),
        prim_root_max=jnp.asarray(prim_rmax),
        prim_tri_count=jnp.asarray(prim_cnt),
        leaf_k=k,
        n_leaf_rows=nl_total,
        n_blas_int=int(node_pack.shape[0]),
    )


# ---------------------------------------------------------------------------
# Per-frame TLAS build (inside jit)
# ---------------------------------------------------------------------------


def _invert_affine_rows(xf):
    """(I, 3, 4) object->world -> (I, 12) world->object [A^-1 | -A^-1 t]
    rows. Adjugate 3x3 inverse; non-differentiable by design (topology)."""
    xf = jax.lax.stop_gradient(xf)
    a = xf[:, :, :3]
    t = xf[:, :, 3]

    def e(i, j):
        return a[:, i, j]

    c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
    c10 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
    c20 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
    det = e(0, 0) * c00 + e(0, 1) * c10 + e(0, 2) * c20
    inv_det = jnp.where(
        jnp.abs(det) > 1e-12,
        1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0),
        0.0,
    )
    inv = jnp.stack(
        [
            c00,
            e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2),
            e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1),
            c10,
            e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0),
            e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2),
            c20,
            e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1),
            e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0),
        ],
        axis=1,
    ) * inv_det[:, None]                               # (I, 9) row-major A^-1
    ainv = inv.reshape(-1, 3, 3)
    b = -jnp.sum(ainv * t[:, None, :], axis=-1)        # (I, 3)
    return jnp.concatenate([inv, b], axis=1)


def build_frame_tlas(blas: BlasSet, scene) -> Tlas2:
    """Per-frame TLAS over the scene's instances (call inside jit; the
    tlas.rs:155-191 queue_build analog, always the FastBuild op — the
    build IS cheap enough to run every frame)."""
    inst_prim = scene.inst_prim
    xf = jax.lax.stop_gradient(scene.inst_transform)   # (I, 3, 4)
    n_inst = int(inst_prim.shape[0])
    nl_total = blas.n_leaf_rows

    # Instance world AABB: transform the 8 corners of the BLAS root box.
    bmin = gather_vec(blas.prim_root_min, inst_prim)   # (I, 3)
    bmax = gather_vec(blas.prim_root_max, inst_prim)
    corners = jnp.stack(
        [
            jnp.where(
                jnp.asarray([(c >> a) & 1 for a in range(3)], bool),
                bmax, bmin,
            )
            for c in range(8)
        ],
        axis=1,
    )                                                   # (I, 8, 3)
    wc = (
        jnp.sum(xf[:, None, :, :3] * corners[:, :, None, :], axis=-1)
        + xf[:, None, :, 3]
    )                                                   # (I, 8, 3)
    wmin = jnp.min(wc, axis=1)
    wmax = jnp.max(wc, axis=1)

    # World-triangle offset per instance CODE (code k+1 = instance k;
    # code 0 = identity context, never consulted at a leaf). Instances
    # expand in order in the world triangle list.
    counts = gather_vec(blas.prim_tri_count, inst_prim)
    off = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    inst_world_off = jnp.concatenate([jnp.zeros((1,), jnp.int32), off])

    inv12 = _invert_affine_rows(xf)
    ident = jnp.concatenate(
        [jnp.eye(3, dtype=jnp.float32).reshape(1, 9),
         jnp.zeros((1, 3), jnp.float32)], axis=1
    )
    inst_inv_ext = jnp.concatenate([ident, inv12], axis=0)

    roots = gather_vec(blas.prim_root, inst_prim)       # (I,) encoded

    if n_inst == 1:
        return Tlas2(
            node_pack=blas.node_pack
            if blas.n_blas_int > 0 else jnp.zeros((1, 16), jnp.float32),
            leaf_pack=blas.leaf_pack,
            inst_inv_ext=inst_inv_ext,
            inst_world_off=inst_world_off,
            root=roots[0],
            root_icode=jnp.int32(1),
            leaf_k=blas.leaf_k,
            n_leaf_rows=nl_total,
        )

    # Morton order of instance centroids inside the scene box.
    centroid = 0.5 * (wmin + wmax)
    smin = jnp.min(wmin, axis=0)
    smax = jnp.max(wmax, axis=0)
    extent = jnp.maximum(smax - smin, 1e-6)
    q = jnp.clip(((centroid - smin) / extent) * 1023.0, 0.0, 1023.0)
    q = q.astype(jnp.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    order = jnp.argsort(codes).astype(jnp.int32)
    child_l, child_r, first, last = karras_topology(codes[order])

    lmin = wmin[order]
    lmax = wmax[order]
    node_min, node_max = _range_boxes(lmin, lmax, first, last)

    leaf_base = n_inst - 1
    base = jnp.int32(nl_total + blas.n_blas_int)

    def enc(c):
        is_leaf = c >= leaf_base
        leaf_k_idx = jnp.clip(c - leaf_base, 0, n_inst - 1)
        inst = order[leaf_k_idx]
        child = jnp.where(is_leaf, gather_vec(roots, inst), base + c)
        icode = jnp.where(is_leaf, inst + 1, 0)
        return child.astype(jnp.int32), icode.astype(jnp.int32)

    el, il = enc(child_l)
    er, ir = enc(child_r)

    # DENORMAL HAZARD (measured: silent black frames on an earlier
    # accelerator): small int ids bitcast to f32 are denormals, and the
    # in-jit concat assembling the rows fuses through float registers,
    # which may FLUSH them to
    # zero — every TLAS child id became node 0 (the eager load-time BLAS
    # pack was unaffected; only this per-frame jit assembly fused).
    # Assemble the table in int32 (bit-exact data movement) and
    # reinterpret ONCE at the end.
    def f2i(x):
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    tlas_rows_i = jnp.concatenate(
        [
            el.astype(jnp.int32)[:, None], er.astype(jnp.int32)[:, None],
            il.astype(jnp.int32)[:, None], ir.astype(jnp.int32)[:, None],
            f2i(node_min[child_l]), f2i(node_max[child_l]),
            f2i(node_min[child_r]), f2i(node_max[child_r]),
        ],
        axis=1,
    )
    node_pack = jax.lax.bitcast_convert_type(
        jnp.concatenate([f2i(blas.node_pack), tlas_rows_i], axis=0),
        jnp.float32,
    )
    return Tlas2(
        node_pack=node_pack,
        leaf_pack=blas.leaf_pack,
        inst_inv_ext=inst_inv_ext,
        inst_world_off=inst_world_off,
        root=base,
        root_icode=jnp.int32(0),
        leaf_k=blas.leaf_k,
        n_leaf_rows=nl_total,
    )


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------


def _traverse_one2(tl: Tlas2, o, d, tmin, tmax, mode: str, exclude):
    """Scalar-ray two-level traversal; vmapped by the callers.

    Same lock-step structure as ops/bvh._traverse_one with (a) a second
    stack carrying the instance code, (b) a per-step world->object ray
    transform from the popped entry's code (row 0 = identity at TLAS
    level), (c) leaf triangle ids lifted to world ids via the instance
    offset."""
    leaf_k = tl.leaf_k
    nl_total = tl.n_leaf_rows
    n_nodes = tl.node_pack.shape[0]

    nstack = jnp.zeros((STACK_DEPTH,), jnp.int32).at[0].set(tl.root)
    istack = jnp.zeros((STACK_DEPTH,), jnp.int32).at[0].set(tl.root_icode)

    state = dict(
        nstack=nstack,
        istack=istack,
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
        node = s["nstack"][sp]
        icode = s["istack"][sp]
        is_leaf = node < nl_total

        # World -> object ray for this entry's instance context. Direction
        # deliberately unnormalized: t is then affine-invariant.
        inv = gather_vec(tl.inst_inv_ext, icode)        # (12,)
        a = inv[:9].reshape(3, 3)
        oo = jnp.sum(a * o[None, :], axis=-1) + inv[9:12]
        dd = jnp.sum(a * d[None, :], axis=-1)
        inv_dd = jnp.where(jnp.abs(dd) > 1e-12, 1.0 / dd, jnp.float32(1e12))

        # --- leaf: K object-space triangles from ONE packed row ---
        lrow = tl.leaf_pack[jnp.clip(node, 0, nl_total - 1)]
        lrow = lrow.reshape(leaf_k, 10)
        va = lrow[:, 0:3]
        vb = lrow[:, 3:6]
        vc = lrow[:, 6:9]
        ids = jax.lax.bitcast_convert_type(lrow[:, 9], jnp.int32)
        woff = gather_vec(tl.inst_world_off, icode)
        wids = ids + woff
        tt, u, v, ok = _tri_hit_one(oo, dd, va, vb, vc, tmin, s["best_t"])
        ok = ok & (ids >= 0) & is_leaf
        if exclude is not None:
            ok = ok & (wids != exclude)
        tt = jnp.where(ok, tt, jnp.inf)
        kbest = jnp.argmin(tt)
        leaf_hit = ok[kbest]
        new_best_t = jnp.where(leaf_hit, tt[kbest], s["best_t"])
        new_best_tri = jnp.where(leaf_hit, wids[kbest], s["best_tri"])
        new_best_u = jnp.where(leaf_hit, u[kbest], s["best_u"])
        new_best_v = jnp.where(leaf_hit, v[kbest], s["best_v"])
        found = s["found"] | leaf_hit

        # --- internal: children + their boxes + their instance codes ---
        nrow = tl.node_pack[jnp.clip(node - nl_total, 0, n_nodes - 1)]
        cl = jax.lax.bitcast_convert_type(nrow[0], jnp.int32)
        cr = jax.lax.bitcast_convert_type(nrow[1], jnp.int32)
        il = jax.lax.bitcast_convert_type(nrow[2], jnp.int32)
        ir = jax.lax.bitcast_convert_type(nrow[3], jnp.int32)
        il = jnp.where(il > 0, il, icode)
        ir = jnp.where(ir > 0, ir, icode)
        hit_l, tn_l = _aabb_hit(oo, inv_dd, nrow[4:7], nrow[7:10], tmin, new_best_t)
        hit_r, tn_r = _aabb_hit(oo, inv_dd, nrow[10:13], nrow[13:16], tmin, new_best_t)
        hit_l = hit_l & ~is_leaf
        hit_r = hit_r & ~is_leaf
        # Push far child first so the near child pops first.
        l_near = tn_l <= tn_r
        first_c = jnp.where(l_near, cr, cl)
        first_i = jnp.where(l_near, ir, il)
        first_h = jnp.where(l_near, hit_r, hit_l)
        second_c = jnp.where(l_near, cl, cr)
        second_i = jnp.where(l_near, il, ir)
        second_h = jnp.where(l_near, hit_l, hit_r)

        ns = s["nstack"]
        is_ = s["istack"]
        ns = ns.at[sp].set(jnp.where(first_h, first_c, ns[sp]))
        is_ = is_.at[sp].set(jnp.where(first_h, first_i, is_[sp]))
        sp1 = sp + first_h.astype(jnp.int32)
        sp1c = jnp.minimum(sp1, STACK_DEPTH - 1)
        ns = ns.at[sp1c].set(jnp.where(second_h, second_c, ns[sp1c]))
        is_ = is_.at[sp1c].set(jnp.where(second_h, second_i, is_[sp1c]))
        sp2 = jnp.minimum(sp1 + second_h.astype(jnp.int32), STACK_DEPTH - 1)

        return dict(
            nstack=ns,
            istack=is_,
            sp=sp2,
            best_t=new_best_t,
            best_tri=new_best_tri,
            best_u=new_best_u,
            best_v=new_best_v,
            found=found,
        )

    return jax.lax.while_loop(cond, body, state)


def trace_closest_bvh2(tl: Tlas2, orig, d, tmin=intersect.T_MIN,
                       tmax=intersect.T_MAX, block=TRAVERSE_BLOCK):
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    tmin_a = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), orig.shape[:1])
    tmax_a = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), orig.shape[:1])

    trav = jax.vmap(
        lambda o, dd, tn, tx: _traverse_one2(tl, o, dd, tn, tx, "closest", None)
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


def trace_occluded_bvh2(tl: Tlas2, orig, d, tmax, tmin=intersect.T_MIN,
                        exclude=None, block=TRAVERSE_BLOCK):
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    tmin_a = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), orig.shape[:1])
    tmax_a = jnp.asarray(tmax, jnp.float32).reshape(-1)

    if exclude is None:
        trav = jax.vmap(
            lambda o, dd, tn, tx: _traverse_one2(
                tl, o, dd, tn, tx, "any", None
            )["found"]
        )

        def fn(args):
            o, dd, (tn, tx) = args
            return trav(o, dd, tn, tx)

        return _blocked_rays(fn, orig, d, (tmin_a, tmax_a), block)

    exclude = jnp.asarray(exclude, jnp.int32).reshape(-1)
    trav = jax.vmap(
        lambda o, dd, tn, tx, ex: _traverse_one2(
            tl, o, dd, tn, tx, "any", ex
        )["found"]
    )

    def fn(args):
        o, dd, (tn, tx, ex) = args
        return trav(o, dd, tn, tx, ex)

    return _blocked_rays(fn, orig, d, (tmin_a, tmax_a, exclude), block)
