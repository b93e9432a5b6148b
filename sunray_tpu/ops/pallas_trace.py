"""Brute-force ray-triangle kernels for the GPU: Pallas through Triton.

The jnp oracle (`ops/intersect.py`) evaluates Moller-Trumbore over a
(rays x tris) plane and reduces it with a 4-output argmin. Here one
program owns a block of `block` rays, keeps each ray and its running
result (t, tri, u, v) or its occlusion bit in registers, and loops over
every triangle inside the kernel. Triangles are a (9, T) SoA table
(v0, e1, e2 by component) whose scalars every thread of the block reads
from the same address, so only the rays and the (N,) results touch
device memory.

Same arithmetic as `intersect.moller_trumbore` (same epsilons, same
products and sums in the same order; no matrix product, so TF32 never
enters). The compiler may contract a multiply-add into an FMA where XLA
does not, so a ray exactly on a triangle edge or with two triangles at
the same t can resolve differently; everything else agrees. Ties go to
the lower triangle id, as with `argmin`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sunray_tpu.ops import intersect

BLOCK_RAYS = 256       # rays per program (power of two)
NUM_WARPS = 4          # 128 threads: two rays per thread at BLOCK_RAYS=256
DET_EPS = intersect.DET_EPS


def tri_table(tris) -> jnp.ndarray:
    """(v0, v1, v2) each (T, 3) -> (9, T) float32 rows [v0 | e1 | e2]."""
    v0, v1, v2 = (jnp.asarray(v, jnp.float32) for v in tris)
    return jnp.concatenate([v0.T, (v1 - v0).T, (v2 - v0).T], axis=0)


def _load_rays(o_ref, d_ref, tn_ref, tx_ref, n_rays, block):
    idx = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    live = idx < n_rays
    o = [plgpu.load(o_ref.at[idx * 3 + c], mask=live, other=0.0)
         for c in range(3)]
    d = [plgpu.load(d_ref.at[idx * 3 + c], mask=live, other=1.0)
         for c in range(3)]
    tn = plgpu.load(tn_ref.at[idx], mask=live, other=0.0)
    tx = plgpu.load(tx_ref.at[idx], mask=live, other=0.0)
    return idx, live, o, d, tn, tx


def _mt(o, d, tn, tx, tri_ref, j):
    """Moller-Trumbore of the ray block against triangle j (the operation
    order of intersect.moller_trumbore). Returns (t, u, v, valid)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = tri_ref[0, j], tri_ref[1, j], tri_ref[2, j]
    e1x, e1y, e1z = tri_ref[3, j], tri_ref[4, j], tri_ref[5, j]
    e2x, e2y, e2z = tri_ref[6, j], tri_ref[7, j], tri_ref[8, j]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > DET_EPS
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= tn) & (t <= tx))
    return t, u, v, valid


def _closest_kernel(o_ref, d_ref, tn_ref, tx_ref, tri_ref,
                    t_out, tri_out, u_out, v_out, *, n_rays, n_tris, block):
    idx, live, o, d, tn, tx = _load_rays(o_ref, d_ref, tn_ref, tx_ref,
                                         n_rays, block)

    def body(j, carry):
        bt, bi, bu, bv = carry
        t, u, v, valid = _mt(o, d, tn, tx, tri_ref, j)
        better = valid & (t < bt)
        return (jnp.where(better, t, bt), jnp.where(better, j, bi),
                jnp.where(better, u, bu), jnp.where(better, v, bv))

    init = (jnp.full((block,), jnp.inf, jnp.float32),
            jnp.full((block,), -1, jnp.int32),
            jnp.zeros((block,), jnp.float32),
            jnp.zeros((block,), jnp.float32))
    bt, bi, bu, bv = jax.lax.fori_loop(0, n_tris, body, init)
    plgpu.store(t_out.at[idx], bt, mask=live)
    plgpu.store(tri_out.at[idx], bi, mask=live)
    plgpu.store(u_out.at[idx], bu, mask=live)
    plgpu.store(v_out.at[idx], bv, mask=live)


def _occluded_kernel(o_ref, d_ref, tn_ref, tx_ref, tri_ref, ex_ref,
                     occ_out, *, n_rays, n_tris, block, use_exclude):
    idx, live, o, d, tn, tx = _load_rays(o_ref, d_ref, tn_ref, tx_ref,
                                         n_rays, block)
    ex = (plgpu.load(ex_ref.at[idx], mask=live, other=-1)
          if use_exclude else None)

    def body(j, occ):
        _, _, _, valid = _mt(o, d, tn, tx, tri_ref, j)
        if use_exclude:
            valid = valid & (ex != j)
        return occ | valid.astype(jnp.int32)

    occ = jax.lax.fori_loop(0, n_tris, body,
                            jnp.zeros((block,), jnp.int32))
    plgpu.store(occ_out.at[idx], occ, mask=live)


def _ray_args(orig, d, tmin, tmax):
    o = orig.reshape(-1, 3).astype(jnp.float32)
    n = o.shape[0]
    dd = d.reshape(-1, 3).astype(jnp.float32)
    tn = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32).reshape(-1), (n,))
    tx = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32).reshape(-1), (n,))
    return n, o.reshape(-1), dd.reshape(-1), tn, tx


def _call(kernel, n, out_shape, block, interpret, name):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(pl.cdiv(n, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )


def trace_closest_pallas(tris, orig, d, tmin=intersect.T_MIN,
                         tmax=intersect.T_MAX, *, block=BLOCK_RAYS,
                         interpret=False) -> intersect.Hit:
    """Closest hit over all triangles; tris: (v0, v1, v2) each (T, 3).
    Misses return t=inf, tri=0, u=v=0, hit=False."""
    n, o, dd, tn, tx = _ray_args(orig, d, tmin, tmax)
    n_tris = tris[0].shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    kernel = functools.partial(_closest_kernel, n_rays=n, n_tris=n_tris,
                               block=block)
    t, tri, u, v = _call(
        kernel, n, [f32, jax.ShapeDtypeStruct((n,), jnp.int32), f32, f32],
        block, interpret, "trace_closest",
    )(o, dd, tn, tx, tri_table(tris))
    return intersect.Hit(t=t, tri=jnp.maximum(tri, 0), u=u, v=v,
                         hit=tri >= 0)


def trace_occluded_pallas(tris, orig, d, tmax, tmin=intersect.T_MIN,
                          exclude=None, *, block=BLOCK_RAYS,
                          interpret=False):
    """Any hit in [tmin, tmax] -> (N,) bool; exclude: optional (N,) int32
    triangle id ignored per ray (-1 = none)."""
    n, o, dd, tn, tx = _ray_args(orig, d, tmin, tmax)
    n_tris = tris[0].shape[0]
    use_exclude = exclude is not None
    ex = (jnp.asarray(exclude, jnp.int32).reshape(-1) if use_exclude
          else jnp.zeros((1,), jnp.int32))
    kernel = functools.partial(_occluded_kernel, n_rays=n, n_tris=n_tris,
                               block=block, use_exclude=use_exclude)
    occ = _call(
        kernel, n, jax.ShapeDtypeStruct((n,), jnp.int32), block, interpret,
        "trace_occluded",
    )(o, dd, tn, tx, tri_table(tris), ex)
    return occ != 0
