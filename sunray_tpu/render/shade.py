"""Surface shading at hit points — the closest-hit "shader".

Port of shaders/closest_hit.slang:12-91 to batched array form: barycentric
vertex-attribute interpolation, inverse-transpose normal transform, TBN
normal mapping (handedness from vertex 0 only, closest_hit.slang:34), PBR
texture sampling (glTF metallic-roughness convention: G = roughness,
B = metallic, closest_hit.slang:85), emissive = emissive_tex.rgb * strength.

Instead of packing the result into a 24-byte RayPayload
(rt_types.slang:9-16), the Surface struct keeps float32 SoA — packing is a
storage optimization for the reference's per-thread payload; here the
arrays are batched SoA planes and quantizing them would only break
gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sunray_tpu.ops.linalg import (
    SELECT_GATHER_MAX_ROWS,
    gather_cols,
    gather_vec,
)

from sunray_tpu.ops.brdf import normalize, safe_sqrt, vec_norm
from sunray_tpu.ops.texture import sample_texture
from sunray_tpu.scene.types import (
    NULL_TEXTURE,
    TEX_BASE_COLOR,
    TEX_EMISSIVE,
    TEX_METALLIC_ROUGHNESS,
    TEX_NORMAL,
)


class Surface(NamedTuple):
    """Batched shading result (the RayPayload analog, unpacked)."""

    dist: jnp.ndarray          # (N,)
    pos: jnp.ndarray           # (N, 3) world hit position
    normal: jnp.ndarray        # (N, 3) shading normal (normal-mapped)
    geo_normal: jnp.ndarray    # (N, 3) interpolated geometric normal
    albedo: jnp.ndarray        # (N, 3)
    emission: jnp.ndarray      # (N, 3)
    roughness: jnp.ndarray     # (N,)
    metallic: jnp.ndarray      # (N,)
    transmission: jnp.ndarray  # (N,)
    ior: jnp.ndarray           # (N,)
    valid: jnp.ndarray         # (N,) bool — hit mask


def instance_inverse_rotations(inst_transform):
    """(I,3,3) inverse of the rotation/scale block, for normal transforms."""
    return jnp.linalg.inv(inst_transform[:, :, :3])


def _recompute_hit(orig, d, w0, w1, w2):
    """Moller-Trumbore (t, u, v) for known winning world triangles, one
    (N, 3) array per corner. Grad-safe determinant handling."""
    v0 = w0
    e1 = w1 - v0
    e2 = w2 - v0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    det_ok = jnp.abs(det) > 1e-9
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = orig - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v


def shade_hits(scene, orig, d, hit, differentiable_t=True,
               face_forward=False):
    """Compute the Surface for a batch of hits.

    scene: SceneBuffers; orig/d: (N, 3); hit: intersect.Hit.
    Misses produce valid=False with dist=-1 (ray_miss.slang:9-13 sentinel).

    face_forward: opt-in divergence (cfg.face_forward_normals) — flip the
    shading AND geometric normal to face the incoming ray when the
    geometric normal points away from it. The reference stores the
    unflipped normal (closest_hit.slang:49-50), which leaks backface
    fireflies (docs/PARITY.md); default False keeps exact parity.
    """
    tri = jnp.where(hit.hit, hit.tri, 0)
    # Per-triangle indices ride one packed row gather (vidx + instance id);
    # small tables (<= 128 rows) gather per column (ops/linalg.gather_cols)
    # so no (N, 4) buffer is sliced apart again.
    tpack = jnp.concatenate(
        [scene.tri_vidx, scene.tri_inst[:, None]], axis=1
    )                                                            # (T, 4)
    if tpack.shape[0] <= SELECT_GATHER_MAX_ROWS:
        tcols = gather_cols(tpack, tri)                          # 4 x (N,)
        vidx_k = tcols[0:3]
        inst = tcols[3]
    else:
        trow = tpack[tri]                                        # (N, 4)
        vidx_k = (trow[:, 0], trow[:, 1], trow[:, 2])
        inst = trow[:, 3]
    prim = gather_vec(scene.inst_prim, inst)                     # (N,)

    # All per-vertex attributes ride THREE packed row gathers (one per
    # triangle corner) instead of ~60 scalar gathers; small scenes
    # (<= 128 vertices — the Cornell/benchmark class) gather per column
    # (gather_cols) instead. Packed layout per vertex row:
    # [position(3), normal(3), tangent(4), uvs(5x2)] = 20 columns.
    nverts = scene.positions.shape[0]
    vpack = jnp.concatenate(
        [
            scene.positions,
            scene.normals,
            scene.tangents,
            scene.uvs.reshape(nverts, -1),
        ],
        axis=1,
    )
    ncols = vpack.shape[1]
    # Textureless scene (static 1x1x1 atlas, sample_texture's short-circuit
    # shape): no normal map can exist, so the whole TBN/normal-mapping
    # block below is provably the identity on final_normal — skip it
    # STATICALLY and drop the tangent columns (6-9) from the corner
    # gathers (per-call-site column narrowing; the tangent planes were
    # 40% of each geometry gather's output traffic on the Cornell bench).
    trivial_atlas = scene.textures.data.shape[:3] == (1, 1, 1)
    geo_cols = 6 if trivial_atlas else 10
    uv_base = geo_cols  # corner-tuple index of packed column 10
    if nverts <= SELECT_GATHER_MAX_ROWS:
        # Geometry (10 cols) and uv (10 cols) ride SEPARATE gathers so a
        # textureless scene's dead uv chain (sample_texture's static
        # trivial-atlas short-circuit) lets XLA drop the uv gather whole —
        # a single fused gather would haul all 20 columns regardless.
        vgeo = vpack[:, :geo_cols]
        vuv = vpack[:, 10:]
        corners = [
            gather_cols(vgeo, vidx_k[k]) + gather_cols(vuv, vidx_k[k])
            for k in range(3)
        ]
    else:
        corners = [
            tuple(r[:, c] for c in range(ncols))
            for r in (vpack[vidx_k[k]] for k in range(3))
        ]                                         # 3 corners x 20 columns
        uv_base = 10                              # full rows: packed layout

    # Recompute (t, u, v) differentiably from the winning triangle: the
    # tracer's winner index is discrete (and its Pallas kernels have no AD
    # rule), so gradients flow through the intersection equations here
    # instead — w.r.t. vertices, transforms, ray origin and direction
    # (SURVEY.md section 7 M3 custom-VJP plan).
    # Everything below stays strictly 2-D (N, C): no (N, 3, 3)-shaped
    # intermediates in the walk loop. The 3-corner / 3-component
    # contractions are unrolled into column slices + weighted sums.
    # gather_cols (not gather_vec): a stacked (N, 12) gather whose columns
    # are sliced apart again costs extra walk-loop temporaries
    # (examples/mem_audit.py); unstacked (N,) columns do not.
    xf = gather_cols(scene.inst_transform.reshape(-1, 12), inst)  # 12 x (N,)

    def to_world(c3):
        # Rows of the (3, 4) object->world transform live at xf[4i..4i+3];
        # c3 is a tuple of 3 position columns.
        return jnp.stack(
            [
                xf[4 * i + 0] * c3[0]
                + xf[4 * i + 1] * c3[1]
                + xf[4 * i + 2] * c3[2]
                + xf[4 * i + 3]
                for i in range(3)
            ],
            axis=-1,
        )

    w0, w1, w2 = (to_world(c[0:3]) for c in corners)
    t_d, u_d, v_d = _recompute_hit(orig, d, w0, w1, w2)
    t_att = jnp.where(hit.hit, t_d, hit.t)
    u = jnp.where(hit.hit, u_d, hit.u)
    v = jnp.where(hit.hit, v_d, hit.v)
    bw = [1.0 - u - v, u, v]                         # (N,) bary weights

    # Vertex attribute decode + barycentric interpolation
    # (closest_hit.slang:31-37, rt_utils.slang:136-147) — per column, so
    # only the columns actually consumed are interpolated (6 of the 10 uv
    # columns are unused texture slots).
    def interp(o):
        return sum(bw[k] * corners[k][o] for k in range(3))

    n_obj = jnp.stack([interp(3 + i) for i in range(3)], axis=-1)
    if not trivial_atlas:
        tangent_obj = jnp.stack([interp(6 + i) for i in range(3)], axis=-1)
        handedness = jnp.where(
            corners[0][9] >= 0.0, 1.0, -1.0)  # vertex 0 only
    ub = uv_base + 2 * TEX_BASE_COLOR
    un = uv_base + 2 * TEX_NORMAL
    uv = jnp.stack([interp(ub), interp(ub + 1)], axis=-1)
    normal_uv = jnp.stack([interp(un), interp(un + 1)], axis=-1)

    # Materials (MeshInfo analog).
    mats = scene.materials
    base_color_f = gather_vec(mats.base_color, prim)             # (N, 4)
    tex = gather_vec(mats.tex_index, prim)                       # (N, 5)

    base_color = sample_texture(
        scene.textures, tex[:, TEX_BASE_COLOR], uv, base_color_f
    )
    emissive_factor = gather_vec(mats.emissive_factor, prim)     # (N, 4) rgb + strength
    emissive_sample = sample_texture(
        scene.textures,
        tex[:, TEX_EMISSIVE],
        uv,
        jnp.concatenate(
            [emissive_factor[:, :3], jnp.ones_like(emissive_factor[:, :1])], axis=-1
        ),
    )
    emission = emissive_sample[:, :3] * emissive_factor[:, 3:4]

    # World normal via inverse-transpose (closest_hit.slang:49-50):
    # world_n = normalize((W2O)^T @ n_obj).
    inv_rot = gather_cols(
        instance_inverse_rotations(scene.inst_transform).reshape(-1, 9), inst,
    )                                                            # 9 x (N,)
    # (W2O)^T @ n per pixel, elementwise column contractions (a batched-tiny
    # einsum would lower to 2M micro-matmuls; no (N, 3, 3) intermediate —
    # see the note above).
    world_normal = normalize(
        jnp.stack(
            [
                sum(inv_rot[3 * i + j] * n_obj[:, i] for i in range(3))
                for j in range(3)
            ],
            axis=-1,
        ),
        eps=1e-12,
    )
    final_normal = world_normal

    if trivial_atlas:
        # No textures -> no normal map: raw_nm would be the static default
        # (0.5, 0.5, 1.0), snm exactly (0, 0, 1), and `mapped` exactly
        # world_normal — the whole TBN pipeline below is the identity.
        return _finish_surface(scene, orig, d, hit, t_att, prim, uv,
                               base_color, emission, world_normal,
                               final_normal, mats, face_forward)

    # Normal mapping (closest_hit.slang:56-72).
    has_tangent = vec_norm(tangent_obj) > 0.001
    has_normal_tex = tex[:, TEX_NORMAL] != NULL_TEXTURE
    do_nm = has_tangent & has_normal_tex
    # Object->world rotation rows are already in xf (columns 4i..4i+2).
    world_tangent = normalize(
        jnp.stack(
            [
                sum(xf[4 * i + j] * tangent_obj[:, j] for j in range(3))
                for i in range(3)
            ],
            axis=-1,
        ),
        eps=1e-12,
    )
    world_tangent = normalize(
        world_tangent
        - jnp.sum(world_tangent * world_normal, -1, keepdims=True) * world_normal,
        eps=1e-12,
    )
    world_bitangent = jnp.cross(world_normal, world_tangent) * handedness[:, None]
    raw_nm = sample_texture(
        scene.textures,
        tex[:, TEX_NORMAL],
        normal_uv,
        jnp.broadcast_to(
            jnp.asarray([0.5, 0.5, 1.0, 1.0], base_color.dtype), base_color.shape
        ),
    )[:, :3]
    snm = raw_nm * 2.0 - 1.0
    snm_z = safe_sqrt(jnp.clip(1.0 - snm[:, 0] ** 2 - snm[:, 1] ** 2, 0.0, 1.0))
    snm = normalize(
        jnp.stack([snm[:, 0], snm[:, 1], snm_z], axis=-1), eps=1e-12
    )
    mapped = normalize(
        snm[:, 0:1] * world_tangent
        + snm[:, 1:2] * world_bitangent
        + snm[:, 2:3] * world_normal,
        eps=1e-12,
    )
    final_normal = jnp.where(do_nm[:, None], mapped, final_normal)

    return _finish_surface(scene, orig, d, hit, t_att, prim, uv, base_color,
                           emission, world_normal, final_normal, mats,
                           face_forward)


def _finish_surface(scene, orig, d, hit, t_att, prim, uv, base_color,
                    emission, world_normal, final_normal, mats,
                    face_forward):
    """Shared shade_hits tail: metallic-roughness sampling, hit position,
    the face-forward flip, and Surface assembly."""
    tex = gather_vec(mats.tex_index, prim)

    # Roughness / metallic (closest_hit.slang:79-87).
    roughness = mats.roughness[prim]
    metallic = mats.metallic[prim]
    mr = sample_texture(
        scene.textures,
        tex[:, TEX_METALLIC_ROUGHNESS],
        uv,
        jnp.ones_like(base_color),
    )
    roughness = roughness * mr[:, 1]   # G channel
    metallic = metallic * mr[:, 2]     # B channel

    dist = jnp.where(hit.hit, t_att, -1.0)
    pos = orig + d * dist[:, None]

    if face_forward:
        # Flip AFTER normal mapping so the TBN frame matches the stored
        # (unflipped) tangent basis; the sign comes from the GEOMETRIC
        # normal so the shading normal can't disagree with the surface
        # side it shades.
        back = (jnp.sum(world_normal * d, axis=-1) > 0.0) & hit.hit
        sgn = jnp.where(back, -1.0, 1.0)[:, None]
        final_normal = final_normal * sgn
        world_normal = world_normal * sgn

    return Surface(
        dist=dist,
        pos=pos,
        normal=final_normal,
        geo_normal=world_normal,
        albedo=base_color[:, :3],
        emission=emission,
        roughness=roughness,
        metallic=metallic,
        transmission=mats.transmission[prim],
        ior=mats.ior[prim],
        valid=hit.hit,
    )
