"""Scene data model: SoA pytrees for geometry, materials, emissives, instances.

The data model mirrors the reference's GPU scene state, re-laid-out as
struct-of-arrays jax pytrees instead of byte-packed buffers:

  - Vertex layout (96-byte packed struct, gltf/vertex.rs:1-36,
    rt_types.slang:24-36) -> SoA arrays: position/normal/tangent + 5 UV sets.
  - Material (112-byte packed struct, resources/material.rs:18-58) ->
    MaterialTable SoA; texture references are indices into a TextureAtlas
    (the descriptor-heap-slot analog; there are no heap slots here).
  - EmissiveTriangle + EmissiveIndirectionEntry (gltf/emissive_triangle.rs:1-30,
    resource_manager.rs:216-267) -> local-space emissive triangle arrays plus
    a per-frame (emissive_tri, instance) indirection built by
    SceneBuffers.emissive_indirection().
  - EntityGpuData / MeshInfo slots (resources/entity.rs:6-13): the "instance
    custom index -> mesh info" indirection becomes tri_prim / inst_prim
    index arrays.

Everything is a utils.struct dataclass => a pytree that can cross jit
boundaries, be donated, sharded, and checkpointed.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from sunray_tpu.ops.linalg import gather_vec
import numpy as np
from sunray_tpu.utils import struct

NULL_TEXTURE = -1  # reference: u32::MAX (rt_types.slang:192); -1 for int32

# glTF alpha modes (resources/material.rs)
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

# Texture slot roles (Material has 5 texture slots, resources/material.rs:18-58)
TEX_BASE_COLOR = 0
TEX_METALLIC_ROUGHNESS = 1
TEX_NORMAL = 2
TEX_OCCLUSION = 3
TEX_EMISSIVE = 4
NUM_TEX_SLOTS = 5

# Sampler wrap modes
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2


@struct.dataclass
class TextureAtlas:
    """All scene images padded to a common size and stacked.

    data:  (N, H, W, 4) float32 in [0,1] (linear; sRGB decode happens at load)
    size:  (N, 2) int32 — (width, height) of the valid region per texture
    wrap:  (N, 2) int32 — (wrap_u, wrap_v) per texture's sampler
    filt:  (N,) int32 — 0 nearest, 1 linear
    """

    data: jnp.ndarray
    size: jnp.ndarray
    wrap: jnp.ndarray
    filt: jnp.ndarray

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas(
            data=jnp.ones((1, 1, 1, 4), jnp.float32),
            size=jnp.ones((1, 2), jnp.int32),
            wrap=jnp.zeros((1, 2), jnp.int32),
            filt=jnp.ones((1,), jnp.int32),
        )


def merge_atlases(a: "TextureAtlas", b: "TextureAtlas"):
    """Stack two atlases -> (merged, offset): texture i of `b` becomes
    texture offset + i (pad to the common HxW; sizes stay per-texture, so
    sampling is unchanged). Used when a second glTF scene group is loaded
    into an existing SceneManager."""
    if a is None:
        return b, 0
    if b is None:
        return a, 0
    da = np.asarray(a.data)
    db = np.asarray(b.data)
    h = max(da.shape[1], db.shape[1])
    w = max(da.shape[2], db.shape[2])

    def pad(d):
        return np.pad(
            d, ((0, 0), (0, h - d.shape[1]), (0, w - d.shape[2]), (0, 0))
        )

    merged = TextureAtlas(
        data=jnp.asarray(np.concatenate([pad(da), pad(db)])),
        size=jnp.asarray(np.concatenate([np.asarray(a.size), np.asarray(b.size)])),
        wrap=jnp.asarray(np.concatenate([np.asarray(a.wrap), np.asarray(b.wrap)])),
        filt=jnp.asarray(np.concatenate([np.asarray(a.filt), np.asarray(b.filt)])),
    )
    return merged, da.shape[0]


@struct.dataclass
class MaterialTable:
    """Per-primitive PBR materials (SoA twin of resources/material.rs:18-58)."""

    base_color: jnp.ndarray        # (M, 4)
    metallic: jnp.ndarray          # (M,)
    roughness: jnp.ndarray         # (M,)
    emissive_factor: jnp.ndarray   # (M, 4) — rgb + strength in w (material.rs)
    alpha_mode: jnp.ndarray        # (M,) int32
    alpha_cutoff: jnp.ndarray      # (M,)
    transmission: jnp.ndarray      # (M,)
    ior: jnp.ndarray               # (M,)
    tex_index: jnp.ndarray         # (M, 5) int32, NULL_TEXTURE = none

    @staticmethod
    def build(records: list) -> "MaterialTable":
        """records: list of dicts with the scalar fields above."""
        m = len(records)

        def col(key, default, shape=()):
            out = np.zeros((m,) + shape, np.float32)
            for i, r in enumerate(records):
                out[i] = np.asarray(r.get(key, default), np.float32)
            return jnp.asarray(out)

        tex = np.full((m, NUM_TEX_SLOTS), NULL_TEXTURE, np.int32)
        for i, r in enumerate(records):
            tex[i] = np.asarray(r.get("tex_index", [NULL_TEXTURE] * 5), np.int32)
        return MaterialTable(
            base_color=col("base_color", (1.0, 1.0, 1.0, 1.0), (4,)),
            metallic=col("metallic", 0.0),
            roughness=col("roughness", 1.0),
            emissive_factor=col("emissive_factor", (0.0, 0.0, 0.0, 0.0), (4,)),
            alpha_mode=jnp.asarray(
                [int(r.get("alpha_mode", ALPHA_OPAQUE)) for r in records], jnp.int32
            ),
            alpha_cutoff=col("alpha_cutoff", 0.5),
            transmission=col("transmission", 0.0),
            ior=col("ior", 1.5),
            tex_index=jnp.asarray(tex),
        )


@struct.dataclass
class SceneBuffers:
    """The full traced scene: geometry + instances + materials + emissives.

    Geometry is a concatenation over unique primitives ("meshes", the BLAS
    analog — scene.rs:98-165 builds one static BLAS per unique primitive).
    A flat world-space triangle list is pre-expanded over instances at load
    time (host): tri_vidx indexes the shared vertex pool, tri_inst maps each
    world triangle to its instance (whose transform is applied inside jit, so
    world positions stay differentiable w.r.t. vertices AND transforms).
    """

    # Vertex pool (SoA of gltf/vertex.rs)
    positions: jnp.ndarray    # (V, 3)
    normals: jnp.ndarray      # (V, 3)
    tangents: jnp.ndarray     # (V, 4)
    uvs: jnp.ndarray          # (V, 5, 2) — 5 UV sets per vertex

    # World triangle list (expanded over instances)
    tri_vidx: jnp.ndarray     # (T, 3) int32 into the vertex pool
    tri_inst: jnp.ndarray     # (T,) int32 instance id

    # Instances (TLAS analog)
    inst_transform: jnp.ndarray   # (I, 3, 4) object->world (VkTransformMatrixKHR rows)
    inst_prim: jnp.ndarray        # (I,) int32 — primitive (material/mesh-info slot)

    # Materials, textures
    materials: MaterialTable
    textures: TextureAtlas

    # Emissive light list (local space, per primitive)
    emissive_v: jnp.ndarray       # (E, 3, 3) local triangle vertices
    emissive_rgb: jnp.ndarray     # (E, 3) emission = factor.rgb * strength
    emissive_prim: jnp.ndarray    # (E,) int32 owning primitive

    # Per-frame light indirection (the EmissiveIndirectionEntry table,
    # resource_manager.rs:216-267): for each (instance, emissive tri of its
    # primitive) pair, (emissive_tri_index, instance_id).
    light_tri: jnp.ndarray        # (L,) int32 into emissive_*
    light_inst: jnp.ndarray       # (L,) int32 into instances
    # World-triangle id of each light — lets occlusion queries exclude the
    # target light's own triangle instead of relying on the reference's
    # absolute TMax epsilon (ray_gen_ris.slang:287-293), which geometrically
    # self-occludes near-perpendicular shadow rays. A software tracer knows
    # triangle ids; a hardware TLAS doesn't — a win of the software tracer.
    light_world_tri: jnp.ndarray  # (L,) int32 into the world triangle list

    # Unique-edge topology for shadow-boundary gradients
    # (render/boundary.py, cfg.shadow_boundary_grads): edge e = local
    # edge edge_k[e] of world tri edge_tri[e, 0]; edge_tri[e, 1] is the
    # adjacent face (-1 open). Populated by boundary.with_edge_topology
    # at scene build (host-side); None when not needed.
    edge_tri: Optional[jnp.ndarray] = None   # (E, 2) int32
    edge_k: Optional[jnp.ndarray] = None     # (E,) int32

    @property
    def num_tris(self) -> int:
        return self.tri_vidx.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_tri.shape[0]

    @property
    def has_alpha_mask(self) -> bool:
        return bool(np.any(np.asarray(self.materials.alpha_mode) == ALPHA_MASK))

    def world_triangle_vertices(self):
        """(v0, v1, v2) world-space positions, each (T, 3). Differentiable."""
        p = gather_vec(self.positions, self.tri_vidx)      # (T, 3, 3)
        xf = gather_vec(self.inst_transform, self.tri_inst)  # (T, 3, 4)
        # out[t,k,i] = sum_j xf[t,i,j] * p[t,k,j] — elementwise broadcast
        # (a batched-tiny einsum lowers to per-triangle micro-matmuls).
        pw = (
            jnp.sum(xf[:, None, :, :3] * p[:, :, None, :], axis=-1)
            + xf[:, None, :, 3]
        )                                                  # (T, 3verts, 3)
        return pw[:, 0], pw[:, 1], pw[:, 2]

    def light_world_triangles(self):
        """World-space emissive triangles: (L,3,3) verts + (L,3) emission."""
        v = self.emissive_v[self.light_tri]                # (L, 3, 3)
        xf = self.inst_transform[self.light_inst]          # (L, 3, 4)
        vw = jnp.sum(xf[:, None, :, :3] * v[:, :, None, :], axis=-1) + xf[:, None, :, 3]
        rgb = self.emissive_rgb[self.light_tri]
        return vw, rgb


def build_scene(
    positions,
    normals,
    tri_vidx,
    prim_of_tri,
    materials: MaterialTable,
    instances,
    tangents=None,
    uvs=None,
    textures: Optional[TextureAtlas] = None,
) -> "SceneBuffers":
    """Assemble SceneBuffers from host (numpy) mesh data.

    positions/normals: (V,3); tri_vidx: (Tm,3) object-space triangle list;
    prim_of_tri: (Tm,) primitive id per object-space triangle;
    instances: list of (prim_id, (3,4) transform). The world triangle list
    is the expansion of each instance's primitive triangles — the analog of
    the reference's per-instance BLAS references resolved late
    (blas.rs:445-482), done eagerly because XLA wants dense arrays.
    """
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    tri_vidx = np.asarray(tri_vidx, np.int32)
    prim_of_tri = np.asarray(prim_of_tri, np.int32)
    v = positions.shape[0]
    if tangents is None:
        tangents = np.zeros((v, 4), np.float32)
    if uvs is None:
        uvs = np.zeros((v, NUM_TEX_SLOTS, 2), np.float32)

    inst_prim = np.asarray([p for p, _ in instances], np.int32)
    inst_xf = np.asarray([t for _, t in instances], np.float32).reshape(-1, 3, 4)

    # Expand world triangles over instances.
    w_vidx, w_inst = [], []
    for i, prim in enumerate(inst_prim):
        mask = prim_of_tri == prim
        w_vidx.append(tri_vidx[mask])
        w_inst.append(np.full(int(mask.sum()), i, np.int32))
    w_vidx = (
        np.concatenate(w_vidx) if w_vidx else np.zeros((0, 3), np.int32)
    )
    w_inst = np.concatenate(w_inst) if w_inst else np.zeros((0,), np.int32)

    # Emissive triangles: local-space copies per emissive primitive
    # (scene.rs:115-135: emission = emissive_factor.rgb * emissive_strength).
    ef = np.asarray(materials.emissive_factor)
    em_v, em_rgb, em_prim = [], [], []
    for prim in range(ef.shape[0]):
        strength_rgb = ef[prim, :3] * ef[prim, 3]
        if not np.any(strength_rgb != 0.0):
            continue
        mask = prim_of_tri == prim
        tv = positions[tri_vidx[mask]]  # (n, 3, 3)
        for k in range(tv.shape[0]):
            em_v.append(tv[k])
            em_rgb.append(strength_rgb)
            em_prim.append(prim)
    em_v = np.asarray(em_v, np.float32).reshape(-1, 3, 3)
    em_rgb = np.asarray(em_rgb, np.float32).reshape(-1, 3)
    em_prim = np.asarray(em_prim, np.int32)

    # Light indirection: every instance of an emissive primitive contributes
    # its emissive triangles (resource_manager.rs:216-267). Also record each
    # light's world-triangle id: an emissive primitive's k-th emissive
    # triangle IS its k-th triangle (the whole primitive is emissive, as in
    # gltf/mod.rs:274-296), so world id = instance offset + k.
    inst_offset = np.zeros(len(inst_prim), np.int64)
    off = 0
    for i, prim in enumerate(inst_prim):
        inst_offset[i] = off
        off += int((prim_of_tri == prim).sum())
    lt, li, lw = [], [], []
    for i, prim in enumerate(inst_prim):
        idx = np.nonzero(em_prim == prim)[0]
        lt.append(idx.astype(np.int32))
        li.append(np.full(idx.shape[0], i, np.int32))
        k = idx - (idx[0] if idx.size else 0)
        lw.append((inst_offset[i] + k).astype(np.int32))
    lt = np.concatenate(lt) if lt else np.zeros((0,), np.int32)
    li = np.concatenate(li) if li else np.zeros((0,), np.int32)
    lw = np.concatenate(lw) if lw else np.zeros((0,), np.int32)

    return SceneBuffers(
        positions=jnp.asarray(positions),
        normals=jnp.asarray(normals),
        tangents=jnp.asarray(tangents),
        uvs=jnp.asarray(uvs),
        tri_vidx=jnp.asarray(w_vidx),
        tri_inst=jnp.asarray(w_inst),
        inst_transform=jnp.asarray(inst_xf),
        inst_prim=jnp.asarray(inst_prim),
        materials=materials,
        textures=textures if textures is not None else TextureAtlas.empty(),
        emissive_v=jnp.asarray(em_v),
        emissive_rgb=jnp.asarray(em_rgb),
        emissive_prim=jnp.asarray(em_prim),
        light_tri=jnp.asarray(lt),
        light_inst=jnp.asarray(li),
        light_world_tri=jnp.asarray(lw),
    )


def identity_transform() -> np.ndarray:
    return np.concatenate([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)], axis=1)


def translate(x, y, z) -> np.ndarray:
    t = identity_transform()
    t[:, 3] = (x, y, z)
    return t
