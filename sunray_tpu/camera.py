"""Camera model.

Replicates the reference camera exactly (src/camera.rs:33-63) so renders can
match: right-handed look-at view (nalgebra `Isometry3::look_at_rh`),
OpenGL-convention perspective (nalgebra `Perspective3::new(aspect, fov_y,
0.1, 100.0)`), and the Vulkan y-flip `proj[(1,1)] *= -1` (camera.rs:51).

Ray generation follows shaders/ray_gen_ris.slang:44-53:
    uv     = (pixel + 0.5) / size
    d      = uv * 2 - 1
    origin = view_inverse @ (0,0,0,1)
    target = proj_inverse @ (d.x, d.y, 1, 1)
    dir    = view_inverse @ (normalize(target.xyz), 0)

All matrices here act on column vectors (M @ v). The reference's
CPU-transpose-before-upload (src/lib.rs:1024-1047) is a Slang row-indexing
artifact with no mathematical content, so it is intentionally absent.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from sunray_tpu.ops.linalg import einsum32

Z_NEAR = 0.1   # camera.rs:44
Z_FAR = 100.0  # camera.rs:45


@dataclasses.dataclass(frozen=True)
class Camera:
    """Position/target/fov camera (camera.rs:3-8). Angles in degrees."""

    position: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fov_y: float = 45.0

    def set_position(self, p) -> "Camera":
        return dataclasses.replace(self, position=tuple(p))

    def set_target(self, t) -> "Camera":
        return dataclasses.replace(self, target=tuple(t))

    def set_fov_y(self, f) -> "Camera":
        return dataclasses.replace(self, fov_y=float(f))


def look_at_rh(eye, target, up):
    """Right-handed look-at view matrix (nalgebra Isometry3::look_at_rh)."""
    eye = jnp.asarray(eye, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)

    zaxis = eye - target
    zaxis = zaxis / jnp.linalg.norm(zaxis)
    xaxis = jnp.cross(up, zaxis)
    xaxis = xaxis / jnp.linalg.norm(xaxis)
    yaxis = jnp.cross(zaxis, xaxis)

    rot = jnp.stack([xaxis, yaxis, zaxis])  # rows
    trans = -einsum32("ij,j->i", rot, eye)
    view = jnp.zeros((4, 4), jnp.float32)
    view = view.at[:3, :3].set(rot)
    view = view.at[:3, 3].set(trans)
    view = view.at[3, 3].set(1.0)
    return view


def perspective_gl(aspect, fov_y_rad, znear, zfar):
    """OpenGL-convention perspective (nalgebra Perspective3), z in [-1, 1]."""
    f = 1.0 / jnp.tan(fov_y_rad / 2.0)
    proj = jnp.zeros((4, 4), jnp.float32)
    proj = proj.at[0, 0].set(f / aspect)
    proj = proj.at[1, 1].set(f)
    proj = proj.at[2, 2].set((zfar + znear) / (znear - zfar))
    proj = proj.at[2, 3].set(2.0 * zfar * znear / (znear - zfar))
    proj = proj.at[3, 2].set(-1.0)
    return proj


def camera_matrices(camera: Camera, width: int, height: int):
    """-> dict with view_inverse, proj_inverse, view_proj (camera.rs:33-63).

    `prev_view_proj` is renderer state (zero on the first frame,
    camera.rs:61), not a camera property, so it is not returned here.
    """
    eye = jnp.asarray(camera.position, jnp.float32)
    target = jnp.asarray(camera.target, jnp.float32)
    up = jnp.asarray((0.0, 1.0, 0.0), jnp.float32)

    view = look_at_rh(eye, target, up)
    proj = perspective_gl(
        jnp.float32(width) / jnp.float32(height),
        jnp.deg2rad(jnp.asarray(camera.fov_y, jnp.float32)),
        Z_NEAR,
        Z_FAR,
    )
    # Vulkan y-flip (camera.rs:51).
    proj = proj.at[1, 1].multiply(-1.0)

    # Analytic inverses: rigid view -> [[R^T, eye], [0, 1]]; perspective
    # [[a,0,0,0],[0,b,0,0],[0,0,c,d],[0,0,-1,0]] -> known closed form.
    # (Avoids linalg.inv's internal matmuls, which may run at reduced
    # precision on an accelerator.)
    rot = view[:3, :3]
    view_inverse = jnp.zeros((4, 4), jnp.float32)
    view_inverse = view_inverse.at[:3, :3].set(rot.T)
    view_inverse = view_inverse.at[:3, 3].set(eye)
    view_inverse = view_inverse.at[3, 3].set(1.0)

    a, b = proj[0, 0], proj[1, 1]
    c, d = proj[2, 2], proj[2, 3]
    proj_inverse = jnp.zeros((4, 4), jnp.float32)
    proj_inverse = proj_inverse.at[0, 0].set(1.0 / a)
    proj_inverse = proj_inverse.at[1, 1].set(1.0 / b)
    proj_inverse = proj_inverse.at[2, 3].set(-1.0)
    proj_inverse = proj_inverse.at[3, 2].set(1.0 / d)
    proj_inverse = proj_inverse.at[3, 3].set(c / d)

    view_proj = einsum32("ij,jk->ik", proj, view)
    return {
        "view_inverse": view_inverse,
        "proj_inverse": proj_inverse,
        "view_proj": view_proj,
    }


_matrices_jit_cache: dict = {}


def camera_matrices_device(camera: Camera, width: int, height: int):
    """camera_matrices as ONE compiled program (cached per frame size).

    The eager form dispatches ~40 tiny device ops per call, each a
    separate launch and host sync point in the Renderer loop. Jitting the
    whole computation makes a frame's camera math
    three small array uploads + one cached program dispatch. Same ops,
    same math — use this from host-side per-frame loops; the traceable
    `camera_matrices` stays for differentiable pipelines that take
    gradients through camera parameters."""
    key = (int(width), int(height))
    fn = _matrices_jit_cache.get(key)
    if fn is None:
        import jax

        def run(pos, tgt, fov):
            return camera_matrices(
                Camera(position=pos, target=tgt, fov_y=fov), width, height
            )

        fn = jax.jit(run)
        _matrices_jit_cache[key] = fn
    return fn(
        jnp.asarray(camera.position, jnp.float32),
        jnp.asarray(camera.target, jnp.float32),
        jnp.asarray(camera.fov_y, jnp.float32),
    )


def generate_rays(matrices, width: int, height: int, row0=None,
                  rows: int = 0):
    """Primary camera rays for every pixel (ray_gen_ris.slang:44-53).

    Returns (origins, directions) with shape (H, W, 3). Row 0 is the top of
    the image (Vulkan launch-id convention); the y-flipped projection makes
    the world-space directions come out right.

    row0/rows: generate only the `rows` global rows starting at traced row
    index `row0` (shard_map row sharding, parallel/spmd.py) — the returned
    arrays are then (rows, W, 3).
    """
    view_inverse = matrices["view_inverse"]
    proj_inverse = matrices["proj_inverse"]

    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    if row0 is not None:
        iy = row0.astype(jnp.float32) + jnp.arange(rows, dtype=jnp.float32)
        py = (iy + 0.5) / height
    else:
        py = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    u, v = jnp.meshgrid(px, py)          # (H, W)
    d = jnp.stack([u, v], axis=-1) * 2.0 - 1.0

    # Column contractions with the small matrices: clip = (dx, dy, 1, 1).
    # A broadcasted (H, W, 4, 4) product would materialize 16 values per
    # pixel (see render/shade.py).
    dx2, dy2 = d[..., 0], d[..., 1]
    tgt = jnp.stack(
        [
            proj_inverse[i, 0] * dx2 + proj_inverse[i, 1] * dy2
            + proj_inverse[i, 2] + proj_inverse[i, 3]
            for i in range(3)
        ],
        axis=-1,
    )
    tgt = tgt / jnp.linalg.norm(tgt, axis=-1, keepdims=True)

    dirs = jnp.stack(
        [
            sum(view_inverse[i, j] * tgt[..., j] for j in range(3))
            for i in range(3)
        ],
        axis=-1,
    )
    origin = view_inverse[:3, 3]
    origins = jnp.broadcast_to(origin, dirs.shape)
    return origins, dirs


def project_to_prev_uv(view_proj_prev, world_pos):
    """Reproject world positions with a previous-frame view-proj matrix.

    Mirrors ray_gen_ris.slang:119-130: returns (prev_uv, valid) where valid
    requires w > 0.01 and uv in [0,1).
    """
    # Column contractions (no broadcast (P, 4, 4) product inside the
    # temporal passes — see render/shade.py).
    x, y, z = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]
    m = view_proj_prev

    def row(i):
        return m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]

    w = row(3)
    valid_w = w > 0.01
    safe_w = jnp.where(valid_w, w, 1.0)
    uv = jnp.stack([row(0), row(1)], axis=-1) / safe_w[..., None] * 0.5 + 0.5
    in_bounds = jnp.all((uv >= 0.0) & (uv < 1.0), axis=-1)
    return uv, valid_w & in_bounds
