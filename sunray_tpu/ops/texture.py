"""Texture atlas sampling: bilinear/nearest, wrap modes, NULL fallback.

The analog of the reference's descriptor-heap texture path
(rt_utils.slang:121-133 `sample_texture`: resolved heap slots + SampleLevel 0
with a per-texture sampler). Heap slots become atlas indices; samplers
become per-texture (wrap_u, wrap_v, filter) metadata baked at load time
(scene.rs:68-83 sampler dedup). Only level 0 exists — the reference never
samples mips.
"""

from __future__ import annotations

import jax.numpy as jnp

from sunray_tpu.scene.types import NULL_TEXTURE, WRAP_CLAMP, WRAP_MIRROR, WRAP_REPEAT


def _apply_wrap(coord, size, mode):
    """Integer texel coordinate wrap. coord: (...,) int32, size: (...,) int32."""
    size = jnp.maximum(size, 1)
    repeat = jnp.mod(coord, size)
    clamp = jnp.clip(coord, 0, size - 1)
    period = 2 * size
    m = jnp.mod(jnp.mod(coord, period) + period, period)
    mirror = jnp.where(m < size, m, period - 1 - m)
    out = jnp.where(mode == WRAP_REPEAT, repeat, 0)
    out = out + jnp.where(mode == WRAP_CLAMP, clamp, 0)
    out = out + jnp.where(mode == WRAP_MIRROR, mirror, 0)
    return out


def sample_texture(atlas, tex_id, uv, fallback):
    """Sample atlas[tex_id] at uv (level 0). tex_id == NULL_TEXTURE -> fallback.

    atlas: TextureAtlas; tex_id: (...,) int32; uv: (..., 2); fallback: (..., 4).
    Returns (..., 4).
    """
    is_null = tex_id == NULL_TEXTURE
    # Textureless scene (TextureAtlas.empty's static 1x1x1 shape): every
    # lookup is the fallback (or the dummy white texel). Short-circuiting
    # on the STATIC shape makes the uv interpolation chain dead code, which
    # lets XLA drop the uv vertex gathers from the shade pass entirely
    # (render/shade.py splits the vertex pack for exactly this).
    if atlas.data.shape[:3] == (1, 1, 1):
        return jnp.where(is_null[..., None], fallback,
                         jnp.ones_like(fallback))
    tid = jnp.where(is_null, 0, tex_id)

    size = atlas.size[tid]                        # (..., 2) (w, h)
    wrap = atlas.wrap[tid]                        # (..., 2)
    filt = atlas.filt[tid]                        # (...,)

    w = size[..., 0]
    h = size[..., 1]
    px = uv[..., 0] * w.astype(jnp.float32) - 0.5
    py = uv[..., 1] * h.astype(jnp.float32) - 0.5
    bx = jnp.floor(px).astype(jnp.int32)
    by = jnp.floor(py).astype(jnp.int32)
    fx = px - bx.astype(jnp.float32)
    fy = py - by.astype(jnp.float32)

    def texel(ix, iy):
        ix = _apply_wrap(ix, w, wrap[..., 0])
        iy = _apply_wrap(iy, h, wrap[..., 1])
        return atlas.data[tid, iy, ix]            # (..., 4)

    t00 = texel(bx, by)
    t10 = texel(bx + 1, by)
    t01 = texel(bx, by + 1)
    t11 = texel(bx + 1, by + 1)
    fxe = fx[..., None]
    fye = fy[..., None]
    bilinear = (
        (t00 * (1 - fxe) + t10 * fxe) * (1 - fye)
        + (t01 * (1 - fxe) + t11 * fxe) * fye
    )

    # Nearest: round the un-offset coordinate.
    nx = _apply_wrap(jnp.floor(uv[..., 0] * w).astype(jnp.int32), w, wrap[..., 0])
    ny = _apply_wrap(jnp.floor(uv[..., 1] * h).astype(jnp.int32), h, wrap[..., 1])
    nearest = atlas.data[tid, ny, nx]

    out = jnp.where((filt == 1)[..., None], bilinear, nearest)
    return jnp.where(is_null[..., None], fallback, out)
