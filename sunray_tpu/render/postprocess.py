"""Post pipeline: temporal accumulation (TAA), a-trous denoise, tonemap.

Ports of shaders/temporal_accumulation.slang, denoise.slang, and
postprocess.slang. The reference's cooperative 18x18 shared-memory tiles and
16x16 workgroups are an execution detail — here these are whole-image
shifted reads that XLA fuses.

All images here are (H, W, C) float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sunray_tpu.ops.banded import (
    auto_row_gather,
    banded_row_gather,
    shift_row_gather,
)
from sunray_tpu.ops.brdf import vec_norm

# Plain floats: a module-level jnp.asarray would initialize the backend at
# import time.
LUMA = (0.2126, 0.7152, 0.0722)
ACCUMULATION_FACTOR = 0.14   # temporal_accumulation.slang:30
ATROUS_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _luminance(c):
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def _shift2d(img, dy, dx, pad_mode="edge"):
    """Shifted window via pad + static slice (fusion-friendly — integer-
    array gathers would materialize the full image per tap, 1080p x 25
    taps x 4 guides)."""
    h, w = img.shape[:2]
    ady, adx = abs(dy), abs(dx)
    pad_width = [(ady, ady), (adx, adx)] + [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad_width, mode=pad_mode)
    return jax.lax.slice(
        padded,
        (ady + dy, adx + dx) + (0,) * (img.ndim - 2),
        (ady + dy + h, adx + dx + w) + img.shape[2:],
    )


def bilinear_sample(img, uv):
    """Manual bilinear fetch at continuous uv, clamp-to-edge
    (temporal_accumulation.slang:42-58). img: (H, W, C); uv: (H, W, 2).

    Four corner gathers of (H, W, C) rows. (A single (2,2,C) patch gather
    regressed 10x on an earlier accelerator: the 5-D result's tiny
    trailing dims padded 64x.)
    """
    h, w = img.shape[:2]
    px = uv[..., 0] * w - 0.5
    py = uv[..., 1] * h - 0.5
    bx = jnp.floor(px).astype(jnp.int32)
    by = jnp.floor(py).astype(jnp.int32)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]

    def at(ix, iy):
        ix = jnp.clip(ix, 0, w - 1)
        iy = jnp.clip(iy, 0, h - 1)
        return img[iy, ix]

    h00 = at(bx, by)
    h10 = at(bx + 1, by)
    h01 = at(bx, by + 1)
    h11 = at(bx + 1, by + 1)
    return (h00 * (1 - fx) + h10 * fx) * (1 - fy) + (h01 * (1 - fx) + h11 * fx) * fy


def bilinear_sample_banded(img, uv, band, halo, force=None, layout="rows",
                           mode="banded", radius=3, shift_global=True,
                           auto_min_retention=0.98):
    """Bilinear history fetch as ONE banded 12-column row gather.

    The four corner taps of `bilinear_sample` are packed into a
    (H, W, 12) table via +1-pixel edge-clamped shifts, so one row gather at
    (by, bx) moves all four corners; the gather itself runs banded
    (ops/banded.py) so each per-band table is a few MB.
    Clipping px/py to [0, size-1] before floor is exactly equivalent to the
    original per-corner index clamping (both end up blending duplicated
    edge texels with matching weights).

    Returns (color (H, W, C), valid (H, W) bool) — valid=False where the
    source row is farther than `halo` rows from the destination (treated by
    TAA exactly like off-screen history).
    """
    h, w = img.shape[:2]
    c = img.shape[2]
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    down = jnp.concatenate([img[1:], img[-1:]], axis=0)
    downright = jnp.concatenate([right[1:], right[-1:]], axis=0)
    packed = jnp.concatenate([img, right, down, downright], axis=-1)
    px = jnp.clip(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    py = jnp.clip(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    bx = jnp.floor(px).astype(jnp.int32)
    by = jnp.floor(py).astype(jnp.int32)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]
    idx = (by * w + bx).reshape(-1)
    if mode == "auto":
        on_screen = jnp.all((uv >= 0.0) & (uv <= 1.0), axis=-1).reshape(-1)
        rows, ok = auto_row_gather(
            packed.reshape(h * w, 4 * c), idx, w, band, halo, radius=radius,
            min_retention=auto_min_retention, force=force,
            valid=on_screen, global_motion=shift_global,
        )
        layout = "rows"
    elif mode == "shift":
        on_screen = jnp.all((uv >= 0.0) & (uv <= 1.0), axis=-1).reshape(-1)
        rows, ok = shift_row_gather(
            packed.reshape(h * w, 4 * c), idx, w, radius, radius, force=force,
            valid=on_screen, global_motion=shift_global,
        )
        layout = "rows"
    else:
        rows, ok = banded_row_gather(
            packed.reshape(h * w, 4 * c), idx, w, band, halo, force=force,
            layout=layout,
        )
    if layout == "out_t":
        corners = [
            rows[k * c : (k + 1) * c].T.reshape(h, w, c) for k in range(4)
        ]
        h00, h10, h01, h11 = corners
    else:
        rows = rows.reshape(h, w, 4 * c)
        h00 = rows[..., 0 * c : 1 * c]
        h10 = rows[..., 1 * c : 2 * c]
        h01 = rows[..., 2 * c : 3 * c]
        h11 = rows[..., 3 * c : 4 * c]
    out = (h00 * (1 - fx) + h10 * fx) * (1 - fy) + (h01 * (1 - fx) + h11 * fx) * fy
    return out, ok.reshape(h, w)


def _bilinear_sample_grid(history, prev_uv, grid):
    """Bilinear history fetch from a halo_t-row ppermute-exchanged window
    of the row-sharded history image (shard_map mode). Returns
    (color (hl, W, C), valid (hl, W)); valid=False where a source corner
    row falls outside the exchanged window."""
    from sunray_tpu.parallel.halo import exchange_rows

    ht = grid.halo_t
    ext = exchange_rows(history, ht, ht, grid)      # (hl + 2*ht, W, C)
    nrows = ext.shape[0]
    row_base = grid.row0 - ht
    w, hg = grid.w, grid.h
    px = jnp.clip(prev_uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    py = jnp.clip(prev_uv[..., 1] * hg - 0.5, 0.0, hg - 1.0)
    bx = jnp.floor(px).astype(jnp.int32)
    by = jnp.floor(py).astype(jnp.int32)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]
    valid = (by >= row_base) & (
        jnp.minimum(by + 1, hg - 1) <= row_base + nrows - 1
    )

    def at(ix, gy):
        ix = jnp.clip(ix, 0, w - 1)
        iy = jnp.clip(jnp.clip(gy, 0, hg - 1) - row_base, 0, nrows - 1)
        return ext[iy, ix]

    h00 = at(bx, by)
    h10 = at(bx + 1, by)
    h01 = at(bx, by + 1)
    h11 = at(bx + 1, by + 1)
    out = (h00 * (1 - fx) + h10 * fx) * (1 - fy)         + (h01 * (1 - fx) + h11 * fx) * fy
    return out, valid


def taa_clamp_blend(raw, hist, use_history, accumulation_factor, nb_at=None):
    """The clamp+blend half of TAA (temporal_accumulation.slang:60-132):
    3x3 luminance-gated neighborhood min/max of `raw`, history clamped into
    that box, lerped by `accumulation_factor`, falling back to `raw` where
    `use_history` is False.

    nb_at: optional (dy, dx) -> shifted raw image override (shard_map halo
    mode); defaults to edge-padded whole-image shifts.
    """
    if nb_at is None:
        nb_at = lambda dy, dx: _shift2d(raw, dy, dx)
    center_luma = _luminance(raw)
    luma_threshold = jnp.maximum(center_luma * 5.0, 0.08)
    min_c = raw
    max_c = raw
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nb = nb_at(dy, dx)
            nb_luma = _luminance(nb)
            ok = (jnp.abs(nb_luma - center_luma) < luma_threshold)[..., None]
            min_c = jnp.where(ok, jnp.minimum(min_c, nb), min_c)
            max_c = jnp.where(ok, jnp.maximum(max_c, nb), max_c)
    clamped = jnp.clip(hist, min_c, max_c)
    blended = clamped + (raw - clamped) * accumulation_factor
    return jnp.where(use_history[..., None], blended, raw)


def temporal_accumulate(raw, motion, history, frame_count,
                        accumulation_factor=ACCUMULATION_FACTOR,
                        history_band=0, history_halo=0,
                        history_layout="rows", history_mode="banded",
                        history_radius=3, history_shift_global=True,
                        history_force=None, history_auto_min_retention=0.98,
                        grid=None):
    """TAA with 3x3 luminance-gated neighborhood clamp
    (temporal_accumulation.slang:60-132).

    raw, history: (H, W, 3); motion: (H, W, 2). Returns the new accumulation
    image (which is next frame's history).

    grid (parallel/halo.ShardGrid): shard_map row-sharded mode — raw/
    motion/history hold this shard's rows; the 3x3 clamp reads a 1-row
    edge-replicated halo and the history fetch reads a halo_t-row
    exchanged window (reprojection beyond it is rejected like off-screen
    history, the multi-chip analog of the banded gather's halo).
    """
    h, w = raw.shape[:2]

    xs = (jnp.arange(w) + 0.5) / w
    if grid is not None:
        gys = grid.row0.astype(jnp.float32) + jnp.arange(h, dtype=jnp.float32)
        ys = (gys + 0.5) / grid.h
    else:
        ys = (jnp.arange(h) + 0.5) / h
    uu, vv = jnp.meshgrid(xs, ys)
    uv = jnp.stack([uu, vv], axis=-1)
    prev_uv = uv - motion

    off_screen = jnp.any((prev_uv < 0.0) | (prev_uv > 1.0), axis=-1)
    if grid is not None:
        hist, valid = _bilinear_sample_grid(history, prev_uv, grid)
    elif history_band > 0:
        hist, valid = bilinear_sample_banded(
            history, prev_uv, history_band, history_halo,
            layout=history_layout, mode=history_mode, radius=history_radius,
            shift_global=history_shift_global, force=history_force,
            auto_min_retention=history_auto_min_retention,
        )
    else:
        hist = bilinear_sample(history, prev_uv)
        valid = True

    use_history = (~off_screen) & valid & (frame_count > 2)
    use_history = jnp.broadcast_to(use_history, (h, w))

    if grid is not None:
        from sunray_tpu.parallel.halo import exchange_rows

        raw_x = exchange_rows(raw, 1, 1, grid, edge="edge")
        nb_at = lambda dy, dx: _shift2d(raw_x, dy, dx)[1:-1]
        return taa_clamp_blend(raw, hist, use_history, accumulation_factor,
                               nb_at=nb_at)

    return taa_clamp_blend(raw, hist, use_history, accumulation_factor)


def atrous_denoise_pass(color, depth, normal, roughness, diffuse, step_width,
                        row0=None, h_global=None):
    """One edge-avoiding a-trous pass (denoise.slang:27-116).

    color: (H,W,3) input; depth: (H,W); normal: (H,W,3); roughness: (H,W);
    diffuse: (H,W,3) demodulation albedo. step_width static int.

    row0/h_global: shard_map mode — the inputs are a halo-extended row
    window whose row 0 sits at (traced) global row `row0`; the tap
    in-bounds test then runs on global rows.
    """
    h, w = color.shape[:2]
    sky = depth >= 10000.0
    smooth = roughness < 0.1
    bypass = sky | smooth

    center_diffuse = jnp.maximum(diffuse, 0.001)
    center_illum = color / center_diffuse
    center_luma = _luminance(center_illum)

    kc = ATROUS_KERNEL[2] * ATROUS_KERNEL[2]
    sum_color = center_illum * kc
    sum_weight = jnp.full((h, w), kc)

    ys = jnp.arange(h) if row0 is None else jnp.arange(h) + row0
    hb = h if h_global is None else h_global
    xs = jnp.arange(w)

    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dx == 0 and dy == 0:
                continue
            oy = dy * step_width
            ox = dx * step_width
            iy = ys + oy
            ix = xs + ox
            in_b = ((iy >= 0) & (iy < hb))[:, None] & ((ix >= 0) & (ix < w))[None, :]
            s_color = _shift2d(color, oy, ox)
            s_depth = _shift2d(depth, oy, ox)
            s_normal = _shift2d(normal, oy, ox)
            s_diffuse = _shift2d(diffuse, oy, ox)

            s_illum = s_color / jnp.maximum(s_diffuse, 0.001)
            s_luma = _luminance(s_illum)

            # vec_norm: d||x||/dx at x=0 is NaN, and identical-albedo
            # neighbors make the difference exactly zero everywhere.
            diffuse_diff = vec_norm(center_diffuse - s_diffuse)
            luma_diff = jnp.abs(center_luma - s_luma)
            luma_sigma = jnp.maximum(center_luma, s_luma) * 0.4 + 0.01
            luma_ratio = luma_diff / luma_sigma

            power = (
                -jnp.abs(depth - s_depth) * 8.0
                + (jnp.sum(normal * s_normal, axis=-1) - 1.0) * 80.0
                - diffuse_diff * 50.0
                - luma_ratio * luma_ratio
            )
            wgt = (
                jnp.exp(power)
                * ATROUS_KERNEL[dx + 2]
                * ATROUS_KERNEL[dy + 2]
            )
            wgt = jnp.where(in_b, wgt, 0.0)
            sum_color = sum_color + s_illum * wgt[..., None]
            sum_weight = sum_weight + wgt

    out = sum_color / jnp.maximum(sum_weight, 1e-4)[..., None] * center_diffuse
    return jnp.where(bypass[..., None], color, out)


def atrous_denoise(color, depth, normal, roughness, diffuse, passes: int):
    """N a-trous passes at step widths 1,2,4,... (src/lib.rs:42,1818)."""
    for i in range(passes):
        color = atrous_denoise_pass(
            color, depth, normal, roughness, diffuse, 1 << i
        )
    return color


def atrous_denoise_grid(color, depth, normal, roughness, diffuse,
                        passes: int, grid):
    """N a-trous passes under shard_map row sharding: the guides are
    halo-exchanged once to the maximum reach (2 * 2^(passes-1) rows) and
    the color is re-exchanged before each pass to that pass's 2*step
    reach, so every shard computes its interior rows exactly as the
    single-device passes would."""
    from sunray_tpu.parallel.halo import exchange_rows

    if passes <= 0:
        return color
    gmax = 2 * (1 << (passes - 1))
    dep_x = exchange_rows(depth, gmax, gmax, grid)
    nor_x = exchange_rows(normal, gmax, gmax, grid)
    rgh_x = exchange_rows(roughness, gmax, gmax, grid)
    dif_x = exchange_rows(diffuse, gmax, gmax, grid)
    hl = color.shape[0]
    for i in range(passes):
        s = 1 << i
        hp = 2 * s
        tr = gmax - hp
        end = gmax + hl + hp
        col_x = exchange_rows(color, hp, hp, grid)
        out = atrous_denoise_pass(
            col_x, dep_x[tr:end], nor_x[tr:end], rgh_x[tr:end],
            dif_x[tr:end], s, row0=grid.row0 - hp, h_global=grid.h,
        )
        color = out[hp:hp + hl]
    return color


def aces_film(x):
    """ACES fitted (Narkowicz) — postprocess.slang:14-18."""
    x = jnp.clip(x, 0.0, 100.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def srgb_encode(x):
    """Exact sRGB OETF (the `use_srgb` output-format analog, lib.rs:1387:
    the reference leaves encoding to the swapchain format; headless we do
    it in the shader-equivalent)."""
    x = jnp.clip(x, 0.0, 1.0)
    lo = x * 12.92
    hi = 1.055 * jnp.maximum(x, 1e-8) ** (1.0 / 2.4) - 0.055
    return jnp.where(x <= 0.0031308, lo, hi)


def tonemap(color, exposure=1.0, mode="aces", gamma=2.2):
    """NaN/Inf scrub -> exposure -> ACES -> transfer curve
    (postprocess.slang:20-42). mode: "aces" | "aces_srgb" | "none"."""
    bad = jnp.any(~jnp.isfinite(color), axis=-1, keepdims=True)
    color = jnp.where(bad, 0.0, color)
    color = color * exposure
    if mode in ("aces", "aces_srgb"):
        color = aces_film(color)
    else:
        color = jnp.clip(color, 0.0, 1.0)
    if mode == "aces_srgb":
        return srgb_encode(color)
    # Epsilon floor: d(x^(1/2.2))/dx is infinite at 0, which poisons
    # gradients of every black pixel. 1e-8^(1/2.2) ~ 2.4e-4, invisible.
    return jnp.maximum(color, 1e-8) ** (1.0 / gamma)
