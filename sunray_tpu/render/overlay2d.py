"""egui-class 2D overlay painter: a jit-able triangle-mesh rasterizer.

The reference ships a full egui raster backend
(bevy_integration/egui_paint.rs:1-425): it consumes egui's tessellated
output — clipped triangle meshes with per-vertex color + uv into managed
RGBA textures — and draws them over the path-traced frame with scissor
rects and alpha blending. This module is the jnp analog of that
*painter* (the egui widget library itself is host-side UI logic the
reference links as a crate; here the same role is covered by the
tessellation helpers below):

  - `Mesh2D`: the ClippedPrimitive analog — (V, 2) pixel positions,
    (V, 2) uv, (V, 4) straight-alpha vertex RGBA, (T, 3) indices, an
    optional texture image and an optional scissor rect
    (egui_paint.rs:139-160 DrawCmd fields, clip_to_scissor:387-403).
  - `rasterize_mesh`: resolves one mesh to (rgb, alpha) planes with a
    `lax.scan` over triangles — each step is edge-function coverage +
    barycentric interpolation on (H, W) planes, so compile size is O(1)
    in triangle count and everything stays jit-able. Within a mesh the
    LAST triangle covering a pixel wins before one texture fetch + one
    blend (egui blends per triangle; its meshes are non-overlapping
    glyph/panel quads, so the difference only shows where a mesh
    overlaps itself — documented divergence, docs/PARITY.md).
  - `paint_meshes`: paint_frame analog — meshes blend back-to-front in
    submission order under their clip rects (egui_paint.rs:121-305).
  - Tessellators: `tess_rect` (rounded corners, egui-style corner fans),
    `tess_line` / `tess_polyline` (quad strips), `tess_text` (textured
    glyph quads into the bitmap `font_atlas`), and a `plot_lines`
    widget — enough to build the FPS/stats/graph overlays the window
    example shows.

All rasterization is (H, W) planar elementwise math (no per-pixel
gathers except the single small-texture fetch per textured mesh).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from sunray_tpu.render.overlay import _GLYPHS, GLYPH_H, GLYPH_W


class Mesh2D(NamedTuple):
    xy: jnp.ndarray            # (V, 2) f32 pixel coords (x right, y down)
    uv: jnp.ndarray            # (V, 2) f32 in [0,1] (ignored if tex None)
    rgba: jnp.ndarray          # (V, 4) f32 straight alpha
    tris: jnp.ndarray          # (T, 3) i32
    tex: Optional[jnp.ndarray] = None    # (TH, TW, 4) f32 or None
    clip: Optional[tuple] = None         # (x0, y0, x1, y1) static or None


def _bilinear_small(tex, u, v):
    """Bilinear fetch from a SMALL (TH, TW, 4) texture at (H, W) uv —
    the table is KBs (font atlas / egui textures), so the four corner
    gathers stay cache-resident."""
    th, tw = tex.shape[:2]
    px = jnp.clip(u * tw - 0.5, 0.0, tw - 1.0)
    py = jnp.clip(v * th - 0.5, 0.0, th - 1.0)
    bx = jnp.floor(px).astype(jnp.int32)
    by = jnp.floor(py).astype(jnp.int32)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]
    bx1 = jnp.minimum(bx + 1, tw - 1)
    by1 = jnp.minimum(by + 1, th - 1)
    t00 = tex[by, bx]
    t10 = tex[by, bx1]
    t01 = tex[by1, bx]
    t11 = tex[by1, bx1]
    return (t00 * (1 - fx) + t10 * fx) * (1 - fy) + (
        t01 * (1 - fx) + t11 * fx
    ) * fy


def rasterize_mesh(h: int, w: int, mesh: Mesh2D):
    """Resolve one mesh to (rgb (H, W, 3), alpha (H, W)) planes.

    lax.scan over triangles: coverage by edge functions (winding-agnostic
    via the signed area), attributes by barycentric interpolation; the
    last covering triangle wins. One texture fetch after the scan."""
    xs = jnp.arange(w, dtype=jnp.float32) + 0.5
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5
    pxg, pyg = jnp.meshgrid(xs, ys)                    # (H, W)

    v_xy = mesh.xy[mesh.tris]                          # (T, 3, 2)
    v_uv = mesh.uv[mesh.tris]                          # (T, 3, 2)
    v_cl = mesh.rgba[mesh.tris]                        # (T, 3, 4)
    # Flatten per-tri data to (T, 24) scalars — scanned, never
    # materialized as an (H, W, ...) array per triangle.
    tri_data = jnp.concatenate(
        [v_xy.reshape(-1, 6), v_uv.reshape(-1, 6), v_cl.reshape(-1, 12)],
        axis=1,
    )

    def body(carry, td):
        rgba, uv, covered = carry
        x0, y0, x1, y1, x2, y2 = (td[i] for i in range(6))
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        s = jnp.where(area < 0.0, -1.0, 1.0)          # winding-agnostic
        inv = s / jnp.maximum(jnp.abs(area), 1e-8)
        e0 = ((x2 - x1) * (pyg - y1) - (y2 - y1) * (pxg - x1)) * s
        e1 = ((x0 - x2) * (pyg - y2) - (y0 - y2) * (pxg - x2)) * s
        e2 = ((x1 - x0) * (pyg - y0) - (y1 - y0) * (pxg - x0)) * s
        inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (
            jnp.abs(area) > 1e-8
        )
        w0 = e0 * inv * s
        w1 = e1 * inv * s
        w2 = e2 * inv * s
        new_uv = (
            w0[..., None] * td[6:8] + w1[..., None] * td[8:10]
            + w2[..., None] * td[10:12]
        )
        new_cl = (
            w0[..., None] * td[12:16] + w1[..., None] * td[16:20]
            + w2[..., None] * td[20:24]
        )
        m = inside[..., None]
        return (
            jnp.where(m, new_cl, rgba),
            jnp.where(m, new_uv, uv),
            covered | inside,
        ), None

    init = (
        jnp.zeros((h, w, 4), jnp.float32),
        jnp.zeros((h, w, 2), jnp.float32),
        jnp.zeros((h, w), bool),
    )
    (rgba, uv, covered), _ = jax.lax.scan(body, init, tri_data)

    if mesh.tex is not None:
        t = _bilinear_small(mesh.tex, uv[..., 0], uv[..., 1])
        rgba = rgba * t                                # egui: vertex * tex
    alpha = jnp.where(covered, rgba[..., 3], 0.0)
    if mesh.clip is not None:
        x0, y0, x1, y1 = mesh.clip
        in_clip = (
            (pxg >= x0) & (pxg < x1) & (pyg >= y0) & (pyg < y1)
        )
        alpha = jnp.where(in_clip, alpha, 0.0)
    return rgba[..., :3], alpha


def paint_meshes(img, meshes):
    """Blend meshes onto (H, W, 3) in submission order (paint_frame)."""
    h, w = img.shape[:2]
    for mesh in meshes:
        rgb, a = rasterize_mesh(h, w, mesh)
        img = img * (1.0 - a[..., None]) + rgb * a[..., None]
    return img


# ---------------------------------------------------------------------------
# Tessellators (the egui::epaint tessellation analog, host-side numpy)
# ---------------------------------------------------------------------------


def _mesh_from_lists(xy, uv, rgba, tris, tex=None, clip=None) -> Mesh2D:
    return Mesh2D(
        xy=jnp.asarray(np.asarray(xy, np.float32).reshape(-1, 2)),
        uv=jnp.asarray(np.asarray(uv, np.float32).reshape(-1, 2)),
        rgba=jnp.asarray(np.asarray(rgba, np.float32).reshape(-1, 4)),
        tris=jnp.asarray(np.asarray(tris, np.int32).reshape(-1, 3)),
        tex=tex,
        clip=clip,
    )


def tess_rect(x0, y0, x1, y1, rgba, rounding: float = 0.0,
              segments: int = 4, clip=None) -> Mesh2D:
    """Axis-aligned rect, optionally with rounded corners (egui-style
    corner fans, `segments` tris per corner)."""
    rgba = tuple(rgba)
    if rounding <= 0.0:
        xy = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        tris = [(0, 1, 2), (0, 2, 3)]
        return _mesh_from_lists(xy, [(0, 0)] * 4, [rgba] * 4, tris,
                                clip=clip)
    r = min(rounding, (x1 - x0) / 2.0, (y1 - y0) / 2.0)
    centers = [
        (x1 - r, y0 + r, -np.pi / 2.0),   # top-right
        (x1 - r, y1 - r, 0.0),            # bottom-right
        (x0 + r, y1 - r, np.pi / 2.0),    # bottom-left
        (x0 + r, y0 + r, np.pi),          # top-left
    ]
    pts = []
    for cx, cy, a0 in centers:
        for k in range(segments + 1):
            a = a0 + (np.pi / 2.0) * k / segments
            pts.append((cx + r * np.cos(a), cy + r * np.sin(a)))
    n = len(pts)
    cx0 = (x0 + x1) / 2.0
    cy0 = (y0 + y1) / 2.0
    xy = [(cx0, cy0)] + pts
    tris = [(0, 1 + i, 1 + (i + 1) % n) for i in range(n)]
    return _mesh_from_lists(xy, [(0, 0)] * (n + 1), [rgba] * (n + 1),
                            tris, clip=clip)


def tess_polyline(points, width, rgba, clip=None) -> Mesh2D:
    """Stroke a polyline as per-segment quads (miterless butt joins)."""
    pts = np.asarray(points, np.float32)
    rgba = tuple(rgba)
    xy = []
    tris = []
    hw = width / 2.0
    for i in range(len(pts) - 1):
        p0, p1 = pts[i], pts[i + 1]
        d = p1 - p0
        ln = float(np.linalg.norm(d))
        if ln < 1e-6:
            continue
        nx, ny = -d[1] / ln * hw, d[0] / ln * hw
        b = len(xy)
        xy += [
            (p0[0] + nx, p0[1] + ny), (p1[0] + nx, p1[1] + ny),
            (p1[0] - nx, p1[1] - ny), (p0[0] - nx, p0[1] - ny),
        ]
        tris += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    if not xy:
        xy = [(0.0, 0.0)] * 3
        tris = [(0, 1, 2)]
        rgba_l = [(0.0,) * 4] * 3
        return _mesh_from_lists(xy, [(0, 0)] * 3, rgba_l, tris, clip=clip)
    return _mesh_from_lists(xy, [(0, 0)] * len(xy), [rgba] * len(xy),
                            tris, clip=clip)


def tess_line(p0, p1, width, rgba, clip=None) -> Mesh2D:
    return tess_polyline([p0, p1], width, rgba, clip=clip)


@functools.lru_cache(maxsize=1)
def font_atlas():
    """(GLYPH_H, GLYPH_W * nglyphs, 4) white-on-transparent atlas from the
    5x7 bitmap font + {char: column index} map (the egui font-texture
    analog, apply_texture_deltas:333-365). Numpy, cached."""
    chars = sorted(_GLYPHS)
    strip = np.zeros((GLYPH_H, GLYPH_W * len(chars), 4), np.float32)
    for i, ch in enumerate(chars):
        g = np.asarray(
            [[c == "1" for c in row] for row in _GLYPHS[ch]], np.float32
        )
        strip[:, i * GLYPH_W : (i + 1) * GLYPH_W, :] = g[..., None]
    return strip, {ch: i for i, ch in enumerate(chars)}


def tess_text(text: str, x, y, rgba, scale: float = 1.0,
              clip=None) -> Mesh2D:
    """One textured quad per glyph into the font atlas."""
    strip, index = font_atlas()
    nchars = strip.shape[1] // GLYPH_W
    rgba = tuple(rgba)
    xy = []
    uv = []
    tris = []
    gw = GLYPH_W * scale
    gh = GLYPH_H * scale
    adv = (GLYPH_W + 1) * scale
    cx = float(x)
    for ch in text:
        ci = index.get(ch.upper())
        if ci is None:
            ci = index[" "]
        u0 = ci / nchars
        u1 = (ci + 1) / nchars
        b = len(xy)
        xy += [(cx, y), (cx + gw, y), (cx + gw, y + gh), (cx, y + gh)]
        uv += [(u0, 0.0), (u1, 0.0), (u1, 1.0), (u0, 1.0)]
        tris += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
        cx += adv
    if not xy:
        xy = [(0.0, 0.0)] * 3
        uv = [(0.0, 0.0)] * 3
        tris = [(0, 1, 2)]
        return _mesh_from_lists(xy, uv, [(0.0,) * 4] * 3, tris,
                                tex=jnp.asarray(strip), clip=clip)
    return _mesh_from_lists(xy, uv, [rgba] * len(xy), tris,
                            tex=jnp.asarray(strip), clip=clip)


def plot_lines(values, x0, y0, x1, y1, rgba=(0.3, 0.9, 0.4, 1.0),
               bg=(0.0, 0.0, 0.0, 0.55), width: float = 1.5,
               vmin=None, vmax=None):
    """Frame-time-graph widget: background panel + polyline of `values`
    scaled into the rect. Returns a list of meshes for paint_meshes."""
    v = np.asarray(values, np.float64)
    lo = float(np.min(v)) if vmin is None else vmin
    hi = float(np.max(v)) if vmax is None else vmax
    hi = max(hi, lo + 1e-9)
    xs = np.linspace(x0 + 2, x1 - 2, num=len(v))
    ys = y1 - 2 - (v - lo) / (hi - lo) * (y1 - y0 - 4)
    meshes = [tess_rect(x0, y0, x1, y1, bg, rounding=3.0)]
    if len(v) >= 2:
        meshes.append(tess_polyline(np.stack([xs, ys], axis=1), width,
                                    rgba))
    return meshes


def hud_overlay(img, lines, frame_ms=None, origin=(6.0, 6.0),
                scale: float = 1.0):
    """Stats HUD built on the painter: rounded panel + text lines +
    optional frame-time plot (the window example's FPS title + egui
    overlay rolled into one; examples/orbit.py uses this)."""
    x, y = origin
    gh = (GLYPH_H + 2) * scale
    tw = max((len(t) for t in lines), default=0) * (GLYPH_W + 1) * scale
    ph = gh * len(lines) + 8
    pw = max(tw + 12, 120.0 if frame_ms is not None else 0.0)
    meshes = [
        tess_rect(x - 4, y - 4, x + pw, y + ph
                  + (34.0 if frame_ms is not None else 0.0),
                  (0.0, 0.0, 0.0, 0.55), rounding=4.0)
    ]
    for i, text in enumerate(lines):
        meshes.append(
            tess_text(text, x, y + i * gh, (1.0, 1.0, 1.0, 1.0),
                      scale=scale)
        )
    if frame_ms is not None and len(frame_ms) >= 2:
        gy0 = y + ph
        meshes += plot_lines(frame_ms, x, gy0, x + pw - 8, gy0 + 28.0)
    return paint_meshes(img, meshes)


# ---------------------------------------------------------------------------
# Host-side (numpy) HUD compositor — for interactive loops. The jit-able
# painter above dispatches each op to the device; eagerly, the ~180 ops of
# a HUD are ~180 launches and host syncs per frame. The interactive loop
# already reads the frame back for present/PNG, so the HUD composites in
# numpy on the host copy — zero extra device traffic, bbox-limited work.
# ---------------------------------------------------------------------------


def _np_blend_rect(img, x0, y0, x1, y1, rgba):
    h, w = img.shape[:2]
    x0i, y0i = max(int(x0), 0), max(int(y0), 0)
    x1i, y1i = min(int(round(x1)), w), min(int(round(y1)), h)
    if x1i <= x0i or y1i <= y0i:
        return
    r, g, b, a = rgba
    img[y0i:y1i, x0i:x1i] *= 1.0 - a
    img[y0i:y1i, x0i:x1i] += np.asarray([r, g, b], np.float32) * a


def _np_text(img, text, x, y, rgba, scale=1):
    from sunray_tpu.render.overlay import _glyph_mask

    h, w = img.shape[:2]
    col = np.asarray(rgba[:3], np.float32)
    a = rgba[3]
    cx = int(x)
    for ch in text:
        m = _glyph_mask(ch)
        if scale > 1:
            m = np.kron(m, np.ones((scale, scale), np.float32))
        gh, gw = m.shape
        if cx + gw >= w or int(y) + gh >= h:
            break
        reg = img[int(y) : int(y) + gh, cx : cx + gw]
        mm = (m * a)[..., None]
        reg *= 1.0 - mm
        reg += col * mm
        cx += gw + scale


def _np_polyline(img, xs, ys, rgba, width=1):
    """Column-sampled polyline (plots are functions of x — draw a short
    vertical segment per column between adjacent samples)."""
    h, w = img.shape[:2]
    col = np.asarray(rgba[:3], np.float32)
    a = rgba[3]
    for i in range(len(xs) - 1):
        x0, x1 = int(xs[i]), int(xs[i + 1])
        for x in range(max(x0, 0), min(x1 + 1, w)):
            t = 0.0 if x1 == x0 else (x - x0) / (x1 - x0)
            yy = ys[i] + t * (ys[i + 1] - ys[i])
            y0i = max(int(yy) - width // 2, 0)
            y1i = min(y0i + width, h)
            img[y0i:y1i, x] = img[y0i:y1i, x] * (1 - a) + col * a


def hud_overlay_np(img, lines, frame_ms=None, origin=(6, 6), scale=1):
    """Numpy twin of hud_overlay operating IN PLACE on a host (H, W, 3)
    float array (call on the np.asarray'd frame). Returns img."""
    x, y = origin
    gh = (GLYPH_H + 2) * scale
    tw = max((len(t) for t in lines), default=0) * (GLYPH_W + 1) * scale
    ph = gh * len(lines) + 8
    pw = max(tw + 12, 120 if frame_ms is not None else 0)
    extra = 34 if frame_ms is not None else 0
    _np_blend_rect(img, x - 4, y - 4, x + pw, y + ph + extra,
                   (0.0, 0.0, 0.0, 0.55))
    for i, text in enumerate(lines):
        _np_text(img, text, x, y + i * gh, (1.0, 1.0, 1.0, 1.0),
                 scale=scale)
    if frame_ms is not None and len(frame_ms) >= 2:
        v = np.asarray(frame_ms, np.float64)
        lo, hi = float(v.min()), float(v.max())
        hi = max(hi, lo + 1e-9)
        gy0 = y + ph
        xs = np.linspace(x + 2, x + pw - 10, num=len(v))
        ys = gy0 + 26 - (v - lo) / (hi - lo) * 24
        _np_polyline(img, xs, ys, (0.3, 0.9, 0.4, 1.0))
    return img
