"""Banded and shift-select row gathers for screen-space history reads.

The two big gathers in the frame — ReSTIR temporal-reuse history and the
TAA bilinear history fetch — read a full-resolution history image at
reprojected pixel positions. This module holds alternatives to the plain
`table[idx]` gather, written for an earlier accelerator whose dynamic
gathers serialized on big tables:

The screen-space structure allows it: a reprojected read lands *near* its
destination pixel (distance = per-frame motion in pixels). Splitting the
destination image into horizontal bands and gathering each band only from a
[band - halo, band + halo] window of source rows keeps every per-op table a
few MB while staying exact for any vertical motion up to `halo` pixels.
Reads outside the window are reported via an `in_band` mask so callers fall
back the way the reference already handles invalid history (reject the
reservoir / use the current frame's color). Horizontal motion is
unrestricted (windows span full rows). shift_row_gather replaces the
gather with compare+selects over a small neighborhood of rolls.

Every entry point takes the path only with force=True
(cfg.history_gather_force); otherwise it is the plain gather. Whether any
of it pays on the H100 is not measured yet (ROADMAP design 3.2). The
reference has no analog; documented in docs/PARITY.md.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Window sizing: the gathered window is (band + 2*halo) rows x W x C floats.
# At 1080p with C=17 (GI reservoir), band=halo=16 gives a 48-row window
# = 6.3 MB per gather.
DEFAULT_BAND = 16
DEFAULT_HALO = 16


def banded_row_gather(table, idx, width, band=DEFAULT_BAND, halo=DEFAULT_HALO,
                      force=None, layout="rows"):
    """Gather rows of a raster-ordered (P, C) table at per-lane indices.

    table: (P, C) where P = H * width, rows in raster order.
    idx:   (P,) int32 global flat indices; lane i (destination pixel i in
           raster order) reads table[idx[i]].
    Returns (rows (P, C), in_band (P,) bool). Lanes whose source row is
    farther than `halo` rows from the destination band get in_band=False
    and an arbitrary (clamped) row — callers must mask on in_band.

    force: True takes the banded path; None/False is the plain gather.

    layout: "rows" gathers rows of the (P, C) table; "lanes" runs the
    same gather on the transposed (C, P) table (columns along the minor
    dimension) — the result and every unpacked field then keep the
    P-minor layout the rest of the frame uses, avoiding the
    {1,0}<->{0,1} relayout copies XLA otherwise inserts around row
    gathers. "out_t" keeps the row-major table but asks lax.gather for a
    transposed (C, P) result via offset_dims=(0,) — same goal as "lanes"
    (P-minor output, no relayout) without transposing the table (which
    made the 1080p compile take many minutes). With "out_t" the result
    is (C, P).
    "flat" slices each band's window from the FLATTENED 1-D table and
    gathers C contiguous elements per lane — the per-band window temp is
    then 1-D and tile-padding-free (the 2-D (win, C) windows tile-pad
    C -> 128 lanes: 45 MB instead of 4.2 MB each at 1080p/C=12, measured
    in examples/mem_audit.py), trading it for a strided start-index
    pattern the gather emitter must handle.
    """
    p, c = table.shape
    h = p // width
    use = bool(force)
    if not use or h <= band + 2 * halo:
        rows = table[idx]
        if layout == "out_t":
            rows = rows.T
        return rows, jnp.ones((p,), bool)

    outs = []
    oks = []
    if layout == "lanes":
        pad = jnp.zeros((c, halo * width), table.dtype)
        padded = jnp.concatenate([pad, table.T, pad], axis=1)
        for b0 in range(0, h, band):
            bh = min(band, h - b0)
            dst0 = b0 * width
            idx_b = jax.lax.slice(idx, (dst0,), (dst0 + bh * width,))
            win = (bh + 2 * halo) * width
            local = idx_b - (b0 - halo) * width
            ok = (local >= 0) & (local < win)
            tbl = jax.lax.slice(padded, (0, b0 * width), (c, b0 * width + win))
            cols = tbl[:, jnp.clip(local, 0, win - 1)]
            outs.append(cols)
            oks.append(ok)
        return (
            jnp.concatenate(outs, axis=1).T,
            jnp.concatenate(oks, axis=0),
        )

    pad = jnp.zeros((halo * width, c), table.dtype)
    padded = jnp.concatenate([pad, table, pad], axis=0)
    padded_flat = padded.reshape(-1) if layout == "flat" else None
    for b0 in range(0, h, band):
        bh = min(band, h - b0)
        dst0 = b0 * width
        idx_b = jax.lax.slice(idx, (dst0,), (dst0 + bh * width,))
        # Window rows [b0 - halo, b0 + bh + halo) in image coords =
        # [b0, b0 + bh + 2*halo) in padded coords.
        win = (bh + 2 * halo) * width
        local = idx_b - (b0 - halo) * width
        ok = (local >= 0) & (local < win)
        local = jnp.clip(local, 0, win - 1)
        if layout == "flat":
            tbl = jax.lax.slice(
                padded_flat, (b0 * width * c,), ((b0 * width + win) * c,)
            )
            dnums = jax.lax.GatherDimensionNumbers(
                offset_dims=(1,), collapsed_slice_dims=(),
                start_index_map=(0,),
            )
            rows = jax.lax.gather(
                tbl, (local * c)[:, None], dnums, slice_sizes=(c,)
            )                                   # (bh*width, c)
            outs.append(rows)
            oks.append(ok)
            continue
        tbl = jax.lax.slice(padded, (b0 * width, 0), (b0 * width + win, c))
        if layout == "out_t":
            dnums = jax.lax.GatherDimensionNumbers(
                offset_dims=(0,), collapsed_slice_dims=(0,),
                start_index_map=(0,),
            )
            rows = jax.lax.gather(
                tbl, local[:, None], dnums, slice_sizes=(1, c)
            )                                   # (c, bh*width)
        else:
            rows = tbl[local]
        outs.append(rows)
        oks.append(ok)
    axis = 1 if layout == "out_t" else 0
    return jnp.concatenate(outs, axis=axis), jnp.concatenate(oks, axis=0)


def auto_row_gather(table, idx, width, band=DEFAULT_BAND, halo=DEFAULT_HALO,
                    radius=1, min_retention=0.98, force=None,
                    global_motion=True, valid=None, layout="rows"):
    """Per-frame runtime selection between the shift-select neighborhood
    (fast; drops history where per-pixel deviation from the mean motion
    exceeds `radius`) and the banded windowed gather (exact up to the
    16-row halo). One `lax.cond` on a measured scalar: the fraction of
    valid lanes whose residual offset fits the shift radius. Static or
    uniformly-panning cameras take the shift branch every frame;
    rotation/parallax beyond the radius flips to banded and keeps full
    reprojection semantics (measured divergences:
    examples/ab_history_motion.py, docs/PARITY.md).

    Only the taken branch executes per frame (scalar-predicate lax.cond);
    both compile into the one frame program.
    """
    p, c = table.shape
    use = bool(force)
    if not use:
        return table[idx], jnp.ones((p,), bool)
    dst = jnp.arange(p, dtype=idx.dtype)
    dy = idx // width - dst // width
    dx = idx % width - dst % width
    wts = (
        valid.astype(jnp.float32) if valid is not None
        else jnp.ones((p,), jnp.float32)
    )
    den = jnp.maximum(jnp.sum(wts), 1.0)
    if global_motion:
        gy = jnp.round(jnp.sum(dy.astype(jnp.float32) * wts) / den)
        gx = jnp.round(jnp.sum(dx.astype(jnp.float32) * wts) / den)
        ry = jnp.abs(dy.astype(jnp.float32) - gy)
        rx = jnp.abs(dx.astype(jnp.float32) - gx)
    else:
        ry = jnp.abs(dy).astype(jnp.float32)
        rx = jnp.abs(dx).astype(jnp.float32)
    fits = ((ry <= radius) & (rx <= radius)).astype(jnp.float32)
    retention = jnp.sum(fits * wts) / den
    if global_motion:
        # Zero-residual fast path: a static or PURELY uniform-motion frame
        # (every valid lane's offset equals the rounded mean offset) needs
        # no neighborhood at all — one global roll of the table replaces
        # the (2r+1)^2 select-chain, cutting ~9 full-table read passes per
        # history read to ~1.
        # Residual-nonzero lanes simply lose one frame of history (ok
        # False), identical semantics to the shift path's rejection.
        fits0 = ((ry == 0) & (rx == 0)).astype(jnp.float32)
        retention0 = jnp.sum(fits0 * wts) / den
        # Jitter window: TAA-style jittered reprojection (floor of
        # uv*W + j - 0.5) lands residuals in {-1, 0} per axis — 4 taps
        # instead of 9. dyr/dxr are the SIGNED residuals (ry/rx above are
        # absolute values, useless for an asymmetric box).
        dyr = dy.astype(jnp.float32) - (gy if global_motion else 0.0)
        dxr = dx.astype(jnp.float32) - (gx if global_motion else 0.0)
        fits4 = ((dyr >= -1) & (dyr <= 0) & (dxr >= -1)
                 & (dxr <= 0)).astype(jnp.float32)
        retention4 = jnp.sum(fits4 * wts) / den
        # Identity rung (round 5): a STATIC camera (mean motion exactly
        # zero AND zero-residual retention) needs no data movement at
        # all — the gathered rows ARE the table. The zero-residual
        # branch below still paid the bitcast + dynamic roll + select
        # pipeline (~5 full-table passes) to realize a g=0 roll.
        # Semantics identical: served lanes have idx == lane exactly.
        ident = ((dy == 0) & (dx == 0))
        static_cam = (gy == 0.0) & (gx == 0.0)
        return jax.lax.cond(
            (retention0 >= min_retention) & static_cam,
            lambda: (table, ident),
            lambda: jax.lax.cond(
                # Static camera + jittered reprojection (the DI/GI
                # temporal reads): the 4-tap window with NO global roll —
                # the g=0 dynamic roll was a full-table copy per read.
                (retention4 >= min_retention) & static_cam,
                lambda: shift_row_gather(table, idx, width, 1, 1,
                                         force=True, global_motion=False,
                                         valid=valid,
                                         window=(-1, 0, -1, 0)),
                lambda: _auto_ladder_rest(
                    table, idx, width, band, halo, radius, min_retention,
                    valid, retention0, retention4, retention),
            ),
        )
    return jax.lax.cond(
        retention >= min_retention,
        lambda: shift_row_gather(table, idx, width, radius, radius,
                                 force=True, global_motion=global_motion,
                                 valid=valid),
        lambda: banded_row_gather(table, idx, width, band, halo, force=True,
                                  layout="rows"),
    )


def _auto_ladder_rest(table, idx, width, band, halo, radius, min_retention,
                      valid, retention0, retention4, retention):
    return jax.lax.cond(
            retention0 >= min_retention,
            lambda: shift_row_gather(table, idx, width, 0, 0,
                                     force=True, global_motion=True,
                                     valid=valid),
            lambda: jax.lax.cond(
                retention4 >= min_retention,
                lambda: shift_row_gather(table, idx, width, 1, 1,
                                         force=True, global_motion=True,
                                         valid=valid,
                                         window=(-1, 0, -1, 0)),
                lambda: jax.lax.cond(
                    retention >= min_retention,
                    lambda: shift_row_gather(
                        table, idx, width, radius, radius,
                        force=True, global_motion=True, valid=valid),
                    lambda: banded_row_gather(
                        table, idx, width, band, halo,
                        force=True, layout="rows"),
                ),
            ),
        )


def shift_row_gather(table, idx, width, radius_y, radius_x, force=None,
                     global_motion=True, valid=None, window=None):
    """Row gather restricted to a (2ry+1) x (2rx+1) screen-space
    neighborhood of the destination pixel, with NO dynamic gather at all:
    one compare+select per neighborhood offset over a flat-rolled view of
    the table. XLA fuses the rolls (static lane rotations) and selects
    into one elementwise loop, so the cost is ~(2ry+1)(2rx+1) reads of
    the table per output element on the VPU — no serialized gather, no
    relayout copies, no per-op table staging.

    global_motion=True additionally compensates uniform camera motion:
    the neighborhood is centered on the MEAN source offset (one dynamic
    roll of the table by round(mean(dy))*width + round(mean(dx))) instead
    of the destination pixel, so arbitrary-speed pans/yaws stay exact as
    long as the per-pixel DEVIATION from the mean motion (rotation
    falloff, parallax) is within `radius` pixels. One extra table copy
    (the dynamic roll) + two scalar reductions per call.

    valid: optional (P,) bool — lanes to include in the mean-motion
    estimate (callers pass their reprojection in-bounds mask so clamped
    off-screen indices don't drag the mean). Purely an estimator hint;
    correctness never depends on it (residual rejection is per-lane).

    Returns (rows (P, C), ok (P,) bool): ok=False where the source pixel
    is outside the neighborhood (callers treat it exactly like
    banded_row_gather's out-of-band lanes: invalid history). Beyond the
    compensated `radius` the frame cleanly loses one frame of history.

    Wraparound safety: a flat roll by sy*width + sx crosses a row
    boundary only for lanes whose dst_x + sx leaves [0, width), but such
    a lane is never SELECTED: selection requires dx == sx (residual
    match), and dx is computed from the in-range source pixel, so rolled
    garbage never lands in the output. The same argument covers the
    global-motion roll (selection requires the full 2-D offset match).

    Denormal hazard: callers pack int32 fields bitcast to f32
    (restir._gather_packed), and small ints are DENORMAL floats — float
    datapaths may flush them to zero. Static rolls are pure lane
    rotations, but the global-motion dynamic roll fuses through float
    registers and corrupted bitcast light/triangle ids (measured:
    light_idx zeroed on 57k/130k lanes at 480x270). The whole
    roll+select pipeline therefore runs on an int32-bitcast view —
    integer ops are bit-exact data movement — and bitcasts back at the
    end.
    """
    p, c = table.shape
    use = bool(force)
    if not use:
        return table[idx], jnp.ones((p,), bool)
    is_float = jnp.issubdtype(table.dtype, jnp.floating)
    bits = (
        jax.lax.bitcast_convert_type(table, jnp.int32) if is_float else table
    )
    dst = jnp.arange(p, dtype=idx.dtype)
    dy = idx // width - dst // width
    dx = idx % width - dst % width
    if global_motion:
        if valid is not None:
            wts = valid.astype(jnp.float32)
            den = jnp.maximum(jnp.sum(wts), 1.0)
            mean = lambda v: jnp.sum(v.astype(jnp.float32) * wts) / den
        else:
            mean = lambda v: jnp.mean(v.astype(jnp.float32))
        gy = jnp.round(mean(dy)).astype(idx.dtype)
        gx = jnp.round(mean(dx)).astype(idx.dtype)
        base = jnp.roll(bits, -(gy * width + gx), axis=0)
        dy = dy - gy
        dx = dx - gx
    else:
        base = bits
    # `window` generalizes the symmetric radius to an ASYMMETRIC offset box
    # (ry_lo, ry_hi, rx_lo, rx_hi): TAA-style jittered reprojection on a
    # static/panning camera lands offsets in {-1, 0} per axis (floor of
    # uv*W + jitter - 0.5), so a 4-tap [-1,0]x[-1,0] window halves the
    # select-chain table passes vs the 9-tap radius-1 box.
    if window is None:
        window = (-radius_y, radius_y, -radius_x, radius_x)
    ry_lo, ry_hi, rx_lo, rx_hi = window
    ok = (dy >= ry_lo) & (dy <= ry_hi) & (dx >= rx_lo) & (dx <= rx_hi)
    nx = rx_hi - rx_lo + 1
    key = jnp.where(ok, (dy - ry_lo) * nx + (dx - rx_lo), -1)
    # One wrap-padded extension + one STATIC slice per window offset.
    # jnp.roll materializes a full-table copy per offset; a
    # static slice of the shared extension is a zero-copy view that XLA
    # fuses straight into the select chain, so the whole neighborhood
    # costs ONE extra table copy (the extension) regardless of radius.
    # ext[j] = base[(j - pad_lo) mod p] => roll(base, -s)[i] = ext[i+pad_lo+s].
    pad_lo = max(-(ry_lo * width + rx_lo), 0)
    pad_hi = max(ry_hi * width + rx_hi, 0)
    ext = jnp.concatenate([base[p - pad_lo:] if pad_lo else base[:0],
                           base,
                           base[:pad_hi]], axis=0)
    out = jnp.zeros_like(base)
    k = 0
    for sy in range(ry_lo, ry_hi + 1):
        for sx in range(rx_lo, rx_hi + 1):
            s = sy * width + sx
            rolled = jax.lax.slice_in_dim(
                ext, pad_lo + s, pad_lo + s + p, axis=0)
            out = jnp.where((key == k)[:, None], rolled, out)
            k += 1
    if is_float:
        out = jax.lax.bitcast_convert_type(out, table.dtype)
    return out, ok
