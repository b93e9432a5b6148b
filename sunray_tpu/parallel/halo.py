"""Explicit row-halo exchange for the shard_map render path.

The frame's cross-pixel reads all have bounded screen-space reach:

  - ReSTIR temporal reuse + TAA history fetch: reprojection distance
    (per-frame motion, bounded by the configured history halo),
  - ReSTIR spatial reuse: tap radius (30 px DI / 20 px GI,
    ray_gen_final.slang:160-161,228-229),
  - TAA 3x3 neighborhood clamp: 1 px,
  - a-trous denoise pass at step s: 2*s px (denoise.slang:27-116).

Under row sharding (mesh axis "sp") each reach becomes a halo of rows
fetched from neighboring shards with `lax.ppermute` — the hand-written
neighbor-collective version of what GSPMD would emit as general collectives
(`parallel/sharding.py` keeps the GSPMD path; this module is the
explicit-scaling path flagged in SURVEY.md section 2.3 / section 7 M8).

`exchange_rows` supports halos larger than the local row count by taking
multiple ppermute hops (needed for tests with tiny per-shard bands; one
hop is the common case on real meshes). Rows beyond the global image are
zero-filled or edge-replicated to match the single-device pad semantics.

All functions here must be called INSIDE a shard_map over `axis_name`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


class ShardGrid(NamedTuple):
    """Row-sharding context threaded through the render stages.

    grid=None everywhere means single-device behavior (the default).
    """

    axis: str           # shard_map mesh axis name carrying image rows
    nshards: int        # static number of shards on that axis
    row0: jnp.ndarray   # () int32 — global row of this shard's local row 0
    h: int              # global image height
    w: int              # image width (never sharded)
    hl: int             # local rows per shard (h // nshards)
    halo_t: int         # temporal-history halo rows (reprojection reach)
    halo_s: int         # spatial-reuse halo rows (max tap radius)

    def global_rows(self):
        """(hl,) global row index of each local row."""
        return self.row0 + jnp.arange(self.hl, dtype=jnp.int32)


def make_grid(cfg, axis: str, nshards: int) -> ShardGrid:
    """Build the grid for a config. Call inside shard_map."""
    assert cfg.height % nshards == 0, (
        f"height {cfg.height} not divisible by {nshards} row shards"
    )
    hl = cfg.height // nshards
    row0 = lax.axis_index(axis).astype(jnp.int32) * hl
    halo_t = max(int(cfg.history_gather_halo), 1)
    halo_s = int(max(cfg.di_spatial_radius, cfg.gi_spatial_radius)) + 1
    reach = cfg.height - hl  # rows available beyond this shard's band
    if nshards > 1:
        assert max(halo_t, halo_s) <= reach, (
            f"halo ({max(halo_t, halo_s)} rows) exceeds the {reach} rows the "
            f"rest of the mesh holds; use fewer shards or a taller image"
        )
    return ShardGrid(
        axis=axis, nshards=nshards, row0=row0, h=cfg.height, w=cfg.width,
        hl=hl, halo_t=halo_t, halo_s=halo_s,
    )


# --- Collective traffic accounting ---------------------------------------
#
# Every cross-shard byte of the explicit-halo frame moves through the
# ppermutes below, and slice shapes are static at trace time — so a
# trace-time tally IS the exact per-device interconnect bytes/frame, with
# no hand-maintained mirror of the exchange call sites to drift.
# tests/test_spmd.py asserts the 1080p/8 number; dryrun_multichip prints
# it.

_TALLY = None


class traffic_tally:
    """Context manager: tallies bytes each ppermute in exchange_rows
    SENDS per chip while tracing runs inside the context.

    with traffic_tally() as t:
        jax.eval_shape(step, ...)   # or trace/lower the sharded frame
    t["bytes"]  ->  per-device interconnect bytes per frame
    """

    def __enter__(self):
        global _TALLY
        self._prev = _TALLY
        _TALLY = {"bytes": 0, "calls": 0}
        return _TALLY

    def __exit__(self, *exc):
        global _TALLY
        _TALLY = self._prev
        return False


def exchange_rows(x, halo_up: int, halo_dn: int, grid: ShardGrid,
                  edge: str = "zero"):
    """Extend a local (hl, ...) row block with halo rows from neighbors.

    Returns (halo_up + hl + halo_dn, ...). Halo rows whose global row
    falls outside [0, h) are zero-filled (edge="zero") or replicated from
    the local boundary row (edge="edge", matching jnp.pad mode="edge"
    semantics of the single-device taps).

    Hop k moves the slice that shard (i -/+ k) owns of the halo; shards
    with no sender at that hop receive ppermute's zero fill, which is
    exactly the out-of-image case.
    """
    hl = x.shape[0]
    n = grid.nshards
    ax = grid.axis

    def hop_slices(halo, is_up):
        parts = []
        h = 1
        rem = halo
        while rem > 0 and h <= n - 1:
            take = min(hl, rem)
            if is_up:
                sl = x[hl - take:]                       # bottom rows of src
                perm = [(i, i + h) for i in range(n - h)]
            else:
                sl = x[:take]                            # top rows of src
                perm = [(i, i - h) for i in range(h, n)]
            parts.append(lax.ppermute(sl, ax, perm))
            if _TALLY is not None:
                _TALLY["bytes"] += int(np.prod(sl.shape)) * sl.dtype.itemsize
                _TALLY["calls"] += 1
            rem -= take
            h += 1
        if rem > 0:   # halo extends past the whole mesh: out-of-image
            pad = jnp.zeros((rem,) + x.shape[1:], x.dtype)
            parts.append(pad)
        return parts

    above = hop_slices(halo_up, True)
    below = hop_slices(halo_dn, False)
    # above parts are ordered nearest-first; rows above stack farthest-first.
    above = above[::-1]
    ext = jnp.concatenate(above + [x] + below, axis=0)

    if edge == "edge" and (halo_up or halo_dn):
        g0 = grid.row0 - halo_up
        grow = g0 + jnp.arange(ext.shape[0], dtype=jnp.int32)
        top = jnp.broadcast_to(x[0], ext.shape)
        bot = jnp.broadcast_to(x[-1], ext.shape)
        mask_shape = (ext.shape[0],) + (1,) * (ext.ndim - 1)
        lo = (grow < 0).reshape(mask_shape)
        hi = (grow >= grid.h).reshape(mask_shape)
        ext = jnp.where(lo, top, jnp.where(hi, bot, ext))
    return ext


def exchange_flat(x, halo: int, grid: ShardGrid, edge: str = "zero"):
    """exchange_rows for raster-flat (P, ...) arrays with P = hl * w.

    Returns ((hl + 2*halo) * w, ...)."""
    img = x.reshape((grid.hl, grid.w) + x.shape[1:])
    ext = exchange_rows(img, halo, halo, grid, edge=edge)
    return ext.reshape(((grid.hl + 2 * halo) * grid.w,) + x.shape[1:])


def gather_flat_ext(ext, idx, halo: int, grid: ShardGrid):
    """Gather rows of a halo-extended flat table at GLOBAL flat indices.

    ext: ((hl + 2*halo) * w, C) from exchange_flat; idx: (P_local,) global
    raster indices (py * w + px). Returns (rows, valid) where valid=False
    for sources outside the exchanged window (callers treat exactly like
    the banded gather's out-of-band lanes: invalid history).
    """
    base = (grid.row0 - halo) * grid.w
    li = idx - base
    nrows = (grid.hl + 2 * halo) * grid.w
    valid = (li >= 0) & (li < nrows)
    rows = ext[jnp.clip(li, 0, nrows - 1)]
    return rows, valid


def shift_flat_ext(x_ext, dx, dy, halo: int, grid: ShardGrid):
    """Local view of a halo-extended flat field shifted by (dx, dy):
    lane i (local pixel i) reads source pixel (x+dx, y+dy). dy may be a
    traced scalar with |dy| <= halo; dx wraps along the row (callers mask
    out-of-bounds with global coords, as with pathtrace._shift_flat)."""
    img = x_ext.reshape((grid.hl + 2 * halo, grid.w) + x_ext.shape[1:])
    sl = lax.dynamic_slice_in_dim(img, halo + dy, grid.hl, axis=0)
    sl = jnp.roll(sl, -dx, axis=1)
    return sl.reshape((grid.hl * grid.w,) + x_ext.shape[1:])
