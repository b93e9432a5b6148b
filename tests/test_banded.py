"""Banded history gathers (ops/banded.py).

The banded path is taken only when forced (force=True); these tests force
it and check it is exact against the plain
gather wherever the source row is within the halo, and that the in-band
mask flags exactly the lanes it cannot serve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.ops.banded import banded_row_gather
from sunray_tpu.render.postprocess import bilinear_sample, bilinear_sample_banded


@pytest.mark.parametrize("layout", ["rows", "lanes", "out_t", "flat"])
def test_banded_matches_plain_within_halo(layout):
    rng = np.random.default_rng(0)
    h, w, c = 40, 16, 5
    band, halo = 4, 6
    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    # Source rows deviate vertically by at most `halo` rows from the
    # destination row; columns arbitrary.
    dy = rng.integers(-halo, halo + 1, size=h * w)
    dst_y = np.arange(h * w) // w
    src_y = np.clip(dst_y + dy, 0, h - 1)
    src_x = rng.integers(0, w, size=h * w)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = banded_row_gather(table, idx, w, band, halo, force=True,
                                 layout=layout)
    if layout == "out_t":
        rows = rows.T
    np.testing.assert_array_equal(np.asarray(ok), True)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table[idx]))


def test_banded_flags_out_of_band():
    rng = np.random.default_rng(1)
    h, w, c = 64, 8, 3
    band, halo = 8, 4
    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dy = rng.integers(-20, 21, size=h * w)
    dst_y = np.arange(h * w) // w
    src_y = np.clip(dst_y + dy, 0, h - 1)
    src_x = rng.integers(0, w, size=h * w)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = banded_row_gather(table, idx, w, band, halo, force=True)
    ok = np.asarray(ok)
    rows = np.asarray(rows)
    ref = np.asarray(table[idx])

    # The window for destination band b covers source rows
    # [b*band - halo, b*band + band + halo): every in-window lane must be
    # served exactly; every served-exact check below is on ok lanes only.
    band_lo = (dst_y // band) * band - halo
    band_hi = (dst_y // band) * band + band + halo
    expect_ok = (src_y >= band_lo) & (src_y < band_hi)
    np.testing.assert_array_equal(ok, expect_ok)
    np.testing.assert_allclose(rows[ok], ref[ok])


def test_banded_disabled_on_small_images():
    # Images shorter than one window fall back to the plain gather.
    table = jnp.arange(12.0).reshape(6, 2)
    idx = jnp.asarray([5, 0, 3], jnp.int32)
    rows, ok = banded_row_gather(table, idx, 2, band=4, halo=4, force=True)
    np.testing.assert_array_equal(np.asarray(ok), True)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table[idx]))


def test_bilinear_banded_matches_reference():
    rng = np.random.default_rng(2)
    h, w = 48, 32
    img = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    xs = (jnp.arange(w) + 0.5) / w
    ys = (jnp.arange(h) + 0.5) / h
    uu, vv = jnp.meshgrid(xs, ys)
    uv = jnp.stack([uu, vv], axis=-1)
    # Small smooth motion (sub-halo): banded must match the plain bilinear
    # exactly, including the edge-clamp behavior.
    motion = jnp.asarray(
        rng.uniform(-3.0, 3.0, size=(h, w, 2)).astype(np.float32)
    ) / jnp.asarray([w, h], jnp.float32)
    prev_uv = uv - motion

    ref = bilinear_sample(img, prev_uv)
    out, valid = bilinear_sample_banded(img, prev_uv, band=4, halo=8, force=True)
    np.testing.assert_array_equal(np.asarray(valid), True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_bilinear_banded_edge_clamp_exact():
    # uv outside [0,1] exercises the clamp path; plain and banded must agree
    # wherever banded reports valid.
    rng = np.random.default_rng(3)
    h, w = 32, 16
    img = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(-0.2, 1.2, size=(h, w, 2)).astype(np.float32))
    ref = np.asarray(bilinear_sample(img, uv))
    out, valid = bilinear_sample_banded(img, uv, band=4, halo=10, force=True)
    valid = np.asarray(valid)
    np.testing.assert_allclose(np.asarray(out)[valid], ref[valid], rtol=1e-6, atol=1e-6)
    assert valid.mean() > 0.3


def test_shift_gather_matches_plain_within_radius():
    rng = np.random.default_rng(4)
    h, w, c = 24, 20, 6
    ry = rx = 3
    from sunray_tpu.ops.banded import shift_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dst_y = np.arange(h * w) // w
    dst_x = np.arange(h * w) % w
    dy = rng.integers(-ry, ry + 1, size=h * w)
    dx = rng.integers(-rx, rx + 1, size=h * w)
    src_y = np.clip(dst_y + dy, 0, h - 1)
    src_x = np.clip(dst_x + dx, 0, w - 1)   # includes row-edge clamps
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = shift_row_gather(table, idx, w, ry, rx, force=True,
                                global_motion=False)
    np.testing.assert_array_equal(np.asarray(ok), True)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table[idx]))


def test_shift_gather_flags_outside_radius():
    rng = np.random.default_rng(5)
    h, w, c = 16, 12, 4
    ry, rx = 2, 2
    from sunray_tpu.ops.banded import shift_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dst_y = np.arange(h * w) // w
    dst_x = np.arange(h * w) % w
    src_y = rng.integers(0, h, size=h * w)
    src_x = rng.integers(0, w, size=h * w)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = shift_row_gather(table, idx, w, ry, rx, force=True,
                                global_motion=False)
    ok = np.asarray(ok)
    expect = (np.abs(src_y - dst_y) <= ry) & (np.abs(src_x - dst_x) <= rx)
    np.testing.assert_array_equal(ok, expect)
    np.testing.assert_allclose(np.asarray(rows)[ok], np.asarray(table[idx])[ok])
    assert 0.05 < ok.mean() < 0.95


def test_shift_gather_global_motion_handles_fast_pan():
    """A uniform pan FAR beyond the residual radius stays exact: the mean
    motion is compensated by one dynamic roll, residual jitter rides the
    select neighborhood."""
    rng = np.random.default_rng(7)
    h, w, c = 40, 32, 5
    from sunray_tpu.ops.banded import shift_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dst_y = np.arange(h * w) // w
    dst_x = np.arange(h * w) % w
    # Pan of (+9, -7) px/frame with zero-mean alternating +-1 jitter.
    jit_y = np.where(np.arange(h * w) % 2 == 0, 1, -1)
    jit_x = np.where(np.arange(h * w) // 2 % 2 == 0, 1, -1)
    src_y = dst_y + 9 + jit_y
    src_x = dst_x - 7 + jit_x
    inside = (src_y >= 0) & (src_y < h) & (src_x >= 0) & (src_x < w)
    idx = jnp.asarray(
        (np.clip(src_y, 0, h - 1) * w + np.clip(src_x, 0, w - 1)).astype(
            np.int32
        )
    )

    rows, ok = shift_row_gather(table, idx, w, 1, 1, force=True,
                                valid=jnp.asarray(inside))
    ok = np.asarray(ok)
    # Every in-image lane is exact; the r=1 window would reject ALL of
    # them without compensation (pan >> radius).
    assert ok[inside].all()
    np.testing.assert_allclose(
        np.asarray(rows)[ok], np.asarray(table[idx])[ok]
    )
    without, ok0 = shift_row_gather(table, idx, w, 1, 1, force=True,
                                    global_motion=False)
    assert not np.asarray(ok0)[inside].any()


def test_shift_gather_global_motion_static_is_exact():
    """Static camera (jitter-only deltas): compensation must not disturb
    the r=1 exactness."""
    rng = np.random.default_rng(8)
    h, w, c = 24, 16, 4
    from sunray_tpu.ops.banded import shift_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dst_y = np.arange(h * w) // w
    dst_x = np.arange(h * w) % w
    jit_y = np.where(np.arange(h * w) % 2 == 0, 1, -1)
    jit_x = np.where(np.arange(h * w) // 2 % 2 == 0, 1, -1)
    src_y = np.clip(dst_y + jit_y, 0, h - 1)
    src_x = np.clip(dst_x + jit_x, 0, w - 1)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = shift_row_gather(table, idx, w, 1, 1, force=True)
    # Edge clamps can push a lane's delta to 0/2 px; interior lanes all ok.
    interior = (
        (dst_y > 1) & (dst_y < h - 2) & (dst_x > 1) & (dst_x < w - 2)
    )
    assert np.asarray(ok)[interior].all()
    np.testing.assert_allclose(
        np.asarray(rows)[np.asarray(ok)],
        np.asarray(table[idx])[np.asarray(ok)],
    )


def test_bilinear_shift_mode_matches_reference():
    rng = np.random.default_rng(6)
    h, w = 40, 24
    img = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    xs = (jnp.arange(w) + 0.5) / w
    ys = (jnp.arange(h) + 0.5) / h
    uu, vv = jnp.meshgrid(xs, ys)
    uv = jnp.stack([uu, vv], axis=-1)
    motion = jnp.asarray(
        rng.uniform(-2.0, 2.0, size=(h, w, 2)).astype(np.float32)
    ) / jnp.asarray([w, h], jnp.float32)
    prev_uv = uv - motion

    ref = bilinear_sample(img, prev_uv)
    out, valid = bilinear_sample_banded(
        img, prev_uv, band=0, halo=0, force=True, mode="shift", radius=3
    )
    np.testing.assert_array_equal(np.asarray(valid), True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


def test_auto_gather_takes_shift_branch_on_small_motion():
    """Within-radius motion: auto must be exact everywhere (shift branch),
    with an all-True mask."""
    rng = np.random.default_rng(8)
    h, w, c = 24, 16, 5
    from sunray_tpu.ops.banded import auto_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dst_y = np.arange(h * w) // w
    dst_x = np.arange(h * w) % w
    dy = rng.integers(-1, 2, size=h * w)
    dx = rng.integers(-1, 2, size=h * w)
    src_y = np.clip(dst_y + dy, 0, h - 1)
    src_x = np.clip(dst_x + dx, 0, w - 1)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = auto_row_gather(table, idx, w, band=4, halo=6, radius=1,
                               force=True, global_motion=False)
    np.testing.assert_array_equal(np.asarray(ok), True)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table[idx]))


def test_auto_gather_falls_back_to_banded_on_rotation():
    """Per-lane offsets far beyond the shift radius but inside the banded
    halo: auto must take the banded branch and stay exact (shift would
    have dropped most lanes)."""
    rng = np.random.default_rng(9)
    h, w, c = 40, 16, 4
    band, halo = 4, 6
    from sunray_tpu.ops.banded import auto_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dst_y = np.arange(h * w) // w
    # "Rotation-like" motion: zero-mean but +/-halo spread vertically,
    # full-width horizontally — retention under radius 1 is tiny.
    dy = rng.integers(-halo, halo + 1, size=h * w)
    src_y = np.clip(dst_y + dy, 0, h - 1)
    src_x = rng.integers(0, w, size=h * w)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = auto_row_gather(table, idx, w, band=band, halo=halo, radius=1,
                               force=True, global_motion=True)
    np.testing.assert_array_equal(np.asarray(ok), True)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table[idx]))


def test_auto_gather_jits_with_cond():
    """The auto gather must stay jittable (scalar-predicate lax.cond) and
    produce branch-consistent results under jit."""
    rng = np.random.default_rng(10)
    h, w, c = 16, 8, 3
    from sunray_tpu.ops.banded import auto_row_gather
    from functools import partial

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    idx_small = jnp.arange(h * w, dtype=jnp.int32)          # static
    src = rng.integers(0, h * w, size=h * w)                # scrambled
    idx_big = jnp.asarray(src.astype(np.int32))

    f = jax.jit(partial(auto_row_gather, band=4, halo=4, radius=1,
                        force=True), static_argnames=("width",))
    rows, ok = f(table, idx_small, width=w)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table))
    rows, ok = f(table, idx_big, width=w)
    served = np.asarray(ok)
    np.testing.assert_allclose(
        np.asarray(rows)[served], np.asarray(table[idx_big])[served]
    )


def test_auto_gather_zero_residual_fast_branch_exact():
    """Static and uniformly-panning frames must take the zero-radius fast
    branch (one global roll, no neighborhood selects) and stay exact;
    semantics identical to the radius-1 shift path on these inputs."""
    rng = np.random.default_rng(11)
    h, w, c = 24, 16, 5
    from sunray_tpu.ops.banded import auto_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    # Static camera: idx == identity.
    idx = jnp.arange(h * w, dtype=jnp.int32)
    rows, ok = auto_row_gather(table, idx, w, band=4, halo=6, radius=1,
                               force=True, global_motion=True)
    np.testing.assert_array_equal(np.asarray(ok), True)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table))

    # Uniform pan by (dy, dx) = (2, 1): every interior lane shares the
    # offset, so the rounded-mean roll serves all of them exactly.
    dst_y = np.arange(h * w) // w
    dst_x = np.arange(h * w) % w
    src_y = np.clip(dst_y + 2, 0, h - 1)
    src_x = np.clip(dst_x + 1, 0, w - 1)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))
    interior = (dst_y + 2 <= h - 1) & (dst_x + 1 <= w - 1)
    rows, ok = auto_row_gather(table, idx, w, band=4, halo=6, radius=1,
                               min_retention=0.7, force=True,
                               global_motion=True)
    served = np.asarray(ok)
    assert served[interior].all()
    np.testing.assert_allclose(
        np.asarray(rows)[served], np.asarray(table[idx])[served]
    )


def test_auto_gather_jitter_window_branch_exact():
    """TAA-style jittered static reprojection (offsets in {-1,0} per axis)
    must be served exactly — the 4-tap [-1,0]x[-1,0] window branch covers
    every lane, so ok must be True wherever the source is in range."""
    rng = np.random.default_rng(12)
    h, w, c = 24, 16, 6
    from sunray_tpu.ops.banded import auto_row_gather

    table = jnp.asarray(rng.normal(size=(h * w, c)).astype(np.float32))
    dst_y = np.arange(h * w) // w
    dst_x = np.arange(h * w) % w
    # floor(x + j - 0.5), j ~ U[0,1): offset -1 or 0 per axis per lane.
    dy = rng.integers(-1, 1, size=h * w)
    dx = rng.integers(-1, 1, size=h * w)
    src_y = np.clip(dst_y + dy, 0, h - 1)
    src_x = np.clip(dst_x + dx, 0, w - 1)
    idx = jnp.asarray((src_y * w + src_x).astype(np.int32))

    rows, ok = auto_row_gather(table, idx, w, band=4, halo=6, radius=1,
                               force=True, global_motion=True)
    np.testing.assert_array_equal(np.asarray(ok), True)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(table[idx]))
