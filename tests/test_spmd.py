"""Explicit shard_map + ppermute render path (parallel/spmd.py) vs the
single-device frame, on the 8-device virtual CPU mesh.

The spmd frame must match the single-device frame wherever no halo
rejection occurs: static camera exactly; small motion (below halo_t rows
per frame) to float-reassociation noise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.pipeline import RenderState, render_frame
from sunray_tpu.scene import cornell_box


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _mesh(n=8):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("sp",))


def _cfg(**kw):
    base = dict(
        width=64, height=48, lighting="restir", bounces=3, virtual_bounces=3,
        ris_candidates=4, di_spatial_samples=2, gi_spatial_samples=2,
        di_spatial_radius=8.0, gi_spatial_radius=6.0, denoise_passes=2,
    )
    base.update(kw)
    return RenderConfig(**base)


def _run_frames(cfg, cams, spmd):
    scene = cornell_box()
    state = RenderState.create(cfg)
    ldrs = []
    if spmd:
        from sunray_tpu.parallel.spmd import make_spmd_step, shard_state

        mesh = _mesh()
        step = make_spmd_step(scene, cfg, mesh)
        state = shard_state(state, cfg, mesh)
        for cam in cams:
            mats = camera_matrices(cam, cfg.width, cfg.height)
            state, ldr, rounds = step(scene, state, mats)
            ldrs.append(np.asarray(ldr))
    else:
        # jit to match the spmd path's compiled numerics: ReSTIR merge
        # decisions are discrete (u < w/w_sum), so eager-vs-jit fusion
        # reassociation flips isolated lanes by design.
        step = jax.jit(lambda st, m: render_frame(scene, cfg, st, m))
        for cam in cams:
            mats = camera_matrices(cam, cfg.width, cfg.height)
            state, ldr, aux = step(state, mats)
            ldrs.append(np.asarray(ldr))
    return ldrs


def _assert_close_frames(ref, got, rtol, atol, min_match=0.995):
    """allclose with an escape hatch for discrete-decision lanes: ReSTIR's
    reservoir takes amplify one-ULP compilation differences into O(1)
    radiance changes on isolated pixels, so demand near-total agreement
    rather than universal."""
    for a, b in zip(ref, got):
        assert np.isfinite(b).all()
        match = np.isclose(b, a, rtol=rtol, atol=atol).all(axis=-1)
        assert match.mean() >= min_match, (
            f"only {match.mean():.4f} of pixels match "
            f"(max|d|={np.abs(a - b).max():.3e})"
        )


CAM = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)


def test_spmd_matches_single_device_static():
    cfg = _cfg()
    cams = [CAM] * 3
    ref = _run_frames(cfg, cams, spmd=False)
    got = _run_frames(cfg, cams, spmd=True)
    _assert_close_frames(ref, got, rtol=2e-5, atol=2e-5)


def test_spmd_matches_single_device_moving():
    """Slow orbit: sub-halo per-frame motion — the halo exchange must
    reproduce the single-device reprojection reads."""
    cfg = _cfg()
    cams = [
        Camera(position=(1.0 + 0.02 * i, 1.0, 3.4 - 0.02 * i),
               target=(1.0, 1.0, 0.0), fov_y=45.0)
        for i in range(3)
    ]
    ref = _run_frames(cfg, cams, spmd=False)
    got = _run_frames(cfg, cams, spmd=True)
    _assert_close_frames(ref, got, rtol=2e-4, atol=2e-4)


def test_spmd_fast_motion_stays_finite():
    """Motion far beyond the halo: history must be cleanly rejected, not
    corrupted."""
    cfg = _cfg()
    cams = [
        Camera(position=(1.0, 1.0 + 0.6 * i, 3.4), target=(1.0, 1.0, 0.0),
               fov_y=45.0)
        for i in range(3)
    ]
    got = _run_frames(cfg, cams, spmd=True)
    for b in got:
        assert np.isfinite(b).all()
        assert b.max() > 0.01


def test_spmd_perpixel_taps():
    cfg = _cfg(spatial_taps="perpixel")
    cams = [CAM] * 2
    ref = _run_frames(cfg, cams, spmd=False)
    got = _run_frames(cfg, cams, spmd=True)
    _assert_close_frames(ref, got, rtol=2e-5, atol=2e-5)


def test_spmd_realistic_shard_height():
    """Shard heights matching a real 1080p/8 pod (544 rows / 8 shards =
    68 rows/shard) with the REFERENCE reuse radii: DI disc 30 px, GI disc
    20 px, 4 a-trous passes (16-row reach), TAA/temporal halo 16. Every
    cross-pixel reach must fit inside one shard's row band (single-hop
    ppermute) and the spmd frame must match the single-device frame.
    Round-2 VERDICT item 5 — the tiny 8-rows/shard dryrun left the halo
    path unvalidated at radii that exceed the shard height."""
    cfg = _cfg(
        width=256, height=544,
        di_spatial_samples=5, di_spatial_radius=30.0,
        gi_spatial_samples=3, gi_spatial_radius=20.0,
        denoise_passes=4,
    )
    hl = cfg.height // 8
    halo_s = int(max(cfg.di_spatial_radius, cfg.gi_spatial_radius)) + 1
    atrous_reach = 2 * (1 << (cfg.denoise_passes - 1))
    halo_t = cfg.history_gather_halo
    # The halo >= radius invariants at real radii (and single-hop room).
    assert halo_s > cfg.di_spatial_radius >= cfg.gi_spatial_radius
    assert hl >= max(halo_s, halo_t, atrous_reach, 1), (
        f"shard height {hl} below a halo reach "
        f"(spatial {halo_s}, temporal {halo_t}, a-trous {atrous_reach})"
    )
    cams = [CAM] * 2
    ref = _run_frames(cfg, cams, spmd=False)
    got = _run_frames(cfg, cams, spmd=True)
    _assert_close_frames(ref, got, rtol=2e-5, atol=2e-5)


def test_exchange_rows_roundtrip():
    """exchange_rows returns exactly the neighboring shards' rows (multi-
    hop halo wider than the local band) with zero/edge fill at the image
    boundary."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from sunray_tpu.parallel.halo import ShardGrid, exchange_rows

    mesh = _mesh()
    h, w = 32, 5          # hl = 4 rows/shard
    halo = 10             # needs 3 hops
    x = jnp.arange(h * w, dtype=jnp.float32).reshape(h, w)

    def body(xl):
        grid = ShardGrid(
            axis="sp", nshards=8,
            row0=jax.lax.axis_index("sp").astype(jnp.int32) * 4,
            h=h, w=w, hl=4, halo_t=halo, halo_s=halo,
        )
        return exchange_rows(xl, halo, halo, grid, edge="zero")

    ext = shard_map(
        body, mesh=mesh, in_specs=P("sp"), out_specs=P("sp"),
        check_vma=False,
    )(x)
    ext = np.asarray(ext).reshape(8, 4 + 2 * halo, w)
    xnp = np.asarray(x)
    for s in range(8):
        row0 = s * 4
        for r in range(4 + 2 * halo):
            g = row0 - halo + r
            if 0 <= g < h:
                np.testing.assert_array_equal(ext[s, r], xnp[g])
            else:
                np.testing.assert_array_equal(ext[s, r], 0.0)


def test_ici_halo_traffic_budget_1080p():
    """Pins the explicit-halo path's per-chip ICI bytes/frame at the
    reference 1080p/8 configuration. The tally
    counts every ppermute's sent slice at TRACE time (parallel/halo.py
    traffic_tally), so this is the exact collective traffic of the
    compiled program, not an estimate."""
    from sunray_tpu.parallel.halo import traffic_tally
    from sunray_tpu.parallel.spmd import (
        make_spmd_step,
        mats_placeholder,
        shard_state,
        state_specs,  # noqa: F401  (import check)
    )

    mesh = _mesh(8)
    cfg = RenderConfig(
        width=1920, height=1080, lighting="restir",
        di_spatial_radius=30.0, gi_spatial_radius=20.0,
        denoise_passes=4,
    )
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                 fov_y=45.0)
    mats = camera_matrices(cam, cfg.width, cfg.height)
    state = RenderState.create(cfg)

    with traffic_tally() as t:
        step = make_spmd_step(scene, cfg, mesh)
        jax.eval_shape(step, scene,
                       jax.tree_util.tree_map(
                           lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           shard_state(state, cfg, mesh)),
                       mats)
    mb = t["bytes"] / 1e6
    # Counted exactly 27.92 MB/chip/frame across 62 ppermutes (a trace-
    # time count, not a device measurement). Bounds at ~15%: a structural
    # change that grows the collective volume materially must update this
    # pin consciously. For scale: per-chip HBM frame traffic lower-bounds at
    # ~3.8 GB (utils/roofline.py) — the halo volume is ~0.7% of it.
    assert t["calls"] > 10, t
    assert 23.0 < mb < 33.0, f"ICI traffic {mb:.2f} MB/chip/frame"
