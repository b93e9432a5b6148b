"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import pytest


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestDryrun:
    def test_dryrun_multichip_8(self):
        import __graft_entry__ as ge
        ge.dryrun_multichip(8)

    def test_entry_compiles(self):
        import __graft_entry__ as ge
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        state, ldr, aux = out
        assert np.isfinite(np.asarray(ldr)).all()


def test_place_frame_args_layout():
    """The GSPMD frame's inputs: (H, W, C) images and flat (P,) reservoir
    arrays sharded over 'sp', the scene and the camera replicated."""
    from sunray_tpu.camera import Camera, camera_matrices
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.parallel.sharding import make_mesh, place_frame_args
    from sunray_tpu.render.pipeline import RenderState
    from sunray_tpu.scene import cornell_box

    cfg = RenderConfig(width=16, height=8, lighting="restir")
    mesh = make_mesh(4, dp=1)
    mats = camera_matrices(Camera(), cfg.width, cfg.height)
    scene, state, mats = place_frame_args(
        cornell_box(), cfg, RenderState.create(cfg), mats, mesh)
    n_split = 0
    for x in jax.tree_util.tree_leaves(state):
        spec = x.sharding.spec
        pixel = ((x.ndim >= 2 and x.shape[0] == cfg.height)
                 or (x.ndim >= 1 and x.shape[0] == cfg.height * cfg.width))
        assert (tuple(spec)[:1] == ("sp",)) == pixel, (x.shape, spec)
        n_split += pixel
    assert n_split > 0
    for x in jax.tree_util.tree_leaves((scene, mats)):
        assert x.sharding.is_fully_replicated
