"""Auxiliary subsystems: checkpoint/resume, overlay, profiling dumps."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from sunray_tpu.camera import Camera, camera_matrices
from sunray_tpu.config import RenderConfig
from sunray_tpu.render.pipeline import RenderState, render_frame
from sunray_tpu.scene import cornell_box
from sunray_tpu.utils import checkpoint as ckpt

CFG = RenderConfig(
    width=48, height=32, bounces=3, virtual_bounces=2, ris_candidates=2,
    di_spatial_samples=1, gi_spatial_samples=1, denoise_passes=1,
)
CAM = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)


class TestCheckpoint:
    def test_save_load_resume_exact(self, tmp_path):
        scene = cornell_box()
        mats = camera_matrices(CAM, CFG.width, CFG.height)
        step = jax.jit(lambda st: render_frame(scene, CFG, st, mats))

        state = RenderState.create(CFG)
        for _ in range(3):
            state, ldr, _ = step(state)

        path = str(tmp_path / "state.npz")
        ckpt.save_state(state, path)
        restored = ckpt.load_state(path, RenderState.create(CFG))

        # Continue both and require identical frames.
        s1, f1, _ = step(state)
        s2, f2, _ = step(restored)
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
        assert int(s1.frame_count) == int(s2.frame_count)

    def test_async_manager_roundtrip(self, tmp_path):
        """AsyncCheckpointManager: non-blocking saves, retention, exact
        resume from latest_step (orbax path when available, npz
        otherwise)."""
        scene = cornell_box()
        mats = camera_matrices(CAM, CFG.width, CFG.height)
        step = jax.jit(lambda st: render_frame(scene, CFG, st, mats))
        state = RenderState.create(CFG)

        mgr = ckpt.AsyncCheckpointManager(str(tmp_path / "ckpts"),
                                          max_to_keep=2)
        saved = {}
        for i in range(4):
            state, ldr, _ = step(state)
            mgr.save(i, state)
            saved[i] = jax.tree_util.tree_map(np.asarray, state)
        mgr.wait()

        assert mgr.latest_step() == 3
        restored = mgr.restore(RenderState.create(CFG))
        for a, b in zip(
            jax.tree_util.tree_leaves(saved[3]),
            jax.tree_util.tree_leaves(restored),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # Retention: only the last 2 steps survive.
        try:
            mgr.restore(RenderState.create(CFG), step=0)
            kept0 = True
        except Exception:
            kept0 = False
        assert not kept0
        mgr.close()

    def test_shape_mismatch_rejected(self, tmp_path):
        state = RenderState.create(CFG)
        path = str(tmp_path / "state.npz")
        ckpt.save_state(state, path)
        other = RenderState.create(CFG.with_size(64, 64))
        try:
            ckpt.load_state(path, other)
            assert False, "expected ValueError"
        except ValueError:
            pass


class TestOverlay:
    def test_stats_overlay_draws(self):
        from sunray_tpu.render.overlay import stats_overlay

        img = jnp.zeros((64, 128, 3))
        out = stats_overlay(img, ["FPS 12.34", "FRAME 0001"])
        out = np.asarray(out)
        assert out.max() > 0.9       # white glyph pixels
        assert out.shape == (64, 128, 3)
        # Pixels outside the overlay box untouched.
        assert out[60:, 100:].max() == 0.0


class TestHloDump:
    def test_dump_hlo(self, tmp_path):
        from sunray_tpu.utils.profiling import dump_hlo

        scene = cornell_box()
        mats = camera_matrices(CAM, CFG.width, CFG.height)
        state = RenderState.create(CFG)
        out = dump_hlo(
            lambda st: render_frame(scene, CFG, st, mats)[1],
            (state,),
            str(tmp_path),
        )
        assert os.path.exists(out)
        lowered = str(tmp_path / "frame_lowered.txt")
        assert os.path.getsize(lowered) > 1000

    def test_async_manager_npz_fallback(self, tmp_path):
        """The orbax-free fallback obeys the same contract (save/restore/
        retention/latest_step)."""
        mgr = ckpt.AsyncCheckpointManager(str(tmp_path / "npz"),
                                          max_to_keep=2)
        mgr._mgr = None               # force the npz path
        mgr._max_to_keep = 2
        state = RenderState.create(CFG)
        for i in range(4):
            mgr.save(i, state)
        assert mgr.latest_step() == 3
        assert len(mgr._npz_steps()) == 2
        restored = mgr.restore(RenderState.create(CFG))
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        mgr.close()


class TestProvenance:
    """utils/provenance.exec_paths reports the dispatch the frame really
    takes: the tracer from render/trace.resolve_tracer (shared with the
    Renderer) and, on the brute path only, the trace kernel — the Triton
    kernel in programs compiled for the GPU, the jnp planes elsewhere."""

    def test_mirrors_dispatch_predicates(self):
        from sunray_tpu.config import RenderConfig
        from sunray_tpu.render import trace
        from sunray_tpu.utils.provenance import exec_paths

        scene = cornell_box()
        cfg = RenderConfig(lighting="restir")
        assert exec_paths(cfg, scene, "gpu") == {
            "tracer": "brute", "trace_kernel": "pallas",
            "num_tris": int(scene.num_tris),
        }
        assert exec_paths(cfg, scene, "cpu")["trace_kernel"] == "xla"
        # make_tracer takes the brute path for the same config.
        ctx = trace.make_tracer(scene, cfg)
        assert ctx.bvh is None and ctx.bvh2 is None and ctx.binned is None
        # Above the crossover the kernel choice does not apply; Cornell's
        # several small instances resolve to the two-level tracer.
        small = cfg.replace(brute_force_max_tris=4)
        ep = exec_paths(small, scene, "gpu")
        assert ep["tracer"] == "bvh2" and ep["trace_kernel"] == "-"
        assert trace.make_tracer(scene, small).bvh is not None
        ep = exec_paths(cfg.replace(tracer="bvh"), scene, "gpu")
        assert ep == {"tracer": "bvh", "trace_kernel": "-",
                      "num_tris": int(scene.num_tris)}
        assert exec_paths(cfg.replace(tracer="bvh"), scene,
                          "cpu")["trace_kernel"] == "-"
