"""AsState heuristic wired into the Renderer.

The reference drives every per-frame BLAS/TLAS build decision through the
shared AsState machine (acceleration_structure/mod.rs:94-148). Here the
Renderer's unified-BVH path must consult it: a fresh scene takes the
quality SLOW_BUILD (native SAH), transform animation takes UPDATE (cached
topology + in-jit refit) at most MAX_UPDATES_BEFORE_REBUILD times between
FAST_BUILDs (device LBVH re-sort, no host stall), and FRAMES_TO_SETTLE
quiet frames settle back to SLOW_BUILD.
"""

import numpy as np

from sunray_tpu.camera import Camera
from sunray_tpu.config import RenderConfig
from sunray_tpu.ops import accel_state
from sunray_tpu.ops.bvh import Bvh
from sunray_tpu.render.renderer import Renderer
from sunray_tpu.scene import cornell_box
from sunray_tpu.scene.manager import SceneManager
from sunray_tpu.scene.types import translate

CFG = RenderConfig(
    width=32, height=24, bounces=2, virtual_bounces=1, ris_candidates=2,
    di_spatial_samples=1, gi_spatial_samples=1, denoise_passes=0,
    tracer="bvh",
)
CAM = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)


def managed_renderer():
    scene = cornell_box()
    r = Renderer(CFG)
    r._manager = SceneManager.from_scene_buffers(scene)
    r._instances = r._manager.default_instances(scene)
    r.scene = r._manager.build(r._instances)
    return r


def step(r, instances=None):
    """One heuristic 'frame': optional instance churn, then the accel
    decision the Renderer would make for that frame."""
    if instances is not None:
        r.set_instances(instances)
    accel = r._scene_accel()
    return r.last_accel_op, accel


def nudged(instances, i, dx):
    out = list(instances)
    key, _ = out[i]
    out[i] = (key, translate(dx, 0.0, 0.0))
    return out


class TestHeuristicWiring:
    def test_fresh_scene_slow_build_then_quiet(self):
        r = managed_renderer()
        op, accel = step(r)
        assert op == accel_state.SLOW_BUILD
        assert isinstance(accel, Bvh)
        # Static frames: no rebuild, the cached topology object survives.
        for _ in range(5):
            op2, accel2 = step(r)
            assert op2 == "none"
            assert accel2 is accel

    def test_animation_updates_without_host_rebuild(self):
        r = managed_renderer()
        _, accel0 = step(r)  # SLOW_BUILD at load
        ops = []
        inst = list(r._instances)
        for k in range(12):
            op, accel = step(r, nudged(inst, 0, 0.001 * (k + 1)))
            ops.append(op)
            if op == accel_state.UPDATE:
                # UPDATE keeps the cached topology: no host build happened.
                assert accel is accel0 or isinstance(accel, Bvh)
        # Animation never pays the host SAH build.
        assert accel_state.SLOW_BUILD not in ops
        # At most 8 consecutive refits between rebuilds (mod.rs:75).
        run = 0
        for op in ops:
            if op == accel_state.UPDATE:
                run += 1
                assert run <= accel_state.MAX_UPDATES_BEFORE_REBUILD
            else:
                run = 0
        assert accel_state.FAST_BUILD in ops
        # The first 8 moving frames are pure refits of the load topology.
        first_fast = ops.index(accel_state.FAST_BUILD)
        assert all(op == accel_state.UPDATE for op in ops[:first_fast])

    def test_spawn_is_fast_build(self):
        r = managed_renderer()
        step(r)
        inst = list(r._instances)
        smallest = min(
            inst, key=lambda kt: r._manager._meshes[kt[0]].tri_vidx.shape[0]
        )[0]
        op, accel = step(r, inst + [(smallest, translate(0.1, 0.0, 0.1))])
        assert op == accel_state.FAST_BUILD
        assert isinstance(accel, Bvh)

    def test_settles_back_to_quality(self):
        r = managed_renderer()
        step(r)
        inst = list(r._instances)
        # Churn until a FAST_BUILD leaves the structure non-optimal.
        for k in range(10):
            step(r, nudged(inst, 0, 0.001 * (k + 1)))
        assert not r._as_state.optimal
        ops = []
        for _ in range(accel_state.FRAMES_TO_SETTLE + 3):
            op, _ = step(r)
            ops.append(op)
        assert accel_state.SLOW_BUILD in ops
        assert r._as_state.optimal
        # Settling happens exactly once.
        assert ops.count(accel_state.SLOW_BUILD) == 1

    def test_directly_loaded_scene_builds_once(self):
        r = Renderer(CFG, scene=cornell_box())
        op, accel = step(r)
        assert op == accel_state.SLOW_BUILD
        for _ in range(3):
            op2, accel2 = step(r)
            assert op2 == "none"
            assert accel2 is accel
        # A replacement scene is a fresh quality build.
        r.load_scene(cornell_box())
        op3, accel3 = step(r)
        assert op3 == accel_state.SLOW_BUILD
        assert accel3 is not accel

    def test_auto_big_single_mesh_picks_binned(self):
        """tracer="auto" resolves big single-instance meshes to the binned
        stream tracer (stack walks collapse on big trees): the Renderer's
        accel and trace.resolve_tracer (which provenance records) agree."""
        from sunray_tpu.ops.binned_trace import ClusterSet
        from sunray_tpu.render.trace import resolve_tracer
        from sunray_tpu.scene.types import identity_transform

        r = Renderer(CFG.replace(tracer="auto", brute_force_max_tris=4))
        base = cornell_box()
        mgr = SceneManager.from_scene_buffers(base)
        # Collapse to ONE instance of the largest mesh.
        key = max(mgr._meshes, key=lambda k: mgr._meshes[k].tri_vidx.shape[0])
        r._manager = mgr
        r._instances = [(key, identity_transform())] * 1
        r.scene = mgr.build(r._instances)
        accel = r._scene_accel()
        assert isinstance(accel, ClusterSet)
        assert resolve_tracer(r.config, r.scene) == "binned"
        # Cache key holds the live scene object: same scene -> same accel.
        assert r._scene_accel() is accel

    def test_auto_big_blas_overrides_bvh2(self):
        """Even a multi-instance scene goes binned when one mesh's BLAS
        would exceed bvh2_blas_max_tris (and resolve_tracer says so)."""
        from sunray_tpu.ops.binned_trace import ClusterSet
        from sunray_tpu.render.trace import resolve_tracer

        r = managed_renderer()
        r.config = r.config.replace(
            tracer="auto", brute_force_max_tris=4, bvh2_blas_max_tris=2
        )
        r._build_frame_fn()
        assert isinstance(r._scene_accel(), ClusterSet)
        assert resolve_tracer(r.config, r.scene) == "binned"
        # A generous BLAS cap flips the same scene to the two-level path.
        assert resolve_tracer(r.config.replace(bvh2_blas_max_tris=10**6),
                              r.scene) == "bvh2"

    def test_render_path_threads_heuristic(self):
        """Full frames with a moving instance: images stay finite and the
        heuristic chose a non-host op for the animated frame."""
        r = managed_renderer()
        img0 = np.asarray(r.render(CAM))
        assert np.isfinite(img0).all()
        assert r.last_accel_op == accel_state.SLOW_BUILD
        inst = nudged(list(r._instances), 0, 0.002)
        img1 = np.asarray(r.render(CAM, inst))
        assert np.isfinite(img1).all()
        assert r.last_accel_op == accel_state.UPDATE
