"""Test configuration: the CPU backend with 8 virtual devices unless
JAX_PLATFORMS says otherwise, so kernel (interpret mode) and sharding
tests run without a GPU (SURVEY.md section 4 test strategy). Must run
before jax initializes."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)


# Tests that cost >~25 s on CPU (full-pipeline compiles, FD gradient
# checks, SPMD lockstep runs — measured via --durations). The default run
# excludes them (pytest.ini addopts -m "not slow") to keep iteration
# <5 min; run everything with `pytest tests/ -m ""` (CI / pre-commit for
# render-path changes).
SLOW_TESTS = (
    "test_spmd.py::",                       # all SPMD lockstep runs
    "test_quality.py::",                    # converged-truth quality runs
    "test_sharding.py::TestDryrun",
    "test_antialias.py::test_occluder_silhouette_gradient",
    "test_antialias.py::test_camera_x_silhouette_gradient",
    "test_pipeline.py::TestMovingCamera::test_reprojection_under_motion",
    "test_pipeline.py::TestRestirMode::test_brighter_than_dark_scene",
    "test_pipeline.py::TestPerPixelSpatialTaps",
    "test_pipeline.py::TestRestirMode::test_renders_finite_nonblack",
    "test_golden.py::test_golden[cornell_restir]",
    "test_golden.py::test_golden[reflroom_glb]",
    "test_grads.py::TestCameraGrads::test_camera_position_fd",
    "test_grads.py::TestOcclusionBoundaryEnvelope",
    "test_grads.py::TestVertexGrads::test_light_height_fd",
    "test_grads.py::TestMaterialGrads::test_emission_strength_fd",
    "test_grads.py::TestMaterialGrads::test_base_color_fd",
    "test_bvh2.py::TestFrame::test_render_matches_brute_backend",
    "test_bvh2.py::TestAutoPicksTwoLevel::test_auto_render_matches_brute",
    "test_bvh.py::TestPipelineWithBvh::test_render_matches_brute",
    "test_gltf.py::TestSceneGroups::test_load_unload_scene_group",
    "test_gltf.py::TestReflectionRoom::test_renders",
    "test_binned_trace.py::TestFrameBinned::test_render_matches_brute_backend",
    "test_binned_trace.py::TestFrameBinned::test_refit_tracks_instance_motion",
    "test_scene_manager.py::TestRuntimeChurn::test_spawn_despawn",
    "test_viewer.py::test_live_viewer_http_roundtrip",
    "test_aux_subsystems.py::TestCheckpoint",
    "test_accel_heuristic.py::TestHeuristicWiring::test_render_path_threads_heuristic",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in item.nodeid for s in SLOW_TESTS):
            item.add_marker(pytest.mark.slow)
