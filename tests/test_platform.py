"""Bring-up plumbing: the compile-cache location, the no-GPU exits of
bench.py and chip_smoke.py, and the card-only checks (marked `gpu`)."""

import os
import subprocess
import sys

import pytest

from sunray_tpu.utils import compile_cache

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_env_unset(monkeypatch):
    import jax

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(HERE, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper configures nothing."""
    import jax

    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def _run(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_no_gpu_exits_nonzero(script):
    """Without a GPU both entry scripts fail and print no result line."""
    out = _run([script])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout and '"metric"' not in out.stdout


@pytest.fixture
def gpu():
    """The card, or a skip: decided here, at run time, never at import."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these checks "
                    "on the card)")
    return devs[0]


@pytest.mark.gpu
def test_compiled_trace_kernel_matches_oracle(gpu):
    """The Triton kernel as compiled for the card (no interpreter) against
    the jnp oracle at 1080p ray counts (chip_smoke.py phase 4)."""
    import jax

    import chip_smoke

    chip_smoke.phase_trace_kernel(jax)
