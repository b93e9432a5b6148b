"""utils/struct: frozen dataclasses registered as pytrees (the replacement
for flax.struct), and the frame path's independence from flax."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.utils import struct


@struct.dataclass
class Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = struct.field(pytree_node=False, default=3)


def test_pytree_roundtrip():
    p = Pair(a=jnp.ones(2), b=jnp.zeros(3), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                      # n is metadata, not a leaf
    np.testing.assert_array_equal(leaves[0], np.ones(2))
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, Pair) and back.n == 5
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, p)
    np.testing.assert_array_equal(doubled.a, 2 * np.ones(2))
    assert doubled.n == 5


def test_replace_and_frozen():
    p = Pair(a=jnp.ones(2), b=jnp.zeros(3))
    q = p.replace(b=jnp.full(3, 7.0))
    np.testing.assert_array_equal(q.b, np.full(3, 7.0))
    np.testing.assert_array_equal(p.b, np.zeros(3))
    assert q.n == 3
    with pytest.raises(Exception):
        p.a = jnp.zeros(2)


def test_static_field_is_jit_static():
    """Metadata fields are part of the treedef: a new value retraces, and
    inside the trace it is a Python int."""
    seen = []

    @jax.jit
    def f(p):
        seen.append(p.n)
        return p.a * p.n

    np.testing.assert_array_equal(f(Pair(jnp.ones(2), jnp.ones(1), n=2)), 2)
    np.testing.assert_array_equal(f(Pair(jnp.ones(2), jnp.ones(1), n=4)), 4)
    assert seen == [2, 4]


def test_donation_under_jit():
    """Donated struct leaves are consumed (the RenderState update path)."""
    from sunray_tpu.config import TEST_CONFIG
    from sunray_tpu.render.pipeline import RenderState

    st = RenderState.create(TEST_CONFIG)
    step = jax.jit(lambda s: s.replace(frame_count=s.frame_count + 1),
                   donate_argnums=(0,))
    leaves = jax.tree_util.tree_leaves(st)
    out = step(st)
    assert int(out.frame_count) == 1
    assert isinstance(out, RenderState)
    assert all(x.is_deleted() for x in leaves)


def test_frame_imports_and_renders_without_flax():
    """render/pipeline imports and one CPU frame renders with flax made
    unimportable (sys.modules entry set to None)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import sys
        sys.modules["flax"] = None
        sys.modules["flax.struct"] = None
        import numpy as np
        import jax
        from sunray_tpu.camera import Camera, camera_matrices
        from sunray_tpu.config import RenderConfig
        from sunray_tpu.render.pipeline import RenderState, render_frame
        from sunray_tpu.scene import cornell_box
        cfg = RenderConfig(width=16, height=12, bounces=2,
                           virtual_bounces=1, ris_candidates=2,
                           di_spatial_samples=1, gi_spatial_samples=1,
                           denoise_passes=1)
        cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                     fov_y=45.0)
        st, ldr, _ = render_frame(cornell_box(), cfg, RenderState.create(cfg),
                                  camera_matrices(cam, 16, 12))
        assert np.isfinite(np.asarray(ldr)).all()
        assert "flax" not in {m.split(".")[0] for m, v in sys.modules.items()
                              if v is not None}
        print("ok")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=here)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=here,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
