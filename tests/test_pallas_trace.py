"""The Triton brute-force trace kernel (ops/pallas_trace.py) in interpret
mode against the jnp oracle (ops/intersect.py), and the dispatch that
chooses between them (render/trace.py).

The kernel evaluates the oracle's Moller-Trumbore arithmetic term for
term; there is no matrix product, so TF32 never enters. On the CPU the
interpreter and XLA round identically, so results agree exactly here; on
the card an FMA-contracted product may resolve an exact edge or t-tie
either way (chip_smoke.py phase 4 checks >= 99.99% agreement there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.config import RenderConfig
from sunray_tpu.ops import intersect, pallas_trace
from sunray_tpu.scene import cornell_box
from sunray_tpu.scene.procedural import triangle_soup


def _tris(n):
    base = [np.asarray(v) for v in cornell_box().world_triangle_vertices()]
    if n <= 36:
        return tuple(jnp.asarray(v[:n]) for v in base)
    soup = triangle_soup(n - 36, seed=n)
    return tuple(jnp.asarray(np.concatenate([b, s]))
                 for b, s in zip(base, soup))


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.05, 1.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


# Ray counts that are not a multiple of the block (masked tail lanes).
CASES = [(1, 37), (36, 300), (37, 129), (512, 70)]


@pytest.mark.parametrize("n_tris,n_rays", CASES)
@pytest.mark.parametrize("query", ["closest", "occluded"])
def test_kernel_matches_oracle(n_tris, n_rays, query):
    tris = _tris(n_tris)
    o, d = _rays(n_rays, seed=n_tris)
    rng = np.random.default_rng(1)
    tmin = jnp.asarray(rng.uniform(1e-3, 0.3, n_rays), jnp.float32)
    tmax = jnp.asarray(rng.uniform(0.5, 3.0, n_rays), jnp.float32)
    if query == "closest":
        ref = intersect.trace_closest_brute(tris, o, d, tmin, tmax, block=64)
        got = pallas_trace.trace_closest_pallas(tris, o, d, tmin, tmax,
                                                block=64, interpret=True)
        np.testing.assert_array_equal(np.asarray(got.hit),
                                      np.asarray(ref.hit))
        h = np.asarray(ref.hit)
        assert 0 < h.sum() or n_tris == 1
        np.testing.assert_array_equal(np.asarray(got.tri)[h],
                                      np.asarray(ref.tri)[h])
        for f in ("t", "u", "v"):
            np.testing.assert_allclose(np.asarray(getattr(got, f))[h],
                                       np.asarray(getattr(ref, f))[h],
                                       rtol=1e-5, atol=1e-6)
        assert np.all(np.isinf(np.asarray(got.t)[~h]))
    else:
        # Exclude each ray's own closest triangle (the shadow-ray target
        # convention) on half the rays, none (-1) on the rest.
        hit = intersect.trace_closest_brute(tris, o, d, tmin, 1e4, block=64)
        ex = jnp.where(jnp.arange(n_rays) % 2 == 0, hit.tri, -1)
        ref = intersect.trace_occluded_brute(tris, o, d, tmax, tmin,
                                             block=64, exclude=ex)
        got = pallas_trace.trace_occluded_pallas(tris, o, d, tmax, tmin,
                                                 exclude=ex, block=64,
                                                 interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        ref0 = intersect.trace_occluded_brute(tris, o, d, tmax, tmin,
                                              block=64)
        got0 = pallas_trace.trace_occluded_pallas(tris, o, d, tmax, tmin,
                                                  block=64, interpret=True)
        np.testing.assert_array_equal(np.asarray(got0), np.asarray(ref0))


@pytest.mark.parametrize("block", [32, 256])
def test_scalar_bounds_and_block_size(block):
    """Scalar tmin/tmax broadcast like the oracle's; the result does not
    depend on the ray block size."""
    tris = _tris(36)
    o, d = _rays(200, seed=3)
    ref = intersect.trace_closest_brute(tris, o, d)
    got = pallas_trace.trace_closest_pallas(tris, o, d, block=block,
                                            interpret=True)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-6)


def test_tri_table_layout():
    """(9, T) SoA rows: v0 | e1 = v1 - v0 | e2 = v2 - v0."""
    tris = _tris(37)
    tab = np.asarray(pallas_trace.tri_table(tris))
    v0, v1, v2 = (np.asarray(v) for v in tris)
    assert tab.shape == (9, 37) and tab.dtype == np.float32
    np.testing.assert_array_equal(tab[0:3], v0.T)
    np.testing.assert_allclose(tab[3:6], (v1 - v0).T)
    np.testing.assert_allclose(tab[6:9], (v2 - v0).T)


def _lowered(query, platform):
    """HLO text of one brute closest or occlusion query through the
    frame's dispatch (render/trace.py), lowered for `platform`."""
    from sunray_tpu.render import trace

    scene = cornell_box()
    o, d = _rays(64)

    def f(o, d):
        ctx = trace.make_tracer(scene, RenderConfig())
        if query == "closest":
            return trace.trace_closest(ctx, o, d).t
        return trace.trace_occluded(ctx, o, d, jnp.full((64,), 2.0))

    return jax.jit(f).trace(o, d).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("query,platform,has_kernel", [
    ("closest", "cuda", True),
    ("closest", "cpu", False),
    ("occluded", "cuda", True),
    ("occluded", "cpu", False),
])
def test_dispatch_choice(query, platform, has_kernel):
    """Each brute query is the Triton kernel in programs compiled for
    CUDA and the jnp planes elsewhere."""
    txt = _lowered(query, platform)
    assert ("triton" in txt) == has_kernel


def test_auto_renders_on_cpu():
    """The default dispatch compiles and runs on the CPU (jnp planes)."""
    from sunray_tpu.render import trace

    scene = cornell_box()
    o, d = _rays(50)
    ctx = trace.make_tracer(scene, RenderConfig())
    got = jax.jit(lambda o, d: trace.trace_closest(ctx, o, d))(o, d)
    ref = intersect.trace_closest_brute(scene.world_triangle_vertices(), o, d)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
