"""Brute-force tracer tests: analytic hits, winding independence, occlusion,
and differentiable hit attributes."""

import numpy as np
import jax
import jax.numpy as jnp

from sunray_tpu.ops import intersect
from sunray_tpu.scene import cornell_box


def single_tri(v0, v1, v2):
    t = (
        jnp.asarray([v0], jnp.float32),
        jnp.asarray([v1], jnp.float32),
        jnp.asarray([v2], jnp.float32),
    )
    return t


class TestMollerTrumbore:
    def test_direct_hit(self):
        tris = single_tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.asarray([[0.25, 0.25, 1.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        h = intersect.trace_closest_brute(tris, o, d)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), 1.0, rtol=1e-5)
        np.testing.assert_allclose(float(h.u[0]), 0.25, rtol=1e-4)
        np.testing.assert_allclose(float(h.v[0]), 0.25, rtol=1e-4)

    def test_no_backface_culling(self):
        # Reference traces with RAY_FLAG_NONE -> both faces hit.
        tris = single_tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.asarray([[0.25, 0.25, -1.0]])
        d = jnp.asarray([[0.0, 0.0, 1.0]])
        h = intersect.trace_closest_brute(tris, o, d)
        assert bool(h.hit[0])

    def test_miss_outside(self):
        tris = single_tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.asarray([[0.9, 0.9, 1.0]])  # outside the hypotenuse
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        h = intersect.trace_closest_brute(tris, o, d)
        assert not bool(h.hit[0])

    def test_tmin_respected(self):
        tris = single_tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.asarray([[0.25, 0.25, 0.0005]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        h = intersect.trace_closest_brute(tris, o, d)  # t = 5e-4 < TMin=1e-3
        assert not bool(h.hit[0])

    def test_closest_of_two(self):
        tris = (
            jnp.asarray([[0, 0, 0], [0, 0, -2]], jnp.float32),
            jnp.asarray([[1, 0, 0], [1, 0, -2]], jnp.float32),
            jnp.asarray([[0, 1, 0], [0, 1, -2]], jnp.float32),
        )
        o = jnp.asarray([[0.25, 0.25, 1.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        h = intersect.trace_closest_brute(tris, o, d)
        assert int(h.tri[0]) == 0
        np.testing.assert_allclose(float(h.t[0]), 1.0, rtol=1e-5)

    def test_occlusion_segment(self):
        tris = single_tri([-1, -1, 0], [3, -1, 0], [0, 3, 0])
        o = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
        tmax = jnp.asarray([2.0, 0.5])  # second segment ends before the plane
        occ = intersect.trace_occluded_brute(tris, o, d, tmax)
        assert bool(occ[0]) and not bool(occ[1])

    def test_ray_block_padding(self):
        # N not a multiple of the block size must still work.
        tris = single_tri([-10, -10, 0], [10, -10, 0], [0, 10, 0])
        n = 37
        o = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
        d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
        h = intersect.trace_closest_brute(tris, o, d, block=16)
        assert bool(h.hit.all())
        np.testing.assert_allclose(np.asarray(h.t), 1.0, rtol=1e-5)


class TestHitAttributes:
    def test_matches_tracer(self):
        scene = cornell_box()
        tris = scene.world_triangle_vertices()
        o = jnp.asarray([[1.0, 1.0, 5.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        h = intersect.trace_closest_brute(tris, o, d)
        assert bool(h.hit[0])
        t, u, v = intersect.hit_attributes(tris, o, d, h.tri)
        np.testing.assert_allclose(float(t[0]), float(h.t[0]), rtol=1e-5)
        np.testing.assert_allclose(float(u[0]), float(h.u[0]), atol=1e-5)
        np.testing.assert_allclose(float(v[0]), float(h.v[0]), atol=1e-5)

    def test_gradient_wrt_origin(self):
        # d t / d origin_z for a ray hitting z=0 plane along -z is +1.
        tris = single_tri([-10, -10, 0], [10, -10, 0], [0, 10, 0])

        def t_of_oz(oz):
            o = jnp.asarray([[0.0, 0.0, oz]])
            d = jnp.asarray([[0.0, 0.0, -1.0]])
            t, _, _ = intersect.hit_attributes(tris, o, d, jnp.asarray([0]))
            return t[0]

        g = jax.grad(t_of_oz)(2.0)
        np.testing.assert_allclose(float(g), 1.0, rtol=1e-5)


class TestCornellGeometry:
    def test_all_center_rays_hit(self):
        scene = cornell_box()
        tris = scene.world_triangle_vertices()
        # Rays from the box center, excluding the open front (+z): all hit.
        g = np.random.default_rng(0)
        d = g.normal(size=(128, 3)).astype(np.float32)
        d[:, 2] = -np.abs(d[:, 2]) - 0.1
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.tile(np.array([[1.0, 1.0, 1.0]], np.float32), (128, 1))
        h = intersect.trace_closest_brute(tris, jnp.asarray(o), jnp.asarray(d))
        assert bool(h.hit.all())
        assert float(h.t.max()) < 4.0  # inside a 2^3 box

    def test_light_list(self):
        scene = cornell_box()
        assert scene.num_lights == 2  # light quad = 2 triangles
        lv, lrgb = scene.light_world_triangles()
        assert lv.shape == (2, 3, 3)
        np.testing.assert_allclose(np.asarray(lrgb), 15.0 * np.ones((2, 3)), rtol=1e-6)
        # light sits just below the ceiling
        assert np.allclose(np.asarray(lv)[..., 1], 1.99)
