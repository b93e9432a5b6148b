"""Binned (cluster-culled) tracer: correctness vs the brute reference and
the conservativeness property of the interval cull."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.ops import binned_trace as bt
from sunray_tpu.ops import intersect


def random_scene(t, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    v0 = base
    v1 = base + rng.uniform(-0.4, 0.4, (t, 3)).astype(np.float32)
    v2 = base + rng.uniform(-0.4, 0.4, (t, 3)).astype(np.float32)
    return jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2)


def random_rays(n, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    orig = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(orig), jnp.asarray(d)


def camera_rays(n, seed=2):
    """Coherent common-origin fan (primary-ray-like blocks)."""
    rng = np.random.default_rng(seed)
    orig = np.broadcast_to(np.array([0.0, 0.0, 8.0], np.float32), (n, 3))
    px = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d = np.concatenate([px, np.full((n, 1), -2.0, np.float32)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(orig.copy()), jnp.asarray(d)


def assert_hits_match(a: intersect.Hit, b: intersect.Hit, v0v1v2=None):
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    m = np.asarray(a.hit)
    np.testing.assert_allclose(
        np.asarray(a.t)[m], np.asarray(b.t)[m], rtol=1e-5, atol=1e-6
    )
    # Different tie-breaks can pick different coplanar triangles; demand
    # equal t (above) and that ids mostly agree.
    agree = (np.asarray(a.tri)[m] == np.asarray(b.tri)[m]).mean() if m.any() else 1.0
    assert agree > 0.99


class TestClusterBuild:
    def test_pack_roundtrip(self):
        tris = random_scene(300, seed=3)
        cs = bt.build_cluster_set(tris, k=128)
        assert cs.tri_pack.shape == (3, 16, 128)
        ids = jax.lax.bitcast_convert_type(
            cs.tri_pack[:, 9, :], jnp.int32
        ).reshape(-1)
        ids = np.asarray(ids)
        real = ids[ids >= 0]
        assert sorted(real.tolist()) == list(range(300))
        # AABBs contain their triangles.
        v0, v1, v2 = (np.asarray(v) for v in tris)
        pack = np.asarray(cs.tri_pack)
        for c in range(3):
            lo = np.asarray(cs.aabb_lo)[c]
            hi = np.asarray(cs.aabb_hi)[c]
            pts = pack[c, 0:9, :].T.reshape(-1, 3)
            assert (pts >= lo - 1e-5).all() and (pts <= hi + 1e-5).all()


class TestIntervalCullConservative:
    @pytest.mark.parametrize("rays", ["random", "camera"])
    def test_no_true_hit_culled(self, rays):
        tris = random_scene(600, seed=5)
        cs = bt.build_cluster_set(tris, k=64)
        n = 1024
        orig, d = random_rays(n, seed=7) if rays == "random" else camera_rays(n)

        nb = n // bt.BLOCK_RAYS
        o_t = orig.T
        d_t = d.T
        tn = jnp.zeros((1, n)) + 1e-3
        tx = jnp.full((1, n), 1e5)
        hit, entry = bt._interval_cull(o_t, d_t, tn, tx, cs.aabb_lo,
                                       cs.aabb_hi, nb, bt.BLOCK_RAYS)
        hit = np.asarray(hit)

        # Ground truth: per-ray slab tests.
        o = np.asarray(orig)
        dd = np.asarray(d)
        inv = np.where(np.abs(dd) > 1e-12, 1.0 / dd, 1e12)
        lo = np.asarray(cs.aabb_lo)
        hi = np.asarray(cs.aabb_hi)
        t1 = (lo[None] - o[:, None]) * inv[:, None]          # (N, C, 3)
        t2 = (hi[None] - o[:, None]) * inv[:, None]
        tnear = np.minimum(t1, t2).max(axis=-1)
        tfar = np.maximum(t1, t2).min(axis=-1)
        ray_hit = (tnear <= tfar) & (tfar >= 1e-3) & (tnear <= 1e5)
        block_truth = ray_hit.reshape(nb, bt.BLOCK_RAYS, -1).any(axis=1)

        # Conservative: everything truly hit must be included.
        assert not (block_truth & ~hit).any()

        # Entry soundness: the reported entry lower-bounds every hitting
        # ray's AABB entry t (the early-termination invariant).
        ent = np.asarray(entry).reshape(nb, 1, -1)
        viol = ray_hit.reshape(nb, bt.BLOCK_RAYS, -1) & (
            tnear.reshape(nb, bt.BLOCK_RAYS, -1) < ent - 1e-4
        )
        assert not viol.any()

    def test_culls_something(self):
        tris = random_scene(600, seed=5)
        cs = bt.build_cluster_set(tris, k=64)
        # Degenerate block (all rays identical): the interval test reduces
        # to that ray's exact slab test, so a ray grazing one edge of the
        # scene must cull the clusters it cannot touch.
        n = 1024
        orig = np.broadcast_to(
            np.array([20.0, 3.5, 3.5], np.float32), (n, 3)
        ).copy()
        d = np.broadcast_to(
            np.array([-1.0, 0.0, 0.0], np.float32), (n, 3)
        ).copy()
        orig, d = jnp.asarray(orig), jnp.asarray(d)
        hit, _ = bt._interval_cull(
            orig.T, d.T, jnp.zeros((1, n)) + 1e-3, jnp.full((1, n), 1e5),
            cs.aabb_lo, cs.aabb_hi, n // bt.BLOCK_RAYS, bt.BLOCK_RAYS,
        )
        assert np.asarray(hit).mean() < 0.9  # narrow coherent fans cull


class TestClosest:
    @pytest.mark.parametrize("rays", ["random", "camera"])
    def test_matches_brute(self, rays):
        tris = random_scene(500, seed=11)
        cs = bt.build_cluster_set(tris, k=64)
        n = 700   # non-multiple of BLOCK_RAYS exercises padding
        orig, d = random_rays(n, seed=13) if rays == "random" else camera_rays(n)

        ref = intersect.trace_closest_brute(tris, orig, d)
        out = trace = bt.trace_closest_binned(cs, orig, d)
        assert_hits_match(out, ref)

    def test_multiple_rounds(self):
        tris = random_scene(400, seed=17)
        cs = bt.build_cluster_set(tris, k=32)
        orig, d = random_rays(1500, seed=19)
        ref = intersect.trace_closest_brute(tris, orig, d)
        out = bt.trace_closest_binned(cs, orig, d, work_chunk=16)
        assert_hits_match(out, ref)

    def test_tmax_and_exclude(self):
        tris = random_scene(200, seed=23)
        cs = bt.build_cluster_set(tris, k=64)
        orig, d = random_rays(256, seed=29)
        ref = intersect.trace_closest_brute(tris, orig, d)
        # Excluding each ray's own winner must change the result there.
        out = bt.trace_closest_binned(
            cs, orig, d, exclude=jnp.where(ref.hit, ref.tri, -2)
        )
        m = np.asarray(ref.hit)
        assert (np.asarray(out.tri)[m] != np.asarray(ref.tri)[m]).all() or (
            ~np.asarray(out.hit)[m]
        ).any()
        # tmax cut: nothing reported beyond it.
        tmax = jnp.full((256,), 2.0)
        out2 = bt.trace_occluded_binned(cs, orig, d, tmax)
        truth = np.asarray(ref.hit) & (np.asarray(ref.t) <= 2.0)
        got = np.asarray(out2)
        # occluded uses any-hit semantics == closest-hit-below-tmax here
        np.testing.assert_array_equal(got, truth)

    def test_empty_and_single_cluster(self):
        tris = random_scene(40, seed=31)
        cs = bt.build_cluster_set(tris, k=128)
        assert cs.num_clusters == 1
        orig, d = random_rays(128, seed=37)
        ref = intersect.trace_closest_brute(tris, orig, d)
        out = bt.trace_closest_binned(cs, orig, d)
        assert_hits_match(out, ref)

        # Rays aimed away from everything: no work at all (nnz may be 0).
        far_o = orig + jnp.asarray([0.0, 0.0, 1e6])
        out2 = bt.trace_closest_binned(cs, far_o, d)
        assert not np.asarray(out2.hit).any()
        assert np.isinf(np.asarray(out2.t)).all()


class TestFrameBinned:
    """tracer="binned" as a frame-level drop-in (mirrors test_bvh2.TestFrame)."""

    def _cfg(self, **kw):
        from sunray_tpu.config import RenderConfig

        return RenderConfig(
            width=48, height=32, lighting="nee", bounces=2, virtual_bounces=2,
            denoise_passes=1, **kw,
        )

    def test_render_matches_brute_backend(self):
        from sunray_tpu.camera import Camera
        from sunray_tpu.render.renderer import Renderer
        from tests.test_bvh2 import multi_instance_scene

        cam = Camera(position=(0.0, 1.0, 5.0), target=(0.0, 0.3, 0.0),
                     fov_y=50.0)
        mgr, scene, instances = multi_instance_scene()

        r_brute = Renderer(self._cfg(tracer="brute"))
        r_brute.load_scene(scene)
        r_brute._manager = mgr
        a = np.asarray(r_brute.render(cam))

        rb = Renderer(self._cfg(tracer="binned", cluster_k=32))
        rb.load_scene(scene)
        rb._manager = mgr
        assert isinstance(rb._scene_accel(), bt.ClusterSet)
        b = np.asarray(rb.render(cam))

        assert np.isfinite(b).all()
        match = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
        assert match.mean() > 0.99

    def test_refit_tracks_instance_motion(self):
        """The cached cluster ASSIGNMENT survives instance motion; the
        in-jit refit keeps results exact (matches brute on the moved
        scene)."""
        from sunray_tpu.camera import Camera
        from sunray_tpu.render.renderer import Renderer
        from tests.test_bvh2 import compose, multi_instance_scene, translate

        cam = Camera(position=(0.0, 1.0, 5.0), target=(0.0, 0.3, 0.0),
                     fov_y=50.0)
        mgr, scene, instances = multi_instance_scene()
        rb = Renderer(self._cfg(tracer="binned", cluster_k=32))
        rb.load_scene(scene)
        rb._manager = mgr
        rb._instances = instances
        rb.render(cam)
        accel1 = rb._accel
        assert accel1 is not None

        moved = [(k, compose(translate(0.4, 0.0, 0.0), t))
                 for k, t in instances]
        b = np.asarray(rb.render(cam, instances=moved))

        r_brute = Renderer(self._cfg(tracer="brute"))
        r_brute.load_scene(scene)
        r_brute._manager = mgr
        r_brute._instances = instances
        r_brute.render(cam)
        a = np.asarray(r_brute.render(cam, instances=moved))

        assert np.isfinite(b).all()
        match = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
        assert match.mean() > 0.99


class TestStress:
    def test_icosphere_matches_bvh(self):
        """Bigger mesh, cross-validated against the BVH walk (a different
        oracle than brute)."""
        from examples.bench_instances import icosphere
        from sunray_tpu.ops import bvh as bvh_mod

        verts, faces = icosphere(3)   # 1280 tris
        v0 = jnp.asarray(verts[faces[:, 0]])
        v1 = jnp.asarray(verts[faces[:, 1]])
        v2 = jnp.asarray(verts[faces[:, 2]])
        tris = (v0, v1, v2)
        cs = bt.build_cluster_set(tris, k=128)
        orig, d = random_rays(800, seed=43, spread=2.5)

        bvh = bvh_mod.build_bvh(tris, leaf_size=4)
        ref = bvh_mod.trace_closest_bvh(bvh, tris, orig, d, block=256)
        out = bt.trace_closest_binned(cs, orig, d)
        assert_hits_match(out, ref)

    def test_origins_inside_clusters(self):
        """Rays starting inside geometry (negative AABB entry t) must not
        be early-terminated away."""
        tris = random_scene(400, seed=47, spread=1.0)
        cs = bt.build_cluster_set(tris, k=64)
        rng = np.random.default_rng(53)
        orig = jnp.asarray(rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32))
        d = rng.normal(size=(512, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = jnp.asarray(d)
        ref = intersect.trace_closest_brute(tris, orig, d)
        out = bt.trace_closest_binned(cs, orig, d)
        assert_hits_match(out, ref)

    def test_infinite_tmax(self):
        """tmax=+inf must not NaN the reachability cull (regression)."""
        tris = random_scene(200, seed=59)
        cs = bt.build_cluster_set(tris, k=64)
        orig, d = random_rays(256, seed=61)
        ref = intersect.trace_closest_brute(tris, orig, d, tmax=1e30)
        out = bt.trace_closest_binned(cs, orig, d, tmax=jnp.inf)
        np.testing.assert_array_equal(np.asarray(out.hit), np.asarray(ref.hit))


class TestReorder:
    """Coherence-reorder path (incoherent bounce/GI batches): results must
    be lane-exact vs the unordered path; the keys must group octants."""

    def test_closest_reorder_matches(self):
        tris = random_scene(500, seed=31)
        cs = bt.build_cluster_set(tris, k=64)
        orig, d = random_rays(700, seed=37)
        ref = bt.trace_closest_binned(cs, orig, d)
        out = bt.trace_closest_binned(cs, orig, d, reorder=True)
        np.testing.assert_array_equal(np.asarray(out.hit), np.asarray(ref.hit))
        m = np.asarray(ref.hit)
        np.testing.assert_allclose(np.asarray(out.t)[m], np.asarray(ref.t)[m],
                                   rtol=1e-6, atol=1e-7)

    def test_occluded_reorder_matches(self):
        tris = random_scene(300, seed=41)
        cs = bt.build_cluster_set(tris, k=64)
        orig, d = random_rays(600, seed=43)
        tmax = jnp.full((600,), 3.0)
        ref = bt.trace_occluded_binned(cs, orig, d, tmax)
        out = bt.trace_occluded_binned(cs, orig, d, tmax, reorder=True)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_reorder_with_exclude(self):
        tris = random_scene(200, seed=47)
        cs = bt.build_cluster_set(tris, k=64)
        orig, d = random_rays(256, seed=53)
        first = bt.trace_closest_binned(cs, orig, d)
        ex = jnp.where(first.hit, first.tri, -2)
        ref = bt.trace_closest_binned(cs, orig, d, exclude=ex)
        out = bt.trace_closest_binned(cs, orig, d, exclude=ex, reorder=True)
        np.testing.assert_array_equal(np.asarray(out.hit), np.asarray(ref.hit))
        m = np.asarray(ref.hit)
        np.testing.assert_allclose(np.asarray(out.t)[m], np.asarray(ref.t)[m],
                                   rtol=1e-6, atol=1e-7)

    def test_keys_group_octants(self):
        orig, d = random_rays(512, seed=59)
        lo = jnp.full((3,), -6.0)
        hi = jnp.full((3,), 6.0)
        keys = np.asarray(bt._coherence_keys(orig, d, lo, hi))
        octant = keys >> 27
        dn = np.asarray(d)
        want = (dn[:, 0] >= 0) * 4 + (dn[:, 1] >= 0) * 2 + (dn[:, 2] >= 0)
        np.testing.assert_array_equal(octant, want)
        # Sorting by key must sort octants into contiguous runs.
        srt = octant[np.argsort(keys)]
        assert (np.diff(srt) >= 0).all()


class TestPairStream:
    """Pair-stream tracing (per-ray cluster scan + pair work list): exact
    vs the brute oracle, including overflow rays (center rays crossing
    many superclusters ride the block-path fallback)."""

    def _scene(self):
        rng = np.random.default_rng(0)
        t = 2000
        v0 = jnp.asarray(rng.normal(size=(t, 3)).astype(np.float32))
        v1 = v0 + 0.3 * jnp.asarray(rng.normal(size=(t, 3)).astype(np.float32))
        v2 = v0 + 0.3 * jnp.asarray(rng.normal(size=(t, 3)).astype(np.float32))
        return (v0, v1, v2), bt.build_cluster_set(
            (v0, v1, v2), k=128)

    def _rays(self, n=2048, center=False, seed=1):
        rng = np.random.default_rng(seed)
        scale = 0.1 if center else 2.0
        o = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)) * scale
        d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        tmax = jnp.abs(
            jnp.asarray(rng.normal(size=(n,)).astype(np.float32))) * 4 + 0.5
        ex = jnp.asarray(rng.integers(-1, 2000, size=n).astype(np.int32))
        return o, d, tmax, ex

    @pytest.mark.parametrize("center", [False, True])
    def test_closest_matches_brute(self, center):
        tris, cs = self._scene()
        o, d, tmax, _ = self._rays(center=center)
        ref = intersect.trace_closest_brute(tris, o, d, tmax=tmax)
        got = bt.trace_closest_pairs(cs, o, d, tmax=tmax)
        np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(got.hit))
        m = np.asarray(ref.hit)
        np.testing.assert_array_equal(np.asarray(ref.tri)[m],
                                      np.asarray(got.tri)[m])
        np.testing.assert_allclose(np.asarray(ref.t)[m],
                                   np.asarray(got.t)[m], rtol=1e-5, atol=1e-5)

    def test_occluded_matches_brute_with_exclude(self):
        tris, cs = self._scene()
        o, d, tmax, ex = self._rays()
        ref = intersect.trace_occluded_brute(tris, o, d, tmax, exclude=ex)
        got = bt.trace_occluded_pairs(cs, o, d, tmax, exclude=ex)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


class TestRoundBody:
    """The jnp round body (gather each work item's ray block and cluster,
    Moller-Trumbore, segment-reduce into ray blocks) with EVERY
    (block, cluster) pair as work equals brute force: same hits and
    triangles, t to float rounding."""

    @pytest.mark.parametrize("closest", [True, False])
    def test_all_pairs_round_matches_brute(self, closest):
        tris = random_scene(300, seed=5)
        cs = bt.build_cluster_set(tris, k=128)
        orig, d = random_rays(700, seed=6)
        tmax = jnp.full((700,), 5.0)
        ex = jnp.full((700,), -1, jnp.int32)
        o_t, d_t, tn, tx, ex_t, n, nb = bt._prep(
            orig, d, intersect.T_MIN, tmax if not closest else 1e4, ex)
        c = cs.num_clusters
        pairs = jnp.arange(nb * c, dtype=jnp.int32)
        n_out = bt._OUT_SPECS_CLOSEST if closest else bt._OUT_SPECS_ANYHIT
        outs = bt._round_call(n_out, pairs // c, pairs % c, o_t, d_t, tn,
                              tx, ex_t, cs.tri_pack, nb)
        assert np.all(np.asarray(outs[-1]) == 1.0)      # every block touched
        if closest:
            ref = intersect.trace_closest_brute(tris, orig, d)
            t, tri = np.asarray(outs[0][0, :n]), np.asarray(outs[1][0, :n])
            np.testing.assert_array_equal(tri >= 0, np.asarray(ref.hit))
            h = np.asarray(ref.hit)
            np.testing.assert_array_equal(tri[h], np.asarray(ref.tri)[h])
            np.testing.assert_allclose(t[h], np.asarray(ref.t)[h], rtol=1e-6)
        else:
            ref = intersect.trace_occluded_brute(tris, orig, d, tmax)
            np.testing.assert_array_equal(np.asarray(outs[0][0, :n]) > 0,
                                          np.asarray(ref))

    def test_scan_records_first_hits_in_order(self):
        """_scan_rays: slots hold each ray's first hit ids ascending, and
        the count is exact (checked against a per-ray numpy slab test)."""
        rng = np.random.default_rng(9)
        lo = rng.uniform(-3, 2, (40, 3)).astype(np.float32)
        ab = np.concatenate([lo, lo + rng.uniform(0.2, 1.5, (40, 3))],
                            axis=1).astype(np.float32)
        o, d = (np.asarray(x) for x in random_rays(64, seed=10, spread=3.0))
        ray = np.concatenate([o, d, np.full((64, 1), 1e-3, np.float32),
                              np.full((64, 1), 50.0, np.float32)], axis=1)
        slots, cnt = bt._scan_rays(jnp.asarray(ray), jnp.asarray(ab), 40, 4)
        slots, cnt = np.asarray(slots), np.asarray(cnt)
        for r in range(64):
            inv = 1.0 / np.where(np.abs(d[r]) < 1e-12, 1e-12, d[r])
            t1 = (ab[:, :3] - o[r]) * inv
            t2 = (ab[:, 3:] - o[r]) * inv
            tn_ = np.minimum(t1, t2).max(axis=1)
            tf_ = np.maximum(t1, t2).min(axis=1)
            hit = np.nonzero((tn_ <= tf_ + 1e-4) & (tf_ >= 1e-3 - 1e-4)
                             & (tn_ <= 50.0 + 1e-4))[0]
            assert cnt[r] == hit.size
            want = list(hit[:4]) + [-1] * (4 - min(4, hit.size))
            assert list(slots[r]) == want
