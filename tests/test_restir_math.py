"""ReSTIR reservoir math unit tests vs hand-computed expectations
(rt_utils.slang:244-274 merge semantics, ray_gen_ris.slang:189-231 RIS)."""

import numpy as np
import pytest
import jax.numpy as jnp

from sunray_tpu.render import restir
from sunray_tpu.ops.brdf import eval_unshadowed_light, luminance_max
from sunray_tpu.scene import cornell_box


def mk_di(p=1, **kw):
    r = restir.ReservoirDI.empty(p)
    return r.replace(**{k: jnp.asarray(v) for k, v in kw.items()})


class TestMergeDI:
    def test_accumulates_w_sum_and_M(self):
        r = mk_di(w_sum=[1.0], M=[2.0])
        new = mk_di(M=[3.0], W=[0.5], light_idx=np.asarray([7], np.int32),
                    light_pos=[[1.0, 2.0, 3.0]])
        p_hat = jnp.asarray([2.0])
        # weight = p_hat * W * M = 2*0.5*3 = 3; w_sum' = 4; M' = 5
        out = restir.merge_di(r, new, p_hat, jnp.asarray([0.9]),
                              jnp.asarray([True]))
        assert float(out.w_sum[0]) == 4.0
        assert float(out.M[0]) == 5.0
        # take iff u < weight/w_sum' = 3/4; u=0.9 -> keep old candidate
        assert int(out.light_idx[0]) == 0

    def test_takes_candidate_when_u_small(self):
        r = mk_di(w_sum=[1.0], M=[2.0])
        new = mk_di(M=[3.0], W=[0.5], light_idx=np.asarray([7], np.int32),
                    light_pos=[[1.0, 2.0, 3.0]])
        out = restir.merge_di(r, new, jnp.asarray([2.0]), jnp.asarray([0.5]),
                              jnp.asarray([True]))
        assert int(out.light_idx[0]) == 7
        np.testing.assert_allclose(np.asarray(out.light_pos[0]), [1, 2, 3])

    def test_disabled_lane_unchanged(self):
        r = mk_di(w_sum=[1.0], M=[2.0])
        new = mk_di(M=[3.0], W=[0.5])
        out = restir.merge_di(r, new, jnp.asarray([2.0]), jnp.asarray([0.0]),
                              jnp.asarray([False]))
        assert float(out.w_sum[0]) == 1.0
        assert float(out.M[0]) == 2.0


class TestMergeGI:
    def test_jacobian_scales_weight(self):
        r = restir.ReservoirGI.empty(1)
        new = restir.ReservoirGI.empty(1).replace(
            M=jnp.asarray([2.0]), W=jnp.asarray([1.0]),
            sample_pos=jnp.asarray([[5.0, 0.0, 0.0]]),
        )
        out = restir.merge_gi(r, new, jnp.asarray([3.0]), jnp.asarray([0.5]),
                              jnp.asarray([0.1]), jnp.asarray([True]))
        # weight = p_hat*W*M*jac = 3*1*2*0.5 = 3
        assert float(out.w_sum[0]) == 3.0
        np.testing.assert_allclose(np.asarray(out.sample_pos[0]), [5, 0, 0])


class TestRisAudition:
    def test_unbiased_weight_scale(self):
        """W ~ w_sum / (M * p_hat(winner)); with one light, p_y fixed, all
        candidates identical -> W == 1/p_hat_winner * (p_hat/p_y)/p_hat =
        1/p_y scaled... sanity: W * p_hat ~ average unshadowed estimate."""
        scene = cornell_box()
        lights = restir.Lights(scene)
        p = 256
        import jax
        from sunray_tpu.ops import rng as rng_mod

        pos = jnp.tile(jnp.asarray([[1.0, 0.0, 1.0]]), (p, 1))
        nrm = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (p, 1))
        vv = jnp.tile(jnp.asarray([[0.0, 0.7, 0.7]]), (p, 1))
        alb = jnp.full((p, 3), 0.7)
        rough = jnp.ones(p)
        metal = jnp.zeros(p)
        seed = rng_mod.init_seed(jnp.arange(p, dtype=jnp.uint32), 1)
        _, r = restir.ris_audition(
            lights, seed, pos, nrm, vv, alb, rough, metal, 16,
            jnp.ones(p, bool),
        )
        # Reference estimator: E[p_hat(winner) * W] ~ integral of unshadowed
        # direct light; compare against dense-area Monte Carlo.
        ph, _ = lights.eval_p_hat(
            r.light_idx, r.light_pos, r.light_normal,
            pos, nrm, vv, alb, rough, metal,
        )
        ris_estimate = float(jnp.mean(ph * r.W))

        g = np.random.default_rng(0)
        n = 20000
        u1 = g.uniform(size=n).astype(np.float32)
        u2 = g.uniform(size=n).astype(np.float32)
        li = g.integers(0, lights.num, n)
        lp, ln, le, area = lights.sample_point(
            jnp.asarray(li, jnp.int32), jnp.asarray(u1), jnp.asarray(u2)
        )
        f = eval_unshadowed_light(
            jnp.tile(pos[:1], (n, 1)), jnp.tile(nrm[:1], (n, 1)),
            jnp.tile(vv[:1], (n, 1)), jnp.tile(alb[:1], (n, 1)),
            jnp.ones(n), jnp.zeros(n), le, lp, ln,
        )
        phat_mc = luminance_max(f)
        pdf = 1.0 / (lights.num * area)
        mc = float(jnp.mean(phat_mc / pdf))
        assert ris_estimate > 0.0
        np.testing.assert_allclose(ris_estimate, mc, rtol=0.15)


class TestBatchedAuditionExact:
    """The (P, K)-batched audition must be BIT-exact with the K-round
    sequential reference (same draws via the closed-form LCG chain, same
    op order per candidate, same reservoir take chain)."""

    def _attrs(self, p, seed=0):
        rng = np.random.default_rng(seed)
        pos = jnp.asarray(rng.uniform(0, 2, (p, 3)), jnp.float32)
        n = rng.normal(size=(p, 3))
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        v = rng.normal(size=(p, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return (
            pos, jnp.asarray(n, jnp.float32), jnp.asarray(v, jnp.float32),
            jnp.asarray(rng.uniform(0, 1, (p, 3)), jnp.float32),
            jnp.asarray(rng.uniform(0.05, 1, (p,)), jnp.float32),
            jnp.asarray(rng.uniform(0, 1, (p,)), jnp.float32),
        )

    @pytest.mark.parametrize("k", [1, 4, 16])
    def test_bit_exact_vs_sequential(self, k):
        p = 4096
        scene = cornell_box()
        lights = restir.Lights(scene)
        pos, n, v, alb, rough, metal = self._attrs(p)
        seed0 = jnp.asarray(
            np.random.default_rng(7).integers(0, 2**32, p, dtype=np.uint32)
        )
        enable = jnp.asarray(
            np.random.default_rng(8).random(p) > 0.2
        )
        s_a, r_a = restir.ris_audition(
            lights, seed0, pos, n, v, alb, rough, metal, k, enable
        )
        s_b, r_b = restir._ris_audition_sequential(
            lights, seed0, pos, n, v, alb, rough, metal, k, enable
        )
        np.testing.assert_array_equal(np.asarray(s_a), np.asarray(s_b))
        for name in ("w_sum", "M", "W", "light_idx"):
            np.testing.assert_array_equal(
                np.asarray(getattr(r_a, name)),
                np.asarray(getattr(r_b, name)),
                err_msg=name,
            )
        for name in ("light_pos", "light_normal"):
            np.testing.assert_array_equal(
                np.asarray(getattr(r_a, name)),
                np.asarray(getattr(r_b, name)),
                err_msg=name,
            )


class TestJointTemporalGather:
    """gather_temporal_histories (cfg.history_joint_gather): ONE packed
    banded gather for both temporal histories must reproduce, leaf for
    leaf, the plain per-reservoir gathers at the same shared jittered
    reprojection (the pack/split index wrangling is the bug surface)."""

    def test_matches_separate_plain_gathers(self):
        import jax
        from sunray_tpu.config import RenderConfig
        from sunray_tpu.ops import rng as rng_mod

        w, h = 12, 8
        p = w * h
        rs = np.random.default_rng(3)

        def rand_like(r):
            leaves, td = jax.tree_util.tree_flatten(r)
            out = []
            for x in leaves:
                x = np.asarray(x)
                if np.issubdtype(x.dtype, np.integer):
                    out.append(jnp.asarray(
                        rs.integers(0, 100, size=x.shape).astype(x.dtype)))
                else:
                    out.append(jnp.asarray(
                        rs.normal(size=x.shape).astype(x.dtype)))
            return jax.tree_util.tree_unflatten(td, out)

        hist_di = rand_like(restir.ReservoirDI.empty(p))
        hist_gi = rand_like(restir.ReservoirGI.empty(p))
        prev_uv = jnp.asarray(rs.uniform(-0.2, 1.2, (p, 2)).astype(np.float32))
        prev_valid = jnp.asarray(rs.random(p) > 0.2)
        enable = jnp.asarray(rs.random(p) > 0.3)
        frame_count = jnp.asarray(5, jnp.int32)
        cfg = RenderConfig(width=w, height=h, history_joint_gather=True)

        seed0 = rng_mod.init_seed(jnp.uint32(123), jnp.uint32(7))
        seed_out, h_di, h_gi, base_ok = restir.gather_temporal_histories(
            cfg, seed0, hist_di, hist_gi, prev_uv, prev_valid, frame_count,
            enable, w, h)

        # Oracle: replicate the one shared jitter draw + plain gathers.
        seed1, j1, j2 = rng_mod.rnd2(seed0)
        np.testing.assert_array_equal(np.asarray(seed_out),
                                      np.asarray(seed1))
        px = np.floor(np.asarray(prev_uv[:, 0]) * w
                      + (np.asarray(j1) - 0.5)).astype(np.int32)
        py = np.floor(np.asarray(prev_uv[:, 1]) * h
                      + (np.asarray(j2) - 0.5)).astype(np.int32)
        in_bounds = (px >= 0) & (py >= 0) & (px < w) & (py < h)
        exp_ok = np.asarray(prev_valid) & in_bounds
        pi = np.clip(py * w + px, 0, p - 1)
        np.testing.assert_array_equal(np.asarray(base_ok), exp_ok)
        for hist, got in ((hist_di, h_di), (hist_gi, h_gi)):
            exp_leaves, _ = jax.tree_util.tree_flatten(
                jax.tree_util.tree_map(lambda x: x[pi], hist))
            got_leaves, _ = jax.tree_util.tree_flatten(got)
            # w_sum (leaf 1) is zeroed by contract, never read downstream.
            exp_leaves[1] = np.zeros_like(np.asarray(exp_leaves[1]))
            for e, g in zip(exp_leaves, got_leaves):
                np.testing.assert_array_equal(np.asarray(e), np.asarray(g))

    def test_frame_finite_with_joint_gather(self):
        from sunray_tpu.camera import Camera
        from sunray_tpu.config import RenderConfig
        from sunray_tpu.render.renderer import Renderer

        cfg = RenderConfig(width=32, height=24, lighting="restir",
                           history_joint_gather=True)
        r = Renderer(cfg)
        r.load_scene(cornell_box())
        cam = Camera(position=(1.0, 1.3, 3.6), target=(1.0, 1.0, 1.0),
                     fov_y=50.0)
        img = None
        for _ in range(3):
            img = np.asarray(r.render(cam))
        assert np.isfinite(img).all()
        assert img.max() > 0.01
