"""The jnp a-trous denoise and TAA clamp+blend (render/postprocess.py)
against straightforward NumPy loops over the shader math
(denoise.slang:27-116, temporal_accumulation.slang:60-132)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.render import postprocess as pp

LUMA = np.array(pp.LUMA, np.float64)
KERNEL = np.array(pp.ATROUS_KERNEL, np.float64)


def _images(h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.0, 2.0, (h, w, 3))
    depth = rng.uniform(1.0, 5.0, (h, w))
    depth[0, :3] = 10000.0                               # sky pixels
    normal = rng.normal(size=(h, w, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[h // 2:] = [0.0, 0.0, 1.0]                    # a flat region
    rough = rng.uniform(0.0, 1.0, (h, w))
    diffuse = rng.uniform(0.0, 1.0, (h, w, 3))
    diffuse[:, :4] = 0.5                                 # equal albedo
    return [x.astype(np.float32) for x in (color, depth, normal, rough,
                                           diffuse)]


def atrous_pass_ref(color, depth, normal, rough, diffuse, step):
    h, w = depth.shape
    out = np.empty_like(color, dtype=np.float64)
    c_dif = np.maximum(diffuse.astype(np.float64), 0.001)
    illum = color / c_dif
    luma = illum @ LUMA
    for y in range(h):
        for x in range(w):
            if depth[y, x] >= 10000.0 or rough[y, x] < 0.1:
                out[y, x] = color[y, x]
                continue
            kc = KERNEL[2] * KERNEL[2]
            s_col = illum[y, x] * kc
            s_w = kc
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    if dx == 0 and dy == 0:
                        continue
                    yy, xx = y + dy * step, x + dx * step
                    if not (0 <= yy < h and 0 <= xx < w):
                        continue
                    n_il = color[yy, xx] / np.maximum(diffuse[yy, xx], 0.001)
                    n_l = n_il @ LUMA
                    sigma = max(luma[y, x], n_l) * 0.4 + 0.01
                    p = (-abs(depth[y, x] - depth[yy, xx]) * 8.0
                         + (normal[y, x] @ normal[yy, xx] - 1.0) * 80.0
                         - np.linalg.norm(c_dif[y, x] - diffuse[yy, xx])
                         * 50.0
                         - (abs(luma[y, x] - n_l) / sigma) ** 2)
                    wgt = np.exp(p) * KERNEL[dx + 2] * KERNEL[dy + 2]
                    s_col = s_col + n_il * wgt
                    s_w += wgt
            out[y, x] = s_col / max(s_w, 1e-4) * c_dif[y, x]
    return out


@pytest.mark.parametrize("step", [1, 2, 4])
def test_atrous_pass_matches_numpy(step):
    imgs = _images(seed=step)
    got = pp.atrous_denoise_pass(*(jnp.asarray(x) for x in imgs), step)
    np.testing.assert_allclose(np.asarray(got), atrous_pass_ref(*imgs, step),
                               rtol=2e-4, atol=1e-5)


def taa_ref(raw, hist, use, factor):
    h, w, _ = raw.shape
    out = np.empty_like(raw, dtype=np.float64)
    lum = raw @ LUMA
    for y in range(h):
        for x in range(w):
            lo = raw[y, x].astype(np.float64).copy()
            hi = lo.copy()
            thr = max(lum[y, x] * 5.0, 0.08)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dx == 0 and dy == 0:
                        continue
                    yy = min(max(y + dy, 0), h - 1)      # edge-clamped
                    xx = min(max(x + dx, 0), w - 1)
                    if abs(lum[yy, xx] - lum[y, x]) < thr:
                        lo = np.minimum(lo, raw[yy, xx])
                        hi = np.maximum(hi, raw[yy, xx])
            c = np.clip(hist[y, x], lo, hi)
            out[y, x] = (c + (raw[y, x] - c) * factor if use[y, x]
                         else raw[y, x])
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_taa_clamp_blend_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0.0, 1.5, (18, 22, 3)).astype(np.float32)
    raw[5:9, 5:9] *= 8.0                                 # luma-gated block
    hist = rng.uniform(0.0, 2.0, (18, 22, 3)).astype(np.float32)
    use = rng.uniform(size=(18, 22)) > 0.3
    got = pp.taa_clamp_blend(jnp.asarray(raw), jnp.asarray(hist),
                             jnp.asarray(use), 0.14)
    np.testing.assert_allclose(np.asarray(got), taa_ref(raw, hist, use, 0.14),
                               rtol=1e-5, atol=1e-6)
