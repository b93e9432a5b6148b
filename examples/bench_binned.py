"""Big-scene tracer A/B: brute Pallas vs unified BVH walk vs binned.

Builds one large icosphere mesh (--subdiv 5 = ~20k tris, 6 = ~82k, 7 =
~328k) and times raw closest-hit queries for (a) coherent camera rays and
(b) incoherent bounce-like rays, across tracer backends.

Usage: python examples/bench_binned.py [--subdiv 6] [--rays 2097152]
       [--tracers binned,bvh,brute] [--cluster-k 128]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp

from examples.bench_instances import icosphere


def make_rays(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "camera":
        # Raster-order pixel fan from one origin — primary-ray coherence.
        side = int(np.sqrt(n))
        ys, xs = np.mgrid[0:side, 0:side].astype(np.float32)
        u = (xs.ravel() + 0.5) / side * 2.0 - 1.0
        v = (ys.ravel() + 0.5) / side * 2.0 - 1.0
        d = np.stack([u, v, np.full_like(u, -2.0)], axis=1)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (d.shape[0], 1))
    else:
        # Bounce-like: origins near the surface, cosine-ish directions.
        o = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--rays", type=int, default=1 << 21)
    ap.add_argument("--tracers", default="binned,bvh,brute")
    ap.add_argument("--cluster-k", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    verts, faces = icosphere(args.subdiv)
    v0 = jnp.asarray(verts[faces[:, 0]])
    v1 = jnp.asarray(verts[faces[:, 1]])
    v2 = jnp.asarray(verts[faces[:, 2]])
    tris = (v0, v1, v2)
    t = v0.shape[0]
    print(f"tris={t}  rays={args.rays}  "
          f"device={jax.devices()[0].device_kind}", flush=True)

    fns = {}
    for name in args.tracers.split(","):
        if name == "brute":
            from sunray_tpu.ops import pallas_trace

            fns[name] = jax.jit(
                lambda o, d: pallas_trace.trace_closest_pallas(tris, o, d)
            )
        elif name == "bvh":
            from sunray_tpu.native import build_sah_bvh
            from sunray_tpu.ops import bvh as bvh_mod

            accel = build_sah_bvh(
                np.asarray(v0), np.asarray(v1), np.asarray(v2), leaf_size=4
            )

            def bvh_fn(o, d, accel=accel):
                b = bvh_mod.refit_bvh(accel, tris)
                return bvh_mod.trace_closest_bvh(b, tris, o, d)

            fns[name] = jax.jit(bvh_fn)
        elif name == "binned":
            from sunray_tpu.ops import binned_trace as bt

            cs = bt.build_cluster_set(tris, k=args.cluster_k)

            def binned_fn(o, d, cs=cs):
                return bt.trace_closest_binned(
                    bt.refit_cluster_set(cs, tris), o, d
                )

            fns[name] = jax.jit(binned_fn)
        elif name == "binned_reorder":
            from sunray_tpu.ops import binned_trace as bt

            cs2 = bt.build_cluster_set(tris, k=args.cluster_k)

            def binned_ro_fn(o, d, cs=cs2):
                return bt.trace_closest_binned(
                    bt.refit_cluster_set(cs, tris), o, d, reorder=True
                )

            fns[name] = jax.jit(binned_ro_fn)

    for kind in ("camera", "bounce"):
        o, d = make_rays(args.rays, kind)
        base_hit = None
        for name, fn in fns.items():
            t0 = time.time()
            out = jax.block_until_ready(fn(o, d))
            warm = time.time() - t0
            t0 = time.time()
            for _ in range(args.reps):
                out = jax.block_until_ready(fn(o, d))
            dt = (time.time() - t0) / args.reps
            hits = float(jnp.mean(out.hit))
            mrs = o.shape[0] / dt / 1e6
            line = (f"{kind:7s} {name:7s} {dt*1e3:9.2f} ms  {mrs:8.1f} Mray/s"
                    f"  hit={hits:.3f}  warm={warm:.1f}s")
            if base_hit is None:
                base_hit = np.asarray(out.t)
            else:
                m = np.isfinite(base_hit) & np.isfinite(np.asarray(out.t))
                dmax = float(np.abs(np.asarray(out.t)[m] - base_hit[m]).max()) \
                    if m.any() else 0.0
                line += f"  max|dt|={dmax:.2e}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
