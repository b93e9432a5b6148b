"""Incoherent-ray floor analysis for the binned tracer: is the time for
2M incoherent rays at 82k tris the CULL-RATE floor, or is there headroom
left in the tile math?

Methodology: the round's runtime is proportional to the number of
surviving (ray block, cluster) pairs — each pair is one work item (one
128x512 Moller-Trumbore tile). This script computes
the exact surviving-pair count (the work-list nnz) for camera rays,
raw incoherent rays, and reorder-sorted incoherent rays on the same
82k-tri big-mesh scene, entirely on CPU. If

    measured_incoherent_ms / measured_camera_ms  ~=  nnz_ratio

then the incoherent cost IS the cull-rate floor of the current
clustering, and further cuts need better culling (per-octant cluster
sets, two-level cluster hierarchies) — not a faster kernel.

Usage: python examples/cull_floor.py [--subdiv 6] [--rays 2097152]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import json

import numpy as np

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--rays", type=int, default=1 << 21)
    ap.add_argument("--cluster-k", type=int, default=128)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    from examples.bench_binned import make_rays
    from examples.bench_instances import icosphere
    from sunray_tpu.ops import binned_trace as bt
    from sunray_tpu.ops import intersect

    verts, faces = icosphere(args.subdiv)
    v0 = jnp.asarray(verts[faces[:, 0]])
    v1 = jnp.asarray(verts[faces[:, 1]])
    v2 = jnp.asarray(verts[faces[:, 2]])
    cs = bt.build_cluster_set((v0, v1, v2), k=args.cluster_k)
    c = cs.num_clusters
    print(f"tris={v0.shape[0]} clusters={c} rays={args.rays}", flush=True)

    def pairs(orig, d, reorder):
        tmax = intersect.T_MAX
        exclude = None
        if reorder:
            orig, d, tmax, exclude, _ = bt._reorder_rays(
                cs, orig.reshape(-1, 3), d.reshape(-1, 3), tmax, None
            )
        o_t, d_t, tn, tx, ex, n, nb = bt._prep(
            orig, d, intersect.T_MIN, tmax, exclude
        )
        hit, entry = bt._interval_cull(
            o_t, d_t, tn, tx, cs.aabb_lo, cs.aabb_hi, nb,
            bt.BLOCK_RAYS,
        )
        nnz = int(jnp.sum(hit))
        return nnz, nb

    results = {}
    for name, kind, reorder in (
        ("camera", "camera", False),
        ("incoherent_raw", "bounce", False),
        ("incoherent_reordered", "bounce", True),
    ):
        o, d = make_rays(args.rays, kind)
        nnz, nb = pairs(o, d, reorder)
        frac = nnz / (nb * c)
        results[name] = {"pairs": nnz, "blocks": nb,
                         "survival": round(frac, 4)}
        print(f"{name:22s} pairs={nnz:9d}  survival={frac:.4f}", flush=True)

    cam = results["camera"]["pairs"]
    reo = results["incoherent_reordered"]["pairs"]
    print(json.dumps({
        "pair_ratio_reordered_vs_camera": round(reo / cam, 3),
        **results,
    }))


if __name__ == "__main__":
    main()
