"""Execution-path provenance for benchmark records.

The frame program chooses its tracer from (cfg, scene) and, on the brute
path, the query implementation from the platform it is compiled for (the
Triton kernel for the GPU, the jnp planes elsewhere; see
render/trace._brute_query). bench.py records both with every
measurement, so a number cannot silently describe another path than the
one it names. The tracer decision lives in render/trace.resolve_tracer,
which the Renderer also uses.
"""

from __future__ import annotations


def exec_paths(cfg, scene, platform: str) -> dict:
    """{"tracer": brute | bvh | bvh2 | binned, "trace_kernel": pallas | xla
    (brute path only, else "-"), "num_tris": int} for a frame compiled
    for `platform` (JAX's device platform, e.g. "gpu")."""
    from sunray_tpu.render.trace import resolve_tracer

    tracer = resolve_tracer(cfg, scene)
    kernel = "pallas" if platform == "gpu" else "xla"
    return {
        "tracer": tracer,
        "trace_kernel": kernel if tracer == "brute" else "-",
        "num_tris": int(scene.num_tris),
    }
