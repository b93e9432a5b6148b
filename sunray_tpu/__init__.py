"""sunray_tpu — a JAX differentiable path-tracing framework, run on NVIDIA GPUs.

A from-scratch JAX / Pallas / pjit re-design of the capabilities of
kalsifer-742/sunray (a Rust + Vulkan hardware path tracer). The Vulkan
machinery (render graph, descriptor heap, barriers, command buffers) is
replaced by XLA's functional dataflow; hardware ray tracing
(VK_KHR_acceleration_structure) is replaced by an LBVH built and
traversed with JAX, and a Pallas (Triton) brute-force kernel; per-pixel megakernels become wavefront ray-batch
stages; temporal resources become an explicit, checkpointable state pytree.

Reference parity map (reference file:line cited throughout the modules):
  - camera.rs            -> sunray_tpu.camera
  - shaders/rt_utils     -> sunray_tpu.ops.{rng,packing,brdf}
  - shaders/closest_hit  -> sunray_tpu.render.shade
  - shaders/ray_gen_ris  -> sunray_tpu.render.gbuffer + render.restir
  - shaders/ray_gen_final-> sunray_tpu.render.pathtrace
  - temporal_accumulation-> sunray_tpu.render.postprocess.temporal_accumulate
  - denoise.slang        -> sunray_tpu.render.postprocess.atrous_denoise
  - postprocess.slang    -> sunray_tpu.render.postprocess.tonemap
  - acceleration_structure/ -> sunray_tpu.ops.bvh (+ refit/rebuild heuristic)
  - gltf/ + scene.rs     -> sunray_tpu.scene.gltf + scene.types
  - lib.rs Renderer      -> sunray_tpu.render.renderer.Renderer
"""

from sunray_tpu.config import RenderConfig
from sunray_tpu.camera import Camera, camera_matrices

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "camera_matrices",
    "__version__",
]
