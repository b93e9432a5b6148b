"""Stateful Renderer facade over the functional core.

The API twin of the reference's `Renderer` (src/lib.rs:84-198): owns the
scene, config, and cross-frame state; exposes render / render_to_host_memory
/ resize. Under the hood each frame is one jitted call of
pipeline.render_frame with the state pytree donated (the reference's
frames-in-flight + temporal-resource machinery collapses to JAX async
dispatch + buffer donation).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import numpy as np

from sunray_tpu.camera import Camera, camera_matrices  # noqa: F401
from sunray_tpu.camera import camera_matrices_device
from sunray_tpu.config import RenderConfig
from sunray_tpu.ops.accel_state import AsState, FAST_BUILD, SLOW_BUILD
from sunray_tpu.render.pipeline import RenderState, render_frame
from sunray_tpu.render.trace import big_scene_mode
from sunray_tpu.utils.compile_cache import enable_compile_cache


class Renderer:
    def __init__(self, config: RenderConfig, scene=None):
        enable_compile_cache()
        self.config = config
        self.scene = scene
        self.state = RenderState.create(config)
        self._frame_jit = None
        self._manager = None
        self._instances = None
        self._last_transforms = None   # host cache of the last upload
        self._accel = None
        self._accel_for = None
        # AS rebuild/refit heuristic state (acceleration_structure/
        # mod.rs:31-148) + the op it chose for the last frame (telemetry).
        self._as_state = AsState()
        self._lbvh_jit = None
        self._lbvh_leaf = None
        self.last_accel_op = None
        # Frame/resize callbacks (lib.rs:537-558): start/end callbacks run
        # ONCE then drop (FnOnce); resize callbacks persist (FnMut).
        self._start_frame_cbs = []
        self._end_frame_cbs = []
        self._resize_cbs = []
        # Scene groups (lib.rs:779/849): load_gltf/load_scene hand back a
        # group id that unload_scene() removes wholesale.
        self._groups = {}
        self._next_group = 0
        self._build_frame_fn()

    # -- callbacks (lib.rs:537-558) --
    def add_start_of_frame_callback(self, callback):
        """Run once at the start of the next render() (FnOnce semantics)."""
        self._start_frame_cbs.append(callback)

    def add_end_of_frame_callback(self, callback):
        """Run once after the next render(), receiving this Renderer."""
        self._end_frame_cbs.append(callback)

    def add_resize_callback(self, callback):
        """Run on every resize() with the new (width, height); persistent."""
        self._resize_cbs.append(callback)

    def _build_frame_fn(self):
        cfg = self.config

        def step(scene, state, mats, accel):
            return render_frame(scene, cfg, state, mats, accel)

        # Donate the state: temporal buffers update in place, the analog of
        # the reference's persistent temporal resources (graph.rs:235-266).
        self._frame_jit = jax.jit(step, donate_argnums=(1,))

    def _scene_accel(self):
        """Host-side quality BVH for the current scene (the SLOW_BUILD op):
        native binned-SAH when the toolchain is available, cached per scene
        object; transform animation is handled by in-jit refit."""
        if self.scene is None:
            return None
        cfg = self.config
        # "auto" above the brute-kernel crossover picks the two-level path:
        # object-space BLASes are built once per mesh topology and shared by
        # every instance, and only the tiny instance TLAS rebuilds per frame
        # — strictly cheaper than the unified world BVH, whose host SAH
        # build reruns on every set_instances() (examples/
        # bench_instances.py). The unified path
        # stays reachable as the forced tracer="bvh".
        if (cfg.tracer == "auto"
                and self.scene.num_tris > cfg.brute_force_max_tris):
            # Above the brute crossover: pick the scalable backend from the
            # scene's shape (see config.py tracer docs for the measured
            # crossovers). Cached per topology — the decision needs host
            # reads of the instance tables.
            mode = self._auto_big_mode()
        else:
            mode = cfg.tracer
        if mode == "binned":
            # Binned cluster-culled tracer (ops/binned_trace.py): the
            # cluster ASSIGNMENT (Morton order) is load-time topology,
            # cached per scene like the unified BVH; per-frame geometry is
            # refit in-jit by make_tracer. The cache key holds the scene
            # OBJECT (not id()) so a freed id can never alias a new scene
            # to a stale ClusterSet.
            if not (
                isinstance(self._accel_for, tuple)
                and self._accel_for[0] == "binned"
                and self._accel_for[1] is self.scene
            ):
                from sunray_tpu.ops.binned_trace import build_cluster_set

                tris = self.scene.world_triangle_vertices()
                self._accel = build_cluster_set(tris, k=cfg.cluster_k)
                self._accel_for = ("binned", self.scene)
            return self._accel
        if mode == "bvh2":
            # Two-level: object-space BLAS set is a function of the mesh
            # TOPOLOGY only — cache survives instance-transform changes
            # (set_instances rebuilds SceneBuffers but not the meshes), the
            # whole point of the BLAS/TLAS split (blas.rs static builds,
            # tlas.rs per-frame builds).
            from sunray_tpu.ops.bvh2 import build_blas_set

            gen = self._manager._generation if self._manager is not None \
                else id(self.scene)
            # A mesh's BLAS is extracted from its first instance's slice of
            # the scene, so gaining a first instance must invalidate too.
            prims = tuple(np.unique(np.asarray(self.scene.inst_prim)))
            key = (gen, prims)
            if self._accel_for != ("bvh2", key):
                self._accel = build_blas_set(
                    self.scene, leaf_size=cfg.bvh_leaf_size
                )
                self._accel_for = ("bvh2", key)
            return self._accel
        if mode != "bvh":
            self.last_accel_op = None
            return None
        return self._unified_accel()

    def _auto_big_mode(self) -> str:
        """trace.big_scene_mode for the current scene, cached per
        topology — recomputing needs host reads."""
        scene = self.scene
        gen = (
            self._manager._generation if self._manager is not None else None
        )
        key = (scene, gen, int(scene.num_tris))
        cached = getattr(self, "_auto_mode_for", None)
        if cached is not None and cached[0] is key[0] and cached[1:3] == key[1:]:
            return self._auto_mode
        self._auto_mode = big_scene_mode(
            scene.tri_inst, int(np.asarray(scene.inst_prim).shape[0]),
            self.config.bvh2_blas_max_tris,
        )
        self._auto_mode_for = key
        return self._auto_mode

    def _unified_accel(self):
        """Unified world BVH driven by the AsState rebuild/refit heuristic
        (acceleration_structure/mod.rs:94-148):

          - a fresh scene (load_scene / first build) -> SLOW_BUILD: native
            binned-SAH quality topology, built once at load like the
            reference's initial AS build; optimal=True, so a static scene
            never rebuilds again;
          - instance spawn/despawn or mesh add/remove -> topology change ->
            FAST_BUILD: device LBVH re-sort (no host stall, the
            arena/deferred-build analog);
          - transform-only churn (animation) -> UPDATE: keep the cached
            topology; node boxes are refit in-jit from the live world
            geometry by make_tracer every frame. At most
            MAX_UPDATES_BEFORE_REBUILD (8) updates between rebuilds;
          - after FRAMES_TO_SETTLE (16) quiet frames a SLOW_BUILD settles
            back to SAH quality.

        The SAH and LBVH topologies have different (jit-static) leaf
        counts, so at most two frame programs exist per scene capacity;
        jax.jit keeps both cached.
        """
        scene = self.scene
        cfg = self.config
        if self._manager is not None:
            # Topology signal: mesh registry generation + the padded
            # triangle capacity + the instance key multiset (spawn/despawn
            # = a TLAS-rebuild-class change in the reference, tlas.rs).
            topo = (
                "mgr",
                self._manager._generation,
                int(scene.num_tris),
                tuple(k for k, _ in (self._instances or [])),
            )
            geom = b"".join(
                np.asarray(t, np.float32).tobytes()
                for _, t in (self._instances or [])
            )
        else:
            # Directly-loaded scenes: the held scene object is the only
            # signal; any new object is a fresh-scene build. Holding the
            # object (not id()) prevents stale-id aliasing.
            topo = ("obj", scene, int(scene.num_tris))
            geom = None

        have = isinstance(self._accel_for, tuple) and self._accel_for[0] == "bvh"
        prev_topo = self._accel_for[1] if have else None
        prev_geom = self._accel_for[2] if have else None

        def same_topo(a, b):
            if a is None or b is None or a[0] != b[0] or a[2:] != b[2:]:
                return False
            return a[1] is b[1] if a[0] == "obj" else a[1] == b[1]

        topology_changed = not same_topo(topo, prev_topo)
        geometry_changed = (not topology_changed) and geom != prev_geom

        if not have or (topology_changed and topo[0] == "obj"):
            op = SLOW_BUILD
            self._as_state = AsState()
        else:
            op = self._as_state.next_op(geometry_changed, topology_changed)

        if op == SLOW_BUILD:
            from sunray_tpu.native import build_sah_bvh

            tris = scene.world_triangle_vertices()
            accel = build_sah_bvh(
                np.asarray(tris[0]), np.asarray(tris[1]), np.asarray(tris[2]),
                leaf_size=cfg.bvh_leaf_size,
            )
            if accel is None:
                # Native toolchain unavailable: the LBVH is the best
                # quality build we have; still counts as settled.
                accel = self._lbvh_build(tris)
            self._accel = accel
        elif op == FAST_BUILD:
            self._accel = self._lbvh_build(scene.world_triangle_vertices())
        # UPDATE / "none": keep the cached topology — make_tracer refits
        # the boxes in-jit from the live world geometry every frame.

        self._as_state.mark(op, topology_changed or geometry_changed)
        self._accel_for = ("bvh", topo, geom)
        self.last_accel_op = op
        return self._accel

    def _lbvh_build(self, tris):
        """Device-side Morton re-sort LBVH (the FAST_BUILD op) — jitted
        once per (shape, leaf_size); no host round-trip for the geometry."""
        from sunray_tpu.ops.bvh import build_bvh

        leaf = self.config.bvh_leaf_size
        if self._lbvh_jit is None or self._lbvh_leaf != leaf:
            self._lbvh_jit = jax.jit(partial(build_bvh, leaf_size=leaf))
            self._lbvh_leaf = leaf
        return self._lbvh_jit(tris)

    def _sync_scene_flags(self):
        """Auto-set jit-static flags that depend on the concrete scene
        (alpha-mask traversal)."""
        if self.scene is None:
            return
        want = bool(self.scene.has_alpha_mask)
        if want != self.config.alpha_mask_tracing:
            self.config = self.config.replace(alpha_mask_tracing=want)
            self._build_frame_fn()

    # -- scene management (load_scene / unload_scene analog, lib.rs:779-857) --
    def load_scene(self, scene, reset_history: bool = True):
        self.scene = scene
        self._manager = None
        self._instances = None
        self._last_transforms = None
        self._groups = {}           # any load_gltf groups are gone with
        self.last_scene_group = None  # the manager they lived in
        self._sync_scene_flags()
        if reset_history:
            self.reset_history()

    def load_gltf(self, path: str):
        """Load a glTF scene and return the caller-owned instance list
        (lib.rs:779-794 contract: the caller hands instances to each frame;
        by default the scene's own placements are used). The scene group id
        for unload_scene() is available as `last_scene_group`."""
        from sunray_tpu.scene.gltf import load_gltf
        from sunray_tpu.scene.manager import SceneManager

        scene = load_gltf(path)
        if self._manager is None:
            self._manager = SceneManager.from_scene_buffers(scene)
            keys = list(self._manager._meshes)
            self._instances = self._manager.default_instances(scene)
            tex0 = self._manager._textures
            tex_range = (0, 0 if tex0 is None
                         else int(np.asarray(tex0.data).shape[0]))
        else:
            from sunray_tpu.scene.types import merge_atlases

            sub = SceneManager.from_scene_buffers(scene)
            atlas, off = merge_atlases(self._manager._textures, sub._textures)
            self._manager._textures = atlas
            tex_range = (off, 0 if sub._textures is None
                         else int(np.asarray(sub._textures.data).shape[0]))
            prefix = f"g{self._next_group}/"
            keys = []
            for key, mesh in sub._meshes.items():
                if off and "tex_index" in mesh.material:
                    ti = np.asarray(mesh.material["tex_index"])
                    mesh.material["tex_index"] = np.where(ti >= 0, ti + off, ti)
                self._manager._meshes[prefix + key] = mesh
                keys.append(prefix + key)
            self._manager._generation += 1
            self._instances = list(self._instances or []) + [
                (prefix + k, t) for k, t in sub.default_instances(scene)
            ]
        group = self._next_group
        self._next_group += 1
        self._groups[group] = {"keys": keys, "tex": tex_range}
        self.last_scene_group = group
        self.scene = self._manager.build(self._instances)
        self._sync_scene_flags()
        self.reset_history()
        return list(self._instances)

    def unload_scene(self, group: int):
        """Remove every mesh (and its atlas textures) a load_gltf() call
        added (lib.rs:849-871). Remaining meshes' texture indices are
        remapped so repeated load/unload cycles don't grow the atlas."""
        if self._manager is None:
            raise KeyError(f"scene group {group} (no manager loaded)")
        rec = self._groups.pop(group)
        keys = set(rec["keys"])
        for k in keys:
            self._manager.remove_mesh(k)
        self._instances = [
            (k, t) for k, t in (self._instances or []) if k not in keys
        ]
        start, count = rec["tex"]
        if count:
            import jax.numpy as jnp

            a = self._manager._textures
            sel = np.r_[0:start, start + count:np.asarray(a.data).shape[0]]
            self._manager._textures = None if sel.size == 0 else type(a)(
                data=jnp.asarray(np.asarray(a.data)[sel]),
                size=jnp.asarray(np.asarray(a.size)[sel]),
                wrap=jnp.asarray(np.asarray(a.wrap)[sel]),
                filt=jnp.asarray(np.asarray(a.filt)[sel]),
            )
            for mesh in self._manager._meshes.values():
                if "tex_index" in mesh.material:
                    ti = np.asarray(mesh.material["tex_index"])
                    mesh.material["tex_index"] = np.where(
                        ti >= start + count, ti - count, ti
                    )
            for g in self._groups.values():
                s0, c0 = g["tex"]
                if s0 >= start + count:
                    g["tex"] = (s0 - count, c0)
        self._manager._generation += 1
        self.scene = self._manager.build(self._instances)
        self._sync_scene_flags()
        self.reset_history()

    # -- runtime mesh churn (load_mesh/unload_mesh analog, lib.rs:873-973) --
    def load_mesh(self, key, positions, normals, tri_vidx, material,
                  tangents=None, uvs=None):
        from sunray_tpu.scene.manager import SceneManager

        if self._manager is None:
            self._manager = SceneManager()
            self._instances = []
        self._manager.add_mesh(
            key, positions, normals, tri_vidx, material, tangents, uvs
        )

    def unload_mesh(self, key):
        self._manager.remove_mesh(key)
        self._instances = [
            (k, t) for k, t in (self._instances or []) if k != key
        ]
        self.scene = self._manager.build(self._instances)

    def set_instances(self, instances):
        """Update the per-frame instance list [(mesh key, (3,4) transform)].

        Same key list as last frame -> transform-only update: the packed
        mesh/triangle tables stay resident and only the (I, 3, 4) transform
        array re-uploads — the reference's per-frame contract (lib.rs:
        1017-1116 uploads camera/TLAS-instances/transforms only; meshes
        stay in their arenas); a full host re-pack per frame would
        dominate the orbit loop. Key-list changes
        (spawn/despawn) re-pack; capacity padding keeps array shapes
        stable for small churn, so the compiled frame program is reused
        (the arena/deferred-build analog of lib.rs:873-973)."""
        instances = list(instances)
        prev = self._instances
        if (
            prev is not None
            and self.scene is not None
            and len(prev) == len(instances)
            and all(a == b for (a, _), (b, _) in zip(prev, instances))
        ):
            import jax.numpy as jnp

            new_t = np.stack(
                [np.asarray(t, np.float32) for _, t in instances]
            )
            self._instances = instances
            # Compare against the HOST-side cache of the last upload — a
            # device readback here is a blocking round trip per frame.
            if self._last_transforms is None or not np.array_equal(
                new_t, self._last_transforms
            ):
                # Keep the instance-capacity padding (zero transforms)
                # that pad_scene_capacity added — replacing with the raw
                # list would change the array shape and recompile.
                cap = int(self.scene.inst_transform.shape[0])
                up = new_t
                if cap > up.shape[0]:
                    up = np.concatenate(
                        [up, np.zeros((cap - up.shape[0], 3, 4),
                                      np.float32)], axis=0
                    )
                self.scene = self.scene.replace(
                    inst_transform=jnp.asarray(up)
                )
                self._last_transforms = new_t
            return
        self._instances = instances
        self.scene = self._manager.build(self._instances)
        self._last_transforms = np.stack(
            [np.asarray(t, np.float32) for _, t in instances]
        ) if instances else None

    def reset_history(self):
        """Temporal-state reset (resize/scene-change semantics, lib.rs:639)."""
        self.state = RenderState.create(self.config)

    def resize(self, width: int, height: int):
        """lib.rs:586-642: rebuild size-dependent resources, reset temporal
        state and the relative frame counter."""
        self.config = self.config.with_size(width, height)
        self._build_frame_fn()
        self.reset_history()
        for cb in self._resize_cbs:
            cb((width, height))

    # -- rendering --
    def render(self, camera: Camera, instances=None):
        """One frame -> (H, W, 3) float32 LDR in [0,1]. Advances state.

        instances: optional caller-owned [(mesh key, transform)] list for
        this frame (the render(..., instances) contract, lib.rs:984)."""
        if self.scene is None and instances is None:
            raise RuntimeError("no scene loaded")
        cbs, self._start_frame_cbs = self._start_frame_cbs, []
        for cb in cbs:
            cb()
        if instances is not None:
            self.set_instances(instances)
        if self.scene is None:
            raise RuntimeError("no scene loaded")
        # Jitted camera math: the eager form is ~40 tiny device ops per
        # frame (camera.camera_matrices_device).
        mats = camera_matrices_device(
            camera, self.config.width, self.config.height
        )
        self.state, ldr, _aux = self._frame_jit(
            self.scene, self.state, mats, self._scene_accel()
        )
        cbs, self._end_frame_cbs = self._end_frame_cbs, []
        for cb in cbs:
            cb(self)
        return ldr

    def render_to_host_memory(self, camera: Camera, warmup: Optional[int] = None):
        """Offline golden-image path (lib.rs:1908-1934): N warm-up frames so
        ReSTIR temporal reuse + TAA have history, then return RGBA8 bytes."""
        warmup = self.config.warmup_frames if warmup is None else warmup
        ldr = None
        for _ in range(warmup + 1):
            ldr = self.render(camera)
        img = np.asarray(ldr)
        rgba = np.concatenate(
            [img, np.ones_like(img[..., :1])], axis=-1
        )
        return (np.clip(rgba, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
