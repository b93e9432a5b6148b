"""Multi-chip / multi-host sharding (SURVEY.md section 7 M8).

The reference is single-GPU (SURVEY.md section 2.3); scaling here is the
design set by BASELINE.md: a 2D device mesh with

  - "dp" (data axis): independent sample batches / camera views — for
    training, the batch axis whose gradients all-reduce (psum);
  - "sp" (spatial axis): screen rows (tile axis) — pixel-parallel passes
    shard cleanly; cross-pixel reads (ReSTIR temporal/spatial gathers, TAA
    history fetch, a-trous taps) become XLA-inserted collectives under
    GSPMD partitioning.

This module uses jit + NamedSharding (the "annotate shardings, let XLA
insert collectives" recipe). Explicit shard_map + ppermute halo exchange is
the later optimization once profiles show the GSPMD gathers dominating.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sunray_tpu.render.pipeline import RenderState, render_frame


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None) -> Mesh:
    """Build a (dp, sp) mesh over the first n devices. dp defaults to the
    largest power-of-two divisor <= sqrt(n)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    devs = devs[:n]
    if dp is None:
        dp = 1
        while dp * 2 <= int(np.sqrt(n)) and n % (dp * 2) == 0:
            dp *= 2
    sp = n // dp
    assert dp * sp == n, f"can't factor {n} devices into ({dp}, {sp})"
    arr = np.asarray(devs).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def replicate(tree, mesh: Mesh):
    s = NamedSharding(mesh, P())
    return jax.device_put(tree, s)


def shard_rows(x, mesh: Mesh):
    """Shard an image-like array's leading (row) axis over 'sp'."""
    return jax.device_put(x, NamedSharding(mesh, P("sp")))


def place_frame_args(scene, cfg, state: RenderState, mats, mesh: Mesh):
    """(scene, state, mats) placed for the GSPMD frame: flat (P,)
    reservoir arrays sharded on their pixel axis and (H, W, C) images on
    rows over 'sp'; the scene, the camera and everything else replicated."""

    def put(x):
        if x.ndim >= 2 and x.shape[0] == cfg.height:
            return jax.device_put(x, NamedSharding(mesh, P("sp")))
        if x.ndim >= 1 and x.shape[0] == cfg.height * cfg.width:
            return jax.device_put(x, NamedSharding(mesh, P("sp")))
        return jax.device_put(x, NamedSharding(mesh, P()))

    return (replicate(scene, mesh), jax.tree_util.tree_map(put, state),
            replicate(mats, mesh))


def render_frame_sharded(scene, cfg, state: RenderState, mats, mesh: Mesh):
    """One frame with the state's pixel arrays sharded over the 'sp' axis
    (place_frame_args). The frame function itself is unchanged — GSPMD
    partitions it.
    """
    scene, state, mats = place_frame_args(scene, cfg, state, mats, mesh)

    # The jitted step is cached per (cfg, mesh): a fresh jit(lambda) per
    # call would recompile EVERY frame (~20 s+ at dryrun sizes — measured;
    # the CLAUDE.md anti-pattern).
    key = (cfg, mesh)
    step = _SHARDED_STEP_CACHE.get(key)
    if step is None:
        step = jax.jit(lambda sc, st, m: render_frame(sc, cfg, st, m))
        _SHARDED_STEP_CACHE[key] = step
    with mesh:
        return step(scene, state, mats)


_SHARDED_STEP_CACHE: dict = {}


def training_step(scene, cfg, mats_batch, targets, mesh: Mesh,
                  param_path: str = "base_color"):
    """One differentiable multi-chip training step (the dryrun contract).

    Renders a batch of views (one per 'dp' shard), compares to target
    images, and returns (loss, grads w.r.t. the chosen material parameter).
    Gradients all-reduce across the mesh automatically (GSPMD psum) because
    the parameter is replicated while the batch is dp-sharded.

    mats_batch: camera-matrices dict with a leading batch axis (K, ...).
    targets: (K, H, W, 3).
    """
    assert cfg.differentiable, "training_step needs cfg.differentiable=True"

    def loss_fn(param, scene, mats_batch, targets):
        mt = scene.materials.replace(**{param_path: param})
        scene2 = scene.replace(materials=mt)

        def render_one(mats):
            st = RenderState.create(cfg)
            _, ldr, _ = render_frame(scene2, cfg, st, mats)
            return ldr

        imgs = jax.vmap(render_one)(mats_batch)
        return jnp.mean((imgs - targets) ** 2)

    param = getattr(scene.materials, param_path)

    # Shard: batch over dp, target rows over sp, everything else replicated.
    targets = jax.device_put(
        targets, NamedSharding(mesh, P("dp", "sp"))
    )
    mats_batch = jax.device_put(
        mats_batch, NamedSharding(mesh, P("dp"))
    )
    scene = replicate(scene, mesh)
    param = replicate(param, mesh)

    key = (cfg, mesh, param_path, "vg")
    vg = _SHARDED_STEP_CACHE.get(key)
    if vg is None:
        vg = jax.jit(jax.value_and_grad(loss_fn))
        _SHARDED_STEP_CACHE[key] = vg
    with mesh:
        loss, grads = vg(param, scene, mats_batch, targets)
    return loss, grads
