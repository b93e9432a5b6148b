"""Loop helpers: early-exit wavefront loops with a differentiable variant.

The bounce walks are masked full-batch loops. Forward rendering wants
`lax.while_loop` (exit as soon as no lane is active — e.g. the ReSTIR final
walk usually terminates after 1-2 rounds); reverse-mode AD requires a fixed
trip count (`lax.while_loop` has no transpose rule), so the differentiable
path runs the same body a static number of times under `lax.scan` — extra
iterations are no-ops because every state update in the body is masked by
the active lanes.
"""

from __future__ import annotations

import jax


def bounded_loop(cond, body, init, max_iters: int, differentiable: bool,
                 peel: int = 0, loop_body=None):
    """Run `body` until `cond` fails (forward) or exactly max_iters times
    (differentiable). body/cond operate on a single carry pytree.

    peel: run the first `peel` iterations UNCONDITIONALLY inline before
    entering the loop. A while_loop boundary materializes the whole carry
    (a device-memory round trip) and blocks fusion with the surrounding
    program. The bounce walks almost always execute at least one round, so
    peeling it is free fusion. Callers must guarantee the body is a no-op
    (masked) for lanes whose cond already failed; only counters may
    advance. peel > max_iters is clamped.
    """
    peel = min(peel, max_iters)
    for _ in range(peel):
        init = body(init)
    # loop_body: optional distinct body for the looped rounds — e.g. the
    # bounce walks pass coherent=True for the peeled (camera-ray) round
    # and coherent=False inside the loop so the binned tracer
    # coherence-sorts only the genuinely incoherent bounce batches.
    loop_body = body if loop_body is None else loop_body
    if not differentiable:
        return jax.lax.while_loop(cond, loop_body, init)

    # Rematerialize each scan iteration in the backward pass: without
    # this, reverse-mode saves every intermediate of every round (dozens
    # of f32[rounds, P, 3] residual buffers). With remat only the
    # per-round CARRY is saved and the body recomputes in the backward — the
    # classic memory/FLOPs trade, and the walk bodies are cheap relative
    # to their residual footprint.
    remat_body = jax.checkpoint(loop_body)

    # Data-dependent round skipping inside the fixed trip count: the
    # forward walks exit after 1-2 rounds on typical frames, but a plain
    # scan would run every masked round's full body (the first 720p
    # fwd+bwd measurement spent ~30 all-dead rounds). lax.cond is
    # differentiable (both branches traced, one executed at runtime), so
    # dead rounds collapse to an identity pass in BOTH directions while
    # the trip count stays static for AD. Semantics match the
    # while_loop exactly: the body is a masked no-op once its lanes are
    # inactive, and `cond` is the same predicate the forward loop uses.
    def scan_body(carry, _):
        return jax.lax.cond(cond(carry), remat_body, lambda c: c, carry), None

    if max_iters - peel <= 0:
        return init
    carry, _ = jax.lax.scan(scan_body, init, None, length=max_iters - peel)
    return carry
