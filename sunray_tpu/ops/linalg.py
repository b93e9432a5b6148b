"""Precision-pinned linear algebra helpers.

Default-precision einsum/matmul may run float32 inputs at reduced precision
(TF32 on the GPU's tensor cores). Every contraction in this framework is a
geometry transform where that costs visible image error (vertex positions
quantized to ~10 mantissa bits), so all modules route through einsum32
(float32-accurate, HIGHEST precision). Kernels that *want* reduced-precision
throughput must opt in explicitly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def einsum32(subscripts, *operands):
    return jnp.einsum(
        subscripts, *operands, precision=jax.lax.Precision.HIGHEST
    )


# Largest table a forced select chain (gather_cols(force_select=True))
# unrolls; beyond it compile size grows linearly.
SELECT_GATHER_MAX_ROWS = 128


def gather_cols(table, idx, force_select=False):
    """Gather rows of a small-component (K, C) table by index, returning a
    TUPLE of C independent (N,)-shaped columns — the trailing dim never
    exists, so nothing can tile-pad.

    force_select: True unrolls a per-row compare+select chain per column
    (tables up to SELECT_GATHER_MAX_ROWS rows) instead of the dynamic
    gather; the equivalence oracle for tests.

    Consumers that use columns (weighted sums, unrolled contractions)
    should take them from here directly: a stacked (N, C) gather result
    whose columns are sliced apart again costs an extra materialization.
    """
    flat = table.reshape(table.shape[0], -1)
    k, c = flat.shape
    if force_select and 0 < k <= SELECT_GATHER_MAX_ROWS:
        # Seed with row 0 and select rows 1..K-1 (one select fewer per
        # column). Out-of-range indices therefore yield row 0 here, while
        # the dynamic-gather branch clamps per XLA semantics — both are
        # arbitrary-but-finite; callers must mask invalid lanes.
        sels = [idx == row for row in range(1, k)]
        cols = []
        for cc in range(c):
            col = jnp.broadcast_to(flat[0, cc], idx.shape)
            for row in range(1, k):
                col = jnp.where(sels[row - 1], flat[row, cc], col)
            cols.append(col)
        return tuple(cols)
    return tuple(flat[:, cc][idx] for cc in range(c))


def gather_vec(table, idx):
    """Gather rows of a small-component table by index.

    Decomposes into per-column gathers (gather_cols), so every gathered
    buffer is (N,)-shaped; the final stack is an elementwise producer XLA
    usually fuses into consumers. Hot-loop callers that consume columns
    should call gather_cols directly and never stack.
    """
    comp_shape = table.shape[1:]
    cols = gather_cols(table, idx)
    if len(cols) == 1 and comp_shape == ():
        return cols[0]
    out = jnp.stack(cols, axis=-1)
    return out.reshape(idx.shape + comp_shape)
