"""ops/linalg gather helpers: the select-chain path is taken only when
forced (force_select=True); these tests pin its semantics against the
plain dynamic-gather path."""

import jax.numpy as jnp
import numpy as np

from sunray_tpu.ops.linalg import SELECT_GATHER_MAX_ROWS, gather_cols


def test_select_chain_matches_gather_in_range():
    rng = np.random.default_rng(0)
    k, c, n = 37, 5, 1000
    table = jnp.asarray(rng.normal(size=(k, c)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, k, size=n).astype(np.int32))
    sel = gather_cols(table, idx, force_select=True)
    ref = gather_cols(table, idx, force_select=False)
    assert len(sel) == c
    for a, b in zip(sel, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_select_chain_out_of_range_yields_row0():
    """Documented divergence: select chains return row 0 for out-of-range
    indices (the gather branch clamps per XLA semantics). Callers mask
    invalid lanes, so either is fine — but the behavior is pinned here."""
    table = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3))
    idx = jnp.asarray([0, 3, 7, -2], np.int32)
    sel = gather_cols(table, idx, force_select=True)
    np.testing.assert_array_equal(
        np.asarray(sel[0]), np.asarray([0.0, 9.0, 0.0, 0.0])
    )


def test_select_chain_row_limit_falls_back():
    k = SELECT_GATHER_MAX_ROWS + 1
    table = jnp.asarray(np.random.default_rng(1).normal(size=(k, 2)).astype(np.float32))
    idx = jnp.asarray([0, k - 1], np.int32)
    # Above the row cap the select chain falls back to plain gathers even
    # when forced (the chain would bloat compiles); result must still be exact.
    out = gather_cols(table, idx, force_select=True)
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(table[idx, 0]))
