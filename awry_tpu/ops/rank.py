"""Device rank (occurrence) primitives: the heart of backward search.

The vectorized form of the reference's SIMD kernel + windowed-BWT rank
(src/simd_instructions.rs:98-121, src/bwt.rs:110-135, :226-271):

* the QUERY BATCH is the minor (last) dimension - every elementwise op is a
  contiguous vector op over the batch;
* each rank gathers its fused block row (windows + milestones in one
  128-byte line), and the batch of rows is transposed once to
  [row_words, B] so the 8 popcount words are 8 batch-wide vectors;
* all small-table lookups (symbol codes, milestones-within-row, prefix
  sums) are where-select chains over compile-time constants, fused into the
  surrounding elementwise code instead of separate table gathers.

pos/starts/ends are uint32 [B]; sym is int32 [B].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import code_to_index_table, index_to_code_table
from .device_index import FmDeviceIndex

_FULL = 0xFFFFFFFF


def select_u32(table, idx: jax.Array) -> jax.Array:
    """LUT via a where-select chain over small compile-time tables (no
    table gather).  table: python/numpy ints; idx: int [B]."""
    out = jnp.full(idx.shape, np.uint32(table[0]), dtype=jnp.uint32)
    for k in range(1, len(table)):
        out = jnp.where(idx == k, jnp.uint32(table[k]), out)
    return out


def select_rows(rows_t: jax.Array, base: int, count: int, idx: jax.Array) -> jax.Array:
    """rows_t[base + idx, lane] for per-lane idx in [0, count), as a select
    chain over the `count` candidate rows."""
    out = rows_t[base]
    for k in range(1, count):
        out = jnp.where(idx == k, rows_t[base + k], out)
    return out


def fetch_rows_t(index: FmDeviceIndex, pos: jax.Array) -> jax.Array:
    """Gather fused block rows for positions [B] and transpose to
    [row_words, B] (batch in lanes)."""
    block = (pos >> 8).astype(jnp.int32)
    return index.blocks[block].T


def window_popcount_t(
    index: FmDeviceIndex, rows_t: jax.Array, pos: jax.Array, sym: jax.Array
) -> jax.Array:
    """Masked popcount of `sym` within transposed rows (milestone NOT added).

    rows_t: uint32 [row_words, B]; pos uint32 [B]; sym int32 [B].
    """
    local = (pos & jnp.uint32(255)).astype(jnp.uint32)
    code_table = index_to_code_table(index.alphabet)
    nv = index.num_planes

    # occv [8, B]: AND over planes of (window ^ xor_polarity).
    occv = None
    for v in range(nv):
        bits = [(int(c) >> v) & 1 for c in code_table]
        xor_mask = select_u32([0xFFFFFFFF if b == 0 else 0 for b in bits], sym)
        plane = rows_t[v * 8 : (v + 1) * 8] ^ xor_mask[None, :]
        occv = plane if occv is None else occv & plane

    # Inclusive positional mask over the 8 window words: bits [0..=local]
    # (mask inclusivity: src/simd_instructions.rs:106-107).
    word = (local >> 5)[None, :]
    lane = jax.lax.broadcasted_iota(jnp.uint32, (8, 1), 0)
    in_word = (jnp.uint32(_FULL) >> (jnp.uint32(31) - (local & jnp.uint32(31))))[None, :]
    mask = jnp.where(lane < word, jnp.uint32(_FULL), jnp.where(lane == word, in_word, jnp.uint32(0)))

    return jax.lax.population_count(occv & mask).sum(axis=0, dtype=jnp.uint32)


def milestone_t(index: FmDeviceIndex, rows_t: jax.Array, sym: jax.Array) -> jax.Array:
    """Per-symbol milestone out of already-fetched transposed rows."""
    return select_rows(rows_t, index.plane_words, index.alphabet.cardinality, sym)


def occurrence_from_rows_t(
    index: FmDeviceIndex, rows_t: jax.Array, pos: jax.Array, sym: jax.Array
) -> jax.Array:
    """Rank given pre-fetched transposed rows: milestone + masked popcount."""
    return milestone_t(index, rows_t, sym) + window_popcount_t(index, rows_t, pos, sym)


def fetch_rows_search_t(index: FmDeviceIndex, pos: jax.Array) -> jax.Array:
    """fetch_rows_t from the mark-free search copy when present (rank never
    reads mark words; 20% fewer bytes per nucleotide gather)."""
    blocks = index.blocks_search if index.blocks_search is not None else index.blocks
    block = (pos >> 8).astype(jnp.int32)
    return blocks[block].T


def occurrence(index: FmDeviceIndex, pos: jax.Array, sym: jax.Array) -> jax.Array:
    """Occ(pos, sym) = count of sym in BWT[0..=pos] (uint32 in/out)."""
    return occurrence_from_rows_t(index, fetch_rows_search_t(index, pos), pos, sym)


def prefix_sum_select(index: FmDeviceIndex, sym: jax.Array) -> jax.Array:
    """C[sym] via select chain (prefix sums are runtime values, so this one
    reads from the device array but only `cardinality` scalar rows)."""
    out = index.prefix_sums[0] * jnp.ones_like(sym, dtype=jnp.uint32)
    for k in range(1, index.alphabet.cardinality + 1):
        out = jnp.where(sym == k, index.prefix_sums[k], out)
    return out


def update_range(index: FmDeviceIndex, starts: jax.Array, ends: jax.Array, sym: jax.Array):
    """Batched LF-mapping range update (src/fm_index.rs:559-582): both
    endpoints ranked from ONE stacked gather+transpose.

    start >= 1 invariant (src/search.rs:43-48) means starts-1 never wraps.
    """
    b = starts.shape[0]
    pos = jnp.concatenate([starts - jnp.uint32(1), ends])
    sym2 = jnp.concatenate([sym, sym])
    occ = occurrence(index, pos, sym2)
    c = prefix_sum_select(index, sym)
    return c + occ[:b], c + occ[b:] - jnp.uint32(1)


def seed_range(index: FmDeviceIndex, sym: jax.Array):
    """Initial range for a single symbol (src/search.rs:43-48)."""
    ps = prefix_sum_select(index, sym)
    ps_next = prefix_sum_select(index, sym + 1)
    return ps, ps_next - jnp.uint32(1)


def symbol_code_t(index: FmDeviceIndex, rows_t: jax.Array, pos: jax.Array) -> jax.Array:
    """Bit-vector code of the BWT symbol at each row (src/bwt.rs:52-62),
    read out of already-fetched transposed rows."""
    local = pos & jnp.uint32(255)
    word = (local >> 5).astype(jnp.int32)
    bit = (local & jnp.uint32(31)).astype(jnp.uint32)
    code = jnp.zeros(pos.shape, dtype=jnp.int32)
    for v in range(index.num_planes):
        lane_word = select_rows(rows_t, v * 8, 8, word)
        code = code | (((lane_word >> bit) & jnp.uint32(1)).astype(jnp.int32) << v)
    return code


def symbol_at(index: FmDeviceIndex, pos: jax.Array) -> jax.Array:
    """Reconstruct BWT symbol indices at a batch of rows."""
    rows_t = fetch_rows_t(index, pos)
    c2i = code_to_index_table(index.alphabet)
    return select_u32(c2i, symbol_code_t(index, rows_t, pos)).astype(jnp.int32)


def backstep_from_rows_t(index: FmDeviceIndex, rows_t: jax.Array, pos: jax.Array) -> jax.Array:
    """One LF step per row given pre-fetched transposed rows
    (src/fm_index.rs:585-593); sentinel rows -> 0.

    Fused: the symbol read and its rank share ONE row fetch (the reference
    does symbol_at + global_occurrence as two block reads,
    src/fm_index.rs:586-591).
    """
    c2i = code_to_index_table(index.alphabet)
    sym = select_u32(c2i, symbol_code_t(index, rows_t, pos)).astype(jnp.int32)
    is_sentinel = sym == 0
    safe = jnp.where(is_sentinel, index.alphabet.ambiguity_idx, sym)
    occ = occurrence_from_rows_t(index, rows_t, pos, safe)
    stepped = prefix_sum_select(index, safe) + occ - jnp.uint32(1)
    return jnp.where(is_sentinel, jnp.uint32(0), stepped)


def backstep(index: FmDeviceIndex, pos: jax.Array) -> jax.Array:
    """One LF step per row (fetch + backstep_from_rows_t)."""
    return backstep_from_rows_t(index, fetch_rows_t(index, pos), pos)


# -- compatibility aliases used by the sharded engine ----------------------

def occurrence_from_rows(index, rows, pos, sym):
    """Row-major [..., row_words] variant (transposes internally)."""
    return occurrence_from_rows_t(index, jnp.moveaxis(rows, -1, 0), pos, sym)


def symbol_code_from_rows(index, rows, pos):
    return symbol_code_t(index, jnp.moveaxis(rows, -1, 0), pos)


def fetch_rows(index: FmDeviceIndex, pos: jax.Array) -> jax.Array:
    """Row-major fetch [..., row_words] (un-transposed)."""
    block = (pos >> 8).astype(jnp.int32)
    return index.blocks[block]
