"""Batched backward search on device.

The reference's per-query scalar loop (get_search_range_for_string,
src/fm_index.rs:402-438) becomes one `lax.fori_loop` over the padded query
length with an active-mask per lane, vectorized over the whole batch: each
step performs one stacked rank gather (start-1 and end together) for every
live query.

Query layout: RIGHT-ALIGNED [B, L] symbol matrices (encode_query_batch).
Backward search consumes characters from the end, so right alignment makes
"the symbol at distance i from the end" a STATIC column L-1-i - each loop
step is a plain row read of the transposed [L, B] matrix, with no per-lane
dynamic indexing anywhere in the loop.

The k-mer lookup table supplies the seed range - skipping the first k
steps - whenever a query's last k symbols are all encoding symbols, which
is exactly when a table entry exists (and equals the recomputed range, so
results are identical to the reference's always-recompute path; SURVEY.md
2.3 quirk #1).

Masking invariants that make the fixed-shape loop exact:
* updating an empty range keeps it empty, and `start >= 1` persists, so
  lanes frozen by the early-exit mask still compute safely;
* pad symbols are never consumed because the mask requires step < len.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import index_to_dense_table
from .device_index import FmDeviceIndex
from .rank import seed_range, update_range


def _select_i32(table, idx: jax.Array) -> jax.Array:
    out = jnp.full(idx.shape, np.int32(table[0]), dtype=jnp.int32)
    for k in range(1, len(table)):
        out = jnp.where(idx == k, np.int32(table[k]), out)
    return out


def unpack_crumbs_t(qpacked: jax.Array, dense_to_index) -> jax.Array:
    """Expand a crumb-packed (2-bit) query matrix int8[B, L//4] to the
    TRANSPOSED int32[L, B] symbol matrix on device (crumb j of a byte at
    bits 2j = column 4*byte + j).  The wire format for nucleotide batches
    whose in-range symbols are all dense encoding symbols (A/C/G/T): 2
    bits halve the upload again vs the nibble wire.

    Transposed output, built as L static row extracts over [B] lane
    vectors: every downstream consumer (search step columns, verify's
    per-distance compares) reads ROWS of the [L, B] form, and producing
    [B, L] first costs a 16 MB relayout plus an element-gather LUT pass.
    ``dense_to_index``
    (static int8[num_encoding_symbols], A,C,G,T -> 1,2,3,5) is applied as
    a where-select chain; padding crumbs decode to 'A' and are masked by
    qlens everywhere downstream."""
    w = jax.lax.bitcast_convert_type(qpacked, jnp.uint8).T  # [L//4, B]
    lut = [int(v) for v in np.asarray(dense_to_index)]
    rows = []
    for j in range(qpacked.shape[1] * 4):
        d = ((w[j // 4] >> jnp.uint8(2 * (j % 4))) & jnp.uint8(3)).astype(jnp.int32)
        out = jnp.full(d.shape, np.int32(lut[0]), dtype=jnp.int32)
        for k in range(1, len(lut)):
            out = jnp.where(d == k, np.int32(lut[k]), out)
        rows.append(out)
    return jnp.stack(rows, axis=0)


def unpack_nibbles_t(qpacked: jax.Array) -> jax.Array:
    """Expand a nibble-packed query matrix uint8[B, L//2] (low nibble =
    even column) to the TRANSPOSED int32[L, B] symbol matrix on device.
    The wire format for alphabets with cardinality <= 16 (nucleotide):
    symbols ship at 4 bits to cut host->device query bytes.  Transposed output for the same reason as
    unpack_crumbs_t."""
    w = qpacked.T  # [L//2, B]
    rows = []
    for j in range(qpacked.shape[1] * 2):
        half = w[j // 2]
        rows.append(
            ((half >> jnp.uint8(4)) if j % 2 else (half & jnp.uint8(0xF))).astype(jnp.int32)
        )
    return jnp.stack(rows, axis=0)


def unpack_crumbs(qpacked: jax.Array, dense_to_index) -> jax.Array:
    """[B, L] int8 view of unpack_crumbs_t (compat for row-major callers)."""
    return unpack_crumbs_t(qpacked, dense_to_index).T.astype(jnp.int8)


def unpack_nibbles(qpacked: jax.Array) -> jax.Array:
    """[B, L] int8 view of unpack_nibbles_t (compat for row-major callers)."""
    return unpack_nibbles_t(qpacked).T.astype(jnp.int8)


def search_ranges(
    index: FmDeviceIndex,
    qsyms: jax.Array,
    qlens: jax.Array,
    *,
    update_fn=None,
    num_steps: int | None = None,
):
    """Backward-search a batch of queries to their final BWT ranges.

    Args:
      qsyms: int32[B, L] RIGHT-ALIGNED symbol indices (pad on the left).
      qlens: integer[B] true query lengths (0 allowed -> empty range).
        Canonically int32; the engine wire ships uint8 for <=255-symbol
        batches and any integer dtype promotes safely at the comparison
        seams.
      update_fn: optional (starts, ends, sym) -> (starts, ends) override for
        the LF-mapping step; used by the range-sharded collective path.
        Defaults to rank.update_range.
      num_steps: optional static cap on consumed symbols (from the query
        end); the seed-walk-verify path (ops/verify.py) stops the search
        after a few post-seed steps.  Queries shorter than the cap still
        finish exactly (the active mask freezes them at their length).

    Returns:
      (starts, ends): uint32[B] inclusive ranges; empty iff start > end.
    """
    # Accept int8 wire format; widen once on device.
    qt = qsyms.T.astype(jnp.int32)  # [L, B]; row L-1-i = symbol at distance i from the end
    return search_ranges_t(index, qt, qlens, update_fn=update_fn, num_steps=num_steps)


def search_ranges_t(
    index: FmDeviceIndex,
    qt: jax.Array,
    qlens: jax.Array,
    *,
    update_fn=None,
    num_steps: int | None = None,
    no_sentinel: bool = False,
):
    """search_ranges over the TRANSPOSED query matrix int32[L, B] (batch in
    lanes) - the native layout of the device hot path: the wire unpackers
    emit it directly and every step reads a static row.

    ``no_sentinel`` (static): the caller guarantees qt contains no sentinel
    symbols (true for the crumb wire, which cannot encode one), skipping
    the whole-matrix sentinel scan."""
    if update_fn is None:
        update_fn = lambda s, e, sym: update_range(index, s, e, sym)  # noqa: E731
    L, B = qt.shape

    last_sym = qt[L - 1]
    s0, e0 = seed_range(index, last_sym)
    steps_done = jnp.ones((B,), dtype=jnp.int32)

    k = index.kmer_len
    if k > 0 and L >= k:
        # Dense radix address over the last k symbols (host layout:
        # awry_tpu/host_engine._kmer_address).  Row L-1-j holds the symbol
        # at distance j from the end, weighted base**j.
        dense_table = index_to_dense_table(index.alphabet)
        base = index.alphabet.num_encoding_symbols
        addr = jnp.zeros((B,), dtype=jnp.int32)
        all_dense = qlens >= k
        for j in range(k):
            d = _select_i32(dense_table, qt[L - 1 - j])
            all_dense = all_dense & (d >= 0)
            addr = addr + jnp.maximum(d, 0) * np.int32(base**j)
        seeded = index.kmer_table[addr]  # [B, 2] gather, once per batch
        s0 = jnp.where(all_dense, seeded[:, 0], s0)
        e0 = jnp.where(all_dense, seeded[:, 1], e0)
        steps_done = jnp.where(all_dense, jnp.int32(k), steps_done)

    def step(i, starts, ends, active):
        sym = jax.lax.dynamic_index_in_dim(qt, L - 1 - i, axis=0, keepdims=False)
        new_starts, new_ends = update_fn(starts, ends, sym)
        return (jnp.where(active, new_starts, starts),
                jnp.where(active, new_ends, ends))

    def body(i, carry):
        starts, ends = carry
        active = (i >= steps_done) & (i < qlens) & (starts <= ends)
        # Steps where NO lane is live (everything seeded past i, exhausted,
        # or empty) skip the rank work entirely - with k-mer seeding the
        # first k-1 loop steps are all skipped this way.
        return jax.lax.cond(
            jnp.any(active), lambda: step(i, starts, ends, active), lambda: (starts, ends)
        )

    def body_seeded(i, carry):
        # Every lane k-mer-seeded: no per-step any(active) reduce + cond -
        # the where-mask alone keeps frozen lanes exact (empty ranges stay
        # empty under update; start >= 1 persists).
        starts, ends = carry
        return step(i, starts, ends, (i < qlens) & (starts <= ends))

    upper = L if num_steps is None else min(L, num_steps)
    if upper > 1:
        if k > 1 and L >= k and upper > k:
            # When EVERY lane k-mer-seeded (one reduce), start the loop at
            # step k and drop the per-step reductions; otherwise take the
            # generic masked loop.  Branch resolved on device.
            s0, e0 = jax.lax.cond(
                jnp.all(all_dense),
                lambda a, b: jax.lax.fori_loop(k, upper, body_seeded, (a, b)),
                lambda a, b: jax.lax.fori_loop(1, upper, body, (a, b)),
                s0, e0,
            )
        else:
            s0, e0 = jax.lax.fori_loop(1, upper, body, (s0, e0))

    # Zero-length queries yield the canonical empty range (start=1, end=0,
    # src/search.rs:51-56).  Queries containing the sentinel symbol do too:
    # the reference's behavior there is UB (global_occurrence panics/OOBs on
    # sentinel search, src/bwt.rs:128-129,261-265), so searching '$'/'#'
    # returns "no matches" instead of silently computing garbage ranks
    # (PARITY.md divergence #7).
    if no_sentinel:
        invalid = qlens <= 0
    else:
        col = jax.lax.broadcasted_iota(jnp.int32, (L, 1), 0)
        in_query = col >= (jnp.int32(L) - qlens)[None, :]
        has_sentinel = jnp.any((qt == 0) & in_query, axis=0)
        invalid = (qlens <= 0) | has_sentinel
    starts = jnp.where(invalid, jnp.uint32(1), s0)
    ends = jnp.where(invalid, jnp.uint32(0), e0)
    return starts, ends


def counts_from_ranges(starts: jax.Array, ends: jax.Array) -> jax.Array:
    """Range length (src/search.rs:66-71); 0 for empty ranges."""
    return jnp.where(starts <= ends, ends - starts + jnp.uint32(1), jnp.uint32(0))


def count_batch_kernel(index: FmDeviceIndex, qsyms: jax.Array, qlens: jax.Array) -> jax.Array:
    starts, ends = search_ranges(index, qsyms, qlens)
    return counts_from_ranges(starts, ends)


def count_batch_kernel_t(
    index: FmDeviceIndex, qt: jax.Array, qlens: jax.Array, *, no_sentinel: bool = False
) -> jax.Array:
    starts, ends = search_ranges_t(index, qt, qlens, no_sentinel=no_sentinel)
    return counts_from_ranges(starts, ends)
