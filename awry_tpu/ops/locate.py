"""Batched locate: LF-walk to sampled positions, on device.

The reference walks each BWT row with a data-dependent scalar loop until it
hits a ROW-sampled entry (src/fm_index.rs:516-544); row sampling makes walk
lengths geometric with an unbounded tail, and a lock-step batched walk pays
the batch MAXIMUM (~ln(B)/ln(r/(r-1)) trips - measured ~57 full-batch
backsteps for 256k rows at r=8).

The device engine therefore walks to TEXT-sampled positions instead: rows
whose SA value is a multiple of sa_ratio are MARKED (mark bits + mark
milestone live in the same fused block row as the rank data, so checking
the mark costs nothing extra), and walking backward decrements the text
position by one per step, so a marked row is reached within sa_ratio-1
steps - a deterministic bound, turning the while-loop into a short fori
loop.  The recovered text position is identical to the reference's
(pos = sampled_value + steps), so results stay bit-exact; the row-sampled
array is still built and persisted for .awry format parity, and indexes
loaded without mark data (e.g. from AWRY's own files) fall back to the
row-sampled walk.

Ragged per-query outputs are handled two-phase (count -> offsets -> flat
fill), the count-then-fill plan from SURVEY.md section 7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .device_index import FmDeviceIndex
from .rank import backstep, backstep_from_rows_t, fetch_rows_t, select_rows

_FULL = 0xFFFFFFFF


def _text_pos_mod(sa_vals: jax.Array, steps: jax.Array, bwt_len: int) -> jax.Array:
    """(sa_vals + steps) % bwt_len in uint32 WITHOUT 2**32 wraparound bugs.

    Both operands are < bwt_len (walk length < bwt_len; SA values < bwt_len),
    so the true sum is < 2*bwt_len and the modulo is a single conditional
    subtraction - but for bwt_len near 2**32 the uint32 sum itself can wrap.
    When it wraps, true_sum = r + 2**32 >= bwt_len, and r - bwt_len in uint32
    equals true_sum - bwt_len exactly; so one wrap-aware select is exact.
    """
    bl = jnp.uint32(bwt_len)
    r = sa_vals + steps
    wrapped = r < sa_vals
    return jnp.where(wrapped | (r >= bl), r - bl, r)


def _mark_bit_t(index: FmDeviceIndex, rows_t: jax.Array, pos: jax.Array) -> jax.Array:
    """1 where the row's SA value is text-sampled (mark bits in the fused row)."""
    local = pos & jnp.uint32(255)
    word = (local >> 5).astype(jnp.int32)
    bit = (local & jnp.uint32(31)).astype(jnp.uint32)
    lane_word = select_rows(rows_t, index.mark_offset, 8, word)
    return (lane_word >> bit) & jnp.uint32(1)


def _mark_rank_t(index: FmDeviceIndex, rows_t: jax.Array, pos: jax.Array) -> jax.Array:
    """Number of marked rows strictly before `pos` within the whole BWT:
    mark milestone + exclusive masked popcount of the block's mark words."""
    local = (pos & jnp.uint32(255)).astype(jnp.uint32)
    word = (local >> 5)[None, :]
    lane = jax.lax.broadcasted_iota(jnp.uint32, (8, 1), 0)
    # Exclusive mask: bits [0, local) of the 256-bit mark window.
    in_word = ((jnp.uint32(1) << (local & jnp.uint32(31))) - jnp.uint32(1))[None, :]
    mask = jnp.where(lane < word, jnp.uint32(_FULL), jnp.where(lane == word, in_word, jnp.uint32(0)))
    marks = rows_t[index.mark_offset : index.mark_offset + 8]
    pop = jax.lax.population_count(marks & mask).sum(axis=0, dtype=jnp.uint32)
    return rows_t[index.mark_offset + 8] + pop


def _marked_walk(index: FmDeviceIndex, rows: jax.Array) -> jax.Array:
    """Deterministically bounded walk to text-sampled rows; returns text_pos."""

    def body(_, carry):
        rw, steps, done = carry
        rows_t = fetch_rows_t(index, rw)
        now_marked = _mark_bit_t(index, rows_t, rw) == 1
        done_now = done | now_marked
        stepped = backstep_from_rows_t(index, rows_t, rw)
        rw = jnp.where(done_now, rw, stepped)
        steps = steps + jnp.where(done_now, jnp.uint32(0), jnp.uint32(1))
        return rw, steps, done_now

    steps0 = jnp.zeros_like(rows)
    done0 = jnp.zeros(rows.shape, dtype=bool)
    # A marked row is reached within mark_ratio - 1 steps (text positions
    # decrement by one per step and every mark_ratio-th position is marked).
    walked, steps, _ = jax.lax.fori_loop(0, index.mark_ratio - 1, body, (rows, steps0, done0))

    final_rows_t = fetch_rows_t(index, walked)
    idx = _mark_rank_t(index, final_rows_t, walked).astype(jnp.int32)
    sa_vals = index.text_sampled_sa[idx]
    return _text_pos_mod(sa_vals, steps, index.bwt_len)


def _row_sampled_walk(index: FmDeviceIndex, rows: jax.Array, backstep_fn) -> jax.Array:
    """Reference-style walk to row-sampled entries (fallback when mark data
    is unavailable, and for collective backstep overrides)."""
    r = jnp.uint32(index.sa_ratio)

    def unsampled(rw):
        return rw % r != 0

    def cond(carry):
        rw, _ = carry
        return jnp.any(unsampled(rw))

    def body(carry):
        rw, steps = carry
        live = unsampled(rw)
        stepped = backstep_fn(rw)
        rw = jnp.where(live, stepped, rw)
        steps = steps + live.astype(jnp.uint32)
        return rw, steps

    steps0 = jnp.zeros_like(rows)
    walked, steps = jax.lax.while_loop(cond, body, (rows, steps0))
    sa_vals = index.sampled_sa[(walked // r).astype(jnp.int32)]
    return _text_pos_mod(sa_vals, steps, index.bwt_len)


def lf_walk(index: FmDeviceIndex, rows: jax.Array, *, backstep_fn=None) -> jax.Array:
    """Walk each BWT row to its recovered text position.

    rows: uint32[N] -> text_pos uint32[N].  Uses the bounded marked walk
    when the index carries mark data and no backstep override is given.
    """
    if backstep_fn is None and index.has_marks and index.mark_ratio == 1:
        # Every row is marked and mark_rank(row) == row: the walk is one
        # SA read (text_sampled_sa is the full inverse-permuted SA), as an
        # 8-word-row gather + select where marked_sa8 ships.
        if index.marked_sa8 is not None:
            rows8_t = index.marked_sa8[(rows >> 3).astype(jnp.int32)].T  # [8, N]
            return select_rows(rows8_t, 0, 8, (rows & jnp.uint32(7)).astype(jnp.int32))
        return index.text_sampled_sa[rows]
    if backstep_fn is None and index.has_marks:
        return _marked_walk(index, rows)
    if backstep_fn is None:
        backstep_fn = lambda rw: backstep(index, rw)  # noqa: E731
    return _row_sampled_walk(index, rows, backstep_fn)


def count_locate_capped(index: FmDeviceIndex, qsyms: jax.Array, qlens: jax.Array, cap: int):
    """Row-major [B, L] compat wrapper over count_locate_capped_t."""
    return count_locate_capped_t(index, qsyms.T.astype(jnp.int32), qlens, cap)


def count_locate_capped_t(
    index: FmDeviceIndex, qt: jax.Array, qlens: jax.Array, cap: int, *, no_sentinel: bool = False
):
    """Fused count + locate in ONE device dispatch, up to `cap` hits/query.
    qt: int32[L, B] TRANSPOSED right-aligned queries (ops/search.py);
    qlens: integer[B] (int32 canonical; the engine's uint8 length wire
    promotes safely — see ops/search.py search_ranges).

    Returns (counts uint32[B], text_pos uint32[B, cap]); entries beyond
    counts[b] are meaningless.  Queries with more than `cap` hits report
    their true count; the engine re-runs just those through the unbounded
    flat path.  This collapses the reference's search-then-per-row-walk
    (src/fm_index.rs:516-544) into a single fused kernel - no host round
    trip between the range search and the LF-walk.  Global->(record, local)
    mapping happens on the host (a trivial searchsorted), keeping the
    device->host payload at one uint32 per hit.
    """
    from .search import counts_from_ranges, search_ranges_t

    starts, ends = search_ranges_t(index, qt, qlens, no_sentinel=no_sentinel)
    counts = counts_from_ranges(starts, ends)
    b = starts.shape[0]
    offs = jnp.arange(cap, dtype=jnp.uint32)
    rows = starts[:, None] + offs[None, :]  # [B, cap]
    valid = offs[None, :] < jnp.minimum(counts, jnp.uint32(cap))[:, None]
    flat_rows = jnp.where(valid, rows, jnp.uint32(0)).reshape(-1)  # row 0 is sampled
    text_pos = lf_walk(index, flat_rows)
    # Ranges ride along so over-cap queries can expand rows host-side and go
    # straight to lf_walk without a second range-search dispatch.
    return counts, text_pos.reshape(b, cap), starts, ends
