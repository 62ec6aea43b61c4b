"""Seed-walk-verify: the fused count+locate serving path.

The classic path (ops/search.py + ops/locate.py) pays one rank step per
consumed symbol - ~17 steps for a 30 bp query after a k=13 seed, ~87 for
the 100 bp queries GRCh38 serving wants.  But on genome-scale indexes the
range collapses almost immediately: after S = kmer_len + 4 consumed
symbols the expected width is n / 4^S << 1, so almost every query is down
to a SINGLE candidate row.  This module stops the backward search at S,
walks that one row to its text position (the bounded marked walk), and
confirms the remaining qlen - S query symbols by comparing them directly
against the original packed text - replacing ~qlen - S rank steps with
one walk + one word-gather + static vector compares, and making locate
FREE for verified hits (the match position falls out of the walk).

The reference has no analog (its per-query loop always finishes the
search, src/fm_index.rs:402-438); this trade pays where every rank step is
a batch-wide dependent gather.  Results are exact:

* width == 0 at S, or qlen <= S: the search already finished; the range
  IS the final answer.
* width == 1 and qlen > S: the unique candidate for the query's last S
  symbols; the full query occurs iff the text just before the candidate
  suffix equals the query's remaining prefix (verified here).  Count is
  0/1, position p - (qlen - S).
* width >= 2 and qlen > S ("wide": repetitive seeds): flagged; the engine
  re-dispatches just those queries through the classic full-depth path.

Text layout: FmIndexData.text_packed - symbol indices at 4 bits
(cardinality <= 16) or 8 bits, little-endian within uint32 words, with
TEXT_PAD_WORDS zero words PREPENDED on device so the per-lane backward
window gather never clamps (zero = sentinel, which never matches a query
symbol; out-of-range distances are masked anyway).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .device_index import FmDeviceIndex
from .locate import lf_walk
from .search import counts_from_ranges, search_ranges_t

TEXT_PAD_WORDS = 64  # zero words prepended to the device text (device_index.py)


# Expected spurious candidates per lane at the search->walk handover.  Each
# +1 of allowed expectation costs wide-group slots (P(width >= 2) ~= the
# expectation for small values, and wide_groups budgets batch/16) but SAVES
# one batch-wide rank step per 4x: 0.06 cuts one step on chr20/chr1/GRCh38
# while E. coli and amino switch steps stay put.
SPURIOUS_TARGET = 0.06


def switch_step(index: FmDeviceIndex) -> int:
    """Consumed-symbol count at which the search hands over to the walk.

    Scale-aware: deep enough that the expected residual range width on
    random text, bwt_len / base^S, drops under SPURIOUS_TARGET — then the
    wide-lane fraction (~= that expectation for small values) stays inside
    the on-device wide_groups budget (batch/32) and classic-path
    redispatches are rare at every index scale.  A fixed ``kmer_len + 4``
    undershoots at GRCh38 scale (3.1e9 / 4^17 ~= 0.18 -> ~16% wide lanes,
    mass redispatch of 100 bp queries) and overshoots on small or amino
    indexes (wasted rank steps).  Never below the k-mer seed: the seed is
    a single gather, so stopping earlier saves nothing.
    """
    import math

    base = max(2, index.alphabet.cardinality - 2)  # dense searchable symbols
    need = math.ceil(math.log(max(2.0, index.bwt_len / SPURIOUS_TARGET), base))
    return max(2, index.kmer_len, need)


def _reverse_symbols(word: jax.Array, bits: int) -> jax.Array:
    """Reverse the symbol order within each uint32 word."""
    w = word
    if bits == 4:
        w = ((w & jnp.uint32(0x0F0F0F0F)) << 4) | ((w >> 4) & jnp.uint32(0x0F0F0F0F))
    # byte swap (bits == 8 needs only this)
    w = ((w & jnp.uint32(0x00FF00FF)) << 8) | ((w >> 8) & jnp.uint32(0x00FF00FF))
    return (w << 16) | (w >> 16)


def compare_text_suffixes_t(
    index: FmDeviceIndex, e: jax.Array, qt: jax.Array, qlens: jax.Array, s: int
) -> jax.Array:
    """True per lane iff text[e - d] == query symbol at distance d from the
    query end, for every d in [s, qlen).  e: uint32[B] anchor positions
    (position of the LAST already-matched symbol); qt int32[L, B]
    TRANSPOSED right-aligned queries, so the distance-d query symbol is the
    STATIC row L-1-d.

    Two backends for the K-word backward window read; then funnel
    alignment into per-distance static slots and L-s static vector
    compares - no per-lane dynamic indexing anywhere:

    * ``text_rows8`` (present unless the engine is lean): ONE row gather
      from the pre-symbol-reversed, stride-4 overlapping 8-word-row text
      layout (device_index.py) + per-lane select chains over the 8 words.
      Covers windows up to 5 words (any 5 consecutive words fit one
      stride-4 row).
    * flat element gather, one per window word.
    """
    bits = 4 if index.alphabet.cardinality <= 16 else 8
    spw = 32 // bits
    lg = 3 if bits == 4 else 2
    L = qt.shape[0]
    # Only distances d in [s, L) are compared (the search already matched
    # the last s symbols), so only backward words jlo..jhi around e are
    # needed: aligned[d//spw] reads rev[j] and rev[j+1] for j = d//spw.
    jlo = s // spw
    jhi = (L - 1) // spw + 1
    if jhi > TEXT_PAD_WORDS:
        raise ValueError(f"padded query length {L} exceeds verify window")

    # rev_at(j) is the symbol-reversed text word at index (e>>lg) - j.
    K = jhi - jlo + 1
    if index.text_rows8 is not None and K <= 5:
        # Window words w in [wb-jhi, wb-jlo]; the stride-4 row r covers
        # words [4r, 4r+8), and (a & 3) + K <= 3 + 5 <= 8 guarantees the
        # whole window sits in row (a >> 2) for a = wb - jhi.
        wb = (e >> lg) + jnp.uint32(TEXT_PAD_WORDS)
        a = wb - jnp.uint32(jhi)
        rows_t = index.text_rows8[(a >> 2).astype(jnp.int32)].T  # [8, B]
        o = (a & jnp.uint32(3)).astype(jnp.int32)

        def rev_at(j):
            idx = o + (jhi - j)  # in [0, 7]
            out = rows_t[0]
            for t in range(1, 8):
                out = jnp.where(idx == t, rows_t[t], out)
            return out

    else:
        w_base = (e >> lg).astype(jnp.int32) + TEXT_PAD_WORDS
        cols = jnp.arange(jlo, jhi + 1, dtype=jnp.int32)  # ascending j
        words = index.text_packed[w_base[:, None] - cols[None, :]]  # [B, K]
        rev = _reverse_symbols(words, bits)

        def rev_at(j):
            return rev[:, j - jlo]

    # Align so distance d sits at slot d: a = spw-1 - (e % spw) symbols of
    # lead-in to drop from the reversed stream.
    a_sh = (jnp.uint32(spw - 1) - (e & jnp.uint32(spw - 1))).astype(jnp.uint32)
    sh = (a_sh * bits).astype(jnp.uint32)
    aligned = {}
    for j in range(jlo, jhi):
        lo = rev_at(j) >> sh
        hi = jnp.where(sh == 0, jnp.uint32(0), rev_at(j + 1) << (jnp.uint32(32) - sh))
        aligned[j] = lo | hi

    mask_sym = jnp.uint32((1 << bits) - 1)
    ok = jnp.ones(e.shape, dtype=bool)
    for d in range(s, L):
        tsym = (aligned[d // spw] >> jnp.uint32(bits * (d % spw))) & mask_sym
        qsym = qt[L - 1 - d].astype(jnp.uint32)
        ok = ok & ((tsym == qsym) | (d >= qlens))
    return ok


def compare_text_suffixes(
    index: FmDeviceIndex, e: jax.Array, qsyms: jax.Array, qlens: jax.Array, s: int
) -> jax.Array:
    """Row-major [B, L] compat wrapper over compare_text_suffixes_t."""
    return compare_text_suffixes_t(index, e, qsyms.T.astype(jnp.int32), qlens, s)


WIDE_CAP = 4  # candidate rows verified per wide lane inside the fused kernel


def wide_groups(batch: int) -> int:
    """Compacted wide-lane budget: lanes whose step-``s`` range is 2..WIDE_CAP
    wide are settled on device through this many group slots (~6% of the
    batch matches SPURIOUS_TARGET's wide-lane rate with headroom; overflow
    just falls back to the classic redispatch)."""
    return max(16, batch // 16)


def count_locate_verify(
    index: FmDeviceIndex, qsyms: jax.Array, qlens: jax.Array, s: int
):
    """Row-major [B, L] compat wrapper over count_locate_verify_t."""
    return count_locate_verify_t(index, qsyms.T.astype(jnp.int32), qlens, s)


def count_locate_verify_t(
    index: FmDeviceIndex, qt: jax.Array, qlens: jax.Array, s: int, *, no_sentinel: bool = False
):
    """Fused seed-walk-verify count+locate in one device dispatch.
    qt: int32[L, B] TRANSPOSED right-aligned queries (wire unpackers emit
    this layout directly; ops/search.py); qlens: integer[B] (int32
    canonical; the engine's uint8 length wire promotes safely).

    Returns ``(bundle, starts, ends)``; ``bundle`` is a single packed u8
    buffer (one host transfer; see unpack_verify_bundle) carrying:

    * counts (7-bit clamp): exact for every lane with redis False; lanes
      with count == 1, qlen > s and not wide-settled have their (unique)
      global match position in pos.
    * redis bool[B]: lanes the caller must re-dispatch through the classic
      full-depth path — ranges wider than WIDE_CAP at step ``s`` (or wide
      lanes past the group budget), and qlen <= s lanes with hits (exact
      count but unwalked positions); their clamped counts are discarded.
    * Wide lanes with width 2..WIDE_CAP are settled HERE: their candidate
      rows are compacted into ``wide_groups(B)`` groups of WIDE_CAP slots
      and verified alongside the singleton lanes.  lane_g maps group ->
      lane (>= B = empty); ok_slot marks verified slots (in BWT-row order,
      the reference's hit order, src/fm_index.rs:521); pos_slot their
      positions.
    * (starts, ends): the step-``s`` device ranges (never transferred).
    """
    starts, ends = search_ranges_t(index, qt, qlens, num_steps=s, no_sentinel=no_sentinel)
    width = counts_from_ranges(starts, ends)
    long_enough = qlens > s
    candidate = (width == 1) & long_enough
    wide = (width >= 2) & long_enough

    B = starts.shape[0]
    G = wide_groups(B)

    # Compact wide lanes (width <= WIDE_CAP) into group slots: group g's
    # lane is the g-th fitting lane = first index where the running count
    # reaches g+1 (searchsorted over the monotone cumsum; keys past the
    # total return B = "empty group").  This form never scatters the whole
    # batch onto one dump slot, and stops over-WIDE_CAP lanes from burning
    # group slots.
    fitsable = wide & (width <= WIDE_CAP)
    csum = jnp.cumsum(fitsable.astype(jnp.int32))
    lane_of_group = jnp.searchsorted(
        csum, jnp.arange(1, G + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    valid_g = lane_of_group < B
    lane_safe = jnp.where(valid_g, lane_of_group, 0)
    # Empty groups read row 0; their slots are discarded.
    g_start = jnp.where(valid_g, starts[lane_safe], jnp.uint32(0))
    g_width = jnp.where(valid_g, width[lane_safe], jnp.uint32(0))
    jslot = jnp.arange(WIDE_CAP, dtype=jnp.uint32)
    slot_valid = jslot[None, :] < g_width[:, None]  # [G, WIDE_CAP]
    # Invalid slots repeat the group's base row (a valid row to read).
    jclip_g = jnp.minimum(jslot[None, :], jnp.maximum(g_width, jnp.uint32(1))[:, None] - 1)
    slot_rows = g_start[:, None] + jclip_g

    # One shared walk + text compare treatment for singleton lanes and wide
    # slots - but compared SEPARATELY: concatenating the repeated slot
    # queries onto qt materializes a second full-batch [L, B+4G] matrix,
    # and each group's WIDE_CAP slots share one query anyway (the [G, CAP]
    # slot compare broadcasts one query read per group).  Empty ranges can
    # start at bwt_len: clamp to a readable row (their results are unused).
    rows_main = jnp.minimum(starts, jnp.uint32(index.bwt_len - 1))
    qt_g = qt[:, lane_safe]  # [L, G]
    l_g = qlens[lane_safe]
    rows_all = jnp.concatenate([rows_main, slot_rows.reshape(-1)])

    L = qt.shape[0]
    bits = 4 if index.alphabet.cardinality <= 16 else 8
    spw = 32 // bits
    use_fat = (
        index.verify_windows is not None
        and index.verify_windows_s == s
        and L <= s + spw * index.verify_windows_w
    )
    if use_fat:
        # Fat-row path: ONE gather serves the SA value AND the pre-aligned
        # text window (see FmDeviceIndex.verify_windows) - no LF-walk, no
        # second gather, no funnel.
        mask_sym = jnp.uint32((1 << bits) - 1)
        w = index.verify_windows_w
        fat_all = index.verify_windows[rows_all.astype(jnp.int32)]
        fat_t = fat_all[:B].T  # [row words, B]
        fat_g = fat_all[B:].reshape(G, WIDE_CAP, -1)
        p = fat_t[w]
        matches = jnp.ones(rows_main.shape, dtype=bool)
        p_slot = fat_g[:, :, w]
        ok_slot_cmp = jnp.ones(slot_rows.shape, dtype=bool)
        for d in range(s, L):
            i, t = (d - s) // spw, (d - s) % spw
            sh = jnp.uint32(bits * t)
            qsym = qt[L - 1 - d].astype(jnp.uint32)
            matches = matches & (
                (((fat_t[i] >> sh) & mask_sym) == qsym) | (d >= qlens)
            )
            qsym_g = qt_g[L - 1 - d].astype(jnp.uint32)[:, None]
            ok_slot_cmp = ok_slot_cmp & (
                (((fat_g[:, :, i] >> sh) & mask_sym) == qsym_g) | (d >= l_g)[:, None]
            )
    else:
        p_all = lf_walk(index, rows_all)
        p = p_all[:B]
        p_slot = p_all[B:].reshape(G, WIDE_CAP)
        e_all = p_all + jnp.uint32(s - 1)
        qt_all = jnp.concatenate(
            [qt, jnp.repeat(qt_g, WIDE_CAP, axis=1)], axis=1
        )
        l_all = jnp.concatenate([qlens, jnp.repeat(l_g, WIDE_CAP)])
        ok_all = compare_text_suffixes_t(index, e_all, qt_all, l_all, s)
        matches = ok_all[:B]
        ok_slot_cmp = ok_all[B:].reshape(G, WIDE_CAP)

    rem = jnp.where(long_enough, qlens - s, 0).astype(jnp.uint32)
    rem_g = rem[lane_safe]
    verified = candidate & matches & (p >= rem)
    ok_slot = ok_slot_cmp & slot_valid & (p_slot >= rem_g[:, None])
    pos_slot = p_slot - rem_g[:, None]
    wide_counts = ok_slot.sum(axis=1).astype(jnp.uint32)  # [G]

    # Scatter wide-group results back to lanes (dump index B for empties).
    lane_or_dump = jnp.where(valid_g, lane_of_group, B)
    settled_w = (
        jnp.zeros((B + 1,), dtype=bool).at[lane_or_dump].set(valid_g)[:B]
    )
    counts_w = (
        jnp.zeros((B + 1,), dtype=jnp.uint32).at[lane_or_dump].set(wide_counts)[:B]
    )
    counts = jnp.where(candidate, verified.astype(jnp.uint32), width)
    counts = jnp.where(settled_w, counts_w, counts)
    redis = (wide & ~settled_w) | ((counts > 0) & ~long_enough)
    text_pos = p - rem

    # Pack every host-bound result into ONE buffer: one device->host copy
    # per batch instead of six, and redis lanes' counts are recomputed
    # anyway so a small clamp loses nothing (non-redis counts are exact and
    # <= WIDE_CAP).
    bundle = _pack_result_bundle(index, text_pos, counts, redis, lane_or_dump, pos_slot, ok_slot)
    return bundle, starts, ends


def _packed_bundle(index: FmDeviceIndex) -> bool:
    """u32-per-lane bundle mode: positions fit 28 bits and exact non-redis
    counts (<= WIDE_CAP) fit 3."""
    return index.bwt_len < (1 << 28) and WIDE_CAP <= 7


def _pack_result_bundle(index, text_pos, counts, redis, lane_of_group, pos_slot, ok_slot):
    """Pack (lane words + wide meta) into the single host-bound buffer (see
    count_locate_verify_t's bundle doc; unpack_verify_bundle is the host
    mirror)."""
    okbits = (
        ok_slot.astype(jnp.uint32) << jnp.arange(WIDE_CAP, dtype=jnp.uint32)[None, :]
    ).sum(axis=1, dtype=jnp.uint32)
    wide_meta = jnp.concatenate(
        [lane_of_group.astype(jnp.uint32)[:, None], pos_slot, okbits[:, None]], axis=1
    )  # [G, 2 + WIDE_CAP]
    if _packed_bundle(index):
        # One u32 per lane: [28b pos | 3b count | 1b redis] - 20% less
        # result wire than the split pos+flags form, and no byte-level
        # relayouts packing it.
        lane_words = (
            (text_pos & jnp.uint32(0x0FFFFFFF))
            | (jnp.minimum(counts, jnp.uint32(7)) << 28)
            | (redis.astype(jnp.uint32) << 31)
        )
        return jnp.concatenate([lane_words, wide_meta.reshape(-1)])
    flags = (
        jnp.minimum(counts, jnp.uint32(127)).astype(jnp.uint8)
        | (redis.astype(jnp.uint8) << 7)
    )
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(text_pos, jnp.uint8).reshape(-1),
            flags,
            jax.lax.bitcast_convert_type(wide_meta, jnp.uint8).reshape(-1),
        ]
    )


def unpack_verify_bundle(bundle: "np.ndarray", batch: int, groups: int):
    """Host-side view of count_locate_verify's packed result buffer (u32
    lane-word mode when the buffer dtype is uint32, else the split
    pos+flags u8 mode; the device picked per _packed_bundle).

    Returns (pos uint32[B], counts int64[B], redis bool[B], lane_g int64[G],
    pos_slot uint32[G, WIDE_CAP], ok_slot bool[G, WIDE_CAP])."""
    import numpy as np

    if bundle.dtype == np.uint32:
        lane_words = bundle[:batch]
        pos = lane_words & np.uint32(0x0FFFFFFF)
        counts = ((lane_words >> 28) & 7).astype(np.int64)
        redis = (lane_words >> 31).astype(bool)
        meta = bundle[batch:].reshape(groups, 2 + WIDE_CAP)
    else:
        b4 = 4 * batch
        pos = bundle[:b4].view(np.uint32)
        flags = bundle[b4 : b4 + batch]
        meta = bundle[b4 + batch :].view(np.uint32).reshape(groups, 2 + WIDE_CAP)
        counts = (flags & 0x7F).astype(np.int64)
        redis = (flags >> 7).astype(bool)
    lane_g = meta[:, 0].astype(np.int64)
    pos_slot = meta[:, 1 : 1 + WIDE_CAP]
    ok_slot = ((meta[:, 1 + WIDE_CAP][:, None] >> np.arange(WIDE_CAP)) & 1).astype(bool)
    return pos, counts, redis, lane_g, pos_slot, ok_slot


def unpack_verify_bundle_sharded(bundle: "np.ndarray", batch: int, shards: int):
    """Unpack a data-sharded verify dispatch's result buffer.

    Under shard_map (FmQueryEngine(mesh=...)) each device packs its OWN
    bundle over its local batch/shards lanes; out_specs concatenate them.
    This splits per device, unpacks each, rebases the wide-group lane ids
    to global lane numbers (empties -> batch), and concatenates — callers
    see exactly unpack_verify_bundle's contract for the global batch."""
    import numpy as np

    bl = batch // shards
    gl = wide_groups(bl)
    chunk = bundle.shape[0] // shards
    parts = [
        unpack_verify_bundle(bundle[i * chunk : (i + 1) * chunk], bl, gl)
        for i in range(shards)
    ]
    pos = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    redis = np.concatenate([p[2] for p in parts])
    lane_g = np.concatenate(
        [np.where(p[3] < bl, p[3] + i * bl, batch) for i, p in enumerate(parts)]
    )
    pos_slot = np.concatenate([p[4] for p in parts])
    ok_slot = np.concatenate([p[5] for p in parts])
    return pos, counts, redis, lane_g, pos_slot, ok_slot
