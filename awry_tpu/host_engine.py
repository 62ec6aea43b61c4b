"""Host-side (NumPy) FM-index query engine.

The correctness anchor of the framework (SURVEY.md section 7, build-order
step 1): a fully vectorized NumPy implementation of the windowed-BWT rank,
backward search, count and locate with semantics pinned bit-for-bit to the
reference (src/fm_index.rs:402-593, src/bwt.rs:110-271).  Every device
engine (single-device, sharded, wide) is tested against this module, and this module
is tested against a brute-force text-scan oracle.

It is also a practical CPU fallback and is what populates the k-mer lookup
table at build time.
"""

from __future__ import annotations

import numpy as np

from .alphabet import (
    Alphabet,
    code_to_index_table,
    encode_ascii,
    index_to_code_table,
    index_to_dense_table,
)
from .index import FmIndexData

_FULL = np.uint32(0xFFFFFFFF)

if hasattr(np, "bitwise_count"):  # NumPy >= 2.0
    _popcount_u32 = np.bitwise_count
else:  # byte-LUT fallback so the correctness anchor works on NumPy 1.x
    _POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)

    def _popcount_u32(a: np.ndarray) -> np.ndarray:
        b = np.ascontiguousarray(a).view(np.uint8)
        return _POP8[b].reshape(a.shape + (4,)).sum(axis=-1, dtype=np.uint32)


def occurrence(index: FmIndexData, pos, sym) -> np.ndarray:
    """Vectorized Occ(pos, sym): number of `sym` in BWT[0..=pos] (inclusive).

    Reference semantics: milestone + masked popcount of the per-symbol
    boolean combination of the block's bit-planes (src/bwt.rs:110-135,
    :226-271; inclusive mask at src/simd_instructions.rs:98-121).  Instead of
    the reference's hand-minimized AND/ANDNOT formulas we compute the exact
    match ``AND_v (plane_v XOR ~code_v)`` which agrees with them on every
    value that can occur in a valid block (all written codes are valid symbol
    codes; all-zero padding matches no non-sentinel symbol).
    """
    pos = np.asarray(pos, dtype=np.int64)
    sym = np.asarray(sym, dtype=np.int64)
    block = pos >> 8
    local = (pos & 255).astype(np.uint32)

    planes = index.planes[block]  # [..., V, 8] u32
    codes = index_to_code_table(index.alphabet)[sym]  # [...]
    nv = index.alphabet.num_planes

    occv = np.full(planes.shape[:-2] + (8,), _FULL, dtype=np.uint32)
    for v in range(nv):
        bit = (codes >> v) & 1
        xor_mask = np.where(bit.astype(bool), np.uint32(0), _FULL).astype(np.uint32)
        occv &= planes[..., v, :] ^ xor_mask[..., None]

    # Inclusive positional mask over 8 u32 lanes: bits [0..=local].
    word = (local >> 5)[..., None]  # which lane holds bit `local`
    lane = np.arange(8, dtype=np.uint32)
    in_word_mask = (_FULL >> (np.uint32(31) - (local & 31))).astype(np.uint32)[..., None]
    mask = np.where(lane < word, _FULL, np.where(lane == word, in_word_mask, np.uint32(0)))

    pop = _popcount_u32(occv & mask).astype(np.uint64).sum(axis=-1)
    return index.milestones[block, sym] + pop


def update_range(index: FmIndexData, starts, ends, sym):
    """Vectorized LF-mapping range update (src/fm_index.rs:559-582):
    start' = C[c] + Occ(start-1, c); end' = C[c] + Occ(end, c) - 1.

    Invariant (src/search.rs:43-48): start >= 1 always, so start-1 never
    underflows; holds even for empty ranges.
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    c = index.prefix_sums[np.asarray(sym, dtype=np.int64)].astype(np.int64)
    new_starts = c + occurrence(index, starts - 1, sym).astype(np.int64)
    new_ends = c + occurrence(index, ends, sym).astype(np.int64) - 1
    return new_starts, new_ends


def seed_range(index: FmIndexData, sym):
    """Initial range for a single symbol (src/search.rs:43-48)."""
    sym = np.asarray(sym, dtype=np.int64)
    ps = index.prefix_sums.astype(np.int64)
    return ps[sym], ps[sym + 1] - 1


def symbol_at(index: FmIndexData, pos) -> np.ndarray:
    """Reconstruct BWT symbol indices from the bit-planes
    (src/bwt.rs:52-62, :161-174)."""
    pos = np.asarray(pos, dtype=np.int64)
    block = pos >> 8
    local = pos & 255
    word = local >> 5
    bit = (local & 31).astype(np.uint32)
    code = np.zeros(pos.shape, dtype=np.int64)
    for v in range(index.alphabet.num_planes):
        bits = (index.planes[block, v, word] >> bit) & np.uint32(1)
        code |= bits.astype(np.int64) << v
    return code_to_index_table(index.alphabet)[code].astype(np.int64)


def backstep(index: FmIndexData, pos) -> np.ndarray:
    """One LF step (src/fm_index.rs:585-593); sentinel rows jump to row 0."""
    pos = np.asarray(pos, dtype=np.int64)
    sym = symbol_at(index, pos)
    safe_sym = np.where(sym == 0, index.alphabet.ambiguity_idx, sym)
    stepped = (
        index.prefix_sums[safe_sym].astype(np.int64)
        + occurrence(index, pos, safe_sym).astype(np.int64)
        - 1
    )
    return np.where(sym == 0, np.int64(0), stepped)


def _encode_queries(alphabet: Alphabet, queries) -> list[np.ndarray]:
    out = []
    for q in queries:
        if isinstance(q, str):
            q = q.encode()
        out.append(encode_ascii(alphabet, q).astype(np.int64))
    return out


def _kmer_address(index: FmIndexData, sym_suffix: np.ndarray) -> int:
    """Dense radix address of the last-k symbols, or -1 if any symbol is not
    an encoding symbol.  Address = sum dense(kmer[k-1-j]) * base**j, matching
    the reference's positional code orientation (kmer_lookup_table.rs:153-158)
    but over the dense symbol ranks."""
    dense = index_to_dense_table(index.alphabet)[sym_suffix]
    if (dense < 0).any():
        return -1
    base = index.alphabet.num_encoding_symbols
    weights = base ** np.arange(len(sym_suffix) - 1, -1, -1, dtype=np.int64)
    return int((dense.astype(np.int64) * weights).sum())


def search_range_for_symbols(index: FmIndexData, syms: np.ndarray) -> tuple[int, int]:
    """Backward search over one index-encoded query
    (src/fm_index.rs:402-438), with the k-mer table supplying the seed range
    when applicable."""
    if len(syms) == 0:
        return 1, 0
    if (syms == 0).any():
        # Sentinel symbols ('$'/'#') are not searchable; the reference's
        # occurrence formulas exclude the sentinel and searching it is UB
        # (src/bwt.rs:128-129,261-265) - return the canonical empty range
        # (PARITY.md divergence #7).
        return 1, 0
    k = index.kmer_len
    start_step: int
    if index.kmer_len > 0 and len(syms) >= k:
        addr = _kmer_address(index, syms[-k:])
    else:
        addr = -1
    if addr >= 0:
        start = int(index.kmer_table[addr, 0])
        end = int(index.kmer_table[addr, 1])
        start_step = k
    else:
        start, end = (int(x) for x in seed_range(index, syms[-1]))
        start_step = 1
    for i in range(len(syms) - 1 - start_step, -1, -1):
        if start > end:
            break  # early exit on empty (src/fm_index.rs:410-412)
        s, e = update_range(index, start, end, syms[i])
        start, end = int(s), int(e)
    return start, end


def count(index: FmIndexData, query) -> int:
    """count_string (src/fm_index.rs:499-501)."""
    (syms,) = _encode_queries(index.alphabet, [query])
    start, end = search_range_for_symbols(index, syms)
    return max(0, end - start + 1)


def count_batch(index: FmIndexData, queries) -> np.ndarray:
    return np.array([count(index, q) for q in queries], dtype=np.uint64)


def locate(index: FmIndexData, query) -> list[tuple[int, int]]:
    """locate_string (src/fm_index.rs:516-544): LF-walk each row in the final
    range to the nearest sampled row, add back the steps, localize via the
    sequence starts.  Returns (sequence_idx, local_position) pairs in
    BWT-row order."""
    (syms,) = _encode_queries(index.alphabet, [query])
    start, end = search_range_for_symbols(index, syms)
    if start > end:
        return []
    rows = np.arange(start, end + 1, dtype=np.int64)
    steps = np.zeros_like(rows)
    active = rows % index.sa_ratio != 0
    while active.any():
        rows[active] = backstep(index, rows[active])
        steps[active] += 1
        active = rows % index.sa_ratio != 0
    sa_vals = index.sampled_sa[rows // index.sa_ratio].astype(np.int64)
    text_pos = (sa_vals + steps) % index.bwt_len
    seq_idx = np.searchsorted(index.seq_starts, text_pos, side="right") - 1
    local = text_pos - index.seq_starts[seq_idx]
    return list(zip(seq_idx.tolist(), local.tolist()))


def locate_batch(index: FmIndexData, queries) -> list[list[tuple[int, int]]]:
    return [locate(index, q) for q in queries]


def populate_kmer_table(index: FmIndexData) -> np.ndarray:
    """Breadth-wise k-mer seed-table construction.

    The reference builds its table by a depth-first recursion of range
    updates (kmer_lookup_table.rs:121-167); on arrays the natural shape is k
    breadth-wise rounds, each extending every prefix by every encoding
    symbol in one vectorized update over base**level ranges (SURVEY.md
    section 7 step 6).  Entry layout: address = sum dense(sym at distance j
    from the k-mer end) * base**j.
    """
    alphabet = index.alphabet
    base = alphabet.num_encoding_symbols
    k = index.kmer_len
    if k == 0:  # table disabled: single canonical-empty entry, never read
        return np.array([[1, 0]], dtype=np.uint64)
    raw_syms = np.flatnonzero(index_to_dense_table(alphabet) >= 0).astype(np.int64)

    starts, ends = seed_range(index, raw_syms)  # address j -> dense symbol j
    level = 1
    while level < k:
        size = base**level
        # Prepend symbol d: new_addr = d * base**level + old_addr.
        rep_syms = np.repeat(raw_syms, size)
        tile_starts = np.tile(starts, base)
        tile_ends = np.tile(ends, base)
        starts, ends = update_range(index, tile_starts, tile_ends, rep_syms)
        level += 1

    table = np.stack(
        [
            np.maximum(starts, 0).astype(np.uint64),
            np.maximum(ends, 0).astype(np.uint64),
        ],
        axis=1,
    )
    # Preserve emptiness exactly: empty ranges keep start > end.
    empty = starts > ends
    table[empty, 0] = 1
    table[empty, 1] = 0
    return table
