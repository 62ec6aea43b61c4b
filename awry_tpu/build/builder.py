"""Index construction: text -> suffix array -> device-layout FM-index arrays.

Vectorized re-design of FmIndex::new (reference: src/fm_index.rs:142-268).
The reference fills its block-of-structs BWT with a scalar pass over the
suffix array; here every component is produced by whole-array NumPy passes
(bit-plane packing via np.packbits, milestones via a per-block bincount +
exclusive cumsum), then the k-mer seed table is populated with the
vectorized host engine.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time

import numpy as np

_log = logging.getLogger("awry_tpu.build")

from ..alphabet import Alphabet, encode_ascii, index_to_code_table
from ..index import SYMBOLS_PER_BLOCK, WORDS_PER_WINDOW, FmBuildArgs, FmIndexData
from ..io.sequence_io import SequenceData, concat_records, read_sequence_file
from .suffix_array import build_suffix_array


def bwt_symbols_from_sa(text_syms: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT[i] = text'[SA[i]-1] with text' = text + sentinel; row with SA==0
    gets the sentinel symbol (src/fm_index.rs:219-228).

    One uint8 gather: the sentinel is appended at the end, and the single
    SA==0 row indexes prev = -1 == text_len, i.e. exactly that appended
    sentinel.  The gather is random-access over the whole text (latency
    bound) and runs through the OpenMP native helper.
    """
    from .suffix_array import gather_u8

    n = text_syms.shape[0]
    ext = np.empty(n + 1, dtype=np.uint8)
    ext[:-1] = text_syms
    ext[-1] = 0
    # Unsigned-safe prev-position: the single sa==0 row maps to index n (the
    # appended sentinel).  Stays in the SA's own (possibly 4-byte) dtype.
    # One subtract + a scalar patch at argmin (the unique sa==0 row) — the
    # np.where form cost ~30 s at 250M rows in temporaries.
    idx = sa - sa.dtype.type(1)
    idx[int(np.argmin(sa))] = sa.dtype.type(n)
    return gather_u8(ext, idx)


def pack_bit_planes(bwt_syms: np.ndarray, alphabet: Alphabet) -> np.ndarray:
    """Pack per-position symbol codes into uint32[num_blocks, V, 8] planes.

    Bit v of a symbol's code goes into plane v at the symbol's in-block bit
    position (src/bwt.rs:65-77); bit order within a 256-bit window is
    little-endian over 8 u32 lanes (byte-compatible with the reference's
    [u64;4] Vec256 when both are viewed little-endian).
    """
    n = bwt_syms.shape[0]
    num_blocks = -(-n // SYMBOLS_PER_BLOCK)
    codes = np.zeros(num_blocks * SYMBOLS_PER_BLOCK, dtype=np.uint8)
    codes[:n] = index_to_code_table(alphabet)[bwt_syms]
    nv = alphabet.num_planes
    planes = np.empty((num_blocks, nv, WORDS_PER_WINDOW), dtype=np.uint32)
    for v in range(nv):
        # np.packbits(bitorder='little') is one C pass producing exactly the
        # little-endian bit layout the windows use.
        plane_bits = (codes >> np.uint8(v)) & np.uint8(1)
        packed = np.packbits(plane_bits, bitorder="little")
        planes[:, v, :] = packed.view("<u4").reshape(num_blocks, WORDS_PER_WINDOW)
    return planes


def compute_milestones(bwt_syms: np.ndarray, alphabet: Alphabet) -> tuple[np.ndarray, np.ndarray]:
    """Milestones[b, c] = count of c in BWT[0 : 256*b] (src/fm_index.rs:211-217)
    plus the global prefix sums C (src/fm_index.rs:232-240)."""
    n = bwt_syms.shape[0]
    c = alphabet.cardinality
    num_blocks = -(-n // SYMBOLS_PER_BLOCK)
    # Per-symbol uint8 compare + block-row sums: no 64-bit key temporaries
    # (a bincount over arange-derived keys costs minutes at 250M symbols).
    padded = np.full(num_blocks * SYMBOLS_PER_BLOCK, 255, dtype=np.uint8)
    padded[:n] = bwt_syms
    rows = padded.reshape(num_blocks, SYMBOLS_PER_BLOCK)
    per_block = np.empty((num_blocks, c), dtype=np.uint64)
    for s in range(c):
        per_block[:, s] = (rows == s).sum(axis=1, dtype=np.uint32)
    cum = np.cumsum(per_block, axis=0, dtype=np.uint64)
    milestones = np.zeros_like(cum)
    milestones[1:] = cum[:-1]
    totals = cum[-1]
    prefix_sums = np.zeros(c + 1, dtype=np.uint64)
    prefix_sums[1:] = np.cumsum(totals, dtype=np.uint64)
    return milestones, prefix_sums


def _sa_cache_digest(sa_path: str) -> str | None:
    """Text fingerprint recorded next to a cached suffix array, if any."""
    try:
        with open(sa_path + ".sha256") as f:
            return f.read().strip()
    except OSError:
        return None


def build_from_sequence_data(seq_data: SequenceData, args: FmBuildArgs) -> FmIndexData:
    """Assemble the full FM-index from canonical concatenated text."""
    alphabet = args.alphabet

    t_phase = time.perf_counter()

    def phase(name: str) -> None:
        # Build observability: genome-scale builds run for minutes; phase
        # timings make a slow/stuck build diagnosable (INFO level, off by
        # default).
        nonlocal t_phase
        now = time.perf_counter()
        _log.info("build phase %-18s %.1fs", name, now - t_phase)
        t_phase = now

    # Reuse / persist the intermediate suffix array like the reference's
    # .sufr round trip (src/fm_index.rs:170-181, :263-265).
    sa = None
    sa_path = args.suffix_array_output_src
    text_digest = hashlib.sha256(seq_data.text.tobytes()).hexdigest()
    phase("text digest")
    if sa_path and os.path.exists(sa_path):
        cached = np.load(sa_path)
        # A same-length SA from a different text would silently corrupt the
        # index; reuse only when the sidecar fingerprint matches this text.
        if cached.shape[0] == seq_data.text.shape[0] + 1 and _sa_cache_digest(sa_path) == text_digest:
            sa = cached
            phase("SA cache load")
    if sa is None:
        sa = build_suffix_array(seq_data.text)
        phase("SA-IS")
        if sa_path:
            np.save(sa_path, sa)
            with open(sa_path + ".sha256", "w") as f:
                f.write(text_digest)
            phase("SA cache save")
    bwt_len = sa.shape[0]  # text_len + 1 (src/fm_index.rs:50,182)
    text_syms = encode_ascii(alphabet, seq_data.text)  # uint8
    bwt_syms = bwt_symbols_from_sa(text_syms, sa)
    phase("BWT gather")

    planes = pack_bit_planes(bwt_syms, alphabet)
    milestones, prefix_sums = compute_milestones(bwt_syms, alphabet)
    del bwt_syms  # 1 B/symbol, unused below
    phase("planes+milestones")

    sa_ratio = args.resolved_sa_ratio()
    # uint32 whenever positions fit (bwt_len <= 2**32): the sampled arrays
    # are the artifact's dominant bytes at genome scale, engines ship them
    # as u32 anyway, and the wide (>4 Gbp) path widens on load.
    pos_dtype = np.uint32 if bwt_len <= (1 << 32) else np.uint64
    sampled_sa = sa[::sa_ratio].astype(pos_dtype)  # sampling by BWT row (csa.rs:109-111)

    # Text-order sampling marks (device locate fast path; index.py docstring).
    # Mark density is a locate-speed knob independent of the .awry sa_ratio:
    # the device walk is bounded at mark_ratio - 1 visits.
    mark_ratio = args.resolved_mark_ratio()
    num_blocks = planes.shape[0]
    marked = np.zeros(num_blocks * SYMBOLS_PER_BLOCK, dtype=np.uint8)
    marked[: sa.shape[0]] = 1 if mark_ratio == 1 else (sa % mark_ratio) == 0
    mark_bits = np.packbits(marked, bitorder="little").view("<u4").reshape(num_blocks, 8)
    per_block_marked = marked.reshape(num_blocks, SYMBOLS_PER_BLOCK).sum(axis=1, dtype=np.uint32)
    mark_milestones = np.zeros(num_blocks, dtype=np.uint32)
    np.cumsum(per_block_marked[:-1], out=mark_milestones[1:], dtype=np.uint32)
    if mark_ratio == 1:  # every row marked: skip the 250M+-row boolean index
        text_sampled_sa = sa.astype(pos_dtype)
    else:
        text_sampled_sa = sa[marked[: sa.shape[0]].astype(bool)].astype(pos_dtype)
    del sa, marked  # 4-8 B/symbol: holding them through the k-mer phase
    # pushed pan-genome partition builds into the OOM killer
    phase("marks")

    # Packed text for the seed-walk-verify serving path (ops/verify.py):
    # symbol indices at 4 (nucleotide) or 8 (amino) bits, little-endian
    # within uint32 words.
    bits = 4 if alphabet.cardinality <= 16 else 8
    spw = 32 // bits
    n_words = -(-(len(text_syms) + 1) // spw)
    padded_syms = np.zeros(n_words * spw, dtype=np.uint32)
    padded_syms[: len(text_syms)] = text_syms
    text_packed = np.zeros(n_words, dtype=np.uint32)
    for j in range(spw):
        text_packed |= padded_syms[j::spw] << np.uint32(bits * j)
    phase("text pack")

    kmer_len = args.resolved_kmer_len()
    base = alphabet.num_encoding_symbols
    index = FmIndexData(
        alphabet=alphabet,
        planes=planes,
        milestones=milestones,
        prefix_sums=prefix_sums,
        sampled_sa=sampled_sa,
        sa_ratio=sa_ratio,
        bwt_len=int(bwt_len),
        kmer_table=np.zeros((base**kmer_len, 2), dtype=np.uint64),
        kmer_len=kmer_len,
        seq_starts=seq_data.start_positions.astype(np.int64),
        headers=list(seq_data.headers),
        mark_bits=mark_bits,
        mark_milestones=mark_milestones,
        text_sampled_sa=text_sampled_sa,
        mark_ratio=mark_ratio,
        text_packed=text_packed,
    )
    if args.build_kmer_table_on_device:
        from ..ops.device_index import to_device
        from ..ops.kmer import populate_kmer_table_device

        # minimal: the table build only rank-steps; shipping the locate /
        # verify tables costs GBs of dead device memory at genome scale.
        index.kmer_table = populate_kmer_table_device(
            to_device(index, minimal=True), kmer_len
        )
    else:
        # Counting construction straight from the text: O(N*k + base**k)
        # host bincounts, bit-identical to the BFS range-update builders
        # (tests/test_kmer_count.py) and ~30x faster at genome scale (the
        # k=14 chr1 table dropped from 449 s of device range updates to
        # ~15 s).  The BFS paths remain for callers that only hold the BWT
        # (io/awry_format.py table reconstruction).
        from .kmer_count import populate_kmer_table_counting

        index.kmer_table = populate_kmer_table_counting(text_syms, alphabet, kmer_len)
    phase("kmer table")
    index.validate()
    phase("validate")
    if sa_path and args.remove_intermediate_suffix_array_file and os.path.exists(sa_path):
        os.remove(sa_path)
        if os.path.exists(sa_path + ".sha256"):
            os.remove(sa_path + ".sha256")
    return index


def build_index(args: FmBuildArgs) -> FmIndexData:
    """FmIndex::new analog: read the input file and build the index."""
    if args.input_file_src is None:
        raise ValueError("input_file_src is required")
    seq_data = read_sequence_file(args.input_file_src, args.alphabet)
    return build_from_sequence_data(seq_data, args)


def build_from_records(records: list[tuple[str, bytes]], args: FmBuildArgs) -> FmIndexData:
    """Build directly from in-memory (header, sequence) records."""
    return build_from_sequence_data(concat_records(records, args.alphabet), args)
