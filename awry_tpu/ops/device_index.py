"""Device-resident FM-index: a pytree of jnp arrays living in device memory.

The host FmIndexData (awry_tpu/index.py) converts to this form once; every
query batch then runs against it with vectorized gathers.  Positions, counts
and ranges use uint32 throughout - texts up to 2^32-1 symbols cover every
single-chip config (GRCh38 at 3.1 Gbp included; SURVEY.md section 7 "hard
parts"); beyond that the index must be range-sharded (awry_tpu/parallel).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_log = logging.getLogger("awry_tpu.ship")

from ..alphabet import (
    Alphabet,
    code_to_index_table,
    index_to_code_table,
    index_to_dense_table,
)
from ..index import FmIndexData


def _text_pad_words() -> int:
    """ops/verify.py's TEXT_PAD_WORDS (local import: verify imports this
    module).  One source of truth - raising the verify window must also grow
    the device text's front padding, or its backward gather would clamp and
    silently compare wrong text words."""
    from .verify import TEXT_PAD_WORDS

    return TEXT_PAD_WORDS


def fused_row_words(alphabet: Alphabet, has_marks: bool = True) -> int:
    """uint32 words per fused block row: V*8 plane words + cardinality
    milestone words [+ 8 text-sampling mark words + 1 mark milestone],
    padded to a multiple of 8.  Nucleotide: 24+6 -> 32 words = exactly one
    128 B memory line without marks, 40 words with; amino: 64 / 72 words.
    Indexes without mark data (.awry imports) keep the slimmer row - they
    never read mark words and shouldn't pay +25% per rank for them."""
    raw = alphabet.num_planes * 8 + alphabet.cardinality + (9 if has_marks else 0)
    return -(-raw // 8) * 8


def mark_words_offset(alphabet: Alphabet) -> int:
    """Word offset of the 8 mark words within a fused row (mark milestone
    follows immediately after)."""
    return alphabet.num_planes * 8 + alphabet.cardinality


@partial(jax.tree_util.register_dataclass, data_fields=[
    "blocks", "prefix_sums", "sampled_sa", "text_sampled_sa", "kmer_table", "seq_starts",
    "index_to_code", "code_to_index", "index_to_dense", "text_packed", "text_rows8",
    "marked_sa8", "verify_windows", "blocks_search",
], meta_fields=["alphabet", "sa_ratio", "bwt_len", "kmer_len", "has_marks", "mark_ratio",
                "verify_windows_s", "verify_windows_w"])
@dataclasses.dataclass(frozen=True)
class FmDeviceIndex:
    """jnp mirror of FmIndexData plus the small codec LUTs the kernels need.

    The windowed BWT lives as ONE fused array `blocks[nb, row_words]`: each
    row holds the block's V 256-bit occurrence windows (as V*8 uint32 lanes)
    followed by its per-symbol milestone counts, padded to a multiple of 8
    words.  A rank query is then a single 128 B (nucleotide) row gather -
    the reference reads the same 160 B block as two separate structures.
    """

    blocks: jax.Array  # uint32 [num_blocks, fused_row_words]
    prefix_sums: jax.Array  # uint32 [cardinality + 1]
    sampled_sa: jax.Array  # uint32 [ceil(bwt_len / sa_ratio)]
    text_sampled_sa: jax.Array  # uint32 [num marked rows]; == sampled_sa when marks absent
    kmer_table: jax.Array  # uint32 [base**kmer_len, 2]
    seq_starts: jax.Array  # uint32 [num_records]
    index_to_code: jax.Array  # uint32 [cardinality]
    code_to_index: jax.Array  # int32 [2**V]
    index_to_dense: jax.Array  # int32 [cardinality]
    alphabet: Alphabet
    sa_ratio: int
    bwt_len: int
    kmer_len: int
    has_marks: bool
    # Text-order mark density: the locate walk is bounded at mark_ratio - 1
    # visits (equals sa_ratio on legacy indexes; see FmIndexData.mark_ratio).
    mark_ratio: int = 8
    # Packed original text (FmIndexData.text_packed) for the seed-walk-verify
    # serving path (ops/verify.py); None when unavailable (.awry imports).
    text_packed: jax.Array | None = None
    # Overlapping stride-4 8-word rows of the padded text, each word
    # pre-SYMBOL-REVERSED: row r = rev(padded[4r .. 4r+8]).  The verify
    # compare's backward window read becomes ONE row gather (any <=5
    # consecutive words sit inside one row) instead of one element gather
    # per word.  Costs 2x the packed text; skipped under `lean`.
    text_rows8: jax.Array | None = None
    # text_sampled_sa reshaped to 8-word rows [ceil(len/8), 8] (zero-padded).
    # The mark_ratio == 1 walk's SA read becomes a row gather + 8-way
    # select.  Ships with the fat rows, under FAT_TABLE_MAX_BYTES.
    marked_sa8: jax.Array | None = None
    # ROW-indexed pre-aligned verify windows, uint32 [bwt_len, 8]: for BWT
    # row r with SA value p and anchor e = p + s - 1, word i holds the
    # packed text symbols at query-end distances s + spw*i + t in bits
    # bits*t (t in 0..spw-1; out-of-text distances hold 0 = sentinel), and
    # word verify_windows_w holds p itself.  The fused verify's LF-walk +
    # text compare collapse into ONE row gather + static shifts/compares -
    # no SA gather, no funnel alignment, no per-lane selects.  Costs
    # 32 B x bwt_len; ships for mark=1 indexes under FAT_TABLE_MAX_BYTES.
    verify_windows: jax.Array | None = None
    verify_windows_s: int = 0  # the switch step the windows were aligned for
    verify_windows_w: int = 0  # window words per row (word index of p)
    # Mark-free copy of the fused rows for SEARCH gathers (planes +
    # milestones only, padded to 32/64 words): rank steps never read mark
    # words, and a nucleotide step moves 20% fewer bytes through the
    # gather (the plane/milestone word offsets are unchanged - marks sit
    # at the row tail).  The walk keeps the full rows; skipped under `lean`.
    blocks_search: jax.Array | None = None

    @property
    def num_planes(self) -> int:
        return self.alphabet.num_planes

    @property
    def plane_words(self) -> int:
        return self.alphabet.num_planes * 8

    @property
    def mark_offset(self) -> int:
        return mark_words_offset(self.alphabet)


_VERIFY_WINDOW_WORDS = 5  # window words per fat row (see verify_windows)
FAT_ROW_WORDS = 8  # uint32 words per fat row: 5 windows + SA value + 2 pad

# Device bytes per BWT row of the per-row tables: verify_windows (32 B) and
# marked_sa8 (4 B).
FAT_ROW_BYTES = 4 * FAT_ROW_WORDS + 4
# Byte budget for those per-row tables.  Past it the verify path takes the
# walk + text compare instead (exact, more reads per lane).  The budget is
# the 16M-row ceiling (E. coli's 4.6M rows fit, chr20's 64M do not) carried
# over unmeasured: no H100 cell has yet located where one fat-row gather
# stops beating walk + compare (ROADMAP Queue 1 item 6).
FAT_TABLE_MAX_BYTES = 16 * 1024 * 1024 * FAT_ROW_BYTES


def _build_verify_windows(index: FmIndexData, inv_sa: np.ndarray):
    """Assemble FmDeviceIndex.verify_windows: [bwt_len, FAT_ROW_WORDS]
    uint32 fat rows (pre-aligned window words + the row's SA value; see the
    field doc), aligned at the engine's switch step.

    inv_sa: uint32[bwt_len], SA value per BWT row (text_sampled_sa at
    mark_ratio 1).  Alignment happens HERE, once per index: runtime then
    needs no funnel shifts - the symbol at query-end distance d sits at a
    static bit position of word (d - s) // spw.
    """
    from .verify import switch_step

    card = index.alphabet.cardinality
    bits = 4 if card <= 16 else 8
    spw = 32 // bits
    s = switch_step(index)
    w = _VERIFY_WINDOW_WORDS
    row_words = FAT_ROW_WORDS
    n_text = index.bwt_len - 1  # text symbols (sentinel excluded)
    n_all = index.bwt_len  # SA values p range over [0, bwt_len)

    # Build in TEXT order first: g[p, i] packs the symbols at positions
    # p - 1 - spw*i - t; one parallel native pass straight off the packed
    # text (the NumPy shifted-slice form did w*spw read-modify-write sweeps
    # over the multi-GB output — minutes at chr1 scale on fault-bound
    # pages).  One parallel row gather then permutes text order -> BWT-row
    # order; the last column g[p, w] = p lands as the row's SA value for
    # free.
    from ..build.suffix_array import fat_rows_native, gather_rows_u32

    g = fat_rows_native(index.text_packed, n_text, bits, n_all, row_words, w)
    if g is None:
        # Pure-NumPy fallback (native library unavailable): unpack the
        # packed text then OR shifted slices per (word, slot).
        tp = index.text_packed.astype(np.uint32)
        syms = np.zeros(tp.shape[0] * spw, dtype=np.uint8)
        for t in range(spw):
            syms[t::spw] = (tp >> np.uint32(bits * t)) & ((1 << bits) - 1)
        syms = syms[:n_text]
        g = np.zeros((n_all, row_words), dtype=np.uint32)
        for i in range(w):
            acc = np.zeros(n_all, dtype=np.uint32)
            for t in range(spw):
                off = 1 + spw * i + t
                if off < n_all:
                    take = min(n_text, n_all - off)
                    acc[off : off + take] |= syms[:take].astype(np.uint32) << np.uint32(bits * t)
            g[:, i] = acc
        g[:, w] = np.arange(n_all, dtype=np.uint32)

    fat = gather_rows_u32(g, inv_sa.astype(np.uint32))
    assert fat.shape == (inv_sa.shape[0], row_words)
    return fat, s, w


def _reverse_symbols_np(w: np.ndarray, bits: int) -> np.ndarray:
    """Host mirror of ops/verify._reverse_symbols (symbol order within each
    uint32 word), applied once at index-ship time for text_rows8."""
    w = w.astype(np.uint32)
    if bits == 4:
        w = ((w & np.uint32(0x0F0F0F0F)) << 4) | ((w >> 4) & np.uint32(0x0F0F0F0F))
    w = ((w & np.uint32(0x00FF00FF)) << 8) | ((w >> 8) & np.uint32(0x00FF00FF))
    return (((w << 16) | (w >> 16)) & np.uint32(0xFFFFFFFF)).astype(np.uint32)


def build_fused_blocks(index: FmIndexData) -> np.ndarray:
    """Assemble the fused [num_blocks, row_words] uint32 block array."""
    nb = index.num_blocks
    v = index.alphabet.num_planes
    c = index.alphabet.cardinality
    row_words = fused_row_words(index.alphabet, index.has_marks)
    fused = np.zeros((nb, row_words), dtype=np.uint32)
    fused[:, : v * 8] = index.planes.reshape(nb, v * 8)
    fused[:, v * 8 : v * 8 + c] = index.milestones.astype(np.uint32)
    if index.has_marks:
        off = mark_words_offset(index.alphabet)
        fused[:, off : off + 8] = index.mark_bits
        fused[:, off + 8] = index.mark_milestones
    return fused


def to_device(
    index: FmIndexData,
    *,
    sharding=None,
    device=None,
    minimal: bool = False,
    ship_row_sa: bool | None = None,
    lean: bool = False,
) -> FmDeviceIndex:
    """Ship a host index to the device(s).

    `sharding`: optional dict component-name -> jax.sharding.Sharding to
    place arrays (used by awry_tpu.parallel for replication/range-sharding);
    `device`: optional single jax.Device to pin every array to (used by
    PartitionedFmIndex to spread partitions across local devices); default
    is single-device placement by jnp.asarray.

    `minimal=True` ships only what the rank/backward-search kernels touch
    (fused blocks + prefix sums + codec LUTs); the locate/verify/seed
    tables are 1-element placeholders.  Used by the device k-mer table
    build (ops/kmer.py), whose update_range loop never locates or
    verifies - shipping the full index there cost GBs of dead device
    memory (and, at chr1 scale with mark=1 fat rows, an outright OOM).

    `ship_row_sa`: ship the ROW-sampled SA (bwt_len/sa_ratio uint32s).  The
    marked walk never reads it - only the row-sampled fallback walk does
    (indexes without marks, and ShardedFmEngine's collective backstep walk) -
    so the default (None) ships it iff the index has no marks.  On GRCh38
    the old always-ship was 1.55 GB of dead device memory.

    `lean=True` additionally skips the slim search-row copy (blocks_search,
    ~0.5 B/symbol) and text_rows8 (2x the packed text): rank gathers then
    read the full fused rows (25% more bytes each) and the text compare
    takes per-word element gathers.  For multi-index deployments
    (PartitionedFmIndex: several multi-Gbp partitions sharing one card's
    memory) the copies are the difference between fitting and
    RESOURCE_EXHAUSTED.
    """
    if index.bwt_len >= 2**32:
        raise NotImplementedError(
            "this engine is uint32-positioned (texts < 4 Gbp); wider single"
            " indexes route through ops/wide.to_device_wide (FmQueryEngine"
            " does this automatically)"
        )

    t_phase = time.perf_counter()

    def phase(name: str) -> None:
        # Ship observability: genome-scale layout assembly (fat rows) runs
        # for minutes; INFO-level phase timings make a slow engine
        # construction diagnosable (mirrors build/builder.py).
        nonlocal t_phase
        now = time.perf_counter()
        _log.info("ship phase %-22s %.1fs", name, now - t_phase)
        t_phase = now

    def put(name: str, arr: np.ndarray) -> jax.Array:
        if sharding is not None and not isinstance(sharding, dict):
            return jax.device_put(arr, sharding)  # one sharding for all
        if sharding and name in sharding:
            return jax.device_put(arr, sharding[name])
        if device is not None:
            return jax.device_put(arr, device)
        return jnp.asarray(arr)

    text_sampled = (
        index.text_sampled_sa if index.has_marks else index.sampled_sa
    )
    fused = build_fused_blocks(index)
    phase("fused blocks")
    if minimal:
        dummy = np.zeros(1, dtype=np.uint32)
        return FmDeviceIndex(
            blocks=put("blocks", fused),
            prefix_sums=put("prefix_sums", index.prefix_sums.astype(np.uint32)),
            sampled_sa=put("sampled_sa", dummy),
            text_sampled_sa=put("text_sampled_sa", dummy),
            kmer_table=put("kmer_table", np.zeros((1, 2), dtype=np.uint32)),
            seq_starts=put("seq_starts", index.seq_starts.astype(np.uint32)),
            index_to_code=put("index_to_code", index_to_code_table(index.alphabet).astype(np.uint32)),
            code_to_index=put("code_to_index", code_to_index_table(index.alphabet).astype(np.int32)),
            index_to_dense=put("index_to_dense", index_to_dense_table(index.alphabet).astype(np.int32)),
            alphabet=index.alphabet,
            sa_ratio=index.sa_ratio,
            bwt_len=index.bwt_len,
            # kmer_len 0 = "table disabled": the placeholder table must never
            # seed a search (ops/search.py takes the pure backward path).
            kmer_len=0,
            has_marks=index.has_marks,
            mark_ratio=index.resolved_mark_ratio,
        )
    padded_text = (
        np.concatenate([
            np.zeros(_text_pad_words(), dtype=np.uint32),
            index.text_packed.astype(np.uint32),
        ])
        if index.text_packed is not None
        else None
    )
    text_rows8_arr = None
    if padded_text is not None and not lean:
        # Verify compare: overlapping stride-4 rows of the padded text,
        # pre-symbol-reversed (see FmDeviceIndex.text_rows8).
        bits = 4 if index.alphabet.cardinality <= 16 else 8
        rev = _reverse_symbols_np(padded_text, bits)
        nrows = -(-rev.shape[0] // 4) + 1
        buf = np.zeros(4 * nrows + 4, dtype=np.uint32)
        buf[: rev.shape[0]] = rev
        overlapped = np.lib.stride_tricks.sliding_window_view(buf, 8)[::4]
        text_rows8_arr = put("text_rows8", np.ascontiguousarray(overlapped))
    marked_sa8_arr = None
    vw_arr, vw_s, vw_w = None, 0, 0
    if (
        index.resolved_mark_ratio == 1
        and index.has_marks
        # HARD size gate: these tables cost FAT_ROW_BYTES per BWT row - at
        # chr1 scale ~9 GB.  Past the gate the verify path falls back to
        # walk + text compare (exact, more reads per lane).
        and index.bwt_len * FAT_ROW_BYTES <= FAT_TABLE_MAX_BYTES
    ):
        flat = text_sampled.astype(np.uint32)
        n8 = -(-flat.shape[0] // 8)
        sa8 = np.zeros((n8, 8), dtype=np.uint32)
        sa8.reshape(-1)[: flat.shape[0]] = flat
        marked_sa8_arr = put("marked_sa8", sa8)
        if index.text_packed is not None:
            vw, vw_s, vw_w = _build_verify_windows(index, flat)
            vw_arr = put("verify_windows", vw)
            phase("fat rows")
    blocks_search_arr = None
    if index.has_marks and not lean:
        slim_words = fused_row_words(index.alphabet, False)
        blocks_search_arr = put(
            "blocks_search", np.ascontiguousarray(fused[:, :slim_words])
        )
    if ship_row_sa is None:
        ship_row_sa = not index.has_marks
    row_sa = (
        index.sampled_sa.astype(np.uint32)
        if ship_row_sa
        else np.zeros(1, dtype=np.uint32)
    )
    phase("aux layouts")
    dev = FmDeviceIndex(
        blocks=put("blocks", fused),
        text_rows8=text_rows8_arr,
        marked_sa8=marked_sa8_arr,
        verify_windows=vw_arr,
        verify_windows_s=vw_s,
        verify_windows_w=vw_w,
        blocks_search=blocks_search_arr,
        # TEXT_PAD_WORDS zero words prepended: the verify path's backward
        # window gather never clamps (ops/verify.py).
        text_packed=put("text_packed", padded_text) if padded_text is not None else None,
        prefix_sums=put("prefix_sums", index.prefix_sums.astype(np.uint32)),
        sampled_sa=put("sampled_sa", row_sa),
        text_sampled_sa=put("text_sampled_sa", text_sampled.astype(np.uint32)),
        kmer_table=put("kmer_table", index.kmer_table.astype(np.uint32)),
        seq_starts=put("seq_starts", index.seq_starts.astype(np.uint32)),
        index_to_code=put("index_to_code", index_to_code_table(index.alphabet).astype(np.uint32)),
        code_to_index=put("code_to_index", code_to_index_table(index.alphabet).astype(np.int32)),
        index_to_dense=put("index_to_dense", index_to_dense_table(index.alphabet).astype(np.int32)),
        alphabet=index.alphabet,
        sa_ratio=index.sa_ratio,
        bwt_len=index.bwt_len,
        kmer_len=index.kmer_len,
        has_marks=index.has_marks,
        mark_ratio=index.resolved_mark_ratio,
    )
    phase("core arrays + upload")
    return dev
