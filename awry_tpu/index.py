"""FM-index data model: structure-of-arrays, designed for device-memory residency.

This is the device-side re-expression of the reference's block-of-structs
windowed BWT (reference: src/bwt.rs:14-25, src/fm_index.rs:40-56).  Instead of
interleaved 32-byte-aligned blocks, every component is a dense array so the
whole index ships to the device as a pytree of jnp arrays and every query
batch touches it with vectorized gathers:

* ``planes``    uint32[num_blocks, num_planes, 8] - the strided occurrence
  bit-vectors; one 256-bit window per (block, plane) as 8 little-endian u32
  lanes (the reference's Vec256 = [u64;4], src/simd_instructions.rs:35-37,
  byte-identical when viewed little-endian).
* ``milestones`` uint64[num_blocks, cardinality] - per-symbol cumulative
  counts at each block start (src/bwt.rs:79-98; only `cardinality` of the
  reference's 8/24 padded slots are meaningful).
* ``prefix_sums`` uint64[cardinality+1] - the C array (src/fm_index.rs:232-240).
* ``sampled_sa`` uint64[ceil(bwt_len/r)] - every r-th suffix-array entry by
  BWT row (src/compressed_suffix_array.rs:109-111).  Stored ALIGNED here (not
  bit-packed); the bit-packed encoding exists only at the .awry file boundary
  (awry_tpu/io/awry_format.py), trading a little memory for gather-friendly
  device access (SURVEY.md section 2, native component #3).
* ``kmer_table`` uint64[base**k, 2] - precomputed seed ranges addressed by a
  DENSE radix over encoding symbols (A,C,G,T->0..3 etc.).  Unlike the
  reference's table (never actually read; SURVEY.md 2.3 quirk #1), ours is
  load-bearing: a table hit replaces the first k backward-search steps.
* ``seq_starts`` int64[num_records] - record start offsets for localization
  (src/sequence_index.rs:10-21).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import Alphabet

SYMBOLS_PER_BLOCK = 256  # reference: src/bwt.rs:285
WORDS_PER_WINDOW = 8  # 256 bits as 8 x u32 lanes
FM_VERSION_NUMBER = 1  # reference: src/fm_index.rs:19


@dataclasses.dataclass
class FmBuildArgs:
    """Build configuration (reference: FmBuildArgs, src/fm_index.rs:78-96).

    Device-specific additions live in the query-engine / sharding configs,
    not here; this mirrors the reference's knobs.
    """

    input_file_src: str | None = None
    alphabet: Alphabet = Alphabet.NUCLEOTIDE
    suffix_array_output_src: str | None = None  # intermediate SA artifact (.npy)
    suffix_array_compression_ratio: int | None = None  # default 8 (fm_index.rs:122)
    lookup_table_kmer_len: int | None = None  # defaults 10 / 4 (kmer_lookup_table.rs:23-24)
    # Accepted for parity but never bounds the sort: the reference caps
    # libsufr's comparison-sort depth (src/fm_index.rs:90-92,158) because
    # that sort costs O(n log n * depth); our SA-IS is linear-time, so the
    # full sort is both faster and exact for every query length (PARITY.md
    # divergence #9).  PartitionedFmIndex uses it as the query-length bound.
    max_query_len: int | None = None
    remove_intermediate_suffix_array_file: bool = False  # fm_index.rs:263-265
    build_kmer_table_on_device: bool = False  # breadth-wise device build (ops/kmer.py)
    # Device locate knob: density of the text-order sampling marks that bound
    # the device LF-walk (mark_ratio - 1 visits).  Independent of the .awry
    # row-sampled array (sa_ratio, format parity); denser marks trade
    # text_sampled_sa memory (4 B per marked position on device) for a
    # proportionally shorter locate walk.  None -> min(4, sa_ratio).
    locate_mark_ratio: int | None = None

    def resolved_sa_ratio(self) -> int:
        return self.suffix_array_compression_ratio or 8

    def resolved_mark_ratio(self) -> int:
        if self.locate_mark_ratio is not None:
            if self.locate_mark_ratio < 1:
                raise ValueError("locate_mark_ratio must be >= 1")
            return self.locate_mark_ratio
        return min(4, self.resolved_sa_ratio())

    def resolved_kmer_len(self) -> int:
        """None -> alphabet default (10/4); explicit 0 disables the table."""
        if self.lookup_table_kmer_len is None:
            return self.alphabet.default_kmer_len
        return self.lookup_table_kmer_len


@dataclasses.dataclass
class FmIndexData:
    """Host-resident (NumPy) FM-index; the single source of truth.

    Device engines (`awry_tpu.ops`, `awry_tpu.parallel`) derive their jnp
    pytrees from this via `awry_tpu.ops.device_index.to_device`.
    """

    alphabet: Alphabet
    planes: np.ndarray  # uint32 [num_blocks, num_planes, 8]
    milestones: np.ndarray  # uint64 [num_blocks, cardinality]
    prefix_sums: np.ndarray  # uint64 [cardinality + 1]
    sampled_sa: np.ndarray  # uint32|uint64 [ceil(bwt_len / sa_ratio)] (u32 iff bwt_len fits)
    sa_ratio: int
    bwt_len: int
    kmer_table: np.ndarray  # uint32|uint64 [base**kmer_len, 2] (u32 iff bwt_len fits)
    kmer_len: int
    seq_starts: np.ndarray  # int64 [num_records]
    headers: list[str]
    version_number: int = FM_VERSION_NUMBER
    # Text-order sampling acceleration (device locate): rows whose SA value
    # is a multiple of sa_ratio are MARKED, which bounds the locate LF-walk
    # at sa_ratio-1 steps (the reference's row sampling gives geometric,
    # unbounded-tail walks; its sampled_sa above is kept for format parity).
    # Derivable only from the full SA at build time; None on .awry imports,
    # where engines fall back to the row-sampled walk.
    mark_bits: np.ndarray | None = None  # uint32 [num_blocks, 8]
    mark_milestones: np.ndarray | None = None  # uint32 [num_blocks]
    text_sampled_sa: np.ndarray | None = None  # uint32|uint64 [num marked rows]
    # Mark density: text positions that are multiples of mark_ratio are
    # marked (walk bound = mark_ratio - 1 steps).  Decoupled from sa_ratio
    # (the .awry row-sampling ratio); 0 means "legacy: equal to sa_ratio"
    # so v2 artifacts load unchanged.
    mark_ratio: int = 0
    # Packed original text (symbol indices; 4 bits/symbol when cardinality
    # <= 16, else 8), little-endian within each uint32 word.  Powers the
    # seed-walk-verify serving path (ops/verify.py): after a few backward
    # search steps, width-1 candidates are confirmed by direct text
    # comparison instead of finishing the search.  None on .awry imports.
    text_packed: np.ndarray | None = None

    @property
    def resolved_mark_ratio(self) -> int:
        return self.mark_ratio or self.sa_ratio

    @property
    def has_marks(self) -> bool:
        return self.mark_bits is not None

    @property
    def text_bits_per_symbol(self) -> int:
        return 4 if self.alphabet.cardinality <= 16 else 8

    @property
    def num_blocks(self) -> int:
        return self.planes.shape[0]

    @property
    def cardinality(self) -> int:
        return self.alphabet.cardinality

    def validate(self, strict: bool = False) -> None:
        """Shape/dtype invariants; ``strict=True`` adds value-level checks
        (SURVEY.md section 5 sanitizer row).  Device gathers CLAMP
        out-of-range indices (silent wrong results on a corrupt artifact);
        strict mode is the loud alternative - run it on any index loaded
        from an untrusted or possibly-damaged file."""
        c = self.alphabet.cardinality
        v = self.alphabet.num_planes
        nb = -(-self.bwt_len // SYMBOLS_PER_BLOCK)
        assert self.planes.shape == (nb, v, WORDS_PER_WINDOW), self.planes.shape
        assert self.planes.dtype == np.uint32
        assert self.milestones.shape == (nb, c)
        assert self.prefix_sums.shape == (c + 1,)
        assert int(self.prefix_sums[-1]) == self.bwt_len
        assert self.sampled_sa.shape == (-(-self.bwt_len // self.sa_ratio),)
        base = self.alphabet.num_encoding_symbols
        assert self.kmer_table.shape == (base**self.kmer_len, 2)
        assert self.seq_starts.shape == (len(self.headers),)
        if not strict:
            return
        if (self.sampled_sa >= self.bwt_len).any():
            raise ValueError("corrupt index: sampled_sa entries beyond bwt_len")
        if (np.diff(self.prefix_sums.astype(np.int64)) < 0).any():
            raise ValueError("corrupt index: prefix_sums not monotone")
        if (np.diff(self.milestones.astype(np.int64), axis=0) < 0).any():
            raise ValueError("corrupt index: milestones not cumulative")
        if (self.milestones[0] != 0).any():
            raise ValueError("corrupt index: first-block milestones nonzero")
        kt = self.kmer_table.astype(np.int64)
        nonempty = kt[:, 0] <= kt[:, 1]
        if (kt[nonempty] >= self.bwt_len).any() or (kt < 0).any():
            raise ValueError("corrupt index: kmer_table range beyond bwt_len")
        ss = self.seq_starts.astype(np.int64)
        if (np.diff(ss) <= 0).any() or (ss < 0).any() or (ss >= self.bwt_len).any():
            raise ValueError("corrupt index: seq_starts not strictly increasing in range")
        if self.has_marks:
            if (self.text_sampled_sa >= self.bwt_len).any():
                raise ValueError("corrupt index: text_sampled_sa beyond bwt_len")
            if (np.diff(self.mark_milestones.astype(np.int64)) < 0).any():
                raise ValueError("corrupt index: mark_milestones not cumulative")

    def memory_report(self) -> dict[str, int]:
        """Bytes per component (analog of the reference's MemSize derive,
        SURVEY.md section 5, tracing row)."""
        report = {
            "planes": self.planes.nbytes,
            "milestones": self.milestones.nbytes,
            "prefix_sums": self.prefix_sums.nbytes,
            "sampled_sa": self.sampled_sa.nbytes,
            "kmer_table": self.kmer_table.nbytes,
            "seq_starts": self.seq_starts.nbytes,
            "headers": sum(len(h) for h in self.headers),
        }
        report["total"] = sum(report.values())
        return report
