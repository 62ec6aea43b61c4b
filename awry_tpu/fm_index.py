"""FmIndex facade: the reference library's public API, one-for-one.

Everything AWRY exports (src/lib.rs:2-10, src/fm_index.rs public items) has a
named equivalent here, so a user of the reference can switch by renaming
imports:

  FmIndex::new(args)               -> FmIndex.new(args)
  FmIndex::load / save             -> FmIndex.load / FmIndex.save (.awry)
  count_string / locate_string     -> count_string / locate_string
  parallel_count / parallel_locate -> parallel_count / parallel_locate
                                      (device-batched instead of rayon)
  update_range_with_symbol         -> update_range_with_symbol
  backstep                         -> backstep
  initial_search_range             -> initial_search_range
  alphabet/bwt_len/prefix_sums/suffix_array_compression_ratio/version_number
                                   -> same names
  SearchRange (src/search.rs)      -> SearchRange
  LocalizedSequencePosition        -> LocalizedSequencePosition

Scalar calls run on the vectorized host (NumPy) engine; batch calls go to
the device engine (lazily constructed).  A device engine that cannot be
built raises: batch calls never demote silently to the host loop, which is
orders of magnitude slower.  The host engine stays reachable explicitly
(awry_tpu.host_engine, the CLI's --host).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import host_engine as he
from .alphabet import Alphabet, Symbol
from .index import FmBuildArgs, FmIndexData


@dataclasses.dataclass
class SearchRange:
    """Inclusive BWT interval [start_ptr, end_ptr]; empty iff start > end
    (reference: src/search.rs:22-80)."""

    start_ptr: int
    end_ptr: int

    @classmethod
    def zero(cls) -> "SearchRange":
        return cls(start_ptr=1, end_ptr=0)  # src/search.rs:51-56

    def is_empty(self) -> bool:
        return self.start_ptr > self.end_ptr

    def len(self) -> int:
        return 0 if self.is_empty() else self.end_ptr - self.start_ptr + 1

    def __len__(self) -> int:
        return self.len()

    def range_iter(self) -> range:
        return range(0, 0) if self.is_empty() else range(self.start_ptr, self.end_ptr + 1)


@dataclasses.dataclass(frozen=True, order=True)
class LocalizedSequencePosition:
    """(record index, position within record) locate result
    (reference: src/sequence_index.rs:31-78)."""

    _sequence_idx: int
    _local_position: int

    @classmethod
    def new(cls, sequence_idx: int, local_position: int) -> "LocalizedSequencePosition":
        return cls(sequence_idx, local_position)

    def sequence_idx(self) -> int:
        return self._sequence_idx

    def local_position(self) -> int:
        return self._local_position


class FmIndex:
    """Reference-parity FM-index handle over FmIndexData."""

    def __init__(self, data: FmIndexData):
        self.data = data
        self._device_engine = None

    # -- construction / persistence ---------------------------------------
    @classmethod
    def new(cls, args: FmBuildArgs) -> "FmIndex":
        """Build from a FASTA/FASTQ file (reference: FmIndex::new,
        src/fm_index.rs:142-268)."""
        from .build.builder import build_index

        return cls(build_index(args))

    @classmethod
    def load(cls, path: str) -> "FmIndex":
        """Load an index: .awry (reference format) or .npz (native artifact),
        chosen by sniffing the file (src/fm_index_file.rs:132-160)."""
        with open(path, "rb") as f:
            head = f.read(11)
        if head == b"AWRY-Index\n":
            from .io.awry_format import load_awry

            return cls(load_awry(path))
        from .io.artifact import load_artifact

        return cls(load_artifact(path))

    def save(self, path: str) -> None:
        """Save: .awry for reference interop, anything else as the native
        artifact (src/fm_index_file.rs:42-106)."""
        if path.endswith(".awry"):
            from .io.awry_format import save_awry

            save_awry(self.data, path)
        else:
            from .io.artifact import save_artifact

            save_artifact(self.data, path)

    # -- queries -----------------------------------------------------------
    def count_string(self, query) -> int:
        """src/fm_index.rs:499-501."""
        return he.count(self.data, query)

    def locate_string(self, query) -> list[LocalizedSequencePosition]:
        """src/fm_index.rs:516-544; results in BWT-row order."""
        return [LocalizedSequencePosition(s, p) for s, p in he.locate(self.data, query)]

    def _engine(self):
        if self._device_engine is None:
            from .ops.engine import FmQueryEngine

            self._device_engine = FmQueryEngine(self.data)
        return self._device_engine

    def parallel_count(self, queries) -> np.ndarray:
        """Batch counts (reference: rayon par_iter, src/fm_index.rs:455-460;
        here one vectorized device dispatch)."""
        return self._engine().count_batch(list(queries))

    def parallel_locate(self, queries) -> list[list[LocalizedSequencePosition]]:
        """Batch locate (src/fm_index.rs:479-487)."""
        raw = self._engine().locate_batch(list(queries))
        return [[LocalizedSequencePosition(s, p) for s, p in hits] for hits in raw]

    # -- search primitives (reference public surface) ----------------------
    def initial_search_range(self, symbol: Symbol) -> SearchRange:
        """src/fm_index.rs:383-385."""
        s, e = he.seed_range(self.data, symbol.index())
        return SearchRange(int(s), int(e))

    def update_range_with_symbol(self, search_range: SearchRange, symbol: Symbol) -> SearchRange:
        """One LF-mapping step (src/fm_index.rs:559-582)."""
        s, e = he.update_range(
            self.data, search_range.start_ptr, search_range.end_ptr, symbol.index()
        )
        return SearchRange(int(s), int(e))

    def backstep(self, search_pointer: int) -> int:
        """src/fm_index.rs:585-593."""
        return int(he.backstep(self.data, np.asarray([search_pointer]))[0])

    # -- accessors ----------------------------------------------------------
    def alphabet(self) -> Alphabet:
        return self.data.alphabet

    def bwt_len(self) -> int:
        return self.data.bwt_len

    def prefix_sums(self) -> np.ndarray:
        return self.data.prefix_sums

    def suffix_array_compression_ratio(self) -> int:
        return self.data.sa_ratio

    def version_number(self) -> int:
        return self.data.version_number

    def memory_report(self) -> dict[str, int]:
        return self.data.memory_report()
