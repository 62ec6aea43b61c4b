"""Reference-parity public API surface (FmIndex facade, Symbol,
SearchRange, LocalizedSequencePosition)."""

import numpy as np
import pytest

from awry_tpu import (
    Alphabet,
    FmBuildArgs,
    FmIndex,
    LocalizedSequencePosition,
    SearchRange,
    Symbol,
)

from .conftest import random_seq
from .oracle import kmer_position_map


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    rng = np.random.default_rng(3)
    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 900)
    fasta = tmp_path_factory.mktemp("api") / "t.fasta"
    fasta.write_bytes(b">rec one\n" + seq + b"\n")
    fm = FmIndex.new(
        FmBuildArgs(input_file_src=str(fasta), lookup_table_kmer_len=3)
    )
    return fm, seq


def test_search_range_semantics():
    # src/search.rs:83-145
    assert SearchRange.zero().len() == 0
    assert SearchRange(1, 0).is_empty()
    assert SearchRange(999, 0).len() == 0
    assert list(SearchRange(500, 499).range_iter()) == []
    r = SearchRange(3, 5)
    assert r.len() == 3 and list(r.range_iter()) == [3, 4, 5]


def test_symbol_round_trips():
    for ch in "acgtnACGTN$":
        s = Symbol.new_ascii(Alphabet.NUCLEOTIDE, ch)
        assert Symbol.new_index(Alphabet.NUCLEOTIDE, s.index()).ascii() == s.ascii()
    assert Symbol.new_ascii(Alphabet.NUCLEOTIDE, "u").index() == 5
    assert Symbol.new_ascii(Alphabet.NUCLEOTIDE, "$").is_sentinel()
    assert Symbol.new_ascii(Alphabet.AMINO, "y").index() == 21
    with pytest.raises(ValueError):
        Symbol.new_index(Alphabet.NUCLEOTIDE, 6)


def test_count_and_locate_strings(built):
    fm, seq = built
    kmap = kmer_position_map(seq, 12)
    for kmer, positions in list(kmap.items())[:50]:
        assert fm.count_string(kmer) == len(positions)
        locs = sorted(fm.locate_string(kmer))
        assert [l.local_position() for l in locs] == sorted(positions)
        assert all(l.sequence_idx() == 0 for l in locs)


def test_parallel_apis(built):
    fm, seq = built
    queries = [seq[i : i + 15] for i in range(0, 100, 7)]
    counts = fm.parallel_count(queries)
    locates = fm.parallel_locate(queries)
    for q, c, ls in zip(queries, counts, locates):
        assert int(c) == fm.count_string(q)
        assert sorted(ls) == sorted(fm.locate_string(q))


def test_engine_fallback_warns(built, monkeypatch):
    """A broken device-engine build must fail loudly from both batch APIs —
    never demote to the (orders of magnitude slower) host engine."""
    import awry_tpu.ops.engine as engine_mod

    fm, seq = built
    fm._device_engine = None  # reset any cached engine

    def boom(*a, **k):
        raise RuntimeError("injected engine failure")

    monkeypatch.setattr(engine_mod, "FmQueryEngine", boom)
    with pytest.raises(RuntimeError, match="injected engine failure"):
        fm.parallel_count([seq[:12]])
    with pytest.raises(RuntimeError, match="injected engine failure"):
        fm.parallel_locate([seq[:12]])
    assert fm._device_engine is None  # nothing cached: the next call retries


def test_manual_backward_search(built):
    """Drive the public search primitives the way the reference's docs do
    (src/fm_index.rs:546-558): manual update_range must equal count."""
    fm, seq = built
    query = seq[40:52]
    r = fm.initial_search_range(Symbol.new_ascii(fm.alphabet(), chr(query[-1])))
    for b in reversed(query[:-1]):
        r = fm.update_range_with_symbol(r, Symbol.new_ascii(fm.alphabet(), chr(b)))
    assert r.len() == fm.count_string(query)


def test_backstep_walks_to_row0(built):
    fm, _ = built
    row = 0
    seen = set()
    for _ in range(min(64, fm.bwt_len())):
        row = fm.backstep(row)
        assert 0 <= row < fm.bwt_len()
        assert row not in seen  # LF is a permutation cycle through the text
        seen.add(row)


def test_accessors_and_save_load(built, tmp_path):
    fm, seq = built
    assert fm.alphabet() is Alphabet.NUCLEOTIDE
    assert fm.bwt_len() == len(seq) + 1
    assert int(fm.prefix_sums()[-1]) == fm.bwt_len()
    assert fm.suffix_array_compression_ratio() == 8
    assert fm.version_number() == 1
    assert fm.memory_report()["total"] > 0

    awry = tmp_path / "x.awry"
    npz = tmp_path / "x.npz"
    fm.save(str(awry))
    fm.save(str(npz))
    for p in (awry, npz):
        loaded = FmIndex.load(str(p))
        q = seq[5:25]
        assert loaded.count_string(q) == fm.count_string(q)
        assert loaded.locate_string(q) == fm.locate_string(q)


def test_localized_sequence_position_api():
    p = LocalizedSequencePosition.new(2, 7)
    assert p.sequence_idx() == 2 and p.local_position() == 7
    assert LocalizedSequencePosition(0, 1) < LocalizedSequencePosition(0, 2)


def test_require_device_raises_instead_of_silent_fallback(rng, monkeypatch):
    """A failed device-engine construction raises from the batch APIs; the
    host engine stays reachable only explicitly (host_engine)."""
    from awry_tpu import FmBuildArgs, build_from_records
    from awry_tpu.fm_index import FmIndex

    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=500))
    data = build_from_records([("r", seq)], FmBuildArgs(lookup_table_kmer_len=2))

    import awry_tpu.ops.engine as eng_mod

    class Boom:
        def __init__(self, *a, **k):
            raise RuntimeError("no device")

    monkeypatch.setattr(eng_mod, "FmQueryEngine", Boom)

    fm = FmIndex(data)
    with pytest.raises(RuntimeError, match="no device"):
        fm.parallel_count([b"ACGT"])
    with pytest.raises(RuntimeError, match="no device"):
        fm.parallel_locate([seq[10:20]])
    import awry_tpu.host_engine as he

    assert int(he.count_batch(data, [seq[10:20]])[0]) >= 1  # explicit host path
