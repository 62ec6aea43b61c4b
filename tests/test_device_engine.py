"""JAX device engine vs the host (NumPy) engine and the brute-force oracle."""

import numpy as np
import pytest

import awry_tpu.host_engine as he
from awry_tpu import Alphabet, FmBuildArgs, build_from_records
from awry_tpu.ops import FmQueryEngine, occurrence, to_device

from .conftest import random_seq
from .oracle import kmer_position_map, localize

ALPHABETS = [Alphabet.NUCLEOTIDE, Alphabet.AMINO]


def _build(alphabet, rng, *, n=800, num_records=1, sa_ratio=None, kmer_len=3):
    records = []
    for i in range(num_records):
        ln = n if num_records == 1 else int(rng.integers(10, n))
        records.append((f"seq_{i}", random_seq(alphabet, rng, ln)))
    args = FmBuildArgs(
        alphabet=alphabet,
        suffix_array_compression_ratio=sa_ratio,
        lookup_table_kmer_len=kmer_len,
    )
    return build_from_records(records, args), records


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_device_occurrence_matches_host(alphabet, rng):
    import jax.numpy as jnp

    index, _ = _build(alphabet, rng, n=700)
    dev = to_device(index)
    pos = rng.integers(0, index.bwt_len, size=256)
    for sym in range(1, alphabet.cardinality):
        host = he.occurrence(index, pos, np.full_like(pos, sym))
        devr = occurrence(dev, jnp.asarray(pos, dtype=jnp.uint32), jnp.full(pos.shape, sym, dtype=jnp.int32))
        np.testing.assert_array_equal(np.asarray(devr).astype(np.int64), host.astype(np.int64))


@pytest.mark.parametrize("alphabet,n,k", [
    (Alphabet.NUCLEOTIDE, 1200, 12),
    (Alphabet.NUCLEOTIDE, 1200, 3),
    (Alphabet.AMINO, 300, 5),
])
def test_device_count_locate_vs_oracle(alphabet, n, k, rng):
    index, records = _build(alphabet, rng, n=n)
    engine = FmQueryEngine(index)
    text = records[0][1]
    kmap = kmer_position_map(text, k)
    queries = list(kmap.keys())
    counts = engine.count_batch(queries)
    locates = engine.locate_batch(queries)
    for q, got_count, got_locs in zip(queries, counts, locates):
        positions = kmap[q]
        assert int(got_count) == len(positions), q
        assert sorted(got_locs) == sorted(localize(positions, index.seq_starts)), q


def test_device_mixed_length_batches(rng):
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=900, kmer_len=4)
    engine = FmQueryEngine(index)
    text = records[0][1]
    queries = [
        text[0:30], text[5:9], text[100:103],  # shorter than k
        b"ZZZZ",  # all-ambiguity (absent unless text has N runs)
        text[40:41],  # single char
        b"", text, text + b"A",
    ]
    got = engine.count_batch(queries)
    expected = [he.count(index, q) for q in queries]
    np.testing.assert_array_equal(got.astype(np.int64), np.array(expected))
    # locate parity too
    for q, locs in zip(queries, engine.locate_batch(queries)):
        assert sorted(locs) == sorted(he.locate(index, q)), q


def test_device_multi_record(rng):
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=60, num_records=6, sa_ratio=4)
    engine = FmQueryEngine(index)
    text = b"N".join(seq for _, seq in records)
    kmap = kmer_position_map(text, 5)
    queries = list(kmap.keys())
    counts = engine.count_batch(queries)
    locates = engine.locate_batch(queries)
    for q, c, locs in zip(queries, counts, locates):
        assert int(c) == len(kmap[q])
        assert sorted(locs) == sorted(localize(kmap[q], index.seq_starts))


@pytest.mark.parametrize("sa_ratio", [1, 3, 16])
def test_device_locate_sa_ratios(sa_ratio, rng):
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=400, sa_ratio=sa_ratio)
    engine = FmQueryEngine(index)
    text = records[0][1]
    kmap = kmer_position_map(text, 6)
    queries = list(kmap.keys())[:80]
    for q, locs in zip(queries, engine.locate_batch(queries)):
        assert sorted(p for _, p in locs) == sorted(kmap[q])


def test_marked_walk_matches_row_sampled_walk(rng):
    """The text-sampled marked walk and the reference-style row-sampled walk
    must recover identical text positions for every BWT row."""
    import dataclasses

    import jax.numpy as jnp

    from awry_tpu.ops.locate import lf_walk

    index, _ = _build(Alphabet.NUCLEOTIDE, rng, n=700, sa_ratio=8)
    dev = to_device(index)
    assert dev.has_marks
    legacy_host = dataclasses.replace(
        index, mark_bits=None, mark_milestones=None, text_sampled_sa=None
    )
    dev_legacy = to_device(legacy_host)
    assert not dev_legacy.has_marks
    rows = jnp.asarray(rng.integers(0, index.bwt_len, size=256), dtype=jnp.uint32)
    fast = np.asarray(lf_walk(dev, rows))
    slow = np.asarray(lf_walk(dev_legacy, rows))
    np.testing.assert_array_equal(fast, slow)


def test_mark1_walk_is_direct_gather(rng):
    """At locate_mark_ratio=1 the walk degenerates to text_sampled_sa[row]
    (the full inverse-permuted SA) and must still match the legacy walk."""
    import dataclasses

    import jax.numpy as jnp

    from awry_tpu import FmBuildArgs, build_from_records
    from awry_tpu.ops.locate import lf_walk

    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 900)
    index = build_from_records(
        [("r", seq)], FmBuildArgs(lookup_table_kmer_len=4, locate_mark_ratio=1)
    )
    dev = to_device(index)
    assert dev.mark_ratio == 1
    legacy = to_device(
        dataclasses.replace(
            index, mark_bits=None, mark_milestones=None, text_sampled_sa=None
        )
    )
    rows = jnp.asarray(rng.integers(0, index.bwt_len, size=300), dtype=jnp.uint32)
    np.testing.assert_array_equal(
        np.asarray(lf_walk(dev, rows)), np.asarray(lf_walk(legacy, rows))
    )


def test_device_engine_from_awry_import(rng, tmp_path):
    """An .awry-imported index (no mark data) must serve identical device
    results through the fallback walk."""
    from awry_tpu.io.awry_format import load_awry, save_awry

    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=600)
    path = str(tmp_path / "x.awry")
    save_awry(index, path)
    loaded = load_awry(path)
    assert not loaded.has_marks
    native = FmQueryEngine(index)
    imported = FmQueryEngine(loaded)
    queries = [records[0][1][i : i + 9] for i in range(0, 120, 11)] + [b"", b"A"]
    np.testing.assert_array_equal(
        imported.count_batch(queries), native.count_batch(queries)
    )
    for a, b in zip(imported.locate_batch(queries), native.locate_batch(queries)):
        assert sorted(a) == sorted(b)


def test_engine_warmup(rng):
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=300)
    engine = FmQueryEngine(index)
    engine.warmup(batch_sizes=(16, 64), query_lens=(8, 16))
    # Warmed buckets serve immediately and correctly.
    q = records[0][1][20:34]
    assert engine.count(q) == he.count(index, q)


def test_device_sentinel_in_query_returns_empty(rng):
    """Device parity for PARITY.md divergence #7: sentinel symbols in a query
    force the canonical empty range (no garbage ranks from starts-1 wrap)."""
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=400)
    engine = FmQueryEngine(index)
    text = records[0][1]
    queries = [b"$", text[:6] + b"$", b"#" + text[:6], text[:6]]
    counts = engine.count_batch(queries)
    assert counts[0] == 0 and counts[1] == 0 and counts[2] == 0
    assert counts[3] >= 1
    assert engine.locate_batch(queries)[:3] == [[], [], []]


def test_text_pos_mod_wraparound():
    """_text_pos_mod is exact for bwt_len near 2**32 where the raw uint32 sum
    wraps (ADVICE round-1: locate walks within ~steps of the uint32 cap)."""
    import jax.numpy as jnp

    from awry_tpu.ops.locate import _text_pos_mod

    bwt_len = 2**32 - 5
    sa = np.array([bwt_len - 1, bwt_len - 1, 7, 0, bwt_len - 2], dtype=np.uint32)
    steps = np.array([0, 300, 2, 0, bwt_len - 1], dtype=np.uint32)
    expected = (sa.astype(np.uint64) + steps.astype(np.uint64)) % np.uint64(bwt_len)
    got = _text_pos_mod(jnp.asarray(sa), jnp.asarray(steps), bwt_len)
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint64), expected)


def test_count_locate_arrays_and_stream_parity(rng):
    """The bulk flat-array API and the pipelined stream API agree with
    count_locate_batch (including over-cap queries) on a low cap."""
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=1500, kmer_len=3)
    engine = FmQueryEngine(index)
    text = records[0][1]
    queries = [text[i : i + 4] for i in range(0, 60, 3)] + [text[10:40], b"A"]
    counts, results = engine.count_locate_batch(queries, cap=2)
    a_counts, seq_idx, local, offsets = engine.count_locate_arrays(queries, cap=2)
    np.testing.assert_array_equal(a_counts, counts)
    for i, r in enumerate(results):
        got = list(zip(seq_idx[offsets[i] : offsets[i + 1]].tolist(),
                       local[offsets[i] : offsets[i + 1]].tolist()))
        assert got == r, i
    # stream over two batches == arrays over each batch
    batches = [queries[:7], queries[7:]]
    streamed = list(engine.count_locate_stream(batches, cap=2))
    assert len(streamed) == 2
    for batch, (s_counts, s_seq, s_loc, s_off) in zip(batches, streamed):
        b_counts, b_seq, b_loc, b_off = engine.count_locate_arrays(batch, cap=2)
        np.testing.assert_array_equal(s_counts, b_counts)
        np.testing.assert_array_equal(s_seq, b_seq)
        np.testing.assert_array_equal(s_loc, b_loc)
        np.testing.assert_array_equal(s_off, b_off)


def test_device_sustained_qps_probe(rng):
    """The capacity probe runs the fused paths end to end (verify when
    enabled, classic otherwise) and returns a positive rate."""
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=1500, kmer_len=3)
    text = records[0][1]
    queries = [text[i : i + 12] for i in range(0, 96, 8)]
    for use_verify in (None, False):
        engine = FmQueryEngine(index, use_verify=use_verify)
        batches = [(*engine.encode_queries(queries), len(queries))]
        qps = engine.device_sustained_qps(batches, cap=2, trials=1)
        assert qps > 0


def test_crumb_wire_selection_and_parity(rng):
    """Pure-ACGT batches ship on the 2-bit crumb wire (int8); batches with
    ambiguity or sentinel symbols fall back to the nibble wire (uint8);
    results are identical either way."""
    import jax.numpy as jnp

    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 20_000)
    index = build_from_records([("r", seq)], FmBuildArgs(lookup_table_kmer_len=5))
    eng = FmQueryEngine(index)
    pure = [bytes(seq[s : s + 21]) for s in rng.integers(0, 19_000, size=64)]
    qw, _ = eng.encode_queries(pure)
    assert qw.dtype == jnp.int8  # crumb wire
    for bad in (b"ACGTNACGTA", b"ACG$ACGTACG", b"acgurrrr"):
        qw_bad, _ = eng.encode_queries(pure + [bad])
        assert qw_bad.dtype == jnp.uint8, bad  # nibble fallback
    # RNA 'u' is dense (U == T) and lowercase folds: still crumb.
    qw_rna, _ = eng.encode_queries([b"acgu" * 5])
    assert qw_rna.dtype == jnp.int8

    from .oracle import kmer_position_map

    kmap = kmer_position_map(seq, 21)
    counts = eng.count_batch(pure)
    locs = eng.locate_batch(pure)
    for q, c, ls in zip(pure, counts, locs):
        assert c == len(kmap[q])
        assert sorted(p for _, p in ls) == sorted(kmap[q])
    # Mixed batch (nibble wire) agrees on the shared queries.
    counts2 = eng.count_batch(pure + [b"ACGTNACGTA"])
    np.testing.assert_array_equal(counts2[: len(pure)], counts)


def test_vmem_regime_gate_skips_fat_tables(rng, monkeypatch):
    """Past FAT_TABLE_MAX_BYTES the per-BWT-row extras (verify_windows fat
    rows, marked_sa8) must NOT ship - at chr1 scale they cost ~9 GB of
    device memory - and the engine must still answer exactly through the
    walk + text-compare fallback."""
    import awry_tpu.ops.device_index as di

    text = random_seq(Alphabet.NUCLEOTIDE, rng, 1500)
    index = build_from_records(
        [("s", text)], FmBuildArgs(lookup_table_kmer_len=3, locate_mark_ratio=1)
    )
    assert to_device(index).verify_windows is not None  # under the gate

    monkeypatch.setattr(di, "FAT_TABLE_MAX_BYTES", 64 * di.FAT_ROW_BYTES)
    dev = to_device(index)
    assert dev.verify_windows is None
    assert dev.marked_sa8 is None

    engine = FmQueryEngine(dev)
    kmap = kmer_position_map(text, 12)
    queries = list(kmap.keys())[:32]
    counts, results = engine.count_locate_batch(queries)
    for q, c, hits in zip(queries, counts, results):
        positions = kmap[q]
        assert int(c) == len(positions), q
        assert sorted(hits) == sorted(localize(positions, index.seq_starts)), q


def test_minimal_device_index_serves_ranges(rng):
    """minimal=True ships rank machinery only; backward search over it must
    match the host engine (the device k-mer build depends on this)."""
    import jax.numpy as jnp

    from awry_tpu.ops.engine import encode_query_batch
    from awry_tpu.ops.search import search_ranges

    text = random_seq(Alphabet.NUCLEOTIDE, rng, 1200)
    index = build_from_records([("s", text)], FmBuildArgs(lookup_table_kmer_len=3))
    dev = to_device(index, minimal=True)
    assert dev.text_packed is None and dev.verify_windows is None
    assert dev.kmer_len == 0  # placeholder table must never seed a search

    queries = [bytes(random_seq(Alphabet.NUCLEOTIDE, rng, 9)) for _ in range(24)]
    qs, ql = encode_query_batch(index.alphabet, queries)
    starts, ends = search_ranges(dev, jnp.asarray(qs), jnp.asarray(ql))
    enc = he._encode_queries(index.alphabet, queries)
    for i, syms in enumerate(enc):
        hs, hend = he.search_range_for_symbols(index, syms)
        assert (int(starts[i]), int(ends[i])) == (int(hs), int(hend))


def test_overcap_walk_is_slabbed(rng, monkeypatch):
    """Over-cap locate expansion runs in bounded walk dispatches: repetitive
    texts expand to tens of millions of rows, and one dispatch that size
    would hold a gathered row per hit in device memory at once.  With a
    tiny slab the results must be unchanged."""
    import awry_tpu.ops.engine as eng_mod

    # ~40 copies of one repeat: every repeat-drawn query has ~40 hits.
    unit = bytes(random_seq(Alphabet.NUCLEOTIDE, rng, 60))
    text = unit * 40 + bytes(random_seq(Alphabet.NUCLEOTIDE, rng, 500))
    index = build_from_records([("s", text)], FmBuildArgs(lookup_table_kmer_len=3))
    engine = FmQueryEngine(index)
    queries = [unit[i : i + 8] for i in range(0, 40, 4)] + [text[-50:-30]]
    baseline = engine.count_locate_arrays(queries, cap=2)

    monkeypatch.setattr(eng_mod, "_OVERCAP_WALK_SLAB", 64)
    engine2 = FmQueryEngine(index)
    slabbed = engine2.count_locate_arrays(queries, cap=2)
    for a, b in zip(baseline, slabbed):
        np.testing.assert_array_equal(a, b)
    he_counts = [he.count(index, q) for q in queries]
    np.testing.assert_array_equal(slabbed[0].astype(np.int64), he_counts)
    assert sum(c for c in he_counts if c > 2) > 2 * 64  # expansion spanned slabs


def test_lean_engine_parity_and_footprint(rng):
    """lean=True skips the slim search copy, text_rows8 and (with marks) the
    row-sampled SA; count/locate stay exact (the pan-genome federation's
    four-partitions-one-chip HBM fit depends on every skip)."""
    text = random_seq(Alphabet.NUCLEOTIDE, rng, 3000)
    index = build_from_records([("s", text)], FmBuildArgs(lookup_table_kmer_len=3))
    lean_eng = FmQueryEngine(index, lean=True)
    dev = lean_eng.device_index
    assert dev.blocks_search is None
    assert dev.text_rows8 is None
    assert dev.sampled_sa.shape == (1,)  # marked index: row-sampled SA unused

    full_eng = FmQueryEngine(index)
    assert full_eng.device_index.sampled_sa.shape == (1,)  # marks: default skip
    kmap = kmer_position_map(text, 10)
    queries = list(kmap.keys())[:48]
    for a, b in zip(
        lean_eng.count_locate_arrays(queries, cap=2),
        full_eng.count_locate_arrays(queries, cap=2),
    ):
        np.testing.assert_array_equal(a, b)
    counts = lean_eng.count_batch(queries)
    for q, c in zip(queries, counts):
        assert int(c) == len(kmap[q])



@pytest.mark.parametrize("mark_ratio", [1, 2, 8])
@pytest.mark.parametrize("fat_gate", ["fat_rows", "walk_compare"])
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_plain_read_parity(alphabet, fat_gate, mark_ratio, rng, monkeypatch, tmp_path):
    """Every plain-read path of the default engine against the host engine:
    the k-mer seed gather, post-seed rank gathers, the SA read (mark 1: the
    8-word-row or element gather; mark > 1: the bounded marked walk), and
    either the fat-row gather or the walk + text compare (fat tables ship
    only at mark 1 and under FAT_TABLE_MAX_BYTES).  locate_mark_ratio
    changes the walk, never results, and survives the artifact round trip."""
    import awry_tpu.ops.device_index as di
    from awry_tpu.io.artifact import load_artifact, save_artifact

    if fat_gate == "walk_compare":
        monkeypatch.setattr(di, "FAT_TABLE_MAX_BYTES", 0)
    n, qlen = (4000, 24) if alphabet is Alphabet.NUCLEOTIDE else (2500, 10)
    seq = random_seq(alphabet, rng, n)
    index = build_from_records(
        [("p", seq)],
        FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=3, locate_mark_ratio=mark_ratio),
    )
    assert index.resolved_mark_ratio == mark_ratio
    assert index.text_sampled_sa.shape[0] == -(-index.bwt_len // mark_ratio)
    engine = FmQueryEngine(index)
    dev = engine.device_index
    fat = mark_ratio == 1 and fat_gate == "fat_rows"
    assert (dev.verify_windows is not None) == fat
    assert (dev.marked_sa8 is not None) == fat
    assert engine._verify_enabled

    queries = [seq[s : s + qlen] for s in rng.integers(0, n - qlen, size=96)]
    queries += [seq[:qlen], seq[-qlen:], seq[10:14], random_seq(alphabet, rng, qlen), b""]
    counts, seq_idx, local, offsets = engine.count_locate_arrays(queries, cap=2)
    for i, q in enumerate(queries):
        assert int(counts[i]) == he.count(index, q), q
        got = list(zip(seq_idx[offsets[i] : offsets[i + 1]].tolist(),
                       local[offsets[i] : offsets[i + 1]].tolist()))
        assert sorted(got) == sorted(he.locate(index, q)), q

    save_artifact(index, str(tmp_path / "i.npz"))
    assert load_artifact(str(tmp_path / "i.npz")).resolved_mark_ratio == mark_ratio


def test_device_path_is_plain_jax():
    """The library is plain JAX: no Pallas kernel written for another
    accelerator, no interpret-mode kernel call, no per-backend switch."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "awry_tpu"
    banned = ("pallas.tpu", "pltpu", "interpret=", 'default_backend() == "tpu"', "use_sweep")
    for path in root.rglob("*.py"):
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{path}: {word}"
