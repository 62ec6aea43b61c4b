"""Multi-device engines on the 8-virtual-CPU-device mesh: replicated (Mode A)
and range-sharded (Mode B) must match the host engine exactly."""

import jax
import numpy as np
import pytest

import awry_tpu.host_engine as he
from awry_tpu import Alphabet, FmBuildArgs, build_from_records
from awry_tpu.parallel import ShardedFmEngine, make_mesh

from .conftest import random_seq
from .oracle import kmer_position_map, localize


def _build(alphabet, rng, n=900, kmer_len=3, num_records=1, sa_ratio=None):
    records = []
    for i in range(num_records):
        ln = n if num_records == 1 else int(rng.integers(20, n))
        records.append((f"seq_{i}", random_seq(alphabet, rng, ln)))
    args = FmBuildArgs(
        alphabet=alphabet,
        lookup_table_kmer_len=kmer_len,
        suffix_array_compression_ratio=sa_ratio,
    )
    return build_from_records(records, args), records


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


@pytest.mark.parametrize("shard_size", [1, 2, 4, 8])
def test_sharded_count_matches_host(shard_size, rng):
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=1100)
    engine = ShardedFmEngine(index, shard_size=shard_size)
    text = records[0][1]
    kmap = kmer_position_map(text, 10)
    queries = list(kmap.keys())[:64]
    queries += [b"GGGGGGGGGGGG", b"A", b""]
    got = engine.count_batch(queries)
    expected = np.array([he.count(index, q) for q in queries])
    np.testing.assert_array_equal(got.astype(np.int64), expected)


@pytest.mark.parametrize("shard_size", [1, 4])
def test_sharded_locate_matches_host(shard_size, rng):
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=700, sa_ratio=8)
    engine = ShardedFmEngine(index, shard_size=shard_size)
    text = records[0][1]
    kmap = kmer_position_map(text, 7)
    queries = list(kmap.keys())[:48]
    locs = engine.locate_batch(queries)
    for q, got in zip(queries, locs):
        assert sorted(got) == sorted(localize(kmap[q], index.seq_starts)), q


def test_sharded_amino(rng):
    index, records = _build(Alphabet.AMINO, rng, n=300, kmer_len=2)
    engine = ShardedFmEngine(index, shard_size=2)
    text = records[0][1]
    kmap = kmer_position_map(text, 4)
    queries = list(kmap.keys())[:32]
    got = engine.count_batch(queries)
    expected = np.array([len(kmap[q]) for q in queries])
    np.testing.assert_array_equal(got.astype(np.int64), expected)


def test_explicit_mesh_shapes(rng):
    index, _ = _build(Alphabet.NUCLEOTIDE, rng, n=600)
    mesh = make_mesh(num_devices=4, shard_size=2)
    assert mesh.shape == {"data": 2, "shard": 2}
    engine = ShardedFmEngine(index, mesh=mesh)
    assert engine.num_shards == 2 and engine.data_size == 2
    assert int(engine.count_batch([b"ACG"])[0]) == he.count(index, b"ACG")


def test_range_sharding_actually_shards(rng):
    """The planes arrays must be placed block-sharded, not replicated."""
    index, _ = _build(Alphabet.NUCLEOTIDE, rng, n=3000)
    engine = ShardedFmEngine(index, shard_size=8)
    sharding = engine.device_index.blocks.sharding
    assert sharding.spec[0] == "shard"
    # Each device holds only its slice of the padded block axis.
    nb = engine.device_index.blocks.shape[0]
    shard_shapes = {s.data.shape for s in engine.device_index.blocks.addressable_shards}
    assert shard_shapes == {(nb // 8,) + engine.device_index.blocks.shape[1:]}


def test_sharded_locate_cap_overflow(rng):
    """Queries whose hit counts exceed locate_cap must fall back to the
    unbounded path and still match the host engine."""
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=800, kmer_len=2)
    engine = ShardedFmEngine(index, shard_size=2, locate_cap=2)
    queries = [b"A", b"AC", records[0][1][3:9], b""]
    got = engine.locate_batch(queries)
    for q, hits in zip(queries, got):
        assert sorted(hits) == sorted(he.locate(index, q)), q


# ---------------------------------------------------------------------------
# Data-parallel FmQueryEngine(mesh=...): the FULL serving machinery
# (seed-walk-verify, crumb wire, ragged assembly) under shard_map.
# ---------------------------------------------------------------------------


def test_mesh_engine_full_serving_parity(rng):
    """FmQueryEngine(mesh=2x'data') must reproduce the single-device engine
    bit-for-bit through count/locate/count_locate_arrays, with the verify
    path (fat rows: a mark=1 index under the fat-table budget) live on
    every device."""
    from awry_tpu.ops import FmQueryEngine
    from jax.sharding import Mesh

    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=120_000, kmer_len=5)
    text = records[0][1]
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("data",))
    ref = FmQueryEngine(index)
    eng = FmQueryEngine(index, mesh=mesh)
    assert eng._verify_enabled and eng._data_shards == 2

    starts = rng.integers(0, len(text) - 25, size=8188)
    queries = [text[s : s + 25] for s in starts]
    queries += [b"ACGTACGTACGTACGTACGTACGTA", b"A", b"", text[5:9] * 6]

    np.testing.assert_array_equal(eng.count_batch(queries), ref.count_batch(queries))

    counts, seq_idx, local, offsets = eng.count_locate_arrays(queries, cap=2)
    c2, s2, l2, o2 = ref.count_locate_arrays(queries, cap=2)
    np.testing.assert_array_equal(counts, c2)
    np.testing.assert_array_equal(offsets, o2)
    for i in range(len(queries)):
        a = sorted(zip(seq_idx[offsets[i]:offsets[i+1]].tolist(), local[offsets[i]:offsets[i+1]].tolist()))
        b = sorted(zip(s2[o2[i]:o2[i+1]].tolist(), l2[o2[i]:o2[i+1]].tolist()))
        assert a == b, i


def test_mesh_engine_stream_and_stats(rng):
    """count_locate_stream pipelines over the mesh engine; serving-shape
    stats accumulate; the crumb (2-bit) wire is exercised (pure-ACGT
    queries) alongside the nibble wire (queries with N)."""
    from awry_tpu.ops import FmQueryEngine
    from jax.sharding import Mesh

    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=60_000, kmer_len=4)
    text = records[0][1]
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("data",))
    eng = FmQueryEngine(index, mesh=mesh)
    ref = FmQueryEngine(index)

    pure = [text[i : i + 20] for i in range(0, 2000, 13)]
    with_n = [b"ACGTNACGT", b"NNN"] + pure[:6]
    batches = [eng.encode_queries(pure) + (len(pure),), eng.encode_queries(with_n) + (len(with_n),)]
    assert batches[0][0].dtype == np.int8  # crumb wire
    ref_batches = [ref.encode_queries(pure) + (len(pure),), ref.encode_queries(with_n) + (len(with_n),)]

    outs = list(eng.count_locate_stream(batches, cap=2))
    refs = list(ref.count_locate_stream(ref_batches, cap=2))
    for (c, si, lo, of), (rc, rsi, rlo, rof) in zip(outs, refs):
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(of, rof)
        for i in range(len(c)):
            assert sorted(zip(si[of[i]:of[i+1]].tolist(), lo[of[i]:of[i+1]].tolist())) == \
                   sorted(zip(rsi[rof[i]:rof[i+1]].tolist(), rlo[rof[i]:rof[i+1]].tolist()))
    assert eng.stats["batches"] >= 1 and eng.stats["queries"] > 0


def test_mode_b_crumb_wire(rng):
    """Mode B (range-sharded, psum-merged rank steps) at a serving-sized
    batch: counts/locates must match the host engine.  Queries are pure
    ACGT, so the crumb (2-bit) wire is exercised through the sharded
    unwire path."""
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=140_000, kmer_len=5)
    text = records[0][1]
    engine = ShardedFmEngine(index, shard_size=4)
    starts = rng.integers(0, len(text) - 22, size=4092)
    queries = [text[s : s + 22] for s in starts] + [b"ACGTACGT", b"AC", text[3:7] * 5, b""]
    enc, _ = engine._encode(queries)
    assert enc.dtype == np.int8  # crumb wire engaged

    got = engine.count_batch(queries)
    expected = np.array([he.count(index, q) for q in queries], dtype=np.uint64)
    np.testing.assert_array_equal(got, expected)

    sample = queries[:40] + queries[-4:]
    locs = engine.locate_batch(sample)
    for q, got_l in zip(sample, locs):
        assert sorted(got_l) == sorted(he.locate(index, q)), q


def test_mode_b_count_locate_arrays_overflow(rng):
    """Vectorized ragged assembly incl. the shared over-cap walk dispatch."""
    index, records = _build(Alphabet.NUCLEOTIDE, rng, n=3000, kmer_len=3)
    text = records[0][1]
    engine = ShardedFmEngine(index, shard_size=2, locate_cap=2)
    queries = [text[i : i + 3] for i in range(0, 40, 5)]  # 3-mers: far over cap
    queries += [text[10:40], b"ACGTACGTACGT"]
    counts, seq_idx, local, offsets = engine.count_locate_arrays(queries)
    for i, q in enumerate(queries):
        hits = sorted(zip(seq_idx[offsets[i]:offsets[i+1]].tolist(), local[offsets[i]:offsets[i+1]].tolist()))
        assert hits == sorted(he.locate(index, q)), q
        assert int(counts[i]) == he.count(index, q)
