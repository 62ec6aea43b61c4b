"""Seed-walk-verify path (ops/verify.py) vs the classic path and the oracle.

The adversarial cases that matter: matches at position 0 (the backward
window gather runs into the front padding), queries that agree on their
last S symbols but DIFFER in the prefix (verification must reject),
repetitive texts whose seeds stay wide at the switch step (classic
re-dispatch), short queries, and the amino (8-bit packed) codec.
"""

import numpy as np
import pytest

import awry_tpu.host_engine as he
from awry_tpu import Alphabet, FmBuildArgs, build_from_records
from awry_tpu.ops import FmQueryEngine

from .conftest import random_seq


def _engine(seq, *, alphabet=Alphabet.NUCLEOTIDE, k=4):
    index = build_from_records(
        [("v", seq)], FmBuildArgs(alphabet=alphabet, lookup_table_kmer_len=k)
    )
    eng = FmQueryEngine(index)
    assert eng._verify_enabled
    return index, eng


def _check_against_classic(index, eng, queries, cap=4):
    classic = FmQueryEngine(index, use_verify=False)
    assert not classic._verify_enabled
    c1, s1, l1, o1 = eng.count_locate_arrays(queries, cap=cap)
    c2, s2, l2, o2 = classic.count_locate_arrays(queries, cap=cap)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(l1, l2)
    # Oracle spot checks
    for i in (0, len(queries) - 1):
        assert he.count(index, queries[i]) == int(c1[i])


def test_verify_matches_classic_random(rng):
    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 60_000)
    index, eng = _engine(seq)
    queries = [seq[s : s + 24] for s in rng.integers(0, 59_000, size=256)]
    # Position-0 match: window gather leans on the front padding.
    queries.append(seq[:20])
    # Same suffix, corrupted prefix: seed+walk succeed, verify must reject.
    good = bytearray(seq[1000:1024])
    bad = bytes([good[0] ^ 6]) + bytes(good[1:])  # flip the FIRST symbol
    queries += [bytes(good), bad]
    # Short (<= switch step) queries with many hits, empty, sentinel.
    queries += [b"ACG", b"", b"AC$GT"]
    _check_against_classic(index, eng, queries)


def test_verify_wide_lanes_redispatch(rng):
    """A repetitive text keeps seeds wide at the switch step; those lanes
    must flow through the classic re-dispatch and stay exact."""
    unit = bytes(random_seq(Alphabet.NUCLEOTIDE, rng, 100))
    seq = unit * 400 + bytes(random_seq(Alphabet.NUCLEOTIDE, rng, 10_000))
    index, eng = _engine(seq, k=3)
    queries = [unit[10:40], unit[:25], seq[-500:-470], unit * 2][:4]
    counts = eng.count_batch(queries)
    c1, s1, l1, o1 = eng.count_locate_arrays(queries, cap=8)
    for i, q in enumerate(queries):
        assert int(c1[i]) == he.count(index, q) == int(counts[i])
    # locations of the wide query verified against the oracle
    oracle = he.locate(index, queries[0])
    got = list(zip(s1[o1[0] : o1[1]].tolist(), l1[o1[0] : o1[1]].tolist()))
    assert sorted(got) == sorted(oracle)
    assert len(got) > 8  # genuinely wide: exercised the over-cap path too


def _planted_text(rng, n, motif, prefixes):
    """ACG-only random base text with `prefix + motif` planted at spaced
    positions; the motif contains T so it cannot occur by chance."""
    base = bytearray(random_seq(Alphabet.NUCLEOTIDE, rng, n).replace(b"T", b"A"))
    gap = n // (len(prefixes) + 1)
    spots = []
    for i, pfx in enumerate(prefixes):
        at = gap * (i + 1)
        base[at : at + len(pfx) + len(motif)] = pfx + motif
        spots.append(at)
    return bytes(base), spots


def test_verify_wide_settled_on_device(rng):
    """Lanes whose step-s range is 2..WIDE_CAP wide are settled inside the
    fused kernel (count AND positions), including partial verification:
    candidates sharing the s-suffix but differing upstream must be
    rejected individually.  Width WIDE_CAP+1 exceeds the cap and takes the
    classic redispatch.  All compared against the classic engine + oracle."""
    from awry_tpu.ops.verify import WIDE_CAP

    # k=4 -> switch step s=8; motifs carry T so the ACG base can't collide.
    m2, m4, m5 = b"TTGTACTT", b"TTCATGTT", b"TTACGTTT"
    p = b"ACGGACAGGCAC"
    q = b"CAGCGAAGGACG"
    plants = (
        [(p, m2)] * 2                               # width 2, both verify
        + [(p, m4)] * 2 + [(q, m4), (b"AAA" + q[3:], m4)]  # width 4, 2/1/1 split
        + [(p, m5)] * (WIDE_CAP + 1)                # width 5 > WIDE_CAP: redispatch
    )
    seq, _ = _planted_text(
        rng, 120_000, b"", [pp + mm for pp, mm in plants]
    )
    index, eng = _engine(seq, k=4)
    queries = [
        p + m2,                  # wide-settled, count 2
        p + m4,                  # wide-settled, count 2 of width 4
        q + m4,                  # wide-settled, count 1 (others rejected)
        b"GGGGAAGGACGT" + m4,    # wide lane, count 0 (no candidate verifies)
        p + m5,                  # width > WIDE_CAP: classic redispatch
        m4[-6:],                 # short query (<= s) stays classic
    ]
    _check_against_classic(index, eng, queries, cap=8)


def test_verify_fast_path_with_wide_settled(rng):
    """The all-singleton fast path must fire even when some lanes are
    wide-settled (step-s width 2..WIDE_CAP, verified down to ONE true hit):
    real 512k serving batches always contain a few such lanes
    (wide_lane_rate 1.7-5.7%), and the original zero-wide gate meant the
    fast path never fired at serving shapes (round-4 verdict weak #5).
    Wide lanes scatter their slot position; host-resolved stray redis
    lanes (true count 1) are tolerated too; results stay exact."""
    m4 = b"TTCATGTT"
    p = b"ACGGACAGGCAC"
    q = b"CAGCGAAGGACG"
    # Full ACGT base (drawn 24-mers are unique-ish, like real reads); m4
    # planted with prefixes whose last symbols collide for the q-variants:
    # the step-s suffix of ``q + m4`` has width 2, the full query width 1.
    base = bytearray(random_seq(Alphabet.NUCLEOTIDE, rng, 120_000))
    for i, plant in enumerate([p + m4, q + m4, b"AAA" + q[3:] + m4]):
        at = 30_000 * (i + 1)
        base[at : at + len(plant)] = plant
    seq = bytes(base)
    index, eng = _engine(seq, k=4)
    queries = [seq[s : s + 24] for s in rng.integers(0, 100_000, size=64)]
    queries += [p + m4, q + m4]
    # The gate needs every lane at exactly one TRUE hit; drop any random
    # draw that happens to repeat (count_batch is exact, so any surviving
    # redis lane resolves host-side to count 1 and stays on the fast path).
    counts0 = eng.count_batch(queries)
    queries = [qq for qq, c in zip(queries, counts0) if int(c) == 1]
    assert (p + m4) in queries and (q + m4) in queries
    eng.stats["fast_path_batches"] = 0
    eng.stats["wide_lanes"] = 0
    _check_against_classic(index, eng, queries, cap=4)
    assert eng.stats["fast_path_batches"] >= 1
    assert eng.stats["wide_lanes"] >= 1  # q+m4 settled wide, inside the fast path


def test_verify_wide_group_budget_overflow(rng):
    """More wide lanes than wide_groups(B) slots: the overflow lanes must
    fall back to the classic redispatch and stay exact."""
    from awry_tpu.ops.verify import wide_groups

    motif = b"TTGAGCTT"
    pfx = b"ACGGACAGGCAC"
    seq, _ = _planted_text(rng, 80_000, b"", [pfx + motif] * 2)
    index, eng = _engine(seq, k=4)
    n_wide = wide_groups(16) + 8  # every lane is width-2 wide at s
    queries = [pfx + motif] * n_wide
    _check_against_classic(index, eng, queries, cap=4)


def test_seeded_chain_parity(rng):
    """The all-seeded loop arm (every lane k-mer-seeded: the post-seed rank
    steps start at k with no per-step any(active) reduce) must stay
    bit-exact vs the classic engine — including seed-miss lanes
    (canonicalized empty), queries going empty mid-chain, N symbols in
    post-seed steps, and length-k lanes.  A batch with a short (<k) query
    must still be exact through the generic masked-loop arm."""
    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 60_000)
    index, eng = _engine(seq, k=6)  # s = 10 -> 4 post-seed steps
    assert eng._verify_s - index.kmer_len <= 6
    queries = [seq[s : s + 24] for s in rng.integers(0, 59_000, size=128)]
    queries += [
        b"TTTTTTGGGGGGCCCCAAAAACGT",  # almost surely absent: empties mid-chain
        b"ACGTNA" + seq[500:514],     # N in a post-seed step position
        seq[777 : 777 + 6],           # exactly k symbols: zero chain steps live
        seq[3000:3024],
    ]
    _check_against_classic(index, eng, queries)
    # Short query in the batch: all_dense is false, the generic arm serves.
    _check_against_classic(index, eng, queries[:8] + [seq[40:43]])


def test_verify_amino_byte_packed(rng):
    seq = random_seq(Alphabet.AMINO, rng, 50_000)
    index, eng = _engine(seq, alphabet=Alphabet.AMINO, k=3)
    queries = [seq[s : s + 12] for s in rng.integers(0, 49_000, size=128)]
    queries += [seq[:10], b"MMMM"]
    _check_against_classic(index, eng, queries)


def test_verify_mixed_lengths(rng):
    """Lengths straddling the switch step in one batch."""
    seq = random_seq(Alphabet.NUCLEOTIDE, rng, 80_000)
    index, eng = _engine(seq, k=5)  # switch = 11 (scale-aware)
    queries = []
    for ln in (4, 8, 9, 10, 15, 31):
        starts = rng.integers(0, 79_000, size=8)
        queries += [seq[s : s + ln] for s in starts]
    _check_against_classic(index, eng, queries, cap=8)


def test_switch_step_scale_aware():
    """The handover depth tracks index scale: expected spurious width
    bwt_len / base^s must be under SPURIOUS_TARGET, never below the seed."""
    import dataclasses
    import types

    from awry_tpu.ops.verify import SPURIOUS_TARGET, switch_step

    def fake(card, bwt_len, k):
        return types.SimpleNamespace(
            alphabet=types.SimpleNamespace(cardinality=card),
            bwt_len=bwt_len,
            kmer_len=k,
        )

    # DNA (base 4): pinned depths at the bench scales.
    assert switch_step(fake(6, 4_600_000, 10)) == 14
    assert switch_step(fake(6, 250_000_000, 13)) == 16
    assert switch_step(fake(6, 3_100_000_000, 13)) == 18
    # Amino (base 20): much shallower.
    assert switch_step(fake(22, 20_000_000, 5)) == 7
    # Never below the k-mer seed (the seed is a single gather).
    assert switch_step(fake(6, 1_000, 8)) == 8
    # Invariant across a scale sweep.
    for n in (10**3, 10**6, 10**9, 10**10):
        s = switch_step(fake(6, n, 2))
        assert n / 4**s <= SPURIOUS_TARGET or s == 2
        assert n / 4 ** (s - 1) > SPURIOUS_TARGET or s <= 2
