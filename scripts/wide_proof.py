"""Build and SERVE a >4.3 Gbp single index.

Builds a 4.4e9-symbol synthetic DNA text (past uint32 positions: the
reference's u64 capability, src/search.rs:7), serves count+locate on the
device through FmQueryEngine's wide (64-bit) path with host-oracle parity
checks, and round-trips the index through the .awry format at that scale.
Writes wide_proof_results.json.

Stages are resumable (SA sidecar + artifact cache under .bench_cache/).
RAM peak ~70 GB during the i64 SA-IS build; run alone.

Usage: python scripts/wide_proof.py [build|serve|awry|all]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, ".")

import numpy as np

N = 4_400_000_000  # > 2^32: forces the 64-bit path end-to-end
K = 8  # small seed table so the .awry round trip's re-derivation is cheap
MARK = 8
NQ = 131_072
QLEN = 30
CACHE = ".bench_cache/wide_proof_4.4Gbp.npz"
AWRY = ".bench_cache/wide_proof_4.4Gbp.awry"
RESULTS = "wide_proof_results.json"


def log(*a):
    print(*a, flush=True)


def synth():
    rng = np.random.default_rng([7, 44])
    t0 = time.time()
    text = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=N)
    log(f"text synthesized in {time.time()-t0:.0f}s")
    return text


def build(text):
    from awry_tpu import FmBuildArgs
    from awry_tpu.build.builder import build_from_sequence_data
    from awry_tpu.io.artifact import load_artifact, save_artifact
    from awry_tpu.io.sequence_io import SequenceData

    if os.path.exists(CACHE):
        t0 = time.time()
        idx = load_artifact(CACHE)
        log(f"loaded cached wide index in {time.time()-t0:.0f}s")
        return idx
    import logging

    logging.basicConfig(stream=sys.stderr)
    logging.getLogger("awry_tpu.build").setLevel(logging.INFO)
    seq_data = SequenceData(
        text=text,
        start_positions=np.array([0], dtype=np.int64),
        headers=["wide_proof"],
    )
    t0 = time.time()
    idx = build_from_sequence_data(
        seq_data,
        FmBuildArgs(
            lookup_table_kmer_len=K,
            locate_mark_ratio=MARK,
            suffix_array_output_src=CACHE + ".sa.npy",
            remove_intermediate_suffix_array_file=True,
        ),
    )
    log(f"built in {time.time()-t0:.0f}s; bwt_len={idx.bwt_len}")
    assert idx.bwt_len >= 2**32
    assert idx.sampled_sa.dtype == np.uint64 and idx.kmer_table.dtype == np.uint64
    t0 = time.time()
    save_artifact(idx, CACHE, compress=False)
    log(f"artifact saved in {time.time()-t0:.0f}s")
    return idx


def serve(idx, text, results):
    import awry_tpu.host_engine as he
    from awry_tpu.ops import FmQueryEngine

    t0 = time.time()
    eng = FmQueryEngine(idx)
    assert eng._wide, "engine must auto-route to the 64-bit path"
    log(f"wide engine constructed in {time.time()-t0:.0f}s")

    rng = np.random.default_rng(99)
    starts = rng.integers(0, N - QLEN, size=NQ)
    queries = [bytes(text[s : s + QLEN]) for s in starts]

    t0 = time.time()
    counts, seq_idx, local, offsets = eng.count_locate_arrays(queries, cap=2)
    warm = time.time() - t0
    assert (counts >= 1).all(), "drawn query not found"
    # Oracle parity on a sample (host engine is u64-clean end-to-end).
    for i in rng.integers(0, NQ, size=24):
        assert int(counts[i]) == he.count(idx, queries[i]), i
        span = sorted(local[offsets[i] : offsets[i + 1]].tolist())
        assert span == sorted(p for _, p in he.locate(idx, queries[i])), i
        assert int(starts[i]) in span
    log(f"parity ok on 24 sampled queries (warm batch {warm:.1f}s)")

    best = 0.0
    for trial in range(3):
        t0 = time.time()
        eng.count_locate_arrays(queries, cap=2)
        qps = NQ / (time.time() - t0)
        best = max(best, qps)
        log(f"trial {trial}: {qps:,.0f} q/s")
    results["serve"] = {
        "bwt_len": idx.bwt_len,
        "queries_per_sec": round(best, 1),
        "num_queries": NQ,
        "query_len": QLEN,
        "kmer_len": K,
        "mark_ratio": MARK,
        "oracle": "count+locate parity vs host engine on 24 sampled queries",
    }
    eng.release()


def awry_roundtrip(idx, results):
    from awry_tpu.io.awry_format import load_awry, save_awry

    t0 = time.time()
    save_awry(idx, AWRY)
    save_s = time.time() - t0
    log(f".awry saved in {save_s:.0f}s ({os.path.getsize(AWRY)/1e9:.2f} GB)")
    t0 = time.time()
    idx2 = load_awry(AWRY)
    load_s = time.time() - t0
    assert idx2.bwt_len == idx.bwt_len
    np.testing.assert_array_equal(idx2.prefix_sums, idx.prefix_sums)
    np.testing.assert_array_equal(idx2.planes[:1000], idx.planes[:1000])
    np.testing.assert_array_equal(idx2.planes[-1000:], idx.planes[-1000:])
    np.testing.assert_array_equal(
        idx2.sampled_sa[:100_000], idx.sampled_sa[:100_000].astype(np.uint64)
    )
    np.testing.assert_array_equal(
        idx2.kmer_table, idx.kmer_table.astype(np.uint64)
    )
    log(".awry round trip bit-exact (planes spot blocks, packed SA prefix, full kmer table)")
    results["awry_roundtrip"] = {
        "file_gb": round(os.path.getsize(AWRY) / 1e9, 2),
        "save_s": round(save_s, 1),
        "load_s": round(load_s, 1),
    }
    os.remove(AWRY)


def main():
    stage = sys.argv[1] if len(sys.argv) > 1 else "all"
    results = {}
    if os.path.exists(RESULTS):
        results = json.load(open(RESULTS))
    text = synth()
    idx = build(text)
    if stage in ("serve", "all"):
        serve(idx, text, results)
        json.dump(results, open(RESULTS, "w"), indent=2)
    if stage in ("awry", "all"):
        del text
        awry_roundtrip(idx, results)
        json.dump(results, open(RESULTS, "w"), indent=2)
    log(json.dumps(results))


if __name__ == "__main__":
    main()
