"""Pan-genome federation demo: >= 8 Gbp partitioned build + exact queries.

bench.py's pan-genome config at synthetic scale: a multi-record corpus beyond the
uint32 position space of a single index, split at record boundaries into
per-partition FM-indexes (awry_tpu/parallel/partitioned.py) built in
PARALLEL worker processes, then queried with planted-occurrence oracles:

* random 30-mers are planted at chosen global positions - including
  positions straddling partition overlap boundaries - before the build, so
  exact global counts/locations are known (collision odds ~ N / 4^30);
* absent queries (random 30-mers, not planted) must count 0.

Host-only by default (the partition engines would not fit one device's
memory at this scale without range-sharding each).  Results + timings are
appended to pangenome_results.json.

Run: python scripts/pangenome_build.py [total_gbp] [num_partitions] [workers]
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from awry_tpu import FmBuildArgs
from awry_tpu.parallel import PartitionedFmIndex

QUERY_LEN = 30
MAX_QUERY_LEN = 64


def main():
    total_gbp = float(sys.argv[1]) if len(sys.argv) > 1 else 8.6
    nparts = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    workers = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    rng = np.random.default_rng(0)
    per = int(total_gbp * 1e9 / nparts)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)

    print(f"generating {nparts} x {per/1e9:.2f} Gbp records...", flush=True)
    records = []
    texts = []
    for i in range(nparts):
        texts.append(rng.choice(letters, size=per).astype(np.uint8))

    # Plant queries: one per region of interest, incl. partition boundaries.
    planted = []  # (query bytes, [(record, local_pos), ...])
    def plant(rec, pos, q=None):
        if q is None:
            q = bytes(rng.choice(letters, size=QUERY_LEN))
        texts[rec][pos : pos + QUERY_LEN] = np.frombuffer(q, dtype=np.uint8)
        planted.append((q, (rec, pos)))
        return q

    for rec in range(nparts):
        plant(rec, int(rng.integers(0, per - QUERY_LEN)))          # interior
        plant(rec, 0)                                              # record start
        plant(rec, per - QUERY_LEN)                                # record end (tail overlap zone)
    # One DUPLICATED query planted in two partitions (global count 2).
    dq = plant(0, per // 2)
    plant(nparts - 1, per // 3, q=dq)

    records = [(f"part_rec_{i}", texts[i].tobytes()) for i in range(nparts)]
    del texts

    t0 = time.perf_counter()
    part = PartitionedFmIndex.build_from_records(
        records,
        FmBuildArgs(lookup_table_kmer_len=8),
        max_partition_symbols=per + 1,
        max_query_len=MAX_QUERY_LEN,
        num_workers=workers,
    )
    build_s = time.perf_counter() - t0
    import resource

    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"built {nparts} partitions ({total_gbp} Gbp) in {build_s:.0f}s, "
          f"parent peak RSS {peak_gb:.1f} GB", flush=True)

    # Queries: every planted q + absent randoms.
    queries = [q for q, _ in planted]
    absent = [bytes(rng.choice(letters, size=QUERY_LEN)) for _ in range(8)]
    t0 = time.perf_counter()
    counts = part.count_batch(queries + absent, use_device=False)
    locs = part.locate_batch(queries, use_device=False)
    query_s = time.perf_counter() - t0

    expected: dict[bytes, list] = {}
    for q, hit in planted:
        expected.setdefault(q, []).append(hit)
    ok = True
    for i, (q, _) in enumerate(planted):
        want = sorted(expected[q])
        got = sorted(locs[i])
        if got != want or int(counts[i]) != len(want):
            ok = False
            print(f"MISMATCH q#{i}: want {want} got {got} count {counts[i]}")
    for j, q in enumerate(absent):
        if int(counts[len(queries) + j]) != 0:
            ok = False
            print(f"ABSENT query counted {counts[len(queries)+j]}")
    print(f"planted-oracle check: {'OK' if ok else 'FAILED'} "
          f"({len(planted)} planted + {len(absent)} absent, {query_s:.1f}s host queries)",
          flush=True)

    out = {
        "total_gbp": total_gbp,
        "partitions": nparts,
        "workers": workers,
        "build_seconds": round(build_s, 1),
        "parent_peak_rss_gb": round(peak_gb, 1),
        "oracle_ok": ok,
        "kmer_len": 8,
    }
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "pangenome_results.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
