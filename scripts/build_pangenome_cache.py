"""Build ONLY the pan-genome federation cache for bench.py config #5.

Replicates run_pangenome's build block (same corpus streams, same params
digest) but skips serving entirely: pure CPU work (SA-IS worker pool + host
k-mer tables at k=11), safe to run while the card is busy.  bench.py then
serves config #5 from this cache under its deadline.

Run: python scripts/build_pangenome_cache.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, "/root/repo")

import bench  # noqa: E402  (the digest/corpus definitions live there)
from awry_tpu import Alphabet, FmBuildArgs  # noqa: E402
from awry_tpu.parallel.partitioned import PartitionedFmIndex  # noqa: E402


def main() -> None:
    cfg = next(c for c in bench.CONFIGS if c["kind"] == "pangenome")
    cache_dir = os.path.join(bench.CACHE_DIR, cfg["name"])
    digest_file = os.path.join(cache_dir, "params.digest")
    digest = bench._pangenome_params_digest(cfg)
    if (
        os.path.isdir(cache_dir)
        and os.path.exists(digest_file)
        and open(digest_file).read().strip() == digest
    ):
        print("pangenome cache already valid", flush=True)
        return
    t0 = time.perf_counter()
    print(
        f"building {cfg['n']/1e9:.1f} Gbp federation "
        f"({cfg['records']} records, cap {cfg['partition_cap']/1e9:.2f} Gbp)",
        flush=True,
    )
    records = [(f"rec_{i}", bench._pangenome_record(cfg, i)) for i in range(cfg["records"])]
    pfm = PartitionedFmIndex.build_from_records(
        records,
        FmBuildArgs(
            alphabet=Alphabet.NUCLEOTIDE,
            suffix_array_compression_ratio=bench.SA_RATIO,
            lookup_table_kmer_len=cfg["k"],
            locate_mark_ratio=cfg["mark"],
        ),
        max_partition_symbols=cfg["partition_cap"],
        max_query_len=cfg["max_query_len"],
        num_workers=int(os.environ.get("AWRY_PANGENOME_WORKERS", "1")),
        consume_input=True,
    )
    del records
    pfm.save(cache_dir)
    with open(digest_file, "w") as f:
        f.write(digest)
    print(f"built + saved in {time.perf_counter()-t0:.0f}s -> {cache_dir}", flush=True)


if __name__ == "__main__":
    main()
