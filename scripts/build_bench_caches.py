"""Pre-build the bench index caches on the CPU (no GPU needed).

`python bench.py` under a timeout with a missing or config-mismatched cache
pays a genome-scale rebuild inside that budget.  This script populates
.bench_cache/ for the named configs (default: every non-pangenome config)
using the same build_or_load path bench.py uses, with JAX pinned to the CPU
so it can run while another process holds the card.

Usage: python scripts/build_bench_caches.py [config ...]
"""

import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

import bench  # noqa: E402


def main() -> None:
    only = set(sys.argv[1:])
    for cfg in bench.CONFIGS:
        if cfg["kind"] == "pangenome":
            continue  # scripts/build_pangenome_cache.py owns config #5
        if only and cfg["name"] not in only:
            continue
        t0 = time.time()
        rng = bench.config_rng(cfg)
        seq = bench.synth_text(cfg, rng)
        print(f"[{cfg['name']}] text synthesized in {time.time()-t0:.0f}s", flush=True)
        t0 = time.time()
        index, build_s = bench.build_or_load(cfg, seq)
        print(
            f"[{cfg['name']}] {'built' if build_s else 'cache hit'} in "
            f"{time.time()-t0:.0f}s (k={index.kmer_len}, mark={index.resolved_mark_ratio})",
            flush=True,
        )
        del index, seq


if __name__ == "__main__":
    main()
