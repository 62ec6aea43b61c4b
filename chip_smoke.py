"""Prove that the serving path runs on an NVIDIA GPU.

    python chip_smoke.py [--seed N]     # one card: three phases
    python chip_smoke.py --four         # four cards: the multi-device engines

Drives the main path through the entry points a user calls —
``FmIndex.new(FmBuildArgs(input_file_src=<FASTA>))``, ``FmQueryEngine``,
``count_locate_stream``, ``FmIndex.parallel_count`` / ``parallel_locate`` —
at real index sizes, on text from bench.py's generator for the matching
config (``--seed`` picks the stream; the default is the benchmark's).

One-card phases:

  dna_chr1         250 Mnt, k=13, mark 1: 2 batches of 524,288 x 30 nt drawn
                   from the text, then the mixed batch
  dna_ecoli        4.6 Mnt, k=10, mark 1 (the fat-row verify path): the mixed
                   batch, then an .awry save/load round trip served by a
                   second engine on the loaded index
  amino_swissprot  20 Maa, k=5, mark 1: the mixed batch of 262,144 x 12 aa

The mixed batch is drawn from the text except for 10% of its queries, which
are random strings (mostly misses) or carry the ambiguity letter (N / X).

Checks, each by exact equality with the NumPy host engine
(awry_tpu.host_engine): every drawn query has a count >= 1 and its drawn
position among its hits; counts on 8,192 sampled queries, misses included;
locate sets on 512; every returned position against the text;
``parallel_count`` / ``parallel_locate`` on 1,024.  All outputs are integers
and no matrix product runs, so TF32 and summation order cannot move a
result: the tolerance is exact equality.

``--four`` builds the dna_chr1 text once, as 4 equal records, and compares
Mode A (``FmQueryEngine`` over a 4-card 'data' mesh), Mode B
(``ShardedFmEngine``, 4 range shards, one psum per LF step) and a
4-partition ``PartitionedFmIndex`` federation (one partition per card) with
the one-card engine and the host engine on the same batch.

The script exits non-zero before any phase when JAX finds no GPU, and on any
exception or mismatch.  Only this process touches the card: nvidia-smi runs
in a child that never imports JAX.  The compile cache is
``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.  The
last stdout line is the JSON verdict.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

COUNT_SAMPLE = 8192
LOCATE_SAMPLE = 512
PARALLEL_SAMPLE = 1024
MIX_FRACTION = 0.10  # share of the mixed batch that is random or ambiguous
SA_RATIO = 8


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    config: str  # bench.py CONFIGS entry whose text stream this phase uses
    amino: bool
    n: int  # text symbols
    k: int  # k-mer seed length
    nq: int  # queries per batch
    qlen: int
    drawn_batches: int  # pure text-drawn batches before the mixed batch
    awry_round_trip: bool = False


PHASES = (
    Phase("dna_chr1", "chr1_250Mbp_dna", False, 250_000_000, 13, 524_288, 30, 2),
    Phase("dna_ecoli", "ecoli_4.6Mbp_dna", False, 4_600_000, 10, 524_288, 30, 0,
          awry_round_trip=True),
    Phase("amino_swissprot", "swissprot_20Mres_amino", True, 20_000_000, 5, 262_144, 12, 0),
)
FOUR_RECORDS = 4
FOUR_MAX_QUERY_LEN = 32


def compile_cache_dir(environ) -> str:
    """The persistent compile cache: $JAX_COMPILATION_CACHE_DIR when set,
    else a fixed path in the repo (the path is part of the cache key)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(REPO, ".jax_cache")


def nvidia_smi_lines() -> list[str]:
    """The cards' name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line for line in out.stdout.splitlines() if line.strip()]


class CacheEvents:
    """Counts JAX persistent-compile-cache hits and misses."""

    def __init__(self):
        import jax

        self.hits = self.misses = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_kw) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def snapshot(self) -> tuple[int, int]:
        return self.hits, self.misses


def _memory(device) -> str:
    stats = device.memory_stats() or {}
    if "peak_bytes_in_use" not in stats:
        return f"{device}: memory stats not reported"
    return (f"{device}: bytes_in_use {stats['bytes_in_use']:,} "
            f"peak_bytes_in_use {stats['peak_bytes_in_use']:,}")


def phase_text(ph: Phase, seed: int) -> tuple[bytes, np.random.Generator]:
    """The phase's text from bench.py's generator, and the stream's
    generator positioned after it (queries are drawn from it next, as the
    benchmark draws them)."""
    import bench

    cfg = dict(next(c for c in bench.CONFIGS if c["name"] == ph.config), n=ph.n)
    rng = bench.config_rng(cfg, seed)
    return bench.synth_text(cfg, rng), rng


def write_fasta(path: str, records: list[tuple[str, bytes]], width: int = 80) -> str:
    with open(path, "wb") as f:
        for header, seq in records:
            f.write(b">" + header.encode() + b"\n")
            for i in range(0, len(seq), 1 << 24):
                chunk = np.frombuffer(seq[i : i + (1 << 24)], dtype=np.uint8)
                full = chunk.shape[0] // width * width
                lines = np.empty((full // width, width + 1), dtype=np.uint8)
                lines[:, :width] = chunk[:full].reshape(-1, width)
                lines[:, width] = ord("\n")
                f.write(lines.tobytes())
                if full < chunk.shape[0]:
                    f.write(chunk[full:].tobytes() + b"\n")
    return path


def split_records(text: bytes, n_records: int, name: str) -> list[tuple[str, bytes]]:
    step = -(-len(text) // n_records)
    return [(f"{name}_{i}", text[i * step : (i + 1) * step]) for i in range(n_records)]


@dataclasses.dataclass
class Batch:
    queries: list[bytes]
    rec: np.ndarray  # drawn record per query (-1 = random or ambiguous)
    off: np.ndarray  # drawn offset within the record


def draw_batch(rng, records, nq: int, qlen: int, *, mixed: bool, letters: bytes,
               ambiguity: bytes) -> Batch:
    lens = np.array([len(s) for _, s in records])
    if len(records) == 1:  # one record: the benchmark's own draw
        rec = np.zeros(nq, dtype=np.int64)
        off = rng.integers(0, lens[0] - qlen, size=nq)
    else:
        rec = rng.integers(0, len(records), size=nq)
        off = rng.integers(0, lens[rec] - qlen)
    queries = [records[r][1][o : o + qlen] for r, o in zip(rec.tolist(), off.tolist())]
    if mixed:
        odd = rng.choice(nq, size=int(nq * MIX_FRACTION), replace=False)
        alphabet = np.frombuffer(letters, dtype=np.uint8)
        for j, i in enumerate(odd.tolist()):
            if j % 2:
                queries[i] = bytes(rng.choice(alphabet, size=qlen))
            else:
                at = int(rng.integers(0, qlen))
                q = queries[i]
                queries[i] = q[:at] + ambiguity + q[at + 1 :]
        rec[odd] = -1
    return Batch(queries, rec, off)


def canonical(counts, seq_idx, local, offsets):
    """A count+locate result with each query's hits sorted, so engines that
    return hits in different orders compare exactly."""
    counts = np.asarray(counts).astype(np.int64)
    qid = np.repeat(np.arange(counts.shape[0]), counts)
    order = np.lexsort((np.asarray(local), np.asarray(seq_idx), qid))
    return counts, np.asarray(seq_idx)[order], np.asarray(local)[order], np.asarray(offsets)


def assert_same(a, b, what: str) -> None:
    for x, y, part in zip(canonical(*a), canonical(*b), ("counts", "seq_idx", "local", "offsets")):
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: {part} differ")


def check_batch(batch: Batch, result, records, qlen: int, data, rng, sample_frac: float):
    """Exact checks of one count+locate result against the text and the host
    engine; returns (count, locate) sample sizes checked."""
    import awry_tpu.host_engine as he

    counts, seq_idx, local, offsets = result
    counts = np.asarray(counts).astype(np.int64)
    nq = len(batch.queries)
    drawn = batch.rec >= 0
    if (counts[drawn] < 1).any():
        raise AssertionError(f"{int((counts[drawn] < 1).sum())} drawn queries not found")
    # Every returned position holds the query in the text.
    qid = np.repeat(np.arange(nq), counts)
    lens = np.array([len(s) for _, s in records], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lens + 1)[:-1]))
    joined = np.frombuffer(b"\0".join(s for _, s in records), dtype=np.uint8)
    if ((local < 0) | (local + qlen > lens[seq_idx])).any():
        raise AssertionError("a returned position runs past its record")
    window = joined[(starts[seq_idx] + local)[:, None] + np.arange(qlen)]
    qmat = np.frombuffer(b"".join(batch.queries), dtype=np.uint8).reshape(nq, qlen)
    if not (window == qmat[qid]).all():
        raise AssertionError("a returned position does not hold its query")
    hit_drawn = (seq_idx == batch.rec[qid]) & (local == batch.off[qid])
    found = np.bincount(qid, weights=hit_drawn, minlength=nq) > 0
    if not found[drawn].all():
        raise AssertionError("a drawn query's own position is missing from its hits")
    # Host engine: counts (misses included) and locate sets on samples.
    n_count = max(1, int(COUNT_SAMPLE * sample_frac))
    idx = rng.choice(nq, size=min(nq, n_count), replace=False)
    idx = np.union1d(idx, np.flatnonzero(~drawn)[:64])  # make sure misses are in
    host = he.count_batch(data, [batch.queries[i] for i in idx]).astype(np.int64)
    if not np.array_equal(host, counts[idx]):
        raise AssertionError("counts differ from the host engine")
    n_loc = max(1, int(LOCATE_SAMPLE * sample_frac))
    for i in rng.choice(nq, size=min(nq, n_loc), replace=False).tolist():
        got = sorted(zip(seq_idx[offsets[i] : offsets[i + 1]].tolist(),
                         local[offsets[i] : offsets[i + 1]].tolist()))
        if got != sorted(he.locate(data, batch.queries[i])):
            raise AssertionError(f"locate set of query {i} differs from the host engine")
    return idx.shape[0], n_loc


def build_index(fasta: str, amino: bool, k: int, log):
    from awry_tpu import Alphabet, FmBuildArgs, FmIndex
    from awry_tpu.build.suffix_array import native_sais_available

    log(f"  suffix array builder: "
        f"{'native SA-IS' if native_sais_available() else 'NumPy prefix doubling (fallback)'}")
    t0 = time.perf_counter()
    fm = FmIndex.new(FmBuildArgs(
        input_file_src=fasta,
        alphabet=Alphabet.AMINO if amino else Alphabet.NUCLEOTIDE,
        suffix_array_compression_ratio=SA_RATIO,
        lookup_table_kmer_len=k,
        locate_mark_ratio=1,
    ))
    log(f"  build seconds: {time.perf_counter() - t0:.1f} ({fm.bwt_len():,} BWT rows)")
    return fm


def bring_up(log, label: str, make):
    import jax

    t0 = time.perf_counter()
    engine = make()
    jax.block_until_ready(jax.tree_util.tree_leaves(engine.device_index))
    log(f"  {label} bring-up seconds: {time.perf_counter() - t0:.1f}")
    return engine


def _letters(amino: bool) -> tuple[bytes, bytes]:
    return (b"ACDEFGHIKLMNPQRSTVWY", b"X") if amino else (b"ACGT", b"N")


def run_phase(ph: Phase, seed: int, workdir: str, log=print, cache=None,
              sample_frac: float = 1.0) -> dict:
    """One single-card phase; raises on any mismatch.  Returns a summary."""
    import jax

    from awry_tpu import FmIndex
    import awry_tpu.host_engine as he
    from awry_tpu.ops import FmQueryEngine

    log(f"=== {ph.name}: {ph.n:,} symbols, k={ph.k}, "
        f"{ph.drawn_batches + 1} x {ph.nq:,} queries of {ph.qlen} ===")
    text, rng = phase_text(ph, seed)
    records = [(ph.name, text)]
    fm = build_index(write_fasta(os.path.join(workdir, ph.name + ".fa"), records),
                     ph.amino, ph.k, log)
    letters, amb = _letters(ph.amino)
    batches = [
        draw_batch(rng, records, ph.nq, ph.qlen, mixed=i == ph.drawn_batches,
                   letters=letters, ambiguity=amb)
        for i in range(ph.drawn_batches + 1)
    ]
    engine = bring_up(log, "engine", lambda: FmQueryEngine(fm.data))
    if not engine._verify_enabled:
        raise AssertionError("a marked index with text must serve through seed-walk-verify")
    log(f"  serving path: seed-walk-verify"
        f"{' with fat rows' if engine.device_index.verify_windows is not None else ''}")
    encoded = [engine.encode_queries(b.queries) + (len(b.queries),) for b in batches]

    before = cache.snapshot() if cache else (0, 0)
    t0 = time.perf_counter()
    engine.warmup(batch_sizes=(ph.nq,), query_lens=(ph.qlen,))
    compile_s = time.perf_counter() - t0
    after = cache.snapshot() if cache else (0, 0)
    log(f"  first-call compile seconds (warmup: compile + one dummy pass): {compile_s:.1f}; "
        f"compile cache hits {after[0] - before[0]}, misses {after[1] - before[1]}")
    qw, ql, _ = encoded[-1]
    fused = engine._verify_fn.lower(engine.device_index, qw, ql, s=engine._verify_s).compile()
    log(f"  fused serving program memory_analysis: {fused.memory_analysis()}")

    results = list(engine.count_locate_stream(encoded))
    checked = [check_batch(b, r, records, ph.qlen, fm.data, rng, sample_frac)
               for b, r in zip(batches, results)]
    log(f"  checks passed: {sum(c for c, _ in checked):,} sampled counts, "
        f"{sum(l for _, l in checked):,} locate sets, "
        f"{sum(int(r[3][-1]) for r in results):,} positions against the text")

    t0 = time.perf_counter()
    for _ in engine.count_locate_stream(encoded):
        pass
    dt = time.perf_counter() - t0
    total = sum(len(b.queries) for b in batches)
    log(f"  single timed pass (not a benchmark): {total / dt:,.0f} q/s "
        f"({total:,} queries in {dt:.3f} s)")
    log(f"  {_memory(jax.devices()[0])}")

    if ph.awry_round_trip:
        path = os.path.join(workdir, ph.name + ".awry")
        fm.save(path)
        loaded = FmIndex.load(path)
        engine2 = bring_up(log, "loaded .awry engine", lambda: FmQueryEngine(loaded.data))
        for b, r in zip(batches, results):
            assert_same(engine2.count_locate_arrays(b.queries), r, ".awry round trip")
        log(f"  .awry round trip: the loaded index serves identical results "
            f"({'verify' if engine2._verify_enabled else 'classic'} path)")
        engine2.release()
    engine.release()

    sample = [q for b in batches for q in b.queries]
    sample = [sample[i] for i in rng.choice(len(sample), size=min(len(sample), PARALLEL_SAMPLE),
                                            replace=False)]
    got = fm.parallel_count(sample)
    if not np.array_equal(np.asarray(got).astype(np.int64),
                          he.count_batch(fm.data, sample).astype(np.int64)):
        raise AssertionError("parallel_count differs from the host engine")
    for q, hits in zip(sample, fm.parallel_locate(sample)):
        if sorted((h.sequence_idx(), h.local_position()) for h in hits) != sorted(he.locate(fm.data, q)):
            raise AssertionError("parallel_locate differs from the host engine")
    log(f"  parallel_count / parallel_locate agree with the host engine on {len(sample):,} queries")
    return {"phase": ph.name, "queries": total, "qps_single_pass": total / dt}


@dataclasses.dataclass
class FourContext:
    """What the --four phases share: one index, one batch, the one-card
    engine's result and the host engine's counts on a sample."""

    fm: object
    records: list
    batch: Batch
    reference: tuple
    sample: np.ndarray
    host_counts: np.ndarray
    devices: list
    args: object  # FmBuildArgs of the index (the federation reuses them)
    workers: int


def four_setup(seed: int, workdir: str, devices, log=print, n: int | None = None,
               nq: int | None = None, workers: int = FOUR_RECORDS,
               sample_frac: float = 1.0) -> FourContext:
    import awry_tpu.host_engine as he
    from awry_tpu import Alphabet, FmBuildArgs
    from awry_tpu.ops import FmQueryEngine

    ph = PHASES[0]
    ph = dataclasses.replace(ph, n=n or ph.n, nq=nq or ph.nq)
    log(f"=== four cards: {ph.config} text ({ph.n:,} nt) as {FOUR_RECORDS} records, "
        f"{ph.nq:,} queries of {ph.qlen} ===")
    text, rng = phase_text(ph, seed)
    records = split_records(text, FOUR_RECORDS, ph.name)
    del text
    fm = build_index(write_fasta(os.path.join(workdir, "four.fa"), records), False, ph.k, log)
    batch = draw_batch(rng, records, ph.nq, ph.qlen, mixed=True, letters=b"ACGT", ambiguity=b"N")
    engine = bring_up(log, "one-card engine", lambda: FmQueryEngine(fm.data))
    reference = tuple(np.asarray(x) for x in engine.count_locate_arrays(batch.queries))
    n_count, n_loc = check_batch(batch, reference, records, ph.qlen, fm.data, rng, sample_frac)
    log(f"  one-card engine agrees with the host engine ({n_count:,} counts, {n_loc} locate "
        "sets) and the text")
    log(f"  {_memory(devices[0])}")
    engine.release()
    sample = np.sort(rng.choice(ph.nq, size=min(ph.nq, COUNT_SAMPLE), replace=False))
    host = he.count_batch(fm.data, [batch.queries[i] for i in sample]).astype(np.int64)
    args = FmBuildArgs(alphabet=Alphabet.NUCLEOTIDE, suffix_array_compression_ratio=SA_RATIO,
                       lookup_table_kmer_len=ph.k, locate_mark_ratio=1)
    return FourContext(fm, records, batch, reference, sample, host, list(devices[:4]), args,
                       workers)


def _four_compare(ctx: FourContext, result, label: str, log) -> None:
    assert_same(result, ctx.reference, f"{label} vs one-card engine")
    if not np.array_equal(np.asarray(result[0]).astype(np.int64)[ctx.sample], ctx.host_counts):
        raise AssertionError(f"{label}: counts differ from the host engine")
    log(f"  {label}: identical to the one-card engine on {len(ctx.batch.queries):,} queries, "
        f"and to the host engine on {len(ctx.sample):,} counts")
    for d in ctx.devices:
        log(f"  {_memory(d)}")


def four_mode_a(ctx: FourContext, log=print) -> None:
    from jax.sharding import Mesh

    from awry_tpu.ops import FmQueryEngine

    mesh = Mesh(np.array(ctx.devices), ("data",))
    engine = bring_up(log, "Mode A", lambda: FmQueryEngine(ctx.fm.data, mesh=mesh))
    _four_compare(ctx, engine.count_locate_arrays(ctx.batch.queries), "Mode A", log)
    engine.release()


def four_mode_b(ctx: FourContext, log=print) -> None:
    from awry_tpu.parallel import ShardedFmEngine, make_mesh

    mesh = make_mesh(len(ctx.devices), shard_size=len(ctx.devices), devices=ctx.devices)
    engine = bring_up(log, "Mode B", lambda: ShardedFmEngine(ctx.fm.data, mesh))
    _four_compare(ctx, engine.count_locate_arrays(ctx.batch.queries), "Mode B", log)
    del engine


def four_federation(ctx: FourContext, log=print) -> None:
    from awry_tpu.parallel import PartitionedFmIndex

    t0 = time.perf_counter()
    pfm = PartitionedFmIndex.build_from_records(
        list(ctx.records), ctx.args,
        max_partition_symbols=max(len(s) for _, s in ctx.records),
        max_query_len=FOUR_MAX_QUERY_LEN, num_workers=ctx.workers,
    )
    log(f"  federation build seconds: {time.perf_counter() - t0:.1f} "
        f"({len(pfm.partitions)} partitions)")
    result = pfm.count_locate_arrays(ctx.batch.queries, cap=8)
    placed = {next(iter(p.engine.device_index.blocks.devices())) for p in pfm.partitions}
    if len(placed) != len(pfm.partitions):
        raise AssertionError(f"partitions share devices: {placed}")
    _four_compare(ctx, result, "federation", log)
    for p in pfm.partitions:
        p.engine.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="text/query stream (0 = bench.py's)")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card engines (Mode A, Mode B, federation)")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir(os.environ))
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {devices[0].platform!r}); nothing ran",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: --four needs 4 GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2
    for line in nvidia_smi_lines():
        print(line)
    print(f"jax.devices(): {devices}")
    print(f"compile cache: {compile_cache_dir(os.environ)}")
    cache = CacheEvents()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.four:
            ctx = four_setup(args.seed, workdir, devices)
            four_mode_a(ctx)
            four_mode_b(ctx)
            four_federation(ctx)
        else:
            for ph in PHASES:
                run_phase(ph, args.seed, workdir, cache=cache)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
