"""Multi-device query engines: replicated and range-sharded indexes.

New capability relative to the reference (which is single-process,
shared-memory only; SURVEY.md section 2 parallelism inventory):

* Mode A (`ShardedFmEngine`, shard_size=1): the index is REPLICATED on every
  device; query batches shard over the 'data' mesh axis under shard_map.
  Zero collectives on the hot path - the device analog of rayon's
  embarrassingly-parallel query loop, at card granularity.

* Mode B (shard_size>1): the BWT block arrays (planes + milestones) are
  RANGE-SHARDED over the 'shard' axis - each device owns a contiguous block
  range of an index too big for one card's memory.  A rank query is answered by the
  owning shard and broadcast with a psum (milestones are globally cumulative,
  so the owner's local value IS the global rank); non-owners contribute 0.
  Queries still shard over 'data', so the two axes compose.

Both modes express collectives through jax.lax.psum over the mesh, which
XLA lowers to the cards' collective library (NCCL over NVLink on one host).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..index import FmIndexData
from ..ops.device_index import FmDeviceIndex, to_device
from ..ops.locate import lf_walk
from ..ops.rank import occurrence, occurrence_from_rows, symbol_code_from_rows
from ..ops.search import counts_from_ranges, search_ranges
from .mesh import DATA_AXIS, SHARD_AXIS, make_mesh


def _pad_blocks(arr: np.ndarray, num_shards: int) -> np.ndarray:
    """Pad the block axis so it divides evenly across shards.  Padded blocks
    are all-zero and are never owned by any reachable position."""
    nb = arr.shape[0]
    pad = (-nb) % num_shards
    if pad == 0:
        return arr
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)], axis=0)


def _local_rows(local: FmDeviceIndex, pos: jax.Array):
    """Fetch fused rows from this device's block shard; returns (rows, owned)."""
    nb_local = local.blocks.shape[0]
    block_local = (pos >> 8).astype(jnp.int32) - jax.lax.axis_index(SHARD_AXIS) * nb_local
    owned = (block_local >= 0) & (block_local < nb_local)
    rows = local.blocks[jnp.clip(block_local, 0, nb_local - 1)]
    return rows, owned


def sharded_occurrence(local: FmDeviceIndex, pos: jax.Array, sym: jax.Array) -> jax.Array:
    """Occ(pos, sym) when this device holds a contiguous block range: the
    owner computes milestone + popcount, everyone psums over the shard axis
    (milestones are globally cumulative, so the owner's value IS the global
    rank)."""
    rows, owned = _local_rows(local, pos)
    rank = occurrence_from_rows(local, rows, pos, sym)
    contrib = jnp.where(owned, rank, jnp.uint32(0))
    return jax.lax.psum(contrib, SHARD_AXIS)


def sharded_symbol_at(local: FmDeviceIndex, pos: jax.Array) -> jax.Array:
    """symbol_at with the bit-plane reads psum-merged from the owning shard."""
    rows, owned = _local_rows(local, pos)
    code = symbol_code_from_rows(local, rows, pos)
    code = jax.lax.psum(jnp.where(owned, code, 0), SHARD_AXIS)
    return local.code_to_index[code]


def _sharded_update_fn(local: FmDeviceIndex):
    """LF-mapping range update with psum-merged ranks: each endpoint is
    ranked from this device's local block range (unowned positions read
    block 0 and contribute 0), then one psum per endpoint merges them."""

    def update(starts, ends, sym):
        c = local.prefix_sums[sym]
        nb_local = local.blocks.shape[0]
        base = jax.lax.axis_index(SHARD_AXIS).astype(jnp.uint32) * jnp.uint32(
            nb_local * 256
        )
        pos_a = starts - jnp.uint32(1)
        la, lb = pos_a - base, ends - base
        own_a = (pos_a >= base) & (la < jnp.uint32(nb_local * 256))
        own_b = (ends >= base) & (lb < jnp.uint32(nb_local * 256))
        occ_a = occurrence(local, jnp.where(own_a, la, jnp.uint32(0)), sym)
        occ_b = occurrence(local, jnp.where(own_b, lb, jnp.uint32(0)), sym)
        occ_a = jax.lax.psum(jnp.where(own_a, occ_a, jnp.uint32(0)), SHARD_AXIS)
        occ_b = jax.lax.psum(jnp.where(own_b, occ_b, jnp.uint32(0)), SHARD_AXIS)
        return c + occ_a, c + occ_b - jnp.uint32(1)

    return update


def _sharded_backstep_fn(local: FmDeviceIndex):
    def bs(pos):
        # One fused-row fetch serves both the symbol read and its rank,
        # merged across shards with a single packed psum.
        rows, owned = _local_rows(local, pos)
        code = symbol_code_from_rows(local, rows, pos)
        code = jax.lax.psum(jnp.where(owned, code, 0), SHARD_AXIS)
        sym = local.code_to_index[code]
        is_sentinel = sym == 0
        safe = jnp.where(is_sentinel, local.alphabet.ambiguity_idx, sym)
        rank = occurrence_from_rows(local, rows, pos, safe)
        rank = jax.lax.psum(jnp.where(owned, rank, jnp.uint32(0)), SHARD_AXIS)
        stepped = local.prefix_sums[safe] + rank - jnp.uint32(1)
        return jnp.where(is_sentinel, jnp.uint32(0), stepped)

    return bs


class ShardedFmEngine:
    """Multi-device count/locate engine over a ('data','shard') mesh.

    locate_cap: hits per query returned by the fused single-dispatch
    count+locate path; queries with more hits re-run through the unbounded
    flat path (same contract as ops.engine.FmQueryEngine).
    """

    def __init__(
        self,
        index: FmIndexData,
        mesh=None,
        *,
        shard_size: int = 1,
        locate_cap: int = 8,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(shard_size=shard_size)
        self.num_shards = self.mesh.shape[SHARD_AXIS]
        self.data_size = self.mesh.shape[DATA_AXIS]
        self.alphabet = index.alphabet

        replicated = NamedSharding(self.mesh, P())
        block_sharded = NamedSharding(self.mesh, P(SHARD_AXIS))

        host = index
        if self.num_shards > 1:
            replaced = dict(
                planes=_pad_blocks(index.planes, self.num_shards),
                milestones=_pad_blocks(index.milestones, self.num_shards),
            )
            if index.has_marks:
                # Padded blocks carry no marks; their milestone must still be
                # monotone (total marked count) for safe unreachable gathers.
                pad = _pad_blocks(index.mark_milestones[:, None], self.num_shards)[:, 0]
                total = np.uint32(index.text_sampled_sa.shape[0])
                pad[index.mark_milestones.shape[0] :] = total
                replaced.update(
                    mark_bits=_pad_blocks(index.mark_bits, self.num_shards),
                    mark_milestones=pad,
                )
            host = dataclasses.replace(index, **replaced)
        placement = {name: replicated for name in (
            "prefix_sums", "sampled_sa", "text_sampled_sa", "kmer_table", "seq_starts",
            "index_to_code", "code_to_index", "index_to_dense",
        )}
        sharded_or_repl = block_sharded if self.num_shards > 1 else replicated
        placement["blocks"] = sharded_or_repl
        # The slim search copy (occurrence's gather target) covers the same
        # block range as `blocks` and must shard with it.
        placement["blocks_search"] = sharded_or_repl
        # Range-sharded locate walks through the COLLECTIVE backstep, which
        # is the row-sampled walk - it needs the row-sampled SA on device
        # (the single-chip marked walk never reads it; ops/device_index.py).
        self.device_index = to_device(
            host, sharding=placement, ship_row_sa=self.num_shards > 1 or None
        )
        self.blocks_per_shard = self.device_index.blocks.shape[0] // self.num_shards

        index_specs = jax.tree.map(lambda _: P(), self.device_index)
        shard_spec = P(SHARD_AXIS) if self.num_shards > 1 else P()
        index_specs = dataclasses.replace(
            index_specs,
            blocks=shard_spec,
            **(
                {"blocks_search": shard_spec}
                if self.device_index.blocks_search is not None
                else {}
            ),
        )
        self._index_specs = index_specs

        num_shards = self.num_shards

        # Same wire formats as the single-device engine: crumb (2-bit int8)
        # for pure-dense batches, nibble (4-bit uint8) otherwise.
        self._wire_packed = self.alphabet.cardinality <= 16
        if self._wire_packed:
            from ..alphabet import index_to_dense_table

            dense_lut = index_to_dense_table(self.alphabet)
            self._crumb_lut = dense_lut
            crumb_inv = np.flatnonzero(dense_lut >= 0).astype(np.int8)
        else:
            self._crumb_lut = crumb_inv = None
        wire_packed = self._wire_packed

        def _unwire(qsyms):
            if wire_packed and qsyms.dtype == jnp.int8:
                from ..ops.search import unpack_crumbs

                return unpack_crumbs(qsyms, crumb_inv)
            if wire_packed:
                from ..ops.search import unpack_nibbles

                return unpack_nibbles(qsyms)
            return qsyms

        def count_fn(local_index, qsyms, qlens):
            qsyms = _unwire(qsyms)
            update_fn = _sharded_update_fn(local_index) if num_shards > 1 else None
            starts, ends = search_ranges(local_index, qsyms, qlens, update_fn=update_fn)
            return counts_from_ranges(starts, ends), starts, ends

        def walk_fn(local_index, rows):
            backstep_fn = _sharded_backstep_fn(local_index) if num_shards > 1 else None
            return lf_walk(local_index, rows, backstep_fn=backstep_fn)

        cap = locate_cap
        self.locate_cap = cap

        def count_locate_fn(local_index, qsyms, qlens):
            """Fused ranges + counts + capped LF-walk in one sharded dispatch
            (mirrors ops.locate.count_locate_capped with collective ranks).
            Also returns the range starts so over-cap queries expand their
            rows host-side and share ONE extra walk dispatch (no re-search)."""
            qsyms = _unwire(qsyms)
            update_fn = _sharded_update_fn(local_index) if num_shards > 1 else None
            backstep_fn = _sharded_backstep_fn(local_index) if num_shards > 1 else None
            starts, ends = search_ranges(local_index, qsyms, qlens, update_fn=update_fn)
            counts = counts_from_ranges(starts, ends)
            b = starts.shape[0]
            offs = jnp.arange(cap, dtype=jnp.uint32)
            rows = starts[:, None] + offs[None, :]
            valid = offs[None, :] < jnp.minimum(counts, jnp.uint32(cap))[:, None]
            flat = jnp.where(valid, rows, jnp.uint32(0)).reshape(-1)
            text_pos = lf_walk(local_index, flat, backstep_fn=backstep_fn)
            return counts, text_pos.reshape(b, cap), starts

        qspec = P(DATA_AXIS)
        self._count = jax.jit(
            shard_map(
                count_fn,
                mesh=self.mesh,
                in_specs=(index_specs, P(DATA_AXIS, None), qspec),
                out_specs=(qspec, qspec, qspec),
                check_vma=False,
            )
        )
        self._walk = jax.jit(
            shard_map(
                walk_fn,
                mesh=self.mesh,
                in_specs=(index_specs, qspec),
                out_specs=qspec,
                check_vma=False,
            )
        )
        self._count_locate = jax.jit(
            shard_map(
                count_locate_fn,
                mesh=self.mesh,
                in_specs=(index_specs, P(DATA_AXIS, None), qspec),
                out_specs=(qspec, P(DATA_AXIS, None), qspec),
                check_vma=False,
            )
        )
        self._seq_starts_host = index.seq_starts.astype(np.int64)

    # -- host-side encoding (bucketed padding, divisible by data axis) -----
    def _encode(self, queries):
        """Encode a query batch to device arrays.

        Multi-process runs (jax.process_count() > 1, see
        parallel/distributed.py): every process passes the SAME global query
        list; each encodes only its host-major slice with collectively-agreed
        padded shapes and assembles the global data-sharded array.  Results
        returned by count_batch/locate_batch then cover only this process's
        slice (use process_local_queries to know which)."""
        from ..ops.engine import _bucket, encode_query_batch

        pc = jax.process_count()
        if pc == 1:
            from ..ops.engine import pack_wire

            qsyms, qlens = encode_query_batch(self.alphabet, queries, min_batch=self.data_size)
            return jnp.asarray(pack_wire(qsyms, qlens, self._crumb_lut)), jnp.asarray(qlens)

        from .distributed import global_query_batch, process_local_queries

        local = process_local_queries(queries, self.mesh)
        per = -(-len(queries) // pc)
        local = local + [b""] * (per - len(local))
        # Padded shapes must agree across processes: derive them from the
        # (identical) global list, not the local slice.
        qbytes_len = [len(q.encode() if isinstance(q, str) else q) for q in queries]
        global_l = _bucket(max(qbytes_len, default=1), minimum=8)
        local_b = _bucket(per, minimum=max(1, self.data_size // pc))
        qsyms, qlens = encode_query_batch(
            self.alphabet, local, min_batch=local_b, min_len=global_l
        )
        qsyms = qsyms[:local_b]
        qlens = qlens[:local_b]
        if self._wire_packed:
            qsyms = (qsyms[:, 0::2] | (qsyms[:, 1::2] << 4)).astype(np.uint8)
        return global_query_batch(qsyms, qlens, self.mesh)

    @staticmethod
    def _host_values(arr) -> np.ndarray:
        """Rows of a (possibly multi-process) data-sharded array that live on
        THIS process, in global row order.  Replicas along the shard axis
        produce duplicate addressable shards - keep one per row range."""
        if jax.process_count() == 1:
            return np.asarray(arr)
        seen: dict[int, np.ndarray] = {}
        for s in arr.addressable_shards:
            start = s.index[0].start or 0
            if start not in seen:
                seen[start] = np.asarray(s.data)
        return np.concatenate([seen[k] for k in sorted(seen)], axis=0)

    def count_batch(self, queries) -> np.ndarray:
        """Counts per query.  Single-process: for the whole list.  Multi-
        process: every process passes the same global list and receives the
        counts for ITS slice (process_local_queries order)."""
        qsyms, qlens = self._encode(queries)
        counts, _, _ = self._count(self.device_index, qsyms, qlens)
        if jax.process_count() > 1:
            from .distributed import process_local_queries

            n_local = len(process_local_queries(queries, self.mesh))
            return self._host_values(counts)[:n_local].astype(np.uint64)
        return np.asarray(counts)[: len(queries)].astype(np.uint64)

    def count_locate_arrays(self, queries):
        """Bulk serving form (FmQueryEngine.count_locate_arrays contract):
        (counts uint64[n], seq_idx int64[T], local int64[T], offsets
        int64[n+1]) with hits of query i at [offsets[i], offsets[i+1]) in
        BWT-row order.  One fused sharded dispatch; over-cap queries expand
        their rows host-side (vectorized, no per-query Python) and share
        ONE extra walk dispatch."""
        n = len(queries)
        qsyms, qlens = self._encode(queries)
        counts_d, text_pos_d, starts_d = self._count_locate(self.device_index, qsyms, qlens)
        counts = np.asarray(counts_d)[:n].astype(np.int64)
        text_pos = np.asarray(text_pos_d)[:n]
        cap = self.locate_cap

        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        flat_pos = np.empty(total, dtype=np.int64)

        over = counts > cap
        nov_counts = np.where(over, 0, counts)
        valid = np.arange(cap, dtype=np.int64)[None, :] < nov_counts[:, None]
        vals = text_pos[valid].astype(np.int64)
        dst_start = np.repeat(offsets[:-1], nov_counts)
        within = np.arange(vals.shape[0], dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(nov_counts)[:-1])), nov_counts
        )
        flat_pos[dst_start + within] = vals

        if over.any():
            o_starts = np.asarray(starts_d)[:n].astype(np.int64)[over]
            o_counts = counts[over]
            o_total = int(o_counts.sum())
            o_cum = np.concatenate(([0], np.cumsum(o_counts)))
            o_within = np.arange(o_total, dtype=np.int64) - np.repeat(o_cum[:-1], o_counts)
            all_rows = (np.repeat(o_starts, o_counts) + o_within).astype(np.uint32)
            dst = np.repeat(offsets[:-1][over], o_counts) + o_within
            # Slabbed dispatches (ops/engine._OVERCAP_WALK_SLAB): bounded
            # device memory per walk over a repetitive text's expanded hits.
            from ..ops.engine import _OVERCAP_WALK_SLAB, _bucket

            for s0 in range(0, o_total, _OVERCAP_WALK_SLAB):
                chunk = all_rows[s0 : s0 + _OVERCAP_WALK_SLAB]
                m = chunk.shape[0]
                rows = np.zeros(
                    min(_OVERCAP_WALK_SLAB, _bucket(m, minimum=self.data_size)),
                    dtype=np.uint32,
                )
                rows[:m] = chunk
                walked = np.asarray(self._walk(self.device_index, jnp.asarray(rows)))[:m]
                flat_pos[dst[s0 : s0 + m]] = walked.astype(np.int64)

        seq_idx = np.searchsorted(self._seq_starts_host, flat_pos, side="right") - 1
        local = flat_pos - self._seq_starts_host[seq_idx]
        return counts.astype(np.uint64), seq_idx, local, offsets

    def locate_batch(self, queries) -> list[list[tuple[int, int]]]:
        """Fused single-dispatch count+locate; over-cap queries share one
        extra walk dispatch (assembly fully vectorized, round-2 verdict
        task 5)."""
        counts, seq_idx, local, offsets = self.count_locate_arrays(queries)
        pairs = list(zip(seq_idx.tolist(), local.tolist()))
        return [pairs[offsets[i] : offsets[i + 1]] for i in range(len(queries))]
