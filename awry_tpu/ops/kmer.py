"""K-mer seed-table construction on device.

The reference builds its table by a depth-first recursion of scalar range
updates (kmer_lookup_table.rs:121-167).  The device shape is k
breadth-wise rounds (SURVEY.md section 7 step 6): round `level` extends all
base**level prefixes by every encoding symbol in ONE vectorized
update_range over the whole next level.

Addressing matches the host builder exactly (host_engine._kmer_address):
address = sum dense(symbol at distance j from the k-mer end) * base**j.

Compile discipline: the whole build uses ONE fixed-shape jitted step - the level
tables live in two ping-pong device buffers of base**k entries, every level
runs as fixed-size chunks over them with the level size as a TRACED scalar,
and buffers are donated so updates are in place.  (The previous shape-per-
level structure compiled ~k distinct programs: most of a deep build's wall
clock was serialized compiles, not device compute.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import dense_to_index_table
from .device_index import FmDeviceIndex
from .rank import seed_range, update_range


@jax.jit
def _seed_level(index: FmDeviceIndex, syms: jax.Array):
    return seed_range(index, syms)


# Largest number of range updates materialized at once: each update gathers a
# fused row per endpoint (plus XLA's gather temporaries), so 2M updates
# take GBs of device temp - deep tables (k=13 is 67M
# entries) must be built in chunks.
_LEVEL_CHUNK = 1 << 21


def _level_chunk(base: int, total: int) -> int:
    """Chunk size for the fixed-shape level loop.

    The chunk must DIVIDE every chunked level's size (levels are base**l):
    dynamic_update_slice clamps out-of-range starts, so a non-dividing final
    chunk would write at a wrong (clamped) offset.  chunk = base**m * 2**j
    with 2**j | base divides base**l for every l > m (base**l = base**m *
    base**(l-m) and 2**j | base), and never exceeds the buffer (<= total).
    (Halving from `total` — the first scheme — broke for base 20 at k >= 6:
    stripping 2s leaves a 5**k factor that 20**(k-1) lacks.)"""
    chunk = 1
    while chunk * base <= _LEVEL_CHUNK:
        chunk *= base
    # Fold in the powers of 2 that divide `base` (keeps the chunk near the
    # cap without breaking divisibility).
    twos = base & -base
    while twos > 1 and chunk * 2 <= _LEVEL_CHUNK:
        chunk *= 2
        twos //= 2
    return min(chunk, total)


@functools.partial(jax.jit, donate_argnames=("dst_s", "dst_e"), static_argnames=("chunk",))
def _extend_step(index: FmDeviceIndex, src_s, src_e, dst_s, dst_e, syms, size, off, *, chunk):
    """One chunk of one level: dst[off + i] = update(src[(off+i) % size],
    sym[(off+i) // size]) for i < chunk.  `size`/`off` are traced scalars, so
    every chunk of every level reuses this single compiled program.  Lanes
    past the level's end compute with clamped indices and are overwritten by
    later levels / ignored past base**k."""
    idx = jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0] + off
    d = jnp.minimum(idx // size, syms.shape[0] - 1)
    old = idx % size
    ns, ne = update_range(index, src_s[old], src_e[old], syms[d])
    dst_s = jax.lax.dynamic_update_slice(dst_s, ns, (off,))
    dst_e = jax.lax.dynamic_update_slice(dst_e, ne, (off,))
    return dst_s, dst_e


def populate_kmer_table_device(index: FmDeviceIndex, kmer_len: int | None = None) -> np.ndarray:
    """Build the dense k-mer seed table on the device.

    Returns uint64[base**k, 2] in the same layout as
    host_engine.populate_kmer_table (bit-identical ranges).
    """
    alphabet = index.alphabet
    base = alphabet.num_encoding_symbols
    if kmer_len is None and index.kmer_len == 0:
        # A minimal device index (to_device(minimal=True)) carries kmer_len=0
        # ("table disabled"); silently returning the 1-entry placeholder here
        # would quietly disable seeding for the caller.  Production call sites
        # (build/builder.py, io/awry_format.py) pass kmer_len explicitly.
        raise ValueError(
            "device index has no k-mer table (kmer_len=0); pass kmer_len "
            "explicitly to build one"
        )
    k = kmer_len if kmer_len is not None else index.kmer_len
    if k == 0:  # explicit k=0: single canonical-empty entry, never read
        return np.array([[1, 0]], dtype=np.uint64)
    raw_syms = dense_to_index_table(alphabet).astype(np.int32)  # dense rank -> raw index
    syms = jnp.asarray(raw_syms)

    total = base**k
    chunk = _level_chunk(base, total)
    s0, e0 = _seed_level(index, syms)
    if k == 1:
        starts = np.asarray(s0).astype(np.int64)
        ends = np.asarray(e0).astype(np.int64)
    else:
        # Ping-pong level buffers (reads at [0, size) must not alias the
        # chunk writes at [0, size*base), since new_addr == old_addr at d=0).
        buf_a_s = jnp.zeros((total,), dtype=jnp.uint32).at[:base].set(s0)
        buf_a_e = jnp.zeros((total,), dtype=jnp.uint32).at[:base].set(e0)
        buf_b_s = jnp.zeros((total,), dtype=jnp.uint32)
        buf_b_e = jnp.zeros((total,), dtype=jnp.uint32)
        src_s, src_e, dst_s, dst_e = buf_a_s, buf_a_e, buf_b_s, buf_b_e
        size = base
        for _level in range(1, k):
            new_size = size * base
            assert new_size <= chunk or new_size % chunk == 0, (new_size, chunk)
            for off in range(0, new_size, chunk):
                dst_s, dst_e = _extend_step(
                    index, src_s, src_e, dst_s, dst_e, syms,
                    jnp.int32(size), jnp.int32(off), chunk=chunk,
                )
            src_s, src_e, dst_s, dst_e = dst_s, dst_e, src_s, src_e
            size = new_size
        starts = np.asarray(src_s).astype(np.int64)
        ends = np.asarray(src_e).astype(np.int64)

    table = np.stack(
        [np.maximum(starts, 0).astype(np.uint64), np.maximum(ends, 0).astype(np.uint64)],
        axis=1,
    )
    empty = starts > ends
    table[empty, 0] = 1  # canonical empty range (src/search.rs:51-56)
    table[empty, 1] = 0
    return table
