"""Data-parallel codec over a JAX device mesh.

The reference is single-process and strictly sequential; its only scaling
axis is streaming in time (SURVEY.md §2.2). This module adds a scaling
axis: **block data parallelism** over a `jax.sharding.Mesh`, with XLA
collectives (NCCL on GPUs) doing the global coordination the reference
never had:

  encode:  each device packs its contiguous symbol shard locally;
           the global bit offset of every shard is an `all_gather` of the
           per-shard bit totals + exclusive cumsum (the NCCL-equivalent
           layer is just this one collective); a final scatter-OR stitches
           the shard word-arrays into one stream, bit-identical to the
           single-chip / reference encoding of the whole buffer.
  decode:  blocks from a BlockIndex are striped contiguously across
           devices; each device receives only the word-range its blocks
           touch (no replicated input), runs the lane decode
           (ops/lanes.py), and the outputs concatenate in order (fixed
           symbols per block).

The mesh is 1-D ``("data",)`` by default; a multi-axis mesh flattens to
one data axis here because block DP is the honest mapping for a codec
(SURVEY.md §2.2).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .errors import UnknownSymbolError
from .ops.bitpack import bytes_from_words_np, words_from_bytes_np
from .ops import dispatch, lanes
from .ops.decode import BlockIndex
from .ops.encode import DEFAULT_BLOCK_SYMBOLS, DEFAULT_EOS_PADDING, DeviceTable
from .tables import HuffmanTable


def _bucket_pow2(per_dev: int, block_symbols: int) -> int:
    """Round a shard size up to (pow2 multiple of block_symbols): nearby
    input sizes then share one compiled shard program; excess lanes are
    zero-padded and masked by n_valid."""
    units = -(-per_dev // block_symbols)
    return block_symbols * (1 << (units - 1).bit_length() if units > 1 else 1)


def default_mesh(devices=None, axis: str = "data") -> Mesh:
    """A 1-D data mesh over all local devices (or the given ones)."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis,))


def _flat_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


# --------------------------------------------------------------- encode ----


def _global_phase_base(local_bits, axes):
    """(phase, word_base) of this shard's exclusive global bit offset.

    Device code runs without int64 (x64 off) and an int32 cumsum of shard
    bit totals silently wraps past 2^31 bits (~256 MiB encoded). Each total is split into
    (hi = bits >> 16, lo = bits & 0xFFFF) int32 halves and the halves are
    cumsummed independently; offset = csum_hi * 2^16 + csum_lo exactly, so
      phase     = offset & 31  = csum_lo & 31          (2^16 ≡ 0 mod 32)
      word_base = offset >> 5  = (csum_hi << 11) + (csum_lo >> 5)
    with no wrap while word_base < 2^31, i.e. streams up to 2^36 bits
    (8 GiB). csum_lo < ndev * 2^16 and csum_hi < 2^20 stay far inside
    int32. Callers guard the 2^36 ceiling host-side.

    Gather innermost axis first so dims stack [a0, a1, ...]; flattening is
    then majority-ordered like the P((a0, a1, ...)) shard assignment.
    """
    totals = local_bits
    for ax in reversed(axes):
        totals = jax.lax.all_gather(totals, ax, axis=0)
    totals = totals.reshape(-1)
    my_idx = jax.lax.axis_index(axes[0])
    for ax in axes[1:]:
        my_idx = my_idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
    csum_hi = jnp.cumsum(totals >> 16)
    csum_lo = jnp.cumsum(totals & 0xFFFF)
    pre_hi = csum_hi[my_idx] - (local_bits >> 16)  # exclusive prefix
    pre_lo = csum_lo[my_idx] - (local_bits & 0xFFFF)
    phase = pre_lo & 31
    word_base = (pre_hi << 11) + (pre_lo >> 5)
    return phase, word_base


def _shard_encode_body(symbols, n_valid, patterns, lengths, axes,
                       offs_every: int = 0):
    """Per-shard bit packing; runs under shard_map.

    symbols: uint8[local_n] this shard's symbols
    n_valid: int32[1]       valid symbols in this shard
    Returns (words uint32[local_n+2] local bit-packed stream aligned to the
    shard's *global* intra-word phase, bit_total int32[1], word_base int32[1],
    bad int32[1][, LOCAL bit offsets of every offs_every-th symbol —
    device-side, O(local); the caller adds the shard's int64 global base
    on host, so block offsets never wrap]).
    """
    n = symbols.shape[0]
    nv = n_valid[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    valid = pos < nv
    lens_raw = lengths[symbols]
    lens = jnp.where(valid, lens_raw, 0)
    bad = jnp.any(valid & (lens_raw == 0))

    ends = jnp.cumsum(lens, dtype=jnp.int32)
    local_bits = ends[-1]

    # Pack local bits phase-aligned: local bit j sits at global bit offset+j,
    # i.e. at bit (offset%32 + j) of local words starting at word offset//32.
    phase, word_base = _global_phase_base(local_bits, axes)
    starts = ends - lens + phase
    pats = patterns[symbols].astype(jnp.uint32)
    shift_left = jnp.uint32(32) - lens.astype(jnp.uint32)
    p32 = jnp.where(lens > 0, pats << (shift_left & jnp.uint32(31)), jnp.uint32(0))
    widx = (starts >> 5).astype(jnp.int32)
    sh = (starts & 31).astype(jnp.uint32)
    hi = p32 >> sh
    lo = (p32 << (jnp.uint32(31) - sh)) << jnp.uint32(1)
    words = jnp.zeros(n + 2, dtype=jnp.uint32)
    words = words.at[widx].add(hi, mode="drop", indices_are_sorted=True)
    words = words.at[widx + 1].add(lo, mode="drop", indices_are_sorted=True)
    outs = (
        words,
        local_bits[None],
        word_base[None],
        bad.astype(jnp.int32)[None],
    )
    if offs_every:
        offs_blk = (ends - lens)[::offs_every][: n // offs_every]
        outs = outs + (offs_blk,)
    return outs


@functools.partial(jax.jit, static_argnames=("num_out_words",))
def _stitch_kernel(words, word_bases, num_out_words: int):
    """OR every shard's word window into the global stream.

    Bits are disjoint across shards (each owns a bit range; the slack words
    past a shard's last bit are zero), so only the boundary word of each
    window genuinely ORs. One read-OR-write dynamic window per shard is
    plain slice traffic, where an elementwise scatter would touch every
    word through an index. The +w over-allocation keeps
    dynamic_slice from clamp-shifting the last shard's window; bits past
    num_out_words are slack zeros and are trimmed on return.
    """
    ndev, w = words.shape
    out = jnp.zeros(num_out_words + w, dtype=jnp.uint32)
    for d in range(ndev):
        base = word_bases[d]
        cur = jax.lax.dynamic_slice(out, (base,), (w,))
        out = jax.lax.dynamic_update_slice(out, cur | words[d], (base,))
    return out[:num_out_words]


@dataclasses.dataclass
class MeshCodec:
    """Data-parallel encoder/decoder bound to a mesh and a table.

    Produces byte streams bit-identical to the single-chip path (and thus to
    the reference); emits/consumes the same BlockIndex metadata.
    """

    table: HuffmanTable
    mesh: Mesh
    block_symbols: int = DEFAULT_BLOCK_SYMBOLS  # index granularity
    eos_padding: int = DEFAULT_EOS_PADDING  # reference: huffman.h:66

    def __post_init__(self):
        self._dt = DeviceTable.for_table(self.table)
        self._lt = lanes.LaneTable.for_table(self.table)
        self._ndev = math.prod(self.mesh.devices.shape)
        self._enc_cache = {}
        self._dec_cache = {}

    # ---- encode ----

    def _encode_sharded_fn(self, per_dev: int, with_offsets: bool):
        """shard_map'd per-shard XLA encode for a fixed shard size;
        with_offsets adds a 5th output: the shard-local bit offsets of
        every block_symbols-th symbol (device-computed, no host cumsum)."""
        key = (per_dev, with_offsets)
        if key in self._enc_cache:
            return self._enc_cache[key]
        axes = _flat_axes(self.mesh)
        spec = P(axes[0] if len(axes) == 1 else axes)
        body = functools.partial(
            _shard_encode_body,
            patterns=self._dt.patterns,
            lengths=self._dt.lengths,
            axes=axes,
            offs_every=self.block_symbols if with_offsets else 0,
        )
        nouts = 5 if with_offsets else 4
        fn = jax.jit(
            jax.shard_map(
                body, mesh=self.mesh, in_specs=(spec, spec),
                out_specs=(spec,) * nouts, check_vma=False,
            )
        )
        self._enc_cache[key] = fn
        return fn

    def encode(self, data: bytes | np.ndarray, with_index: bool = True):
        """Returns (encoded_bytes, BlockIndex | None).

        Output bytes == tpu_huffman.encode(data) == the reference encoding.
        """
        symbols = (
            np.frombuffer(bytes(data), dtype=np.uint8)
            if isinstance(data, (bytes, bytearray))
            else np.asarray(data, dtype=np.uint8)
        )
        n = symbols.size
        if n == 0:
            empty = BlockIndex(self.block_symbols, np.zeros(0, np.int64),
                               np.zeros(0, np.int32), 0, 0)
            return b"", (empty if with_index else None)

        ndev = self._ndev
        # Shard size: multiple of block_symbols so decode striping aligns,
        # bucketed to a power of two so nearby input sizes reuse one
        # compiled shard program.
        per_dev = -(-n // ndev)
        per_dev = _bucket_pow2(per_dev, self.block_symbols)
        total_padded = per_dev * ndev
        padded = np.zeros(total_padded, dtype=np.uint8)
        padded[:n] = symbols
        n_valid = np.minimum(
            np.maximum(n - per_dev * np.arange(ndev, dtype=np.int64), 0), per_dev
        ).astype(np.int32)

        # Wrap guards (the device offset math is exact to 2^36 bits; local
        # per-shard cumsums are int32): raise instead of wrapping, matching
        # the single-device encode_with_index guard.
        if per_dev * int(self.table.max_len) >= 1 << 31:
            raise ValueError(
                "per-device shard would exceed 2^31 bits encoded; use more "
                "devices or the chunked streaming protocol"
            )

        outs = self._encode_sharded_fn(per_dev, with_index)(
            jnp.asarray(padded), jnp.asarray(n_valid)
        )
        words, local_bits, word_bases, bad = outs[:4]
        if bool(jnp.any(bad > 0)):
            lens = self.table.lengths[symbols]
            idx = int(np.flatnonzero(lens == 0)[0])
            raise UnknownSymbolError(index=idx, symbol=int(symbols[idx]))

        # Host-side int64 view of the shard bit layout (never wraps).
        totals64 = np.asarray(local_bits).astype(np.int64).reshape(-1)
        bases64 = np.cumsum(totals64) - totals64
        total_bits = int(totals64.sum())
        if total_bits >= 1 << 36:
            raise ValueError(
                "encoded stream exceeds 2^36 bits (8 GiB): int32 word "
                "indices would wrap; use the chunked streaming protocol"
            )
        num_words = total_bits // 32 + 2
        out_words = _stitch_kernel(
            words.reshape(ndev, -1), word_bases.reshape(-1).astype(jnp.int32),
            num_out_words=num_words,
        )
        out_np = np.asarray(out_words)
        # EOS padding on the final partial byte (host-side: one byte).
        out = bytearray(bytes_from_words_np(out_np, (total_bits + 7) // 8))
        tail = total_bits & 7
        if tail:
            pad = 8 - tail
            out[-1] |= self.eos_padding & ((1 << pad) - 1)
        if not with_index:
            return bytes(out), None

        n_blocks = -(-n // self.block_symbols)
        # Block offsets straight from the shard encode's own prefix sums
        # (LOCAL to each shard) plus the shard's int64 global base — host
        # work O(blocks), and the absolute offsets never wrap.
        local_offs = np.asarray(outs[4]).astype(np.int64).reshape(ndev, -1)
        offsets = (local_offs + bases64[:, None]).reshape(-1)[:n_blocks]
        n_sym = np.full(n_blocks, self.block_symbols, dtype=np.int32)
        n_sym[-1] = n - (n_blocks - 1) * self.block_symbols
        index = BlockIndex(
            symbols_per_block=self.block_symbols,
            bit_offsets=offsets.astype(np.int64),
            n_symbols=n_sym,
            total_symbols=n,
            total_bits=total_bits,
        )
        return bytes(out), index

    # ---- multi-host collective encode ----

    def encode_sharded(self, local_data: bytes | np.ndarray,
                       with_index: bool = True):
        """Collective encode where each process contributes only ITS bytes.

        All processes must call this together; every process returns the
        same (encoded_bytes, BlockIndex) — bit-identical to the
        single-stream encoding of the processes' bytes concatenated in
        process order (the reference's chunked == one-shot contract,
        huffman_testing.c:75-173). No host ever materializes the full
        input: each process feeds its local shard via
        jax.make_array_from_process_local_data; the only host-side global
        arrays are the (compressed-size) output words, the per-shard bit
        totals and the O(blocks) offset index. Shard lengths may differ
        across processes (interior padding is masked out of the stream by
        per-block valid counts; padding blocks appear in the index with
        n_symbols == 0).

        Requires ``self.mesh`` to enumerate devices in process order
        (e.g. distributed.global_data_mesh / process_local_mesh).
        """
        local = (
            np.frombuffer(bytes(local_data), dtype=np.uint8)
            if isinstance(local_data, (bytes, bytearray))
            else np.asarray(local_data, dtype=np.uint8)
        )
        nproc = jax.process_count()
        if nproc == 1:
            return self.encode(local.tobytes(), with_index=with_index)
        from jax.experimental import multihost_utils

        ld = jax.local_device_count()
        bs = self.block_symbols
        axes = _flat_axes(self.mesh)
        spec = P(axes[0] if len(axes) == 1 else axes)
        sh1 = NamedSharding(self.mesh, spec)

        lens = np.asarray(
            multihost_utils.process_allgather(
                np.array([local.size], np.int64)
            )
        ).reshape(-1)
        per_dev = max(bs, -(-int(lens.max()) // ld))
        per_dev = _bucket_pow2(per_dev, bs)
        slab = np.zeros(ld * per_dev, np.uint8)
        slab[: local.size] = local
        nv_local = np.clip(
            local.size - per_dev * np.arange(ld, dtype=np.int64), 0, per_dev
        ).astype(np.int32)
        ndev = nproc * ld
        arr = jax.make_array_from_process_local_data(
            sh1, slab, (ndev * per_dev,)
        )
        nv = jax.make_array_from_process_local_data(sh1, nv_local, (ndev,))

        if per_dev * int(self.table.max_len) >= 1 << 31:
            raise ValueError(
                "per-device shard would exceed 2^31 bits encoded; use more "
                "devices or the chunked streaming protocol"
            )
        outs = self._encode_sharded_fn(per_dev, with_index)(arr, nv)
        words, local_bits, _word_bases, bad = outs[:4]

        def gather(garr) -> np.ndarray:
            """Global sharded array -> full np array on every process, via
            allgather of each process's addressable rows (process order ==
            device order by the mesh requirement above)."""
            shards = sorted(garr.addressable_shards, key=lambda s: s.index)
            local_np = np.concatenate([np.asarray(s.data) for s in shards])
            return np.asarray(
                multihost_utils.process_allgather(local_np, tiled=True)
            )

        bad_np = gather(bad)  # small [ndev]
        if (bad_np > 0).any():
            # Report the first local offender if this process has one (each
            # process scans only its OWN bytes).
            bad_l = np.flatnonzero(self.table.lengths[local] == 0)
            if bad_l.size:
                i = int(bad_l[0])
                raise UnknownSymbolError(index=i, symbol=int(local[i]))
            raise UnknownSymbolError()
        totals = gather(local_bits).astype(np.int64).reshape(-1)
        offsets_dev = np.cumsum(totals) - totals
        total_bits = int(totals.sum())
        if total_bits >= 1 << 36:
            raise ValueError(
                "encoded stream exceeds 2^36 bits (8 GiB): int32 word "
                "indices would wrap; use the chunked streaming protocol"
            )

        # Output assembly: gather only the words each shard actually used
        # (~compressed size), then OR them in at their word bases on host.
        Wshard = words.shape[0] // ndev
        wmax = int(
            min(Wshard, (int(totals.max()) + 31) // 32 + 2)
        )
        w2d = words.reshape(ndev, Wshard)[:, :wmax]
        words_np = gather(w2d).reshape(ndev, wmax)
        out_words = np.zeros(total_bits // 32 + 2, np.uint32)
        for s in range(ndev):
            if totals[s] == 0:
                continue
            base = int(offsets_dev[s]) >> 5
            nw = min(wmax, out_words.size - base)
            out_words[base : base + nw] |= words_np[s, :nw]
        out = bytearray(bytes_from_words_np(out_words, (total_bits + 7) // 8))
        tail = total_bits & 7
        if tail:
            out[-1] |= self.eos_padding & ((1 << (8 - tail)) - 1)

        n_total = int(lens.sum())
        if not with_index:
            return bytes(out), None

        # Index over the padded global positions: per-device block counts
        # from the gathered lengths; offsets from the shard encode.
        blocks_per_dev = per_dev // bs
        n_blocks = ndev * blocks_per_dev
        counts_dev = np.clip(
            np.repeat(lens, ld)
            - per_dev * np.tile(np.arange(ld, dtype=np.int64), nproc),
            0,
            per_dev,
        )
        n_sym = np.clip(
            counts_dev[:, None] - bs * np.arange(blocks_per_dev)[None, :],
            0,
            bs,
        ).astype(np.int32).reshape(-1)
        # Local shard offsets + each shard's int64 global base: absolute
        # block offsets are int64 end-to-end and never wrap.
        local_offs = gather(outs[4]).astype(np.int64).reshape(ndev, -1)
        offsets = (local_offs + offsets_dev[:, None]).reshape(-1)[:n_blocks]
        index = BlockIndex(
            symbols_per_block=bs,
            bit_offsets=offsets.astype(np.int64),
            n_symbols=n_sym,
            total_symbols=n_total,
            total_bits=total_bits,
        )
        return bytes(out), index

    # ---- decode ----

    def _decode_sharded_fn(self, impl: str):
        if impl in self._dec_cache:
            return self._dec_cache[impl]
        axes = _flat_axes(self.mesh)
        spec = P(axes[0] if len(axes) == 1 else axes)
        fn = jax.jit(
            jax.shard_map(
                functools.partial(
                    _shard_decode_body, lt=self._lt,
                    steps=self.block_symbols, impl=impl,
                ),
                mesh=self.mesh,
                in_specs=(spec, spec),
                out_specs=(spec, spec),
                check_vma=False,
            )
        )
        self._dec_cache[impl] = fn
        return fn

    def decode(self, data: bytes | np.ndarray, index: BlockIndex,
               impl: str | None = None) -> bytes:
        """Block-parallel decode striped over the mesh.

        Each device receives the word window its blocks touch and decodes
        them as lanes of the lane decode (``impl`` from ops/dispatch.py
        unless given). Raises UnknownSymbolError on a corrupt stream.
        """
        raw = bytes(data) if isinstance(data, (bytes, bytearray)) else bytes(
            np.asarray(data, dtype=np.uint8).tobytes()
        )
        if index.total_symbols == 0:
            return b""
        if index.symbols_per_block != self.block_symbols:
            raise ValueError(
                f"index has {index.symbols_per_block} symbols per block; "
                f"this codec decodes {self.block_symbols}"
            )
        impl = impl or dispatch.lane_impl("mesh_decode")
        words_np, _ = words_from_bytes_np(raw)
        words_np = np.concatenate([words_np, np.zeros(2, dtype=np.uint32)])

        ndev = self._ndev
        B = index.bit_offsets.size
        bpd = -(-B // ndev)  # blocks per device
        bpd = -(-bpd // lanes.TILE) * lanes.TILE
        offs = index.bit_offsets.astype(np.int64)
        # Per-shard word windows: shard s covers blocks [s*bpd, (s+1)*bpd).
        first = np.minimum(np.arange(ndev) * bpd, B - 1)
        word_base = offs[first] // 32
        ends_bits = np.empty(ndev, dtype=np.int64)
        for s in range(ndev):
            last_b = min((s + 1) * bpd, B) - 1
            if last_b < s * bpd:
                ends_bits[s] = word_base[s] * 32
            else:
                ends_bits[s] = int(offs[last_b]) + int(
                    index.n_symbols[last_b]
                ) * self.table.max_len
        wmax = int(np.max(-(-(ends_bits - word_base * 32) // 32))) + 2
        win = np.zeros((ndev, wmax), dtype=np.uint32)
        for s in range(ndev):
            lo = int(word_base[s])
            hi = min(lo + wmax, words_np.size)
            win[s, : hi - lo] = words_np[lo:hi]

        # lanes[s] = (word index within shard s's window, bit phase, count)
        lane_in = np.zeros((ndev, 3, bpd), dtype=np.int32)
        b_idx = np.arange(B)
        s_of_b = b_idx // bpd
        rel = offs - 32 * word_base[s_of_b]
        lane_in[s_of_b, 0, b_idx - s_of_b * bpd] = rel >> 5
        lane_in[s_of_b, 1, b_idx - s_of_b * bpd] = rel & 31
        lane_in[s_of_b, 2, b_idx - s_of_b * bpd] = index.n_symbols

        syms, bad = self._decode_sharded_fn(impl)(
            jnp.asarray(win).reshape(-1), jnp.asarray(lane_in).reshape(-1)
        )
        if jax.process_count() > 1:
            # Sharded output isn't fully addressable per process: gather the
            # global value so every host returns the stream.
            from jax.experimental import multihost_utils

            syms_np = multihost_utils.process_allgather(syms, tiled=True)
            bad_np = multihost_utils.process_allgather(bad, tiled=True)
        else:
            syms_np, bad_np = np.asarray(syms), np.asarray(bad)
        if (bad_np != 0).any():
            raise UnknownSymbolError()
        out = syms_np.reshape(ndev * bpd, self.block_symbols)[:B]
        if (index.n_symbols[:-1] == self.block_symbols).all():
            # Blocks are full except possibly the last: flatten then cut.
            return out.reshape(-1)[: index.total_symbols].tobytes()
        mask = (
            np.arange(self.block_symbols)[None, :] < index.n_symbols[:, None]
        )
        return out[mask].tobytes()


def _shard_decode_body(win, lane_in, *, lt, steps, impl):
    """Per-shard block decode; runs under shard_map (flat 1-D inputs).
    Returns (symbols uint8[bpd * steps], bad int32[1])."""
    lane_in = lane_in.reshape(3, -1)
    syms, _exits, bad, _o, _b = lanes.decode_lanes(
        win, lane_in[0], lane_in[1], lane_in[2], lt, steps=steps, impl=impl
    )
    return syms.reshape(-1), jnp.any(bad != 0).astype(jnp.int32)[None]
