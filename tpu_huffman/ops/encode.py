"""Vectorized Huffman encode.

Data-parallel replacement for the reference's serial bit packer
(reference: source/huffman.c:59-105 ``encode_write_bit_pattern`` and the
per-byte loop at source/huffman.c:161-173). Instead of threading one working
byte through the stream, the kernel:

1. gathers ``(pattern, num_bits)`` for every symbol at once
   (the vectorized coder->encode, reference: source/huffman.c:168),
2. computes every code's absolute output bit offset with an exclusive
   prefix sum over code lengths,
3. left-aligns each code in a uint32, splits it at the word boundary it
   straddles (a code is <= 32 bits so it touches at most 2 words), and
4. scatter-adds the two word contributions. Bits never collide, so integer
   add is exactly bitwise OR — XLA lowers this to a sorted-index scatter.

EOS padding reproduces reference semantics bit-for-bit: the final partial
byte is completed with the low ``8 - (total_bits % 8)`` bits of
``eos_padding`` (reference: source/huffman.c:178-184 pads via
``encode_write_bit_pattern`` which takes the low ``num_bits`` of the
pattern, source/huffman.c:71-76; default padding byte 0xFF,
source/huffman.c:19).

Unknown symbols (num_bits == 0, reference: source/huffman.c:62-64) cannot
early-return from a traced kernel; the kernel reduces a validity mask and
reports (flag, first_bad_index) for the host wrapper to raise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import UnknownSymbolError
from ..tables import HuffmanTable
from .bitpack import bytes_from_words_np

DEFAULT_EOS_PADDING = 0xFF  # reference: source/huffman.c:19


@functools.partial(jax.jit, static_argnames=("num_out_words",))
def encode_block_kernel(
    symbols: jnp.ndarray,  # uint8[N] (padded to fixed N)
    n_valid: jnp.ndarray,  # int32 scalar, number of real symbols
    patterns: jnp.ndarray,  # uint32[256]
    lengths: jnp.ndarray,  # int32[256]
    eos_padding: jnp.ndarray,  # uint32 scalar
    bit_carry: jnp.ndarray,  # int32 scalar: bits already in words[0]'s MSBs
    num_out_words: int,
):
    """Encode one block of symbols into packed uint32 words.

    Returns (words[num_out_words], total_bits, padded_bits, bad_flag, bad_idx).
    ``total_bits`` includes ``bit_carry``; callers stitching blocks OR the
    first word onto an existing tail. ``padded_bits`` is total_bits rounded
    up to a byte with EOS padding applied in the words.
    """
    n = symbols.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    valid = pos < n_valid

    lens_raw = lengths[symbols]
    lens = jnp.where(valid, lens_raw, 0)
    unknown = valid & (lens_raw == 0)
    bad_flag = jnp.any(unknown)
    bad_idx = jnp.argmax(unknown).astype(jnp.int32)

    ends = jnp.cumsum(lens, dtype=jnp.int32) + bit_carry
    starts = ends - lens
    total_bits = ends[-1] if n > 0 else bit_carry

    # Left-align each code at the MSB of a uint32.
    pats = patterns[symbols].astype(jnp.uint32)
    shift_left = jnp.uint32(32) - lens.astype(jnp.uint32)
    p32 = jnp.where(lens > 0, pats << (shift_left & jnp.uint32(31)), jnp.uint32(0))

    # EOS padding as one extra synthetic "code" appended at total_bits.
    tail = (total_bits & 7).astype(jnp.int32)
    pad_len = ((8 - tail) & 7).astype(jnp.uint32)
    pad_low = eos_padding.astype(jnp.uint32) & ((jnp.uint32(1) << pad_len) - jnp.uint32(1))
    pad_p32 = jnp.where(
        pad_len > 0, pad_low << ((jnp.uint32(32) - pad_len) & jnp.uint32(31)), jnp.uint32(0)
    )
    padded_bits = total_bits + pad_len.astype(jnp.int32)

    all_p32 = jnp.concatenate([p32, pad_p32[None]])
    all_starts = jnp.concatenate([starts, total_bits[None]])

    widx = (all_starts >> 5).astype(jnp.int32)
    sh = (all_starts & 31).astype(jnp.uint32)
    hi = all_p32 >> sh
    lo = (all_p32 << (jnp.uint32(31) - sh)) << jnp.uint32(1)  # == p32 << (32-sh), 0 at sh==0

    words = jnp.zeros(num_out_words, dtype=jnp.uint32)
    # Disjoint bit positions => add === or. Indices are monotone nondecreasing.
    words = words.at[widx].add(hi, mode="drop", indices_are_sorted=True)
    words = words.at[widx + 1].add(lo, mode="drop", indices_are_sorted=True)
    return words, total_bits, padded_bits, bad_flag, bad_idx


@jax.jit
def encoded_length_bits_kernel(symbols, n_valid, lengths):
    """Sum of code lengths in bits (reference: source/huffman.c:107-129)."""
    n = symbols.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    lens = jnp.where(pos < n_valid, lengths[symbols], 0)
    return jnp.sum(lens, dtype=jnp.int32)


def _bucket_size(n: int, block: int = 65536) -> int:
    """Round up to a small set of static shapes to bound recompilation."""
    if n <= 256:
        return 256
    if n <= block:
        # powers of two between 256 and block
        return 1 << (n - 1).bit_length()
    return ((n + block - 1) // block) * block


class DeviceTable:
    """A HuffmanTable's arrays staged on device, cached per table instance."""

    def __init__(self, table: HuffmanTable):
        self.table = table
        self.patterns = jnp.asarray(table.patterns, dtype=jnp.uint32)
        self.lengths = jnp.asarray(table.lengths, dtype=jnp.int32)
        self.l0_bits = jnp.asarray(table.l0_bits, dtype=jnp.int32)
        self.l0_val = jnp.asarray(table.l0_val, dtype=jnp.int32)
        self.l1_bits = jnp.asarray(table.l1_bits, dtype=jnp.int32)
        self.l1_val = jnp.asarray(table.l1_val, dtype=jnp.int32)

    _cache: dict[int, "DeviceTable"] = {}

    @staticmethod
    def for_table(table: HuffmanTable) -> "DeviceTable":
        key = id(table)
        dt = DeviceTable._cache.get(key)
        if dt is None or dt.table is not table:
            dt = DeviceTable(table)
            DeviceTable._cache[key] = dt
        return dt


def encode(
    data: bytes | bytearray | np.ndarray,
    table: HuffmanTable,
    eos_padding: int = DEFAULT_EOS_PADDING,
) -> bytes:
    """One-shot encode: bytes in, reference-bit-identical compressed bytes out."""
    from .. import metrics

    with metrics.record("encode", len(data)) as _m:
        out = _encode_impl(data, table, eos_padding)
        _m[0] = len(out)
    return out


def _encode_impl(data, table, eos_padding):
    symbols = (
        np.frombuffer(bytes(data), dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.asarray(data, dtype=np.uint8)
    )
    n = symbols.size
    if n == 0:
        return b""
    from .. import stream as _stream

    if n * int(table.max_len) >= _stream._ONE_SHOT_BIT_LIMIT:
        # int32 device bit offsets bound one call at 2^31 output bits.
        # The data's own code-length envelope often clears the bound; when
        # it doesn't, HuffmanEncoder auto-segments internally through the
        # capacity protocol — the carry path never inserts mid-stream
        # padding, so the bytes are identical to a true one-shot
        # (reference is size_t-clean, source/huffman.c:107-129).
        eff = int(table.lengths[symbols].max()) if n else 0
        if n * max(eff, 1) >= _stream._ONE_SHOT_BIT_LIMIT:
            return _stream.HuffmanEncoder(table, eos_padding).encode_chunk(
                symbols, None
            ).data
    bucket = _bucket_size(n)
    padded = np.zeros(bucket, dtype=np.uint8)
    padded[:n] = symbols
    dt = DeviceTable.for_table(table)
    num_words = bucket + 2  # 32 bits/code max + pad word + straddle word
    words, total_bits, padded_bits, bad_flag, bad_idx = encode_block_kernel(
        jnp.asarray(padded),
        jnp.int32(n),
        dt.patterns,
        dt.lengths,
        jnp.uint32(eos_padding),
        jnp.int32(0),
        num_out_words=num_words,
    )
    if bool(bad_flag):
        idx = int(bad_idx)
        raise UnknownSymbolError(index=idx, symbol=int(symbols[idx]))
    nbytes = int(padded_bits) // 8
    return bytes_from_words_np(np.asarray(words), nbytes)


@functools.partial(jax.jit, static_argnames=("num_out_words", "block_symbols"))
def encode_block_kernel_indexed(
    symbols, n_valid, patterns, lengths, eos_padding, bit_carry,
    num_out_words: int, block_symbols: int,
):
    """encode_block_kernel + per-block bit offsets for parallel decode.

    The extra output is the exclusive prefix sum sampled every
    ``block_symbols`` symbols — free, since the cumsum already exists.
    """
    n = symbols.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    valid = pos < n_valid
    lens_raw = lengths[symbols]
    lens = jnp.where(valid, lens_raw, 0)
    unknown = valid & (lens_raw == 0)
    bad_flag = jnp.any(unknown)
    bad_idx = jnp.argmax(unknown).astype(jnp.int32)

    ends = jnp.cumsum(lens, dtype=jnp.int32) + bit_carry
    starts = ends - lens
    total_bits = ends[-1]

    pats = patterns[symbols].astype(jnp.uint32)
    shift_left = jnp.uint32(32) - lens.astype(jnp.uint32)
    p32 = jnp.where(lens > 0, pats << (shift_left & jnp.uint32(31)), jnp.uint32(0))

    tail = (total_bits & 7).astype(jnp.int32)
    pad_len = ((8 - tail) & 7).astype(jnp.uint32)
    pad_low = eos_padding.astype(jnp.uint32) & ((jnp.uint32(1) << pad_len) - jnp.uint32(1))
    pad_p32 = jnp.where(
        pad_len > 0, pad_low << ((jnp.uint32(32) - pad_len) & jnp.uint32(31)), jnp.uint32(0)
    )
    padded_bits = total_bits + pad_len.astype(jnp.int32)

    all_p32 = jnp.concatenate([p32, pad_p32[None]])
    all_starts = jnp.concatenate([starts, total_bits[None]])
    widx = (all_starts >> 5).astype(jnp.int32)
    sh = (all_starts & 31).astype(jnp.uint32)
    hi = all_p32 >> sh
    lo = (all_p32 << (jnp.uint32(31) - sh)) << jnp.uint32(1)

    words = jnp.zeros(num_out_words, dtype=jnp.uint32)
    words = words.at[widx].add(hi, mode="drop", indices_are_sorted=True)
    words = words.at[widx + 1].add(lo, mode="drop", indices_are_sorted=True)

    block_offsets = starts[::block_symbols]
    return words, total_bits, padded_bits, bad_flag, bad_idx, block_offsets


# Symbols per index block: one lane of the lane decode (ops/lanes.py) per
# block. Each block costs 12 bytes of index; 512 measured fastest end to
# end at 128 MiB on the H100 (PERF.md "Kernel choices").
DEFAULT_BLOCK_SYMBOLS = 512


def encode_with_index(
    data: bytes | bytearray | np.ndarray,
    table: HuffmanTable,
    eos_padding: int = DEFAULT_EOS_PADDING,
    block_symbols: int = DEFAULT_BLOCK_SYMBOLS,
):
    """Encode and return (bytes, BlockIndex) for block-parallel decode.

    The bytes are identical to :func:`encode`; the index is side metadata
    (SURVEY.md §7 "Plan A": stream stays bit-identical to the reference).
    One call is bounded at 2^31 encoded bits (int32 device offsets).
    """
    from .. import stream as _stream
    from .decode import BlockIndex  # local import to avoid a cycle

    symbols = (
        np.frombuffer(bytes(data), dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.asarray(data, dtype=np.uint8)
    )
    n = symbols.size
    if n == 0:
        return b"", BlockIndex(block_symbols, np.zeros(0, np.int64), np.zeros(0, np.int32), 0, 0)
    eff = int(table.lengths[symbols].max())
    if n * max(eff, 1) >= _stream._ONE_SHOT_BIT_LIMIT:
        raise ValueError(
            f"input of {n} symbols may exceed 2^31 encoded bits "
            f"(max code length {eff}); feed it through "
            "HuffmanEncoder.encode_chunk in smaller pieces"
        )
    bucket = max(_bucket_size(n), block_symbols)
    bucket = ((bucket + block_symbols - 1) // block_symbols) * block_symbols
    padded = np.zeros(bucket, dtype=np.uint8)
    padded[:n] = symbols
    dt = DeviceTable.for_table(table)
    words, total_bits, padded_bits, bad_flag, bad_idx, offsets = (
        encode_block_kernel_indexed(
            jnp.asarray(padded),
            jnp.int32(n),
            dt.patterns,
            dt.lengths,
            jnp.uint32(eos_padding),
            jnp.int32(0),
            num_out_words=bucket + 2,
            block_symbols=block_symbols,
        )
    )
    if bool(bad_flag):
        idx = int(bad_idx)
        raise UnknownSymbolError(index=idx, symbol=int(symbols[idx]))
    n_blocks = (n + block_symbols - 1) // block_symbols
    n_syms = np.full(n_blocks, block_symbols, dtype=np.int32)
    n_syms[-1] = n - (n_blocks - 1) * block_symbols
    index = BlockIndex(
        symbols_per_block=block_symbols,
        bit_offsets=np.asarray(offsets)[:n_blocks].astype(np.int64),
        n_symbols=n_syms,
        total_symbols=n,
        total_bits=int(total_bits),
    )
    nbytes = int(padded_bits) // 8
    return bytes_from_words_np(np.asarray(words), nbytes), index


def get_encoded_length(
    data: bytes | bytearray | np.ndarray, table: HuffmanTable
) -> int:
    """Byte length of ``data`` post-encoding (reference: source/huffman.c:107-129).

    Unknown symbols contribute 0 bits, matching the reference's dry-run
    behavior (it never raises; num_bits of 0 simply adds nothing).
    """
    symbols = (
        np.frombuffer(bytes(data), dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.asarray(data, dtype=np.uint8)
    )
    bits = int(table.lengths[symbols].sum())
    return (bits + 7) // 8
