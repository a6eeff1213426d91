"""Vectorized Huffman decode.

The reference decoder is a strictly sequential bit-window state machine: the
bit position of symbol *n* depends on every previous code length
(reference: source/huffman.c:230-281). This module breaks that dependency
two ways:

1. **Block-parallel indexed decode** (the fast path): the encoder emits a
   per-block bit-offset index as metadata *outside* the byte stream (stream
   bytes stay bit-identical to the reference). Every block is one lane of
   the lane decode (ops/lanes.py): on a GPU a Pallas kernel in which each
   lane loops over its block's symbols in registers.

2. **Foreign streams** with no index: the self-synchronizing segment decode
   (ops/selfsync.py) for all but short streams, and below it a sequential
   scan that reproduces the reference state machine's termination rules
   exactly (reference: source/huffman.c:240-255): no-match with < 32 bits
   left => need more input (success); no-match with >= 32 bits => unknown
   symbol; code longer than remaining bits => trailing padding (success).

Symbol lookup is two gathers into the flattened LUT (tables.py) instead of
the reference's generated goto tree — branch-free and vectorizable.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import UnknownSymbolError
from ..tables import HuffmanTable
from . import dispatch, lanes
from .bitpack import extract_windows, stream_words_dev, words_from_bytes_np
from .encode import DeviceTable

STATUS_OK = 0
STATUS_UNKNOWN_SYMBOL = 1
STATUS_OUTPUT_FULL = 2  # the SHORT_BUFFER stop reason (reference huffman.c:266)


def lut_lookup(window: jnp.ndarray, dt: DeviceTable, root_bits: int):
    """Vectorized two-level LUT decode of 32-bit MSB-aligned windows.

    Returns (symbol int32, bits_read int32); bits_read == 0 => no match,
    matching the reference coder contract
    (include/aws/compression/huffman.h:46-48).
    """
    win = window.astype(jnp.uint32)
    idx0 = (win >> jnp.uint32(32 - root_bits)).astype(jnp.int32)
    b0 = dt.l0_bits[idx0]
    v0 = dt.l0_val[idx0]
    is_ptr = b0 < 0
    width = jnp.where(is_ptr, -b0, 1).astype(jnp.uint32)
    sub = (win << jnp.uint32(root_bits % 32)) >> ((jnp.uint32(32) - width) & jnp.uint32(31))
    idx1 = jnp.where(is_ptr, v0 + sub.astype(jnp.int32), 0)
    b1 = dt.l1_bits[idx1]
    v1 = dt.l1_val[idx1]
    bits_read = jnp.where(is_ptr, b1, b0)
    symbol = jnp.where(is_ptr, v1, v0)
    return symbol, bits_read


class _LutView:
    """Duck-typed stand-in for DeviceTable inside jitted kernels."""

    def __init__(self, l0_bits, l0_val, l1_bits, l1_val):
        self.l0_bits = l0_bits
        self.l0_val = l0_val
        self.l1_bits = l1_bits
        self.l1_val = l1_val


@functools.partial(jax.jit, static_argnames=("root_bits", "steps"))
def decode_stream_kernel(
    words: jnp.ndarray,  # uint32[W+1]
    start_bit: jnp.ndarray,  # int32 scalar
    total_bits: jnp.ndarray,  # int32 scalar: real bits in the stream
    out_capacity: jnp.ndarray,  # int32 scalar: max symbols to emit
    l0_bits, l0_val, l1_bits, l1_val,
    root_bits: int,
    steps: int,
):
    """Sequential decode with full reference termination semantics.

    One symbol per scan step; mirrors the reference loop
    (source/huffman.c:230-281) including the output-full check happening
    *before* the symbol is consumed, so a truncated call is restartable.

    Returns (symbols uint8[steps], valid bool[steps], n_decoded, end_bit,
    status). ``status`` is STATUS_OK (input exhausted / needs more input /
    trailing padding), STATUS_UNKNOWN_SYMBOL, or STATUS_OUTPUT_FULL (the
    stream layer maps the latter to the SHORT_BUFFER protocol);
    ``end_bit`` marks the resume position.
    """
    dt = _LutView(l0_bits, l0_val, l1_bits, l1_val)

    def step(carry, _):
        off, n_out, done, status = carry
        win = extract_windows(words, off)
        sym, nbits = lut_lookup(win, dt, root_bits)
        bits_left = total_bits - off

        no_match = nbits == 0
        need_more = no_match & (bits_left < 32)  # reference: huffman.c:240-244
        unknown = no_match & (bits_left >= 32)  # reference: huffman.c:246
        overrun = (~no_match) & (nbits > bits_left)  # padding, huffman.c:248-255
        out_full = n_out >= out_capacity  # huffman.c:257-266 (before consume)
        exhausted = bits_left <= 0

        stop = done | need_more | unknown | overrun | out_full | exhausted
        emit = ~stop
        # Stop-reason priority follows the reference check order:
        # no-match cases first, then padding overrun, then output-full.
        new_status = jnp.where(
            done,
            status,
            jnp.where(
                unknown,
                STATUS_UNKNOWN_SYMBOL,
                jnp.where(
                    out_full & ~need_more & ~overrun & ~exhausted,
                    STATUS_OUTPUT_FULL,
                    STATUS_OK,
                ),
            ),
        )
        off2 = jnp.where(emit, off + nbits, off)
        n2 = jnp.where(emit, n_out + 1, n_out)
        return (off2, n2, stop | done, new_status), (sym.astype(jnp.uint8), emit)

    init = (
        start_bit.astype(jnp.int32),
        jnp.int32(0),
        jnp.bool_(False),
        jnp.int32(STATUS_OK),
    )
    (end_bit, n_decoded, _, status), (syms, valid) = jax.lax.scan(
        step, init, None, length=steps
    )
    return syms, valid, n_decoded, end_bit, status


@dataclasses.dataclass(frozen=True)
class BlockIndex:
    """Parallel-decode metadata emitted alongside an encoded stream.

    Lives *outside* the byte stream (the bytes stay bit-identical to the
    reference); this is the framework's answer to the serial bit-offset
    dependency (reference: source/huffman.c:270-272).
    """

    symbols_per_block: int
    bit_offsets: np.ndarray  # int64[B]: absolute start bit of each block
    n_symbols: np.ndarray  # int32[B]: symbol count per block
    total_symbols: int
    total_bits: int  # unpadded bit length of the stream


def decode(
    data: bytes | bytearray | np.ndarray,
    table: HuffmanTable,
    max_output: int | None = None,
) -> bytes:
    """One-shot sequential decode of a foreign (un-indexed) stream.

    Raises UnknownSymbolError exactly where the reference would
    (source/huffman.c:246). Trailing padding is skipped per reference rules.
    """
    from .. import metrics

    with metrics.record("decode", len(data)) as _m:
        out = _decode_impl(data, table, max_output)
        _m[0] = len(out)
    return out


# One-shot decode feeds larger than this are auto-segmented through the
# streaming decoder: the self-sync dense assembly's per-slot channels
# scale with the segment count, so a 1 GiB
# view would allocate multi-GB scratch; 64 MiB feeds keep the per-call
# footprint flat while the decoder's remainder state preserves exact
# one-shot semantics (padding rules, error positions).
DECODE_SEGMENT_BYTES = 64 << 20


def _decode_impl(data, table, max_output):
    raw = bytes(data) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8).tobytes()
    if not raw:
        return b""
    if max_output is None and len(raw) > DECODE_SEGMENT_BYTES:
        from ..stream import HuffmanDecoder

        dec = HuffmanDecoder(table)
        parts = []
        for i in range(0, len(raw), DECODE_SEGMENT_BYTES):
            parts.append(dec.decode_chunk(raw[i : i + DECODE_SEGMENT_BYTES]).data)
        return b"".join(parts)
    # Foreign streams past a few KiB: self-synchronizing parallel decode;
    # the scan state machine below stays for short streams and for
    # truncated decodes (max_output), whose semantics it defines.
    if max_output is None and len(raw) > dispatch.SELFSYNC_MIN_BYTES:
        from . import selfsync

        if selfsync.supports(table):
            dispatch.note("decode", "selfsync")
            return selfsync.selfsync_decode(raw, table)
    dispatch.note("decode", "sequential")
    words_np, nbytes = words_from_bytes_np(raw)
    words = jnp.concatenate(
        [jnp.asarray(words_np), jnp.zeros(2, dtype=jnp.uint32)]
    )
    total_bits = nbytes * 8
    dt = DeviceTable.for_table(table)
    # Upper bound on symbols; bucketed to bound recompiles.
    max_syms = total_bits // max(table.min_len, 1) + 1
    if max_output is not None:
        max_syms = min(max_syms, max_output + 1)
    steps = 1 << max(8, (max_syms - 1).bit_length())
    cap = max_output if max_output is not None else max_syms
    syms, valid, n_decoded, _end_bit, status = decode_stream_kernel(
        words,
        jnp.int32(0),
        jnp.int32(total_bits),
        jnp.int32(cap),
        dt.l0_bits, dt.l0_val, dt.l1_bits, dt.l1_val,
        root_bits=table.root_bits,
        steps=steps,
    )
    if int(status) == STATUS_UNKNOWN_SYMBOL:
        raise UnknownSymbolError()
    n = int(n_decoded)
    return np.asarray(syms)[:n].tobytes()


def decode_indexed(
    data: bytes | bytearray | np.ndarray,
    index: BlockIndex,
    table: HuffmanTable,
    impl: str | None = None,
) -> bytes:
    """Block-parallel decode using a trusted BlockIndex (the fast path).

    Every index block is one lane of the lane decode (ops/lanes.py); the
    implementation comes from ops/dispatch.py unless ``impl`` names one.
    Raises UnknownSymbolError when a block meets a window that matches no
    code (a corrupt stream or index).
    """
    raw = bytes(data) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8).tobytes()
    if index.total_symbols == 0:
        return b""
    if index.total_bits >= 1 << 36:
        # lanes address the stream by int32 word index
        raise ValueError(
            "indexed decode supports streams < 2^36 bits; use the chunked "
            "streaming protocol"
        )
    impl = impl or dispatch.lane_impl("decode_indexed")
    K = index.symbols_per_block
    off = index.bit_offsets.astype(np.int64)
    B = off.size
    Bp = max(lanes.TILE, 1 << (B - 1).bit_length())
    lane_in = np.zeros((3, Bp), np.int32)
    lane_in[0, :B] = off >> 5
    lane_in[1, :B] = off & 31
    lane_in[2, :B] = index.n_symbols
    syms, bad = _decode_indexed_dev(
        stream_words_dev(raw), jnp.asarray(lane_in),
        lt=lanes.LaneTable.for_table(table), steps=K, impl=impl,
    )
    if bool(bad):
        raise UnknownSymbolError()
    out = np.asarray(syms)[:B]
    # All blocks are full except possibly the last => flat slice reassembles.
    if (index.n_symbols[:-1] == K).all():
        return out.reshape(-1)[: index.total_symbols].tobytes()
    return _ragged_concat(out, index)


@functools.partial(jax.jit, static_argnames=("lt", "steps", "impl"))
def _decode_indexed_dev(words, lane_in, *, lt, steps, impl):
    syms, _exits, bad, _o, _b = lanes.decode_lanes(
        words, lane_in[0], lane_in[1], lane_in[2], lt, steps=steps, impl=impl
    )
    return syms, jnp.any(bad != 0)


def _ragged_concat(syms: np.ndarray, index: BlockIndex) -> bytes:
    parts = [syms[b, : int(index.n_symbols[b])] for b in range(syms.shape[0])]
    return np.concatenate(parts).tobytes()
