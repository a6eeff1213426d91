"""Streaming codec: the chunked, resumable protocol.

Python equivalents of the reference's persistent encoder/decoder objects
(reference: include/aws/compression/huffman.h:63-84) and their
SHORT_BUFFER resume protocol (reference README.md:110-174). The streaming
state *is* the checkpoint (SURVEY.md §5): both classes expose their state
as plain ints/bytes so callers can serialize and resume anywhere.

Protocol mapping (C -> Python):
  aws_huffman_encode raising AWS_ERROR_SHORT_BUFFER with partial output
    -> ``HuffmanEncoder.encode_chunk`` returning ``done=False`` with the
       partial bytes (Python can't both return data and raise).
  encoder overflow_bits (reference huffman.h:69, saved huffman.c:89-99)
    -> ``HuffmanEncoder`` carry state (pattern, nbits), bit-identical.
  decoder working_bits/num_bits window (reference huffman.h:82-83)
    -> ``HuffmanDecoder`` remainder bitstream. One deliberate internal
       difference: when output capacity stops a decode, the reference
       leaves unread bytes in the *caller's* cursor while we retain them
       internally — emitted bytes and error conditions are identical, the
       caller just never re-feeds consumed input.

Bulk bit-packing runs on device through the same XLA kernel as the one-shot
path; only the protocol arithmetic (prefix-sum searches over code lengths)
runs on host. Bulk decode keeps the retained stream on device and drains it
through the self-synchronizing lane decode (ops/selfsync.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .errors import ShortBufferError, UnknownSymbolError
from .ops.bitpack import bytes_from_words_np, words_from_bytes_np
from .ops.decode import (
    STATUS_OUTPUT_FULL,
    STATUS_UNKNOWN_SYMBOL,
    decode_stream_kernel,
)
from .ops.encode import (
    DEFAULT_EOS_PADDING,
    DeviceTable,
    _bucket_size,
    encode_block_kernel,
)
from .tables import HuffmanTable


# Chunks above this byte count take the device-resident self-sync path.
BULK_DECODE_THRESHOLD = 65536

# One device encode call is bounded by int32 bit offsets; larger one-shot
# calls are auto-segmented through the capacity protocol (the carry path
# never inserts mid-stream padding, so the result is bit-identical to a
# true one-shot — the reference's size_t never limits, huffman.c:107-129).
_ONE_SHOT_BIT_LIMIT = 1 << 31


@dataclasses.dataclass
class EncodeResult:
    data: bytes  # bytes produced by this call (always complete bytes)
    consumed: int  # input symbols consumed (reference: cursor advance)
    done: bool  # False == reference AWS_ERROR_SHORT_BUFFER


@dataclasses.dataclass
class DecodeResult:
    data: bytes  # symbols produced by this call
    done: bool  # False == reference AWS_ERROR_SHORT_BUFFER


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


class HuffmanEncoder:
    """Persistent streaming encoder (reference: aws_huffman_encoder).

    State between calls is the carry: the low bits of a code that crossed
    the last capacity boundary (== reference overflow_bits, huffman.h:69).
    Every call that finishes the stream pads the final partial byte with
    the low bits of ``eos_padding`` (reference huffman.c:178-184), so —
    exactly like the reference — chunking *input* across successful calls
    inserts padding at each chunk end, while chunking *output* via
    ``done=False`` resumes produce one continuous bitstream.
    """

    def __init__(self, table: HuffmanTable, eos_padding: int = DEFAULT_EOS_PADDING):
        self.table = table
        self.eos_padding = eos_padding
        self._carry_pattern = 0
        self._carry_len = 0

    def reset(self) -> None:
        """Clear resume state (reference: aws_huffman_encoder_reset,
        source/huffman.c:22-27)."""
        self._carry_pattern = 0
        self._carry_len = 0

    @property
    def overflow_bits(self) -> tuple[int, int]:
        """(pattern, num_bits) carry, bit-identical to the reference field."""
        return self._carry_pattern, self._carry_len

    def state(self) -> dict:
        """Serializable checkpoint of the stream state."""
        return {"carry_pattern": self._carry_pattern, "carry_len": self._carry_len}

    def load_state(self, state: dict) -> None:
        self._carry_pattern = int(state["carry_pattern"])
        self._carry_len = int(state["carry_len"])

    def encoded_length(self, data) -> int:
        """Dry-run byte length (reference: aws_huffman_get_encoded_length,
        source/huffman.c:107-129). Ignores carry, like the reference."""
        symbols = _as_u8(data)
        bits = int(self.table.lengths[symbols].sum())
        return (bits + 7) // 8

    def encode_chunk(self, data, capacity: int | None = None) -> EncodeResult:
        """Encode up to ``capacity`` output bytes; resume-safe.

        ``capacity=None`` means unbounded (always completes). Raises
        UnknownSymbolError on the first symbol without a code, matching
        reference behavior (huffman.c:62-64) except no partial bytes are
        emitted first.
        """
        symbols = _as_u8(data)
        n = symbols.size
        if capacity is not None:
            # Only ceil(8*capacity / min_len) symbols can fit; bound the
            # host prefix-sum to O(chunk) instead of O(remaining stream).
            limit = (8 * int(capacity)) // max(self.table.min_len, 1) + 2
            if n > limit:
                symbols = symbols[:limit]
                n = limit
        if capacity is None and n * int(self.table.max_len) >= _ONE_SHOT_BIT_LIMIT:
            eff = int(self.table.lengths[symbols].max()) if n else 0
            if n * max(eff, 1) >= _ONE_SHOT_BIT_LIMIT:
                # Auto-segment: drive the capacity protocol internally.
                # Each sub-call's truncated symbol budget (8*cap/min_len)
                # times the envelope stays well inside the device
                # kernel's 2^31-bit offset range.
                seg_cap = max(
                    1024,
                    (_ONE_SHOT_BIT_LIMIT // 16)
                    * max(int(self.table.min_len), 1) // max(eff, 1),
                )
                parts = []
                pending = symbols
                while True:
                    r = self.encode_chunk(pending, seg_cap)
                    parts.append(r.data)
                    pending = pending[r.consumed :]
                    if r.done:
                        return EncodeResult(b"".join(parts), n, True)
        lens = self.table.lengths[symbols].astype(np.int64)
        bad = np.flatnonzero(lens == 0)
        if bad.size:
            i = int(bad[0])
            raise UnknownSymbolError(index=i, symbol=int(symbols[i]))

        # The per-symbol prefix sum is only needed to CUT at a capacity
        # boundary; unbounded bulk calls skip it (it would be O(chunk)
        # host work on every streaming call).
        total_bits = int(lens.sum()) + self._carry_len
        if total_bits == 0:
            return EncodeResult(b"", 0, True)
        writable = None if capacity is None else 8 * int(capacity)

        if writable is None or total_bits <= writable:
            out = self._pack(symbols, pad=True)
            self._carry_pattern = 0
            self._carry_len = 0
            return EncodeResult(out, n, True)
        ends = np.cumsum(lens) + self._carry_len

        # Short-buffer path: emit exactly `capacity` full bytes.
        if writable == 0:
            return EncodeResult(b"", 0, False)
        if self._carry_len > writable:
            # The pending carry alone overflows the budget: re-overflow its
            # tail, consuming no input (reference: the overflow flush at
            # huffman.c:148-159 can itself hit the short-buffer path in
            # encode_write_bit_pattern, huffman.c:88-99).
            over = self._carry_len - writable
            out = self._pack(symbols[:0], pad=False, min_bytes=capacity)
            self._carry_pattern &= (1 << over) - 1
            self._carry_len = over
            return EncodeResult(out[:capacity], 0, False)
        k_full = int(np.searchsorted(ends, writable, side="right"))
        consumed = k_full
        new_carry = (0, 0)
        if k_full < n and int(ends[k_full] - lens[k_full]) < writable:
            # Code k_full straddles the boundary: its low bits carry over
            # (reference huffman.c:88-99).
            over = int(ends[k_full]) - writable
            pattern = int(self.table.patterns[symbols[k_full]])
            new_carry = (pattern & ((1 << over) - 1), over)
            consumed = k_full + 1
        out = self._pack(symbols[:consumed], pad=False, min_bytes=capacity)
        self._carry_pattern, self._carry_len = new_carry
        return EncodeResult(out[:capacity], consumed, False)

    def encode(self, data) -> bytes:
        """One-shot convenience; includes any pending carry."""
        return self.encode_chunk(data, None).data

    def _pack(self, symbols: np.ndarray, pad: bool, min_bytes: int | None = None) -> bytes:
        """Device bit-pack of ``symbols`` behind the current carry bits."""
        n = symbols.size
        bucket = _bucket_size(max(n, 1))
        padded = np.zeros(bucket, dtype=np.uint8)
        padded[:n] = symbols
        dt = DeviceTable.for_table(self.table)
        words, total_bits, padded_bits, _bad, _idx = encode_block_kernel(
            jnp.asarray(padded),
            jnp.int32(n),
            dt.patterns,
            dt.lengths,
            jnp.uint32(self.eos_padding if pad else 0),
            jnp.int32(self._carry_len),
            num_out_words=bucket + 2,
        )
        words_np = np.asarray(words).copy()
        if self._carry_len:
            words_np[0] |= np.uint32(
                (self._carry_pattern << (32 - self._carry_len)) & 0xFFFFFFFF
            )
        nbits = int(padded_bits) if pad else int(total_bits)
        nbytes = (nbits + 7) // 8
        if min_bytes is not None:
            nbytes = max(nbytes, min_bytes)
        return bytes_from_words_np(words_np, nbytes)


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("sh",))
def _merge_words(buf, up, w0b, sh: int):
    """OR-merge shifted new words into ``buf`` at word ``w0b``.

    ``up`` is the new chunk packed from bit 0; ``sh`` = 8 * (nbytes % 4) is
    the byte phase of the append point. Bits past the valid stream are zero
    on both sides, so only the boundary word needs an OR; the rest
    overwrite zeros.
    """
    if sh:
        ext = jnp.concatenate([jnp.zeros(1, jnp.uint32), up])
        shifted = (ext[:-1] << jnp.uint32(32 - sh)) | (ext[1:] >> jnp.uint32(sh))
        up = jnp.concatenate([shifted, up[-1:] << jnp.uint32(32 - sh)])
    first = jax.lax.dynamic_index_in_dim(buf, w0b, keepdims=False)
    up = up.at[0].set(up[0] | first)
    return jax.lax.dynamic_update_slice(buf, up, (w0b,))


@functools.partial(jax.jit, donate_argnums=(0,))
def _slide_words(buf, cw):
    """Drop ``cw`` consumed words off the front (device compaction)."""
    n = buf.shape[0]
    padded = jnp.concatenate([buf, jnp.zeros(n, jnp.uint32)])
    return jax.lax.dynamic_slice(padded, (cw,), (n,))


class _DeviceRemainder:
    """Device-resident retained stream for the streaming decoder.

    The reference decoder's window state (working_bits/num_bits,
    huffman.h:82-83) generalizes here to (word buffer, consumed_bit): the
    buffer holds the stream since the last compaction, the cursor marks the
    resume point. Feeds upload only the NEW bytes; drains download only the
    emitted symbols — the remainder is never rebuilt on the host or
    re-uploaded.
    """

    def __init__(self):
        self.buf = None  # jnp.uint32[cap]; bits past nbytes*8 are zero
        self.nbytes = 0
        self.consumed_bit = 0

    @property
    def active(self) -> bool:
        return self.buf is not None

    def _ensure_capacity(self, need_words: int) -> None:
        # 2x headroom: covers the selfsync grid's pow2 bucketing overshoot
        # and the sliced-view slack without per-call repads.
        cap = max(2 << max(need_words - 1, 1).bit_length(), 1 << 12)
        if self.buf is None:
            self.buf = jnp.zeros(cap, jnp.uint32)
        elif self.buf.shape[0] < need_words:
            grown = jnp.zeros(cap, jnp.uint32)
            self.buf = jax.lax.dynamic_update_slice(grown, self.buf, (0,))

    def append(self, new: np.ndarray) -> None:
        if new.size == 0:
            if self.buf is None:
                self._ensure_capacity(1)
            return
        nb = self.nbytes
        w_new, _ = words_from_bytes_np(new.tobytes())
        sh = (nb % 4) * 8
        # +1 word for the shift spill; bucket the upload to limit compiles.
        n_up = w_new.size + 1
        n_up = 1 << (n_up - 1).bit_length()
        up_np = np.zeros(n_up, np.uint32)
        up_np[: w_new.size] = w_new
        w0b = nb // 4
        self._ensure_capacity(w0b + n_up)
        self.buf = _merge_words(self.buf, jnp.asarray(up_np), w0b, sh)
        self.nbytes = nb + new.size

    def compact(self) -> None:
        """Slide consumed whole words off the front when they dominate."""
        cw = self.consumed_bit >> 5
        if self.buf is None or cw < 1024 or cw < self.buf.shape[0] // 4:
            return
        self.buf = _slide_words(self.buf, cw)
        self.consumed_bit -= cw * 32
        self.nbytes -= cw * 4

    def to_host(self) -> tuple[np.ndarray, int]:
        """Materialize the unconsumed remainder as (bytes u8, start_bit<8).

        One D2H of the remainder — used when leaving device residency
        (small feeds, state(), leftover_bits)."""
        start_byte = self.consumed_bit >> 3
        nwords = -(-self.nbytes // 4)
        if self.buf is None or nwords == 0:
            return np.zeros(0, np.uint8), 0
        words = np.asarray(self.buf[:nwords])
        data = np.frombuffer(
            words.astype(">u4").tobytes(), dtype=np.uint8
        )[start_byte : self.nbytes]
        return data.copy(), self.consumed_bit & 7

    def clear(self) -> None:
        self.buf = None
        self.nbytes = 0
        self.consumed_bit = 0


class HuffmanDecoder:
    """Persistent streaming decoder (reference: aws_huffman_decoder).

    ``allow_growth=True`` makes plain :meth:`decode` ignore capacity and
    always finish (reference: aws_huffman_decoder_allow_growth,
    source/huffman.c:44-46 — growth is internal here since Python bytes
    aren't fixed buffers).
    """

    def __init__(self, table: HuffmanTable, allow_growth: bool = False):
        self.table = table
        self.allow_growth = allow_growth
        self._rem = np.zeros(0, dtype=np.uint8)  # unread stream bytes
        self._rem_start_bit = 0  # bit offset into _rem[0]
        self._dev = _DeviceRemainder()  # device-resident twin (bulk path)

    def _host_state(self) -> None:
        """Leave device residency: one D2H of the remainder into _rem."""
        if self._dev.active:
            self._rem, self._rem_start_bit = self._dev.to_host()
            self._dev.clear()

    def reset(self) -> None:
        """Reference: aws_huffman_decoder_reset (source/huffman.c:38-42)."""
        self._rem = np.zeros(0, dtype=np.uint8)
        self._rem_start_bit = 0
        self._dev.clear()

    def state(self) -> dict:
        self._host_state()
        return {"rem": self._rem.tobytes(), "rem_start_bit": self._rem_start_bit}

    def load_state(self, state: dict) -> None:
        self._rem = np.frombuffer(state["rem"], dtype=np.uint8).copy()
        self._rem_start_bit = int(state["rem_start_bit"])
        self._dev.clear()

    @property
    def leftover_bits(self) -> tuple[int, int]:
        """(value, num_bits) of unconsumed tail bits, MSB-first.

        The reference leaves trailing padding in working_bits for caller
        inspection — e.g. HPACK's all-1s padding check
        (reference README.md:176-183).
        """
        self._host_state()
        total = self._rem.size * 8 - self._rem_start_bit
        value = int.from_bytes(self._rem.tobytes(), "big")
        value &= (1 << total) - 1 if total else 0
        return value, total

    def padding_is_all_ones(self) -> bool:
        """HPACK-style validity check of trailing padding (RFC 7541 §5.2).

        The reference leaves padding in ``working_bits`` and documents this
        exact check as the caller's job (reference README.md:176-183); here
        it is a method. True iff every unconsumed tail bit is 1 (also true
        for a fully-consumed stream with no tail).
        """
        value, total = self.leftover_bits
        return total < 8 and value == (1 << total) - 1

    def decode_chunk(self, data, capacity: int | None = None) -> DecodeResult:
        """Decode; stops after ``capacity`` symbols (done=False) or when the
        input is exhausted (done=True). Consumes all of ``data`` into
        internal state either way."""
        new = _as_u8(data)

        # Bulk fast path: big chunks ride the self-sync lane decode (the
        # scan kernel below runs one symbol per step — unusable at MB
        # sizes). Capacity-bounded calls use the capped variant, which
        # decodes only a capacity-sized prefix and retains the remainder —
        # the SHORT_BUFFER resume protocol at device speed
        # (reference contract: huffman.c:257-268, huffman_testing.c:75-173).
        # The retained stream is DEVICE-RESIDENT across calls: feeds upload
        # only the new bytes, drains download only the emitted symbols; the
        # remainder is never rebuilt on host or re-uploaded.
        from .ops import dispatch, selfsync

        bulk_ok = selfsync.supports(self.table)
        # Engagement needs a big stream and a non-tiny capacity; once
        # device-resident, stay there for ANY capacity (the words-capped
        # path is O(capacity) regardless; leaving would re-download the
        # whole remainder).
        if bulk_ok and (
            self._dev.active
            or (
                self._rem.size + new.size > BULK_DECODE_THRESHOLD
                and (capacity is None or capacity >= 64)
            )
        ):
            if not self._dev.active and (self._rem.size or new.size):
                # Migrate the host remainder once; start_bit < 8 becomes
                # the device cursor.
                self._dev.append(self._rem)
                self._dev.consumed_bit = self._rem_start_bit
                self._rem = np.zeros(0, dtype=np.uint8)
                self._rem_start_bit = 0
            # Fused one-dispatch drain: compact slide + feed append +
            # decode + tail window ride ONE device program with one
            # batched download.
            dispatch.note("decode_chunk", "selfsync")
            res = self._drain_fused(new, capacity)
            if res is not None:
                return res
            self._dev.append(new)
            if capacity is None:
                out, end = selfsync.selfsync_decode_words(
                    self._dev.buf, self._dev.nbytes, self._dev.consumed_bit,
                    self.table,
                )
                more = False
            else:
                out, end, more = selfsync.selfsync_decode_capped_words(
                    self._dev.buf, self._dev.nbytes, self._dev.consumed_bit,
                    self.table, int(capacity),
                )
            self._dev.consumed_bit = end
            self._dev.compact()
            return DecodeResult(out, not more)

        # Host/scan paths below: leave device residency first (small feeds,
        # unsupported tables).
        dispatch.note("decode_chunk", "sequential")
        self._host_state()
        stream = np.concatenate([self._rem, new]) if self._rem.size else new
        start_bit = self._rem_start_bit
        total_bits = stream.size * 8
        if total_bits - start_bit <= 0:
            return DecodeResult(b"", True)

        words_np, _ = words_from_bytes_np(stream)
        words = jnp.concatenate([jnp.asarray(words_np), jnp.zeros(2, dtype=jnp.uint32)])
        max_possible = (total_bits - start_bit) // max(self.table.min_len, 1) + 1
        cap = max_possible if capacity is None else min(int(capacity), max_possible)
        steps = 1 << max(4, int(min(cap + 1, max_possible + 1) - 1).bit_length())
        dt = DeviceTable.for_table(self.table)
        syms, _valid, n_decoded, end_bit, status = decode_stream_kernel(
            words,
            jnp.int32(start_bit),
            jnp.int32(total_bits),
            jnp.int32(cap),
            dt.l0_bits, dt.l0_val, dt.l1_bits, dt.l1_val,
            root_bits=self.table.root_bits,
            steps=steps,
        )
        status = int(status)
        if status == STATUS_UNKNOWN_SYMBOL:
            raise UnknownSymbolError()
        n = int(n_decoded)
        end = int(end_bit)
        self._rem = stream[end // 8 :].copy()
        self._rem_start_bit = end % 8
        out = np.asarray(syms)[:n].tobytes()
        return DecodeResult(out, status != STATUS_OUTPUT_FULL)

    def _drain_fused(self, new: np.ndarray, capacity) -> "DecodeResult | None":
        """One-dispatch bulk drain; None = shape unsuited (classic path).

        Host-side mirror of the device mutation: the compact decision and
        the append point are computed here BEFORE the fused call, so the
        remainder's (nbytes, consumed_bit) bookkeeping never needs a
        device read. A rare unresolved/corrupt stream raises
        _FusedFallback carrying the already-mutated buffer; the classic
        path then re-runs over it with exact error semantics.
        """
        from .ops import selfsync

        dev = self._dev
        if dev.buf is None:
            dev._ensure_capacity(1)
        # compact slide, applied pre-merge (same rule as compact())
        cw = 0
        cwc = dev.consumed_bit >> 5
        if cwc >= 1024 and cwc >= dev.buf.shape[0] // 4:
            cw = cwc
        up = None
        up_bytes = 0
        if new.size:
            w_new, _ = words_from_bytes_np(new.tobytes())
            # floor the bucket at 256 words: sub-KB upload waste is free,
            # and every distinct bucket is a fused-graph variant whose
            # per-process compile-cache load costs seconds
            n_up = max(256, 1 << max(0, (w_new.size + 1 - 1).bit_length()))
            up = np.zeros(n_up, np.uint32)
            up[: w_new.size] = w_new
            up_bytes = int(new.size)
        try:
            res = selfsync.fused_drain_words(
                dev.buf, dev.nbytes, dev.consumed_bit, self.table,
                None if capacity is None else int(capacity),
                up=up, up_bytes=up_bytes, cw=cw,
            )
        except selfsync._FusedFallback as fb:
            dev.buf = fb.new_buf
            dev.nbytes = dev.nbytes - 4 * cw + up_bytes
            dev.consumed_bit -= 32 * cw
            if fb.error is not None:
                raise fb.error
            if capacity is None:
                out, end = selfsync.selfsync_decode_words(
                    dev.buf, dev.nbytes, dev.consumed_bit, self.table
                )
                more = False
            else:
                out, end, more = selfsync.selfsync_decode_capped_words(
                    dev.buf, dev.nbytes, dev.consumed_bit, self.table,
                    int(capacity),
                )
            dev.consumed_bit = end
            return DecodeResult(out, not more)
        if res is None:
            return None
        out, end, more, new_buf = res
        dev.buf = new_buf
        dev.nbytes = dev.nbytes - 4 * cw + up_bytes
        dev.consumed_bit = end
        return DecodeResult(out, not more)

    def decode(self, data, capacity: int | None = None) -> bytes:
        """Reference-shaped decode: raises ShortBufferError when capacity
        stops the decode and growth is off (reference huffman.c:257-266)."""
        if capacity is None or self.allow_growth:
            return self.decode_chunk(data, None).data
        res = self.decode_chunk(data, capacity)
        if not res.done:
            # State already advanced; caller can call again with b"".
            raise ShortBufferError(res.data)
        return res.data
