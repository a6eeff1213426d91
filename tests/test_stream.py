"""Streaming protocol tests: reference tier 3 (SURVEY.md §4).

Ports the partial-I/O property tests (reference tests/huffman_test.c:117-197
encoder partial/exact output; 275-363 decoder partial input/output; 365-385
allow-growth) and the chunked transitive oracle
(reference tests/huffman_test.c:429-446).
"""

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman import testing as oracle

from golden import ALL_CODES, ALL_CODES_ENCODED, STEP_SIZES, URL, URL_ENCODED


@pytest.fixture(scope="session")
def table():
    return th.load_static_test_table()


# --- encoder streaming -----------------------------------------------------


@pytest.mark.parametrize("step", STEP_SIZES)
def test_encoder_partial_output(table, step):
    """Grow output budget step bytes at a time; concatenation must equal the
    one-shot golden bytes (reference tests/huffman_test.c:117-165)."""
    enc = th.HuffmanEncoder(table)
    out = bytearray()
    remaining = ALL_CODES
    guard = 0
    while True:
        budget = min(step, len(ALL_CODES_ENCODED) - len(out))
        res = enc.encode_chunk(remaining, budget)
        assert res.data, "encode wrote no data"
        out.extend(res.data)
        remaining = remaining[res.consumed :]
        assert bytes(out) == ALL_CODES_ENCODED[: len(out)]
        if res.done:
            break
        guard += 1
        assert guard < 1000
    assert bytes(out) == ALL_CODES_ENCODED
    assert not remaining


def test_encoder_exact_output(table):
    """Exact-fit buffers complete without SHORT_BUFFER
    (reference tests/huffman_test.c:167-197)."""
    enc = th.HuffmanEncoder(table)
    res = enc.encode_chunk(b"?", 1)
    assert res.done and res.data == bytes([0xBA])
    res = enc.encode_chunk(b"yz", 2)
    assert res.done and res.data == bytes([0xA3, 0x79])


def test_encoder_zero_capacity(table):
    enc = th.HuffmanEncoder(table)
    res = enc.encode_chunk(URL, 0)
    assert res == th.EncodeResult(b"", 0, False)


def test_encoder_carry_state_roundtrip(table):
    """The carry (overflow_bits) is serializable mid-stream."""
    enc = th.HuffmanEncoder(table)
    res = enc.encode_chunk(ALL_CODES, 10)
    assert not res.done
    state = enc.state()

    enc2 = th.HuffmanEncoder(table)
    enc2.load_state(state)
    res2 = enc2.encode_chunk(ALL_CODES[res.consumed :], None)
    assert res.data + res2.data == ALL_CODES_ENCODED


def test_encoder_input_chunking_pads_each_chunk(table):
    """Chunking *input* across successful calls inserts padding per chunk,
    exactly like the reference (SURVEY.md §3.2 key semantic)."""
    enc = th.HuffmanEncoder(table)
    a = enc.encode(b"w")
    b = enc.encode(b"w")
    assert a == b == th.encode(b"w", table)  # each padded independently


def test_encoder_unknown_symbol_mid_stream():
    t = th.make_canonical({65: 1, 66: 2, 67: 3, 68: 3})
    enc = th.HuffmanEncoder(t)
    with pytest.raises(th.UnknownSymbolError):
        enc.encode_chunk(b"AAZA", None)


# --- decoder streaming -----------------------------------------------------


@pytest.mark.parametrize("step", STEP_SIZES)
def test_decoder_partial_input(table, step):
    """Feed encoded bytes in chunks (reference tests/huffman_test.c:275-314)."""
    dec = th.HuffmanDecoder(table)
    out = bytearray()
    for i in range(0, len(ALL_CODES_ENCODED), step):
        res = dec.decode_chunk(ALL_CODES_ENCODED[i : i + step], None)
        out.extend(res.data)
        assert bytes(out) == ALL_CODES[: len(out)]
    assert bytes(out) == ALL_CODES


@pytest.mark.parametrize("step", STEP_SIZES)
def test_decoder_partial_output(table, step):
    """Limit output budget per call (reference tests/huffman_test.c:316-363)."""
    dec = th.HuffmanDecoder(table)
    out = bytearray()
    feed: bytes = ALL_CODES_ENCODED
    guard = 0
    while True:
        budget = min(step, len(ALL_CODES) - len(out))
        res = dec.decode_chunk(feed, budget)
        feed = b""
        assert res.data, "decode wrote no data"
        out.extend(res.data)
        assert bytes(out) == ALL_CODES[: len(out)]
        if res.done:
            break
        guard += 1
        assert guard < 1000
    assert bytes(out) == ALL_CODES


def test_decoder_allow_growth(table):
    """reference tests/huffman_test.c:365-385."""
    dec = th.HuffmanDecoder(table, allow_growth=True)
    assert dec.decode(URL_ENCODED, capacity=1) == URL


def test_decoder_short_buffer_raises(table):
    dec = th.HuffmanDecoder(table)
    with pytest.raises(th.ShortBufferError):
        dec.decode(URL_ENCODED, capacity=1)


def test_decoder_state_roundtrip(table):
    dec = th.HuffmanDecoder(table)
    res = dec.decode_chunk(ALL_CODES_ENCODED, 10)
    assert not res.done
    state = dec.state()

    dec2 = th.HuffmanDecoder(table)
    dec2.load_state(state)
    rest = dec2.decode_chunk(b"", None)
    assert res.data + rest.data == ALL_CODES


def test_decoder_reset(table):
    dec = th.HuffmanDecoder(table)
    dec.decode_chunk(ALL_CODES_ENCODED[:5], None)
    dec.reset()
    assert dec.decode_chunk(URL_ENCODED, None).data == URL


def test_decoder_leftover_padding_bits(table):
    """Trailing padding is exposed for inspection (HPACK all-1s check,
    reference README.md:176-183)."""
    dec = th.HuffmanDecoder(table)
    res = dec.decode_chunk(th.encode(b"w", table), None)
    assert res.done and res.data == b"w"
    value, nbits = dec.leftover_bits
    assert nbits == 2 and value == 0b11  # 0xFF padding -> all ones


# --- oracles (tier 4 chunked) ----------------------------------------------


@pytest.mark.parametrize("step", STEP_SIZES)
def test_transitive_chunked(table, step):
    oracle.transitive_chunked(table, ALL_CODES, len(ALL_CODES_ENCODED), step)


def test_transitive_oracle(table):
    oracle.transitive(table, URL, len(URL_ENCODED))
    oracle.transitive(table, b"cdfh", 3)


@pytest.mark.parametrize("step", (1, 3, 7, 64))
def test_transitive_chunked_input(table, step):
    oracle.transitive_chunked_input(table, ALL_CODES, step)


@pytest.mark.slow
def test_chunked_random_data(table):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    oracle.transitive_chunked(table, data, None, 17)


# --- capacity-bounded bulk decode (SHORT_BUFFER at device speed) ---


def _route_fused_small(monkeypatch, counter=None):
    """Route the fused one-dispatch drain through seg_words=4 and the
    interpreted lane kernel: small segments keep the interpreter cheap.
    Returns nothing; the fused path stays live (same code, small
    segments)."""
    from tpu_huffman.ops import selfsync

    origf = selfsync.fused_drain_words

    def small_fused(buf, nbytes, consumed_bit, tab, capacity, **kw):
        if counter is not None:
            counter["n"] = counter.get("n", 0) + 1
        kw["seg_words"] = 4
        kw["impl"] = "interpret"
        return origf(buf, nbytes, consumed_bit, tab, capacity, **kw)

    monkeypatch.setattr(selfsync, "fused_drain_words", small_fused)


@pytest.mark.slow
def test_decode_chunk_capped_bulk_path(monkeypatch):
    """Capacity-bounded decode_chunk rides the capped self-sync kernel for
    big retained streams: the reference's SHORT_BUFFER resume contract
    (huffman.c:257-268, huffman_testing.c:75-173) off the scan kernel.
    (Slow tier: each drain's shrinking remainder crosses a new padded-S
    bucket, each a separate interpreted pipeline compile.
    test_decode_chunk_capped_fast keeps a single-bucket twin in the
    default gate.)"""
    from tpu_huffman import oracle as coracle
    from tpu_huffman import stream as stream_mod
    from tpu_huffman.ops import selfsync

    table = th.load_static_test_table()
    monkeypatch.setattr(stream_mod, "BULK_DECODE_THRESHOLD", 256)
    orig = selfsync.selfsync_decode_capped_words
    called = {}

    def spy(buf, nbytes, consumed_bit, tab, capacity,
            seg_words=selfsync.SEG_WORDS, impl=None):
        called["n"] = called.get("n", 0) + 1
        return orig(buf, nbytes, consumed_bit, tab, capacity, seg_words=4,
                    impl="interpret")

    monkeypatch.setattr(selfsync, "selfsync_decode_capped_words", spy)
    _route_fused_small(monkeypatch, counter=called)
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, size=4000, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)

    # Drive ours and the C++ oracle through the same capacity protocol and
    # compare EVERY chunk, not just the concatenation.
    dec = th.HuffmanDecoder(table)
    odec = coracle.OracleDecoder(coracle.OracleTable(table))
    pending_o = enc
    cap = 1600  # 3 capped rounds over the 4000-symbol stream
    res = dec.decode_chunk(enc, capacity=cap)
    out = res.data
    while True:
        o_out, o_consumed, o_done = odec.decode_chunk(pending_o, cap)
        pending_o = pending_o[o_consumed:]
        assert res.data == o_out
        assert res.done == (o_done and not pending_o)
        if res.done:
            break
        res = dec.decode_chunk(b"", capacity=cap)
        out += res.data
    assert out == data
    assert called.get("n", 0) >= 3


def test_selfsync_capped_matches_unbounded(monkeypatch):
    """Chained capped calls reproduce the one-shot decode exactly, at every
    capacity, including resume mid-byte."""
    from tpu_huffman.ops import selfsync

    table = th.load_static_test_table()
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=2500, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    # capacities: mid-byte resume chains (333), the cap==total-1/total
    # edges, and cap>total in one call; a cap-64 long chain lives in the
    # slow tier (test_words_capped_matches_host_capped).
    for cap in (333, 2499, 2500, 9999):
        got = b""
        rem = enc
        start_bit = 0
        while True:
            out, end, more = selfsync.selfsync_decode_capped(
                rem, table, cap, seg_words=4, start_bit=start_bit
            )
            got += out
            rem = rem[end // 8 :]
            start_bit = end % 8
            if not more:
                break
        assert got == data, cap


# --- device-resident retained stream ---


def test_device_remainder_misaligned_appends(monkeypatch):
    """Feeding odd-sized chunks exercises every byte phase of the device
    append's funnel merge; output must equal the host decode exactly."""
    from tpu_huffman import stream as stream_mod
    from tpu_huffman.ops import selfsync

    monkeypatch.setattr(stream_mod, "BULK_DECODE_THRESHOLD", 64)
    orig = selfsync.selfsync_decode_words

    def small(buf, nbytes, consumed_bit, tab, seg_words=selfsync.SEG_WORDS,
              impl=None):
        return orig(buf, nbytes, consumed_bit, tab, seg_words=4,
                    impl="interpret")

    monkeypatch.setattr(selfsync, "selfsync_decode_words", small)
    _route_fused_small(monkeypatch)
    table = th.load_static_test_table()
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, size=2000, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    dec = th.HuffmanDecoder(table)
    out = b""
    pos = 0
    for step in (517, 102, 3, 250, 10_000):  # cumulative pos hits all %4 phases
        out += dec.decode_chunk(enc[pos : pos + step]).data
        pos += step
        if pos >= len(enc):
            break
    assert out == data
    assert dec._dev.active  # stayed device-resident throughout


@pytest.mark.slow
def test_device_remainder_capped_drain_and_state(monkeypatch):
    """Feed once, drain by capacity: the remainder stays on device between
    calls (no host rebuild), compaction keeps the cursor bounded, and
    state()/leftover_bits still materialize exactly. (Slow tier: see
    test_decode_chunk_capped_bulk_path; the default gate covers the
    protocol with test_decode_chunk_capped_fast.)"""
    from tpu_huffman import stream as stream_mod
    from tpu_huffman.ops import selfsync

    monkeypatch.setattr(stream_mod, "BULK_DECODE_THRESHOLD", 64)
    orig = selfsync.selfsync_decode_capped_words

    def small(buf, nbytes, consumed_bit, tab, capacity,
              seg_words=selfsync.SEG_WORDS, impl=None):
        return orig(buf, nbytes, consumed_bit, tab, capacity, seg_words=4,
                    impl="interpret")

    monkeypatch.setattr(selfsync, "selfsync_decode_capped_words", small)
    _route_fused_small(monkeypatch)
    table = th.load_static_test_table()
    rng = np.random.default_rng(22)
    data = rng.integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    dec = th.HuffmanDecoder(table)
    out = b""
    res = dec.decode_chunk(enc, capacity=800)
    out += res.data
    while not res.done:
        assert dec._dev.active
        res = dec.decode_chunk(b"", capacity=800)
        out += res.data
    assert out == data
    # leftover padding inspection materializes the (tiny) remainder
    assert dec.padding_is_all_ones() or dec.leftover_bits[1] < 8
    st = dec.state()
    dec2 = th.HuffmanDecoder(table)
    dec2.load_state(st)
    assert dec2.decode_chunk(b"").data == b""


@pytest.mark.slow
def test_words_capped_matches_host_capped():
    """selfsync_decode_capped_words == selfsync_decode_capped at every
    capacity, including mid-WORD resume (consumed_bit beyond bit 7, which
    the host twin cannot even express)."""
    import jax.numpy as jnp

    from tpu_huffman.ops import selfsync
    from tpu_huffman.ops.bitpack import words_from_bytes_np

    table = th.load_static_test_table()
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, size=2500, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    words, nbytes = words_from_bytes_np(enc)
    buf = jnp.asarray(np.concatenate([words, np.zeros(64, np.uint32)]))
    for cap in (64, 333, 2499, 2500, 9999):
        got = b""
        consumed = 0
        while True:
            out, consumed, more = selfsync.selfsync_decode_capped_words(
                buf, nbytes, consumed, table, cap, seg_words=4
            )
            got += out
            if not more:
                break
        assert got == data, cap


def test_decode_chunk_capped_fast(monkeypatch):
    """Default-gate twin of the slow capped-protocol tests: ONE capped
    drain + resume over a stream sized to share the 2500-byte tests'
    compile bucket, device-resident throughout, every chunk compared to
    the C++ oracle."""
    from tpu_huffman import oracle as coracle
    from tpu_huffman import stream as stream_mod
    from tpu_huffman.ops import selfsync

    table = th.load_static_test_table()
    monkeypatch.setattr(stream_mod, "BULK_DECODE_THRESHOLD", 256)
    orig = selfsync.selfsync_decode_capped_words

    def small(buf, nbytes, consumed_bit, tab, capacity,
              seg_words=selfsync.SEG_WORDS, impl=None):
        return orig(buf, nbytes, consumed_bit, tab, capacity, seg_words=4,
                    impl="interpret")

    monkeypatch.setattr(selfsync, "selfsync_decode_capped_words", small)
    _route_fused_small(monkeypatch)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=2500, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    dec = th.HuffmanDecoder(table)
    odec = coracle.OracleDecoder(coracle.OracleTable(table))
    pending_o = enc
    out = b""
    cap = 1600
    res = dec.decode_chunk(enc, capacity=cap)
    while True:
        o_out, o_consumed, o_done = odec.decode_chunk(pending_o, cap)
        pending_o = pending_o[o_consumed:]
        assert res.data == o_out
        out += res.data
        if res.done:
            break
        assert dec._dev.active
        res = dec.decode_chunk(b"", capacity=cap)
    assert out == data
    st = dec.state()
    dec2 = th.HuffmanDecoder(table)
    dec2.load_state(st)
    assert dec2.decode_chunk(b"").data == b""
