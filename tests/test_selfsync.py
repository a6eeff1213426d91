"""Self-synchronizing foreign-stream decode (SURVEY.md §7 Plan B).

Kernel-path tests run the lane kernel under the Pallas interpreter
(``impl="interpret"``) with tiny segments, so sizes stay modest; the
full-size run on the GPU is chip_smoke.py.
"""

import numpy as np
import pytest

import tpu_huffman as th
from tpu_huffman.ops import selfsync


@pytest.fixture(scope="module")
def table():
    return th.load_static_test_table()


def test_supports(table):
    assert selfsync.supports(table)


def test_small_stream_host_path(table):
    data = b"www.example.com"
    enc = th.encode(data, table)
    assert selfsync.selfsync_decode(enc, table) == data


def test_tail_host_decoder_matches_reference_rules(table):
    # Exactly the sequential semantics: trailing padding skipped.
    for payload in (b"a", b"cdfh", b"hello world"):
        enc = th.encode(payload, table)
        value = int.from_bytes(enc, "big")
        out, pos = selfsync._decode_tail_host(table, value, len(enc) * 8)
        assert bytes(out) == payload
        assert pos <= len(enc) * 8


def test_unknown_symbol_raises(table):
    sparse = th.make_canonical({65: 1, 66: 2, 67: 3, 68: 3}, name="s4")
    # encode valid data then corrupt: all-zero bytes decode as 'A' (code 0)
    # forever in this sparse table, so use a table where 1111... is invalid.
    # Static table: craft a stream with an invalid prefix at the start.
    # 0b00000 is an invalid 5-bit prefix for the static table (codes start
    # at pattern 4), and a zero window never matches any interval.
    blob = bytes(300)  # 2400 bits of zeros: invalid with >=32 bits left
    with pytest.raises(th.UnknownSymbolError):
        selfsync.selfsync_decode(blob, table)


def test_kernel_path_roundtrip(table):
    """Hit the segment pipeline with tiny segments (seg_words=4: ~100+
    segments from a 1.9 KB stream)."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=1500, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)  # ~1.9 KB -> ~100+ tiny segments
    assert selfsync.selfsync_decode(enc, table, seg_words=4, impl="interpret") == data


def test_kernel_path_text_corpus(table):
    """Compressible (skewed) data synchronizes too."""
    data = (b"the quick brown fox jumps over the lazy dog. " * 40)[:1600]
    enc = th.encode(data, table)
    assert selfsync.selfsync_decode(enc, table, seg_words=4, impl="interpret") == data


def test_chunk_resume_mid_stream(table):
    """selfsync_decode_ex across an arbitrary split == full decode."""
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=1800, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    for cut in (701, 1111):
        out1, end1 = selfsync.selfsync_decode_ex(
            enc[:cut], table, seg_words=4, impl="interpret"
        )
        rem = enc[end1 // 8 : cut]
        out2, _ = selfsync.selfsync_decode_ex(
            rem + enc[cut:], table, seg_words=4, start_bit=end1 % 8,
            impl="interpret",
        )
        assert out1 + out2 == data, cut


def test_streaming_decoder_bulk_path(table, monkeypatch):
    """HuffmanDecoder.decode_chunk rides the device-resident selfsync for
    big chunks (the retained stream stays on device; feeds upload only new
    bytes)."""
    from tpu_huffman import stream as stream_mod

    monkeypatch.setattr(stream_mod, "BULK_DECODE_THRESHOLD", 256)
    called = {}
    orig_w = selfsync.selfsync_decode_words

    def spy_w(buf, nbytes, consumed_bit, tab, seg_words=selfsync.SEG_WORDS,
              impl=None):
        called["yes"] = True
        return orig_w(buf, nbytes, consumed_bit, tab, seg_words=4,
                      impl="interpret")

    monkeypatch.setattr(selfsync, "selfsync_decode_words", spy_w)
    # the one-dispatch fused drain handles bulk calls first; route it
    # through 4-word segments and the interpreted kernel, and count it too
    orig_f = selfsync.fused_drain_words

    def spy_f(buf, nbytes, consumed_bit, tab, capacity, **kw):
        called["yes"] = True
        kw["seg_words"] = 4
        kw["impl"] = "interpret"
        return orig_f(buf, nbytes, consumed_bit, tab, capacity, **kw)

    monkeypatch.setattr(selfsync, "fused_drain_words", spy_f)
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    dec = th.HuffmanDecoder(table)
    mid = len(enc) // 2
    out = dec.decode_chunk(enc[:mid]).data
    out += dec.decode_chunk(enc[mid:]).data
    assert out == data
    assert called.get("yes")


def test_decode_dispatches_to_selfsync(table, monkeypatch):
    called = {}
    orig = selfsync.selfsync_decode

    def spy(raw, tab, seg_words=selfsync.SEG_WORDS, impl=None):
        called["yes"] = True
        return orig(raw, tab, seg_words=4, impl="interpret")

    monkeypatch.setattr(selfsync, "selfsync_decode", spy)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=4000, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    assert th.decode(enc, table) == data
    assert called.get("yes")


def test_one_pass_fast_path_engages():
    """Clean streams resolve via the one-pass + patch stitch — no fixpoint
    fallback — and stay bit-exact.

    Uses a Kraft-complete table: self-sync there is a pure codeword walk
    (no invalid 1-bit steps), fast enough to merge inside the tiny
    128-bit test segments. The incomplete static table syncs in ~100-250
    bits and is exercised at production segment size by chip_smoke.py.
    """
    import tpu_huffman.ops.selfsync as ss

    lens = {}
    sym = 0
    for length, count in ((2, 2), (4, 4), (6, 8), (7, 16)):
        for _ in range(count):
            lens[sym] = length
            sym += 1
    t = th.make_canonical(lens, name="complete30")
    rng = np.random.default_rng(31)
    data = rng.integers(0, sym, size=2200, dtype=np.uint8).tobytes()
    enc = th.encode(data, t)
    # Clean streams resolve entirely in the DEVICE stitch — the
    # host merge (_stitch_fast), the repair round (_dense_repair), and the
    # fixpoint (_segments_pipeline) must all stay untouched.
    calls = {"stitch": 0, "repair": 0, "fixpoint": 0}
    origs = (ss._stitch_fast, ss._dense_repair, ss._segments_pipeline)

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    ss._stitch_fast = spy("stitch", origs[0])
    ss._dense_repair = spy("repair", origs[1])
    ss._segments_pipeline = spy("fixpoint", origs[2])
    try:
        out = selfsync.selfsync_decode(enc, t, seg_words=4, impl="interpret")
    finally:
        ss._stitch_fast, ss._dense_repair, ss._segments_pipeline = origs
    assert out == data
    assert calls == {"stitch": 0, "repair": 0, "fixpoint": 0}


@pytest.mark.slow
def test_one_pass_repair_round(table):
    """Failed segments (sync slower than the patch reach) are repaired by
    the compacted device round, still bit-exact. The static table's
    ~100-250-bit sync distance vs 128-bit test segments forces repairs
    (or, when pass 0 never syncs, the fixpoint fallback) — either way the
    output must match."""
    import tpu_huffman.ops.selfsync as ss

    rng = np.random.default_rng(33)
    data = rng.integers(0, 256, size=2200, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    assert selfsync.selfsync_decode(enc, table, seg_words=4, impl="interpret") == data
    # larger test segments: sync fits, repairs become rare/none
    assert selfsync.selfsync_decode(enc, table, seg_words=8, impl="interpret") == data


def test_one_pass_fallback_still_correct(table):
    """Forcing the stitch to fail must route through the fixpoint loop
    with identical output."""
    import tpu_huffman.ops.selfsync as ss

    rng = np.random.default_rng(32)
    data = rng.integers(0, 256, size=1700, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    old = ss._stitch_fast
    ss._stitch_fast = lambda *a, **k: None
    try:
        out = selfsync.selfsync_decode(enc, table, seg_words=4, impl="interpret")
    finally:
        ss._stitch_fast = old
    assert out == data


def test_one_pass_text_corpus_and_chunks(table):
    """Skewed data + chunked resume ride the fast path bit-exactly."""
    data = (b"a bird in hand is worth two in the bush. " * 64)[:2048]
    enc = th.encode(data, table)
    out1, end1 = selfsync.selfsync_decode_ex(enc[:900], table, seg_words=4, impl="interpret")
    rem = enc[end1 // 8 : 900]
    out2, _ = selfsync.selfsync_decode_ex(
        rem + enc[900:], table, seg_words=4, start_bit=end1 % 8,
        impl="interpret",
    )
    assert out1 + out2 == data


@pytest.mark.slow
def test_in_graph_repair_splices_failed_segments(table, monkeypatch):
    """Segments that fail to merge within the patch reach are re-decoded
    and spliced INSIDE the dense program (no classic-path fallback). A
    4-symbol patch over 256-bit segments makes failures plentiful; the
    happy ("dense") path must still produce the exact stream — which
    proves the repair validated and spliced, because with failures present
    all_ok is only true post-repair."""
    monkeypatch.setattr(selfsync, "PATCH_SYMS", 4)
    rng = np.random.default_rng(33)
    data = rng.integers(0, 256, size=16000, dtype=np.uint8).tobytes()
    enc = th.encode(data, table)
    out, end = selfsync.selfsync_decode_ex(enc, table, seg_words=8, impl="interpret")
    assert out == data
